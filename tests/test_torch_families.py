"""The example families (``binf_tpu_torch/example/{logistic,statespace,
mixture,hierarchical}.py``), the two forward models this slice ports, and
the device densities of the logistic, AR(1), mixture and hierarchical
posteriors (``ops/kernels/densities.py``) against the JAX package, on the
CPU.

Both packages build each posterior from the same numpy data (the JAX
package's synthetic data; the port cannot reproduce ``jax.random``).  Log
densities and gradients agree at 16 seeded points to 1e-5 relative to the
largest value (float32 sums in other orders).  The fused route on the CPU
runs the plain K3 and K4 with the family's device density, not
``CallableDensity``; the plain K4 follows the JAX package's interpret-mode
kernel draw for draw on the same host noise, at 2e-4 as
``tests/test_torch_fused_potential.py`` holds the linear regression."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import hierarchical as jh
from binf_tpu.example import logistic as jl
from binf_tpu.example import mixture as jm
from binf_tpu.example import statespace as js
from binf_tpu.model.forward import PairwiseDistanceModel as JaxPairwise
from binf_tpu.model.forward import ParametricCurveModel as JaxCurve
from binf_tpu.core.density import VariableSpec as JaxSpec
from binf_tpu.ops.pallas.fused_potential import (
    fused_potential_hmc_run as jax_run,
    tile_potential_from_scalar,
)
from binf_tpu.pdf.transforms import LogTransform as JaxLog
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu_torch.core.density import VariableSpec
from binf_tpu_torch.example import hierarchical, logistic, mixture, statespace
from binf_tpu_torch.model import PairwiseDistanceModel, ParametricCurveModel
from binf_tpu_torch.ops.kernels import densities
from binf_tpu_torch.ops.kernels import density_compiler as dc
from binf_tpu_torch.ops.kernels.densities import (AR1Density, CallableDensity,
                                                  HierarchicalDensity, LogisticDensity,
                                                  MixtureDensity, device_density)
from binf_tpu_torch.ops.kernels.fused_potential import (fused_potential_hmc_plain, pack_positions,
                                                        pack_template, unpack_draws)
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import auto
from binf_tpu_torch.samplers import fused as fused_mod

RTOL = 1e-5
P = 16  # seeded points
C, BC, STEPS = 16, 16, 20


def _np(x):
    return np.array(x, np.float32)


@pytest.fixture(scope="module")
def problems():
    """name -> (JAX log density, port log density, template shapes, the
    port's device density class or None)."""
    X, y = jl.synthetic_logistic_data(jax.random.key(0))
    y_ar = js.synthetic_ar1_data(jax.random.key(0))
    y_mx = jm.synthetic_mixture_data(jax.random.key(0))
    x_h, y_h, c_h, _ = jh.synthetic_hierarchical_data(jax.random.key(0), 8)
    return {
        "logistic": (jl.make_logistic_posterior(X, y).log_prob,
                     logistic.make_logistic_posterior(_np(X), _np(y), device="cpu").log_prob,
                     {"weights": (5,)}, LogisticDensity),
        "ar1": (jax_transform(js.make_ar1_posterior(y_ar).log_prob, {"precision": JaxLog}),
                transform_logdensity(statespace.make_ar1_posterior(_np(y_ar), device="cpu")
                                     .log_prob, {"precision": LogTransform}),
                {"dynamics": (3,), "precision": ()}, AR1Density),
        "mixture": (jm.make_mixture_posterior(y_mx).log_prob,
                    mixture.make_mixture_posterior(_np(y_mx), device="cpu").log_prob,
                    {"log_sigma": (), "log_weights": (3,), "means": (3,)}, MixtureDensity),
        "hierarchical": (
            jax_transform(jh.make_hierarchical_posterior(x_h, y_h, c_h, 8).log_prob,
                          {"precision": JaxLog}),
            transform_logdensity(hierarchical.make_hierarchical_posterior(
                _np(x_h), _np(y_h), _np(c_h), 8, device="cpu").log_prob,
                {"precision": LogTransform}),
            {"group_params": (8, 2), "log_tau": (2,), "mu": (2,), "precision": ()},
            HierarchicalDensity),
    }


def _points(shapes, seed, n=P):
    rng = np.random.default_rng(seed)
    D = sum(int(np.prod(s)) for s in shapes.values())
    q = 0.5 * rng.normal(size=(n, D))
    names = sorted(shapes)
    if "precision" in shapes:  # log precision near the data's
        q[:, sum(int(np.prod(shapes[k])) for k in names[:names.index("precision")])] += 3.0
    return q.astype(np.float32)


def _template(shapes):
    return {k: torch.zeros(s) for k, s in shapes.items()}


def _jax_value_and_grad(fn, shapes, q):
    spec = pack_template(_template(shapes))

    def flat(v):
        out, o = {}, 0
        for name, shape, size in spec:
            out[name] = v[o:o + size].reshape(shape)
            o += size
        return fn(out)

    ld, g = jax.vmap(jax.value_and_grad(flat))(jnp.asarray(q))
    return np.asarray(ld), np.asarray(g)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_refs(problems):
    """name -> (points, JAX log density and gradient there), once a family."""
    out = {}
    for name, (jfn, _, shapes, _) in problems.items():
        q = _points(shapes, 1)
        out[name] = (q, *_jax_value_and_grad(jfn, shapes, q))
    return out


@pytest.mark.parametrize("name", ["logistic", "ar1", "mixture", "hierarchical"])
def test_log_density_and_gradient_match_jax(problems, jax_refs, name):
    _, tfn, shapes, _ = problems[name]
    q, ld, g = jax_refs[name]
    U, gU = CallableDensity(tfn, _template(shapes)).potential_and_grad(torch.tensor(q))
    _close(-U.numpy(), ld)
    _close(-gU.numpy(), g)


@pytest.mark.parametrize("name", ["logistic", "ar1", "mixture", "hierarchical"])
def test_device_density_matches_jax(problems, jax_refs, name):
    _, tfn, shapes, cls = problems[name]
    density = device_density(tfn, _template(shapes))
    assert type(density) is cls and densities.is_device_density(density)
    q, ld, g = jax_refs[name]
    U, gU = density.potential_and_grad(torch.tensor(q))
    _close(-U.numpy(), ld)
    _close(-gU.numpy(), g)
    # the one-launch evaluation on the CPU is the plain version
    U2, g2 = densities.density_eval(density, torch.tensor(q), device="cpu")
    assert torch.equal(U2, U) and torch.equal(g2, gU)


def test_hierarchical_has_no_device_density(problems):
    """The hierarchical posterior has a hand-written device density at the
    CLI's 8 groups, the one csrc instantiates, and none at 20, past the 2
    to 16 groups the family runs: there the density compiler's wide form
    takes it (D = 45, a TracedDensity)."""
    _, tfn, shapes, _ = problems["hierarchical"]
    assert type(device_density(tfn, _template(shapes))) is HierarchicalDensity
    x4, y4, c4, _ = jh.synthetic_hierarchical_data(jax.random.key(0), 20)
    tfn4 = transform_logdensity(hierarchical.make_hierarchical_posterior(
        _np(x4), _np(y4), _np(c4), 20, device="cpu").log_prob, {"precision": LogTransform})
    wide = device_density(tfn4, _template({**shapes, "group_params": (20, 2)}))
    assert type(wide) is densities.TracedDensity and wide.D == 45 and wide.wide


def test_introspection_is_strict(problems):
    """Only the exact posteriors are recognised: anything else gets no
    family's device density, but the density compiler's functor where it
    traces the callable (a TracedDensity), else its refusal (no
    coordinates), which raises on the card, or the callable's own error
    (the wrong template), raised as it is."""
    X, y = jl.synthetic_logistic_data(jax.random.key(0))
    post = logistic.make_logistic_posterior(_np(X), _np(y), device="cpu")
    t = {"weights": torch.zeros(5)}
    cases = [
        (lambda p: post.log_prob(p), t),  # not the bound method
        (post.fix(weights=torch.zeros(5)).log_prob, {}),
        (transform_logdensity(post.log_prob, {"weights": LogTransform}), t),
        (post.tempered(0.5).log_prob, t),
        (post.log_prob, {"weights": torch.zeros(4)}),
        (statespace.make_ar1_posterior(_np(js.synthetic_ar1_data(jax.random.key(0))),
                                       device="cpu").log_prob,
         {"dynamics": torch.zeros(3), "precision": torch.zeros(())}),
        (mixture.make_mixture_posterior(_np(jm.synthetic_mixture_data(jax.random.key(0))), 9,
                                        device="cpu").log_prob,
         {"log_sigma": torch.zeros(()), "log_weights": torch.zeros(9), "means": torch.zeros(9)}),
    ]
    for k, (fn, template) in enumerate(cases):
        assert densities.recognise(fn, template) is None
        if k == 1:
            with pytest.raises(NotImplementedError, match="not tile-compilable"):
                device_density(fn, template)
        elif k == 4:
            with pytest.raises(RuntimeError) as e:
                device_density(fn, template)
            assert not isinstance(e.value, NotImplementedError), e.value
        else:
            assert isinstance(device_density(fn, template), densities.TracedDensity)


def test_forward_models_match_jax():
    x = np.linspace(-2, 2, 9).astype(np.float32)
    specs = (("amp", ()), ("rate", ()))

    def jcurve(xx, v):
        return v["amp"] * jax.nn.sigmoid(v["rate"] * xx)

    def tcurve(xx, v):
        return v["amp"] * torch.sigmoid(v["rate"] * xx)

    jm_ = JaxCurve(x=jnp.asarray(x), fn=jcurve, specs=tuple(JaxSpec(n, s) for n, s in specs))
    tm_ = ParametricCurveModel(x=torch.tensor(x), fn=tcurve,
                               specs=tuple(VariableSpec(n, s) for n, s in specs))
    vals = {"amp": np.float32(1.3), "rate": np.float32(-0.7)}
    np.testing.assert_allclose(tm_(vals).numpy(), np.asarray(jm_(vals)), rtol=RTOL)
    jac = tm_.jacobian(vals)
    jjac = jm_.jacobian(vals)
    for k in ("amp", "rate"):
        np.testing.assert_allclose(jac[k].numpy(), np.asarray(jjac[k]), rtol=RTOL, atol=1e-7)

    pairs = np.array([[0, 1], [1, 2], [0, 3], [2, 2]])
    Xs = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    jp = JaxPairwise.create(4, pairs)
    tp = PairwiseDistanceModel.create(4, pairs)
    np.testing.assert_allclose(tp(structure=Xs).numpy(), np.asarray(jp(structure=Xs)),
                               rtol=RTOL)
    # coincident beads (pair (2, 2)): a finite gradient from the clipped norm
    g = tp.jacobian(structure=torch.tensor(Xs))["structure"]
    gj = jp.jacobian(structure=jnp.asarray(Xs))["structure"]
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=RTOL, atol=1e-6)


def test_builders_take_numpy_and_tensors_and_helpers_match_jax():
    X, y = jl.synthetic_logistic_data(jax.random.key(0))
    a = logistic.make_logistic_posterior(_np(X), _np(y), device="cpu")
    b = logistic.make_logistic_posterior(torch.tensor(_np(X)), torch.tensor(_np(y)), device="cpu")
    w = {"weights": torch.tensor([1.0, -1.0, 0.5, 0.0, 0.3])}
    assert float(a.log_prob(w)) == float(b.log_prob(w))
    draws = np.random.default_rng(0).normal(size=(50, 5)).astype(np.float32)
    np.testing.assert_allclose(logistic.predict_proba(_np(X[:7]), torch.tensor(draws)).numpy(),
                               np.asarray(jl.predict_proba(X[:7], jnp.asarray(draws))), rtol=RTOL)
    y_mx = jm.synthetic_mixture_data(jax.random.key(0))
    s = {"means": np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32),
         "log_weights": np.random.default_rng(2).normal(size=(40, 3)).astype(np.float32),
         "log_sigma": np.random.default_rng(3).normal(size=40).astype(np.float32) * 0.1}
    assert (mixture.classify(_np(y_mx[:30]), {k: torch.tensor(v) for k, v in s.items()}).numpy()
            == np.asarray(jm.classify(y_mx[:30], {k: jnp.asarray(v) for k, v in s.items()}))).all()
    g = torch.Generator().manual_seed(0)
    for fn, n in ((logistic.synthetic_logistic_data, 200),):
        Xs, ys = fn(g, device="cpu")
        assert Xs.shape == (n, 5) and ys.shape == (n,) and set(ys.tolist()) <= {0.0, 1.0}
    assert statespace.synthetic_ar1_data(g, device="cpu").shape == (64,)
    assert mixture.synthetic_mixture_data(g, device="cpu").shape == (240,)
    xh, yh, ch, gp = hierarchical.synthetic_hierarchical_data(g, 8, device="cpu")
    assert xh.shape == (15,) and yh.shape == (120,) and ch.shape == (8,) and gp.shape == (8, 2)
    assert statespace.initial_positions(7, device="cpu")["precision"].shape == (7,)
    assert mixture.initial_positions(7, device="cpu")["means"].shape == (7, 3)
    assert logistic.initial_positions(7, device="cpu")["weights"].shape == (7, 5)


def _noise(seed, steps):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    return (torch.tensor(np.asarray(jax.random.normal(k1, (steps, 8, C), jnp.float32))),
            torch.tensor(np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32))))


# (family, seed, step size): steps inside the stable range, seeds whose MH
# decisions all lie more than 5e-5 from their thresholds (asserted)
PLAIN_RUNS = [("logistic", 1, 0.15), ("ar1", 2, 0.01), ("mixture", 1, 0.04)]


@pytest.mark.parametrize("name, seed, eps", PLAIN_RUNS)
def test_plain_k4_matches_jax_interpret(problems, name, seed, eps):
    jfn, tfn, shapes, _ = problems[name]
    template = {k: jnp.zeros(s) for k, s in shapes.items()}
    potential, consts, _ = tile_potential_from_scalar(jfn, template)
    density = device_density(tfn, _template(shapes))
    q0 = _points(shapes, 3, C)
    if name == "logistic":
        q0 = (np.array([1.5, -2.0, 0.75, 0.0, 1.0]) + 0.1 * q0).astype(np.float32)
    if name == "mixture":
        q0[:, 4:] += np.array([-2.0, 0.5, 3.0], np.float32)
    eps_c = np.full(C, eps, np.float32)
    im = np.ones((C, q0.shape[1]), np.float32)
    jr = jax_run(potential, jnp.asarray(q0), seed, jnp.asarray(eps_c), jnp.asarray(im), consts,
                 num_steps=STEPS, block_chains=BC, steps_per_block=STEPS, interpret=True,
                 host_noise=True)
    trace = fused_potential_hmc_plain(density, torch.tensor(q0), seed, torch.tensor(eps_c),
                                      torch.tensor(im), num_steps=STEPS, block_chains=BC,
                                      noise=_noise(seed, STEPS))
    assert float(trace.margin.abs().min()) > 5e-5
    got = trace.result
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    assert 0.0 < float(got.accept_rate) < 1.0
    np.testing.assert_allclose(got.draws.numpy(), np.asarray(jr.draws), atol=2e-4)


@pytest.mark.parametrize("name", ["logistic", "ar1", "mixture"])
def test_fused_route_on_the_cpu_runs_the_device_density(problems, monkeypatch, name):
    """``fused_model_hmc(device="cpu", warmup="fused")`` hands K3 and K4 the
    family's device density, not CallableDensity, and its draws are
    finite and accepted at a sane rate."""
    _, tfn, shapes, cls = problems[name]
    seen = []
    for attr in ("fused_warmup_run", "fused_potential_hmc_run"):
        real = getattr(fused_mod, attr)

        def spy(density, *a, _real=real, **k):
            seen.append(type(density))
            return _real(density, *a, **k)

        monkeypatch.setattr(fused_mod, attr, spy)
    start = unpack_draws(torch.tensor(_points(shapes, 4, 32)), pack_template(_template(shapes)))
    if name == "mixture":
        start["means"] = start["means"] + torch.tensor([-2.0, 0.5, 3.0])
    res = fused_mod.fused_model_hmc(tfn, start, 0, num_warmup=60, num_samples=20,
                                    initial_step_size=0.05, block_chains=32, warmup="fused",
                                    device="cpu")
    assert seen == [cls, cls]
    assert all(bool(torch.isfinite(v).all()) for v in res.samples.values())
    assert 0.2 < float(res.accept_rate) <= 1.0


def test_router_decisions(problems):
    """route_algorithm: "fused" for the four families, the hierarchical
    posterior at 8 groups among them, and for it at 20 and 126 groups (the
    density compiler's wide form: a warp a chain at D = 45, two at D =
    257), "xla" past the compiler's MAX_D_WIDE coordinates (2,046 groups,
    D = 4,097); route_trajectory_sampler passes other requests through and
    reroutes NUTS where a functor runs the density ("device density"),
    else follows the measurement."""
    for name in ("logistic", "ar1", "mixture", "hierarchical"):
        _, tfn, shapes, cls = problems[name]
        start = unpack_draws(torch.tensor(_points(shapes, 5, 8)), pack_template(_template(shapes)))
        dec = auto.route_algorithm(tfn, start)
        assert dec.path == ("xla" if cls is None else "fused"), dec
        assert auto.route_trajectory_sampler("hmc", tfn, start) == (
            "hmc", "requested 'hmc' (no reroute rule)")
        sampler, reason = auto.route_trajectory_sampler("nuts", tfn, start)
        if cls is not None:
            assert sampler == "hmc" and cls.__name__ in reason
    _, _, shapes, _ = problems["hierarchical"]
    shapes4 = {**shapes, "group_params": (20, 2)}
    x4, y4, c4, _ = jh.synthetic_hierarchical_data(jax.random.key(0), 20)
    tfn4 = transform_logdensity(hierarchical.make_hierarchical_posterior(
        _np(x4), _np(y4), _np(c4), 20, device="cpu").log_prob, {"precision": LogTransform})
    start = unpack_draws(torch.tensor(_points(shapes4, 5, 8)), pack_template(_template(shapes4)))
    dec = auto.route_algorithm(tfn4, start)
    assert dec.path == "fused" and "TracedDensity" in dec.reason and dec.d == 45, dec
    assert auto.route_trajectory_sampler("nuts", tfn4, start)[0] == "hmc"
    for groups in (126, (dc.MAX_D_WIDE - 5) // 2 + 1):
        shapes4 = {**shapes, "group_params": (groups, 2)}
        x4, y4, c4, _ = jh.synthetic_hierarchical_data(jax.random.key(0), groups)
        tfn4 = transform_logdensity(hierarchical.make_hierarchical_posterior(
            _np(x4), _np(y4), _np(c4), groups, device="cpu").log_prob,
            {"precision": LogTransform})
        start = unpack_draws(torch.tensor(_points(shapes4, 5, 8)),
                             pack_template(_template(shapes4)))
        dec = auto.route_algorithm(tfn4, start)
        if groups == 126:
            assert dec.path == "fused" and "TracedDensity" in dec.reason and dec.d == 257, dec
            assert "2 warp(s) a chain" in dec.reason, dec
            assert auto.route_trajectory_sampler("nuts", tfn4, start)[0] == "hmc"
    assert dec.path == "xla" and dec.reason.startswith("not tile-compilable"), dec
    assert dec.d == dc.MAX_D_WIDE + 1, dec
    m = auto.NUTS_MEASUREMENT
    if m is not None:
        expect = "hmc" if m["hmc_ess_per_s"] > m["nuts_ess_per_s"] else "nuts"
        assert auto.route_trajectory_sampler("nuts", tfn4, start)[0] == expect


def test_new_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'binf_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import binf_tpu_torch.samplers.mala, binf_tpu_torch.samplers.nuts\n"
        "import binf_tpu_torch.samplers.slice, binf_tpu_torch.samplers.tempering\n"
        "import binf_tpu_torch.samplers.gibbs, binf_tpu_torch.samplers.auto\n"
        "import binf_tpu_torch.example.logistic, binf_tpu_torch.example.statespace\n"
        "import binf_tpu_torch.example.mixture, binf_tpu_torch.example.hierarchical\n"
        "import binf_tpu_torch.model.forward, binf_tpu_torch.ops.kernels.densities\n"
        "from binf_tpu_torch.samplers import route_trajectory_sampler, NUTSInfo, parallel_tempering\n"
        "from binf_tpu_torch.model import ParametricCurveModel, PairwiseDistanceModel\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
