"""Models of the DSL with no hand-written functor, through the density
compiler, against the JAX package, on the CPU.

Each error model and prior of the DSL sits in a small model (Student-t,
Laplace, Poisson with its log link, Bernoulli, log-normal, Gamma,
half-normal, exponential, and a uniform prior under the sigmoid transform).
Both packages build it from the same numpy data (seeded); the port's
density is compiled (``density_compiler.compile_density``) and its functor
built with ``g++`` (one library for the module).  Its U and gradient are
held against ``jax.value_and_grad`` of the JAX model at 16 seeded points,
within 1e-4 of the largest |entry|.  Then the router: on the robust
regression, the Poisson GLM and the 6-D Gaussian at 1,024 chains it
compiles what the JAX router finds tile-compilable and sends it to K3 and
K4 (the JAX router sends the GLM to XLA by its TPU VMEM model, which the
port does not carry); a density the compiler refuses routes eagerly,
naming the op, and raises on the card with the same reason; a traced
density runs the plain K3 and K4 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binf_tpu.model as jmodel
import binf_tpu.pdf as jpdf
import binf_tpu.pdf.priors as jpriors
import binf_tpu.pdf.transforms as jtransforms
import binf_tpu_torch.model as tmodel
import binf_tpu_torch.pdf as tpdf
import binf_tpu_torch.pdf.priors as tpriors
import binf_tpu_torch.pdf.transforms as ttransforms
from binf_tpu_torch.ops.kernels import density_compiler as dc
from binf_tpu_torch.ops.kernels import densities
from binf_tpu_torch.samplers import auto

P = 16
RTOL = 1e-4

JAX = dict(model=jmodel, pdf=jpdf, priors=jpriors, tr=jtransforms,
           arr=lambda x: jnp.asarray(x, jnp.float32))
TORCH = dict(model=tmodel, pdf=tpdf, priors=tpriors, tr=ttransforms,
             arr=lambda x: torch.as_tensor(np.asarray(x, np.float32)))


def _data():
    rng = np.random.default_rng(7)
    xs = np.linspace(-2.0, 2.0, 20).astype(np.float32)
    ys = (2.0 - 4.0 * xs + xs ** 2 + 1.5 * xs ** 3 + rng.standard_t(4, 20) / 1.6).astype(
        np.float32)
    X = np.concatenate([np.ones((40, 1)), rng.standard_normal((40, 2))], 1).astype(np.float32)
    w = np.array([0.4, 0.3, -0.5], np.float32)
    return dict(
        xs=xs, ys=ys, X=X,
        y_lap=(X[:30] @ w + rng.laplace(size=30) * 0.5).astype(np.float32),
        counts=rng.poisson(np.exp(X @ w)).astype(np.float32),
        labels=(rng.random(40) < 1 / (1 + np.exp(-X @ w))).astype(np.float32),
        Xpos=np.abs(rng.standard_normal((30, 2))).astype(np.float32) + 0.5,
        ypos=np.exp(rng.standard_normal(30) * 0.3 + 1.0).astype(np.float32),
        y_gauss=(X[:30] @ w + rng.standard_normal(30) * 0.7).astype(np.float32))


DATA = _data()


def _gauss(pk, var, d, v=5.0, m=0.0):
    return pk["priors"].GaussianPrior.create(pk["arr"](np.full(d, m)), pk["arr"](np.full(d, v)),
                                             variable=var)


def build(pk, name):
    """``(log density, template shapes)`` of the named model in one package
    (``pk`` is JAX or TORCH)."""
    a, M, pdf, pr, tr, D = pk["arr"], pk["model"], pk["pdf"], pk["priors"], pk["tr"], DATA

    def post(lik, priors, transforms=None):
        p = pdf.Posterior.create({"lik": lik}, priors)
        return p.log_prob if transforms is None else tr.transform_logdensity(p.log_prob,
                                                                             transforms)

    def linear(X, var="w"):
        return M.LinearForwardModel(design=a(X), variable=var)

    if name == "student_t":  # with a half-normal prior on its scale
        lik = pdf.Likelihood.create("lik", M.PolynomialForwardModel.create(a(D["xs"]), 4),
                                    M.StudentTErrorModel.create(a(D["ys"]), df=4.0))
        return post(lik, {"c": _gauss(pk, "coefficients", 4),
                          "s": pr.HalfNormalPrior.create(a(1.0), variable="scale")},
                    {"scale": tr.LogTransform}), {"coefficients": (4,), "scale": ()}
    if name == "laplace":  # with an exponential prior on its scale
        lik = pdf.Likelihood.create("lik", linear(D["X"][:30]),
                                    M.LaplaceErrorModel.create(a(D["y_lap"])))
        return post(lik, {"w": _gauss(pk, "w", 3),
                          "s": pr.ExponentialPrior.create(a(1.0), variable="scale")},
                    {"scale": tr.LogTransform}), {"scale": (), "w": (3,)}
    if name == "poisson":
        lik = pdf.Likelihood.create("lik", linear(D["X"]),
                                    M.PoissonErrorModel.create(a(D["counts"]), log_link=True))
        return post(lik, {"w": _gauss(pk, "w", 3, 4.0)}), {"w": (3,)}
    if name == "bernoulli":
        lik = pdf.Likelihood.create("lik", linear(D["X"]),
                                    M.BernoulliErrorModel.create(a(D["labels"])))
        return post(lik, {"w": _gauss(pk, "w", 3, 4.0)}), {"w": (3,)}
    if name == "lognormal":  # with a Gamma prior on its precision
        lik = pdf.Likelihood.create("lik", linear(D["Xpos"]),
                                    M.LogNormalErrorModel.create(a(D["ypos"])))
        return post(lik, {"w": _gauss(pk, "w", 2, 1.0, 1.0),
                          "p": pr.GammaPrior.create(a(2.0), a(0.5), variable="precision")},
                    {"precision": tr.LogTransform}), {"precision": (), "w": (2,)}
    if name == "gamma":  # the Gaussian regression with its Gamma precision
        lik = pdf.Likelihood.create("lik", linear(D["X"][:30]),
                                    M.GaussianErrorModel.create(a(D["y_gauss"])))
        return post(lik, {"w": _gauss(pk, "w", 3),
                          "p": pr.GammaPrior.create(a(1.0), a(0.2), variable="precision")},
                    {"precision": tr.LogTransform}), {"precision": (), "w": (3,)}
    if name == "sigmoid_uniform":  # a uniform prior on the precision, pulled back
        lik = pdf.Likelihood.create("lik", linear(D["X"][:30]),
                                    M.GaussianErrorModel.create(a(D["y_gauss"])))
        return post(lik, {"w": _gauss(pk, "w", 3),
                          "p": pr.UniformPrior.create(a(0.5), a(5.0), variable="precision")},
                    {"precision": tr.SigmoidTransform(0.5, 5.0)}), {"precision": (), "w": (3,)}
    raise KeyError(name)


MODELS = ["student_t", "laplace", "poisson", "bernoulli", "lognormal", "gamma",
          "sigmoid_uniform"]


def _flat_jax(fn, shapes):
    def f(q):
        pos, at = {}, 0
        for k in sorted(shapes):
            size = int(np.prod(shapes[k]))
            pos[k] = q[at:at + size].reshape(shapes[k])
            at += size
        return fn(pos)
    return f


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    compiled = {}
    for name in MODELS:
        fn, shapes = build(TORCH, name)
        compiled[name] = dc.compile_density(fn, {k: torch.zeros(s) for k, s in shapes.items()})
    return compiled, dc.build_host_library(list(compiled.values()),
                                           tmp_path_factory.mktemp("traced_models"))


@pytest.mark.parametrize("name", MODELS)
def test_dsl_model_matches_jax(built, name):
    compiled, lib = built
    fn, shapes = build(JAX, name)
    cd = compiled[name]
    q = (0.5 * np.random.default_rng(40 + MODELS.index(name)).standard_normal((P, cd.D))
         ).astype(np.float32)
    U, g = dc.host_eval(lib, cd, q)
    f_ref, g_ref = jax.vmap(jax.value_and_grad(_flat_jax(fn, shapes)))(jnp.asarray(q))
    U_ref, G_ref = -np.asarray(f_ref), -np.asarray(g_ref)
    assert np.isfinite(U).all() and np.isfinite(g).all()
    assert np.abs(U - U_ref).max() <= RTOL * np.abs(U_ref).max()
    assert np.abs(g - G_ref).max() <= RTOL * np.abs(G_ref).max()


def _poisson_glm(pk):
    """The traced path's Poisson GLM (chip_smoke.py::traced_problems): a
    200 x 5 standardised design, counts at weights (0.5, 0.3, -0.2, 0.1,
    0.2), N(0, 4 I) on the weights."""
    rng = np.random.default_rng(80)
    X = np.concatenate([np.ones((200, 1)), rng.standard_normal((200, 4))], 1)
    y = rng.poisson(np.exp(X @ np.array([0.5, 0.3, -0.2, 0.1, 0.2]))).astype(np.float32)
    lik = pk["pdf"].Likelihood.create(
        "counts", pk["model"].LinearForwardModel(design=pk["arr"](X), variable="weights"),
        pk["model"].PoissonErrorModel.create(pk["arr"](y), log_link=True))
    return pk["pdf"].Posterior.create({"counts": lik},
                                      {"w": _gauss(pk, "weights", 5, 4.0)}).log_prob


def _gaussian6(pk):
    """The router's 6-D Gaussian of correlation 0.95 as a plain callable."""
    rng = np.random.default_rng(0)
    scales = np.exp(np.linspace(-1.0, 1.5, 6))
    S = np.diag(scales) @ (np.full((6, 6), 0.95) + 0.05 * np.eye(6)) @ np.diag(scales)
    mu, Pm = pk["arr"](rng.normal(size=6)), pk["arr"](np.linalg.inv(S))

    def gaussian(pos):
        x = pos["x"] - mu
        return -0.5 * x @ (Pm @ x)

    return gaussian


ROUTED = {
    "robust_regression": (lambda pk: build(pk, "student_t")[0], {"coefficients": (4,),
                                                                  "scale": ()}),
    "poisson_glm": (_poisson_glm, {"weights": (5,)}),
    "gaussian6": (_gaussian6, {"x": (6,)}),
}


@pytest.mark.parametrize("name", list(ROUTED))
def test_router_matches_the_jax_router(name):
    """At 1,024 chains the JAX router finds each tile-compilable (its rule
    1) and sends the robust regression and the 6-D Gaussian to its fused
    kernels (its 2,048-chain rule); the port's router sends all three to K3
    and K4 through the compiled functor.  The one difference is the
    Poisson GLM: the JAX router calls its 1,200 floats of data too many for
    a TPU's VMEM (``_data_heavy``, a TPU cost model the port does not
    carry, ROADMAP "Not ported") and sends it to XLA; the port routes on
    its own kernels' limit, 12,288 floats of shared memory, which its 1,615
    operand floats pass."""
    from binf_tpu.samplers.auto import route_algorithm as jax_route

    make, shapes = ROUTED[name]
    start = {k: np.full((1024,) + s, 0.1, np.float32) for k, s in shapes.items()}
    j = jax_route(make(JAX), {k: jnp.asarray(v) for k, v in start.items()})
    t = auto.route_algorithm(make(TORCH), {k: torch.tensor(v) for k, v in start.items()})
    assert t.path == "fused", t.reason
    if name == "poisson_glm":
        assert j.path == "xla" and j.reason.startswith("data-heavy"), j.reason
    else:
        assert j.path == "fused" and not j.reason.startswith("not tile-compilable"), j.reason
    assert t.reason.startswith("device density: TracedDensity") and "Traced_" in t.reason
    assert (t.d, t.n_local_chains, t.block_chains) == (j.d, 1024, 1024)


def _refused(pos):
    x = pos["x"].reshape(2, 2)
    return -torch.linalg.eigvalsh(x @ x.T + torch.eye(2)).sum()


def test_refused_density_routes_eagerly_and_raises_on_the_card(monkeypatch):
    """``linalg.eigvalsh`` has no lowering rule (JAX ``tests/test_auto.py``
    routes it to XLA): the router sends it to the eager path with a reason
    that begins ``not tile-compilable:`` and names the op; the NUTS rule
    weighs it as a density with no functor; on the card
    ``fused_model_hmc`` raises that reason before anything runs."""
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    start = {"x": torch.full((32, 4), 0.1)}
    d = auto.route_algorithm(_refused, start)
    assert d.path == "xla" and d.reason.startswith("not tile-compilable:")
    assert "aten._linalg_eigh" in d.reason and d.block_chains is None
    sampler, why = auto.route_trajectory_sampler("nuts", _refused, start)
    assert sampler == "hmc" and "not tile-compilable" in why
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(dc.UnsupportedOpError, match="not tile-compilable: .*aten._linalg_eigh"):
        fused_model_hmc(_refused, start, 0, warmup="fused")


def test_traced_density_as_a_device_density():
    """``device_density`` compiles what no family takes: a TracedDensity
    whose source names its functor, traced afresh at every call (data
    changed in place reach the next density's operands, under the same key
    and so the same built units), which K3 and K4 take at one lane; on the
    CPU its plain version is torch.func on the callable, and the plain K3
    and K4 sample the Gaussian's moments."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    fn = _gaussian6(TORCH)
    template = {"x": torch.zeros(6)}
    dens = densities.device_density(fn, template)
    assert isinstance(dens, densities.TracedDensity) and densities.is_device_density(dens)
    assert f"struct {dens.compiled.name}" in dens.source and dens.D == 6
    y = torch.zeros(6)
    shifted = densities.device_density(lambda p: -0.5 * torch.sum((p["x"] - y) ** 2), template)
    y += 1.5
    again = densities.device_density(lambda p: -0.5 * torch.sum((p["x"] - y) ** 2), template)
    assert again.key == shifted.key and not torch.equal(again.operands, shifted.operands)
    assert float(again.potential_and_grad(y[None])[0]) == 0.0
    assert fp.kernel_refusal(dens) is None and fp.lanes_for(dens) == 1
    assert dens.shared_floats() == dens.cuda_operands()[1] == dens.operands.numel()
    q = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
    U, g = densities.density_eval(dens, q, device="cpu")
    U2, g2 = densities.CallableDensity(fn, template).potential_and_grad(q)
    torch.testing.assert_close((U, g), (U2, g2))
    res = fused_model_hmc(dens, {"x": 0.5 * torch.randn(
        (64, 6), generator=torch.Generator().manual_seed(1))}, 3, num_warmup=150,
        num_samples=150, warmup="fused", device="cpu")
    x = res.samples["x"][50:].reshape(-1, 6).double()
    rng = np.random.default_rng(0)
    scales = np.exp(np.linspace(-1.0, 1.5, 6))
    mu = rng.normal(size=6)
    np.testing.assert_allclose(x.mean(0).numpy(), mu, atol=0.35 * scales.max())
    np.testing.assert_allclose(x.std(0).numpy(), scales, rtol=0.35)


def test_kernel_refusal_of_a_traced_density():
    """K3 and K4 refuse a traced density past their shared memory, with
    the reason (the compiler itself refuses D = MAX_D_WIDE + 1, past the
    wide form's 4,096, test_torch_density_compiler.py)."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp

    y = torch.arange(13000.0)
    dens = densities.device_density(
        lambda p: -0.5 * torch.sum((y - p["m"]) ** 2), {"m": torch.zeros(())})
    why = fp.kernel_refusal(dens)
    assert why is not None and "shared memory" in why
    d = auto.route_algorithm(lambda p: -0.5 * torch.sum((y - p["m"]) ** 2),
                             {"m": torch.zeros(8)})
    assert d.path == "xla" and "shared memory" in d.reason


def test_a_trace_failure_that_is_no_refusal_raises():
    """Only the compiler's refusals route eagerly: a density whose trace
    fails for another reason (here a shape mismatch of its own) raises from
    the router and from ``device_density``; a data-dependent shape (a
    boolean mask) is a refusal, named."""
    w = torch.ones(5)
    start = {"x": torch.zeros((8, 3))}

    def mismatched(p):
        return -(p["x"] @ w)

    for call in (lambda: auto.route_algorithm(mismatched, start),
                 lambda: densities.device_density(mismatched, {"x": torch.zeros(3)})):
        with pytest.raises(RuntimeError) as e:
            call()
        assert not isinstance(e.value, NotImplementedError), e.value
    d = auto.route_algorithm(lambda p: -torch.sum(p["x"][p["x"] > 0] ** 2), start)
    assert d.path == "xla" and d.reason.startswith("not tile-compilable: data-dependent")
