"""Traced densities past 32 coordinates, the wide form (``density_compiler``'s
``TracedWide_<key>``, run by K3's and K4's wide branches and K7), against
the JAX package, on the CPU.

The hierarchical posterior of 32 groups (D = 69; the JAX package's
synthetic data as numpy arrays, under ``{"precision": LogTransform}``)
is compiled by the density compiler (no hand-written functor takes 32
groups).  Checked:

- its plain version (``torch.func`` on the callable) and the wide form
  built with ``g++`` through ``csrc/host_compat.h``, on one host thread
  and on groups of 1, 8 and 32 host threads meeting at a barrier, against
  the JAX package's ``tile_potential_from_scalar`` value and gradient at
  16 seeded points, within 1e-5 of the largest |U| and |grad U|;
- the plain K4 and K3 at D = 69 against the JAX package's interpret-mode
  kernels on the same host noise (8 chains, d_pad 72), at the tolerances
  of ``test_torch_hierarchical_density.py`` on a seed whose decisions all
  lie past 5e-5 of their thresholds (asserted);
- both routers at 1,024 chains choose the fused kernels; at 8,192 the JAX
  router sends the model to XLA by its TPU rule 4 and the port's keeps it
  fused (the documented difference);
- the wide branch's shared memory (``fused_potential.kernel_refusal``):
  its operands, the Halton table and its chains' buffers and partials, no
  2 D^2 of dense metric, at D = 256 by its emitted text and key only; a
  wide density whose constants alone pass the kernels' 12,288 floats is
  refused with its reason (one whose constants fit only without its
  chains' buffers is taken: they come on top, within the block's 227 KB),
  and D = MAX_D_WIDE + 1 by the compiler;
- ``cummax`` and ``cummin`` (values, indices and their scatter-add
  backward) in the one-lane, group and wide forms against JAX's
  ``lax.cummax``/``lax.cummin`` through ``tile_potential_from_scalar``;
- a density that calls a ``torch.autograd.Function`` (the CLI's chromatin
  model, D = 193) refused by name and routed eagerly;
- at D <= 32 the one-lane keys and whole headers of
  ``tests/test_torch_traced_models.py``'s models and of a log-sum-exp over
  data rows, as the compiler emitted them before the wide form.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import hierarchical as jh
from binf_tpu.ops.pallas.fused_potential import _pad_const, tile_potential_from_scalar
from binf_tpu.ops.pallas.fused_potential import fused_potential_hmc_run as jax_run
from binf_tpu.ops.pallas.fused_potential import fused_warmup_run as jax_warmup
from binf_tpu.pdf.transforms import LogTransform as JaxLog
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers import auto as jax_auto
from binf_tpu_torch.example import hierarchical
from binf_tpu_torch.ops.kernels import density_compiler as dc
from binf_tpu_torch.ops.kernels import fused_potential as fp
from binf_tpu_torch.ops.kernels.densities import TracedDensity, device_density
from binf_tpu_torch.ops.kernels.fused_potential import (fused_potential_hmc_plain,
                                                        fused_warmup_plain, pack_template)
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import auto

NG, D = 32, 69
SHAPES = {"group_params": (NG, 2), "log_tau": (2,), "mu": (2,), "precision": ()}
P = 16  # seeded points
TOL = 1e-5  # of the largest |U| and |grad U|
C = 8  # chains of the interpret-mode comparisons: one tile
f32 = np.float32


def _template(shapes=SHAPES):
    return {k: torch.zeros(s) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def problem():
    """(JAX log density, port log density, the port's TracedDensity)."""
    x, y, c, _ = jh.synthetic_hierarchical_data(jax.random.key(0), NG)
    data = tuple(np.array(a, f32) for a in (x, y, c))
    jfn = jax_transform(jh.make_hierarchical_posterior(x, y, c, NG).log_prob,
                        {"precision": JaxLog})
    tfn = transform_logdensity(
        hierarchical.make_hierarchical_posterior(*data, NG, device="cpu").log_prob,
        {"precision": LogTransform})
    return jfn, tfn, device_density(tfn, _template())


@pytest.fixture(scope="module")
def host(problem, tmp_path_factory):
    """The host library of the wide form and of the cummax/cummin cases."""
    compiled = [problem[2].compiled] + [cd for cd, *_ in _cum_cases().values()]
    return dc.build_host_library(compiled, tmp_path_factory.mktemp("wide"))


def _points(seed, n=P):
    """Points near the posterior's bulk (as test_torch_hierarchical_density.py's)."""
    rng = np.random.default_rng(seed)
    centre = np.concatenate([np.tile([0.8, 1.2], NG), [-1.3, -1.3, 0.8, 1.2, 3.2]])
    return (centre + 0.3 * rng.normal(size=(n, D))).astype(f32)


def _jax_tile(jfn, shapes=SHAPES):
    return tile_potential_from_scalar(jfn, {k: jnp.zeros(s) for k, s in shapes.items()})


def _tile_value_and_grad(jfn, q, shapes=SHAPES):
    """The JAX package's lane-interpreter U and grad U at points q (n, D),
    as its kernels take them: ``tile_value_and_grad``, or where the
    backward graph has a primitive with no lane rule (cummax's) the vjp of
    the lane-level forward."""
    potential, consts, _ = _jax_tile(jfn, shapes)
    padded = {k: _pad_const(v) for k, v in consts.items()}
    d = q.shape[1]
    tile = np.zeros(((d + 7) // 8 * 8, q.shape[0]), f32)
    tile[:d] = q.T
    tile = jnp.asarray(tile)
    if potential.tile_value_and_grad is not None:
        U, G = potential.tile_value_and_grad(tile, padded)
    else:
        U, vjp = jax.vjp(lambda t: potential(t, padded), tile)
        (G,) = vjp(jnp.ones_like(U))
    return np.asarray(U)[0], np.asarray(G)[:d].T


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_wide_form_compiles(problem):
    """D = 69 compiles to the wide form: the base functor and
    ``TracedWide_<key>``, no one-lane entry, the position read from the
    group's shared buffer, the gradient one loop strided over the group."""
    density = problem[2]
    assert isinstance(density, TracedDensity) and density.D == D and density.wide
    cd = density.compiled
    assert cd.group_name == f"TracedWide_{cd.key}" and cd.kernel_name == cd.group_name
    assert "kWide = true" in cd.group_source and "float q[" not in cd.header
    assert f"for (int" in cd.group_source and "gs[i" in cd.group_source
    assert "value_and_grad(const float (&q)" not in cd.header
    assert fp.lanes_for(density) == fp.WIDE_LANES == 32 and fp.wide_warps(D) == 1
    assert fp.kernel_refusal(density) is None


def test_plain_matches_jax(problem):
    """The plain version (torch.func on the port's callable) against the
    JAX package's tile value and gradient."""
    jfn, _, density = problem
    q = _points(1)
    U, g = density.potential_and_grad(torch.tensor(q))
    U_j, g_j = _tile_value_and_grad(jfn, q)
    _close(U.numpy(), U_j)
    _close(g.numpy(), g_j)


@pytest.mark.parametrize("threads", [None, 1, 8, 32])
def test_wide_form_on_host_threads_matches_jax_and_torch_func(problem, host, threads):
    """The wide form built with g++, on one host thread (``threads`` None:
    the library's one-point entry) or a group of 1, 8 or 32 threads at a
    barrier (every thread's U the same bits), against torch.func and the
    JAX package's tile value and gradient."""
    jfn, _, density = problem
    q = _points(2)
    U, g = dc.host_eval(host, density.compiled, q, threads=threads)
    U_f, g_f = density.potential_and_grad(torch.tensor(q))
    _close(U, U_f.numpy())
    _close(g, g_f.numpy())
    U_j, g_j = _tile_value_and_grad(jfn, q)
    _close(U, U_j)
    _close(g, g_j)


def _noise(seed, steps):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    d_pad = (D + 7) // 8 * 8
    return (np.asarray(jax.random.normal(k1, (steps, d_pad, C), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32)))


K4_SEED, K4_STEPS, K4_EPS = 1, 10, 0.02


def test_plain_k4_matches_jax_interpret(problem):
    """Ten K4 steps at L = 10 on host noise: acceptance to 1e-6, draws to
    2e-4, no decision within 5e-5 of its threshold."""
    jfn, _, density = problem
    potential, consts, _ = _jax_tile(jfn)
    q0 = _points(4, C)
    eps = np.full(C, K4_EPS, f32)
    im = np.ones((C, D), f32)
    jr = jax_run(potential, jnp.asarray(q0), K4_SEED, jnp.asarray(eps), jnp.asarray(im), consts,
                 num_steps=K4_STEPS, block_chains=C, steps_per_block=K4_STEPS,
                 interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in _noise(K4_SEED, K4_STEPS))
    trace = fused_potential_hmc_plain(density, torch.tensor(q0), K4_SEED, torch.tensor(eps),
                                      torch.tensor(im), num_steps=K4_STEPS, block_chains=C,
                                      noise=noise)
    assert float(trace.margin.abs().min()) > 5e-5
    got = trace.result
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    assert 0.0 < float(got.accept_rate) < 1.0
    np.testing.assert_allclose(got.draws.numpy(), np.asarray(jr.draws), atol=2e-4)


K3_SEED, K3_STEPS, K3_EPS = 0, 6, 0.02


def test_plain_k3_matches_jax_interpret(problem):
    """Six warmup steps (the window fold and the harvest at the last
    boundary run): positions to 2e-4, the step size to 1e-4 relative, the
    metric to 1e-3."""
    jfn, _, density = problem
    potential, consts, _ = _jax_tile(jfn)
    q0 = _points(5, C)
    jq, jeps, jim = jax_warmup(potential, jnp.asarray(q0), K3_SEED, K3_EPS, consts,
                               num_warmup=K3_STEPS, num_leapfrog=10, block_chains=C,
                               interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in _noise(K3_SEED, K3_STEPS))
    margins = []
    tq, teps, tim = fused_warmup_plain(density, torch.tensor(q0), K3_SEED, K3_EPS,
                                       num_warmup=K3_STEPS, num_leapfrog=10, block_chains=C,
                                       target_accept=0.8, init_search=False, noise=noise,
                                       margins=margins)
    assert float(torch.stack(margins).abs().min()) > 5e-5
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-4)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("trajectory", ["fixed", "chees"])
def test_plain_k3_resumes_from_its_state(problem, trajectory):
    """What the card's step-by-step K3 check rests on: the plain K3 over 20
    steps (two tiles of 4 chains) in two legs, the second from the first's
    WarmupTiles, ends bit for bit where the whole run ends; taking its own
    ChEES counts as ``follow_counts`` changes nothing; ``flip`` takes a
    decision the other way."""
    _, _, density = problem
    q0 = torch.tensor(_points(6, C))
    kw = dict(num_warmup=20, num_leapfrog=10, block_chains=C // 2, init_search=False,
              target_accept=0.8)
    if trajectory == "chees":
        kw.update(trajectory="chees", max_leapfrog=16, target_accept=0.651)
    counts = torch.zeros((20, 2), dtype=torch.int32)
    whole = fused_warmup_plain(density, q0, 3, K3_EPS, leapfrog_counts=counts, **kw)
    half = fused_warmup_plain(density, q0, 3, K3_EPS, steps=(0, 11), **kw)
    end = fused_warmup_plain(density, q0, 3, K3_EPS, state=half, steps=(11, 20), **kw)
    assert isinstance(end, fp.WarmupTiles) and end.q.shape == (2, C // 2, D)
    assert torch.equal(end.q.reshape(C, D), whole[0])
    eps = torch.exp(end.log_step_avg).expand(2, C // 2).reshape(C)
    assert torch.equal(eps, whole[1])
    assert torch.equal(end.im[:, None].expand(2, C // 2, D).reshape(C, D), whole[2])
    follow = fused_warmup_plain(density, q0, 3, K3_EPS, follow_counts=counts, **kw)
    assert all(torch.equal(a, b) for a, b in zip(follow, whole))
    flip = torch.zeros((20, C), dtype=torch.bool)
    flip[4, 1] = True
    flipped = fused_warmup_plain(density, q0, 3, K3_EPS, flip=flip, **kw)
    assert not torch.equal(flipped[0][1], whole[0][1])


@pytest.mark.parametrize("chains, jax_path", [(1024, "fused"), (8192, "xla")])
def test_routers_on_the_32_group_posterior(problem, chains, jax_path):
    """At 1,024 chains both routers send the model to the fused kernels
    (the JAX router: "small/medium chain batch"); at 8,192 the JAX router
    sends it to XLA by its TPU rule 4 (d_pad 72 > 8), which the port does
    not carry: it stays fused, naming the traced density at D = 69."""
    jfn, tfn, _ = problem
    jd = jax_auto.route_algorithm(jfn, {k: jnp.zeros((chains,) + s) for k, s in SHAPES.items()})
    td = auto.route_algorithm(tfn, {k: torch.zeros((chains,) + s) for k, s in SHAPES.items()})
    assert jd.path == jax_path, jd
    assert td.path == "fused" and "TracedDensity" in td.reason and td.d == D, td


def _gaussian256():
    mean = torch.randn(256, generator=torch.Generator().manual_seed(0))
    scale = torch.logspace(-1, 1, 256)

    def ld(p):
        return -0.5 * torch.sum(((p["x"] - mean) / scale) ** 2)

    return ld


# the wide form of _gaussian256 as the compiler emits it (the hash of its
# text, which names neither the data nor the build)
GAUSS256_KEY = "9456011560460c55"


def test_wide_branch_shared_memory_at_256():
    """At D = 256 (a warp a chain) the wide branch stages the operands, K4
    the Halton table, and three buffers of D floats and the group's 8
    partials for each of a CTA's chains (K3's 8, K4's 4): no 2 D^2 of
    dense metric, which alone would pass the 12,288 floats.  The emitted
    text: a key of its own, the strided gradient, no one-lane entry and no
    per-thread copy of the position."""
    density = device_density(_gaussian256(), {"x": torch.zeros(256)})
    cd = density.compiled
    assert density.wide and cd.key == GAUSS256_KEY and cd.D == 256
    assert cd.group_rows == 256 and cd.lines < 200 and "float q[" not in cd.header
    assert fp.lanes_for(density) == 32
    nf = (density.shared_floats() + 3) // 4 * 4
    assert fp._shared_need(density, "K3") == nf + 8 * (3 * 256 + 8)
    assert fp._shared_need(density, "K4") == nf + 256 + 4 * (3 * 256 + 8)
    assert 2 * 256 ** 2 > fp._SMEM_FLOATS
    assert fp.kernel_refusal(density) is None


def test_wide_density_past_shared_memory_is_refused():
    """A wide density whose constants pass the kernels' 12,288 floats of
    shared memory alone (12,300 operand floats) is refused with its reason
    (the router sends it eagerly; the wrappers raise it).  One whose
    constants fit only without its chains' buffers (11,500: K3's 11,500 +
    8 x 128 passed 12,288 while the buffers counted against it) is taken:
    the buffers come on top, within the block's 227 KB."""
    def density_of(n):
        y = torch.arange(float(n))

        def ld(p):
            return -0.5 * torch.sum((y[:, None] - p["m"]) ** 2) / 1e9

        return ld, device_density(ld, {"m": torch.zeros(40)})

    _, taken = density_of(11500)
    assert taken.wide and taken.shared_floats() == 11500
    assert fp._shared_need(taken, "K3") == 11500 + 8 * (3 * 40 + 8) > fp._SMEM_FLOATS
    assert fp.kernel_refusal(taken) is None
    ld, density = density_of(12300)
    assert density.wide and density.shared_floats() == 12300
    why = fp.kernel_refusal(density)
    assert why is not None and "K3 needs 12300 floats" in why and "operands" in why, why
    assert fp.kernel_refusal(density, ("K4",)) is not None
    with pytest.raises(ValueError, match="shared memory"):
        fp.refuse(density, ("K3",))
    dec = auto.route_algorithm(ld, {"m": torch.zeros((64, 40))})
    assert dec.path == "xla" and "shared memory" in dec.reason


def test_refusal_past_the_cap():
    with pytest.raises(dc.UnsupportedOpError, match=f"at most {dc.MAX_D_WIDE}"):
        dc.compile_density(lambda p: -0.5 * torch.sum(p["x"] ** 2),
                           {"x": torch.zeros(dc.MAX_D_WIDE + 1)})


# -- cummax and cummin ----------------------------------------------------------------

def _jax_cum(q):
    a = jax.lax.cummax(q * 1.5 - 0.2, axis=0)
    b = jax.lax.cummin(jnp.sin(q), axis=0)
    return -jnp.sum(a * jnp.arange(q.shape[0], dtype=jnp.float32) / q.shape[0]) \
        + jnp.sum(b ** 2) - 0.1 * jnp.sum(q ** 2)


def _torch_cum(q):
    a = torch.cummax(q * 1.5 - 0.2, 0).values
    b = torch.cummin(torch.sin(q), 0).values
    return -torch.sum(a * torch.arange(q.shape[0], dtype=torch.float32) / q.shape[0]) \
        + torch.sum(b ** 2) - 0.1 * torch.sum(q ** 2)


def _jax_cum2(q):
    x = q.reshape(6, 8)
    return -jnp.sum(jax.lax.cummax(x, axis=1) ** 2) + jnp.sum(jax.lax.cummin(x, axis=0))


def _torch_cum2(q):
    x = q.reshape(6, 8)
    return -torch.sum(torch.cummax(x, 1).values ** 2) + torch.sum(torch.cummin(x, 0).values)


def _cum_cases():
    """name -> (compiled, JAX log density of q, D, threads): scans of up to
    32 elements in scalars (one lane, 12; the group form, 20, at 4 host
    threads) and in arrays (the wide form: 40 coordinates at 8 threads, and
    a (6, 8) scan along each axis at 48)."""
    out = {}
    for name, D, jfn, tfn, threads in (("one_lane", 12, _jax_cum, _torch_cum, None),
                                        ("group", 20, _jax_cum, _torch_cum, 4),
                                        ("wide", 40, _jax_cum, _torch_cum, 8),
                                        ("wide_2d", 48, _jax_cum2, _torch_cum2, 8)):
        cd = dc.compile_density(lambda p, f=tfn: f(p["q"]), {"q": torch.zeros(D)})
        out[name] = (cd, jfn, D, threads)
    return out


@pytest.mark.parametrize("name", ["one_lane", "group", "wide", "wide_2d"])
def test_cummax_cummin_match_jax(host, name):
    """cummax and cummin (values, and through their indices the
    scatter-add backward) against lax.cummax / lax.cummin through the JAX
    package's tile_potential_from_scalar, value and gradient, within 1e-5
    of the largest |entry|; seeded points have no ties."""
    cd, jfn, D, threads = _cum_cases()[name]
    assert cd.wide == (D > dc.MAX_D)
    q = np.random.default_rng(D).standard_normal((P, D)).astype(f32)
    U, g = dc.host_eval(host, cd, q, threads=threads)
    U_j, g_j = _tile_value_and_grad(lambda p: jfn(p["q"]), q, {"q": (D,)})
    _close(U, U_j)
    _close(g, g_j)


# -- nothing moves at D <= 32 ------------------------------------------------------------

# the key and the sha256 of the whole header (one-lane and group texts) of
# tests/test_torch_traced_models.py's models and of the log-sum-exp over data
# rows of tests/test_torch_chain_grid_traced.py, as the compiler emitted them
# before the wide form
HEADERS = {"bernoulli": ("f7c38d2e50415e15", "4ca065985d7fcd69"),
           "gamma": ("efcbaa16739cd1ad", "be96e10dab739d00"),
           "laplace": ("78b923e3e64ba270", "adcf97fe8cf53786"),
           "lognormal": ("3abafb8f582da64a", "accd71a071e09818"),
           "poisson": ("f45973f271ec1bef", "7e89f696f497c528"),
           "sigmoid_uniform": ("7b7c2377912d08f1", "f8d8bef732b6098a"),
           "student_t": ("d60d9f760d5e8677", "8f4eeb2c8b804b5d"),
           "lse_rows": ("88bbbe1524777efd", "17d85a4aa210861f")}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_texts_at_32_or_fewer_coordinates_are_unchanged(name):
    """At D <= 32 the compiler emits byte for byte what it did before the
    wide form: the one-lane key (tests/test_torch_chain_grid_traced.py's)
    and the whole header."""
    import test_torch_chain_grid_traced as cgt
    import test_torch_traced_models as traced_models

    if name == "lse_rows":
        cd = dc.compile_density(cgt._torch_lse_rows, {"w": torch.zeros(3)})
    else:
        fn, shapes = traced_models.build(traced_models.TORCH, name)
        cd = dc.compile_density(fn, {k: torch.zeros(s) for k, s in shapes.items()})
        assert cd.key == cgt.ONE_LANE_KEYS[name]
    assert not cd.wide and cd.kernel_name == cd.name == f"Traced_{cd.key}"
    assert (cd.key, hashlib.sha256(cd.header.encode()).hexdigest()[:16]) == HEADERS[name]


def test_autograd_function_past_32_coordinates_routes_eagerly():
    """A density that calls a torch.autograd.Function (the CLI's chromatin
    model, D = 193: its restraints' pairwise kernel has its own backward)
    reaches the trace now that 193 coordinates are in scope; the compiler
    refuses it by name, so the router sends it to the eager path as before
    and the fused route raises."""
    from binf_tpu_torch import cli
    from binf_tpu_torch.pdf.transforms import unconstrain

    model = cli.build_model("chromatin", torch.Generator().manual_seed(0), device="cpu")
    start = unconstrain(model.transforms, model.init_fn(8, generator=torch.Generator().manual_seed(1)))
    ld = cli._logdensity(model)
    dec = auto.route_algorithm(ld, start)
    assert dec.path == "xla" and dec.d == 193, dec
    assert dec.reason.startswith("not tile-compilable: no lowering rule for a "
                                 "torch.autograd.Function"), dec.reason
    with pytest.raises(NotImplementedError, match="autograd.Function"):
        device_density(ld, {k: v[0] for k, v in start.items()})
