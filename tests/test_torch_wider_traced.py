"""Traced densities past 256 coordinates: the wide form at a group of W warps
a chain (``fused_potential.wide_warps``: 2 at D = 261, 4 at 1,024, 8 up to
``density_compiler.MAX_D_WIDE``), against the JAX package, on the CPU.

Two models, the slice's: the hierarchical posterior of 128 groups (D = 261;
the JAX package's synthetic data at key 0 as numpy arrays, under
``{"precision": LogTransform}``) and a 1,024-D Gaussian (means N(0, 1)
from numpy seed 0, scales log-spaced 0.1 to 10).  Checked:

- the wide form built with ``g++`` through ``csrc/host_compat.h``, on
  groups of 32, 64 and 256 host threads meeting at a barrier (a warp and
  the groups of 2 and 8 warps; every thread's U the same bits), against
  the JAX package's ``tile_potential_from_scalar`` value and gradient and
  against ``torch.func``, within 1e-5 of the largest |U| and |grad U|;
- the plain K4 and K3 at D = 261 against the JAX package's interpret-mode
  kernels on the same host noise (8 chains, d_pad 264), at
  ``test_torch_wide_traced.py``'s tolerances, on a seed whose decisions
  all lie past 5e-5 of their thresholds (asserted);
- both routers at 128 chains send both models to the fused kernels; at
  512 chains the JAX router sends the hierarchical posterior to XLA by its
  VMEM model (``_data_heavy``) and the port keeps it fused (the documented
  difference: the port's kernels keep a chain's state in shared memory);
- ``kernel_refusal``'s count at D = 261, 1,024 and MAX_D_WIDE, by emitted
  text and key only: the operands within the kernels' 12,288 floats, the
  chains' buffers and partials on top, within the block's 227 KB;
- the refusal at MAX_D_WIDE + 1, by name, in the compiler, the device
  density and the router.
"""

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
from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_plain, fused_warmup_plain
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import auto

NG, DH = 128, 261
DG = 1024
SHAPES = {"group_params": (NG, 2), "log_tau": (2,), "mu": (2,), "precision": ()}
P = 8  # seeded points
TOL = 1e-5  # of the largest |U| and |grad U|
C = 8  # chains of the interpret-mode comparisons: one tile
f32 = np.float32
# the keys of the two models' wide forms as the compiler emits them (the
# hash of the text, which names neither the data nor the build)
KEYS = {"hierarchical128": "8f4ddf5c70ab7194", "gauss1024": "c5ebc43debce0ccb"}


def _gauss_data():
    rng = np.random.default_rng(0)
    return rng.standard_normal(DG).astype(f32), np.logspace(-1, 1, DG).astype(f32)


@pytest.fixture(scope="module")
def models():
    """name -> (JAX log density, the port's log density, TracedDensity,
    shapes, points(seed, n))."""
    x, y, c, _ = jh.synthetic_hierarchical_data(jax.random.key(0), NG)
    data = tuple(np.array(a, f32) for a in (x, y, c))
    jh_fn = jax_transform(jh.make_hierarchical_posterior(x, y, c, NG).log_prob,
                          {"precision": JaxLog})
    th_fn = transform_logdensity(
        hierarchical.make_hierarchical_posterior(*data, NG, device="cpu").log_prob,
        {"precision": LogTransform})

    def h_points(seed, n=P):
        rng = np.random.default_rng(seed)
        centre = np.concatenate([np.tile([0.8, 1.2], NG), [-1.3, -1.3, 0.8, 1.2, 3.2]])
        return (centre + 0.3 * rng.normal(size=(n, DH))).astype(f32)

    mean, scale = _gauss_data()
    tm, ts = torch.tensor(mean), torch.tensor(scale)

    def jg_fn(p):
        return -0.5 * jnp.sum(((p["x"] - mean) / scale) ** 2)

    def tg_fn(p):
        return -0.5 * torch.sum(((p["x"] - tm) / ts) ** 2)

    def g_points(seed, n=P):
        rng = np.random.default_rng(seed)
        return (mean + scale * rng.standard_normal((n, DG))).astype(f32)

    g_shapes = {"x": (DG,)}
    return {"hierarchical128": (jh_fn, th_fn, device_density(th_fn, _template(SHAPES)),
                                SHAPES, h_points),
            "gauss1024": (jg_fn, tg_fn, device_density(tg_fn, _template(g_shapes)), g_shapes,
                          g_points)}


@pytest.fixture(scope="module")
def host(models, tmp_path_factory):
    """The host library of both models' wide forms."""
    return dc.build_host_library([m[2].compiled for m in models.values()],
                                 tmp_path_factory.mktemp("wider"))


def _template(shapes):
    return {k: torch.zeros(s) for k, s in shapes.items()}


def _tile_value_and_grad(jfn, q, shapes):
    """The JAX package's lane-interpreter U and grad U at points q (n, D),
    as its kernels take them."""
    potential, consts, _ = tile_potential_from_scalar(
        jfn, {k: jnp.zeros(s) for k, s in shapes.items()})
    padded = {k: _pad_const(v) for k, v in consts.items()}
    d = q.shape[1]
    tile = np.zeros(((d + 7) // 8 * 8, q.shape[0]), f32)
    tile[:d] = q.T
    U, G = potential.tile_value_and_grad(jnp.asarray(tile), padded)
    return np.asarray(U)[0], np.asarray(G)[:d].T


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("name, D, warps", [("hierarchical128", DH, 2), ("gauss1024", DG, 4)])
def test_wide_form_at_a_group_of_warps(models, name, D, warps):
    """Both models compile to the wide form (no one-lane entry, the
    position read from the group's shared buffer), which K3 and K4 run at
    W warps a chain, and the kernels take them."""
    density = models[name][2]
    cd = density.compiled
    assert isinstance(density, TracedDensity) and density.D == D and density.wide
    assert cd.key == KEYS[name] and cd.kernel_name == cd.group_name == f"TracedWide_{cd.key}"
    assert "kWide = true" in cd.group_source and "float q[" not in cd.header
    assert "float t" not in cd.group_source  # no per-thread array of a node
    assert fp.wide_warps(D) == warps and fp.lanes_for(density) == 32 * warps
    assert fp.kernel_refusal(density) is None


@pytest.mark.parametrize("threads", [32, 64, 256])
@pytest.mark.parametrize("name", ["hierarchical128", "gauss1024"])
def test_wide_form_on_host_groups_matches_jax_and_torch_func(models, host, name, threads):
    """The wide form built with g++ on a group of 32, 64 or 256 host
    threads (a warp, 2 and 8 warps; every thread's U the same bits)
    against torch.func and the JAX package's tile value and gradient."""
    jfn, _, density, shapes, points = models[name]
    q = points(2)
    U, g = dc.host_eval(host, density.compiled, q, threads=threads)
    U_f, g_f = density.potential_and_grad(torch.tensor(q))
    _close(U, U_f.numpy())
    _close(g, g_f.numpy())
    U_j, g_j = _tile_value_and_grad(jfn, q, shapes)
    _close(U, U_j)
    _close(g, g_j)


def _noise(seed, steps, D):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    d_pad = (D + 7) // 8 * 8
    return (np.asarray(jax.random.normal(k1, (steps, d_pad, C), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32)))


K4_SEED, K4_STEPS, K4_EPS = 1, 4, 0.01


def test_plain_k4_matches_jax_interpret(models):
    """Four K4 steps at L = 10 on host noise at D = 261: acceptance to 1e-6,
    draws to 2e-4, no decision within 5e-5 of its threshold."""
    jfn, _, density, shapes, points = models["hierarchical128"]
    potential, consts, _ = tile_potential_from_scalar(
        jfn, {k: jnp.zeros(s) for k, s in shapes.items()})
    q0 = points(4, C)
    eps = np.full(C, K4_EPS, f32)
    im = np.ones((C, DH), f32)
    jr = jax_run(potential, jnp.asarray(q0), K4_SEED, jnp.asarray(eps), jnp.asarray(im), consts,
                 num_steps=K4_STEPS, block_chains=C, steps_per_block=K4_STEPS,
                 interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in _noise(K4_SEED, K4_STEPS, DH))
    trace = fused_potential_hmc_plain(density, torch.tensor(q0), K4_SEED, torch.tensor(eps),
                                      torch.tensor(im), num_steps=K4_STEPS, block_chains=C,
                                      noise=noise)
    assert float(trace.margin.abs().min()) > 5e-5
    got = trace.result
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    assert 0.0 < float(got.accept_rate) < 1.0
    np.testing.assert_allclose(got.draws.numpy(), np.asarray(jr.draws), atol=2e-4)


K3_SEED, K3_STEPS, K3_EPS = 0, 6, 0.01


def test_plain_k3_matches_jax_interpret(models):
    """Six warmup steps at D = 261 (the window fold and the harvest at the
    last boundary run): positions to 2e-4, the step size to 1e-4 relative,
    the metric to 1e-3."""
    jfn, _, density, shapes, points = models["hierarchical128"]
    potential, consts, _ = tile_potential_from_scalar(
        jfn, {k: jnp.zeros(s) for k, s in shapes.items()})
    q0 = points(5, C)
    jq, jeps, jim = jax_warmup(potential, jnp.asarray(q0), K3_SEED, K3_EPS, consts,
                               num_warmup=K3_STEPS, num_leapfrog=10, block_chains=C,
                               interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in _noise(K3_SEED, K3_STEPS, DH))
    margins = []
    tq, teps, tim = fused_warmup_plain(density, torch.tensor(q0), K3_SEED, K3_EPS,
                                       num_warmup=K3_STEPS, num_leapfrog=10, block_chains=C,
                                       target_accept=0.8, init_search=False, noise=noise,
                                       margins=margins)
    assert float(torch.stack(margins).abs().min()) > 5e-5
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-4)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name, chains, jax_path", [("hierarchical128", 128, "fused"),
                                                    ("gauss1024", 128, "fused"),
                                                    ("hierarchical128", 512, "xla")])
def test_routers_past_256_coordinates(models, name, chains, jax_path):
    """At 128 chains both routers send both models to the fused kernels
    (the JAX router: "small/medium chain batch"); at 512 chains the JAX
    router sends the hierarchical posterior to XLA by its VMEM model (a
    floor tile of 512 lanes of d_pad + c_tot floats past its budget), which
    the port does not carry: it stays fused, naming the traced density."""
    jfn, tfn, density, shapes, _ = models[name]
    jd = jax_auto.route_algorithm(jfn, {k: jnp.zeros((chains,) + s) for k, s in shapes.items()})
    td = auto.route_algorithm(tfn, {k: torch.zeros((chains,) + s) for k, s in shapes.items()})
    assert jd.path == jax_path, jd
    if jax_path == "xla":
        assert jd.reason.startswith("data-heavy density"), jd.reason
    assert td.path == "fused" and "TracedDensity" in td.reason and td.d == density.D, td
    assert f"{fp.wide_warps(density.D)} warp(s) a chain" in td.reason, td.reason


def _chain_floats(D):
    return 3 * ((D + 3) // 4 * 4) + 8


@pytest.mark.parametrize("name", ["hierarchical128", "gauss1024", "cap"])
def test_kernel_refusal_counts_past_256(models, name):
    """What the wide launches allocate, by emitted text and key only: the
    operands (padded to 4) within the kernels' 12,288 floats; K3's 8 / W
    chains a CTA and K4's max(4 / W, 1), each three buffers of D floats
    and the group's 8 partials, and K4's 256 Halton floats, on top; with
    K3's static arrays within the block's 227 KB.  At MAX_D_WIDE (a
    standard normal: W = 8, one chain a CTA) K4's buffers alone pass the
    12,288 floats the old count held them to."""
    if name == "cap":
        D = dc.MAX_D_WIDE
        density = device_density(lambda p: -0.5 * torch.sum(p["x"] ** 2), {"x": torch.zeros(D)})
    else:
        density = models[name][2]
        D = density.D
    W = fp.wide_warps(D)
    assert W == {261: 2, 1024: 4, dc.MAX_D_WIDE: 8}[D]
    nf = (density.shared_floats() + 3) // 4 * 4
    assert nf <= fp._SMEM_FLOATS
    k3 = nf + (8 // W) * _chain_floats(D)
    k4 = nf + 256 + max(4 // W, 1) * _chain_floats(D)
    assert fp._shared_need(density, "K3") == k3
    assert fp._shared_need(density, "K4") == k4
    assert k3 + 8 + 8 // W + 64 + 256 <= 232448 // 4
    assert fp.kernel_refusal(density) is None
    if name == "cap":
        assert k4 > fp._SMEM_FLOATS and density.compiled.lines < 200


def test_refusal_past_the_cap():
    """MAX_D_WIDE + 1 coordinates: the compiler refuses by name before any
    trace, device_density raises it, and the router sends the density to
    the eager path with the reason; nothing falls back on the card."""
    D = dc.MAX_D_WIDE + 1
    assert dc.MAX_D_WIDE >= 3528  # the JAX router fuses d_pad + c_tot up to 3,531 floats

    def ld(p):
        return -0.5 * torch.sum(p["x"] ** 2)

    with pytest.raises(dc.UnsupportedOpError, match=f"{D} coordinates.*at most {dc.MAX_D_WIDE}"):
        dc.compile_density(ld, {"x": torch.zeros(D)})
    with pytest.raises(NotImplementedError, match=f"at most {dc.MAX_D_WIDE}"):
        device_density(ld, {"x": torch.zeros(D)})
    dec = auto.route_algorithm(ld, {"x": torch.zeros((16, D))})
    assert dec.path == "xla" and dec.reason.startswith("not tile-compilable"), dec
    assert f"at most {dc.MAX_D_WIDE}" in dec.reason
