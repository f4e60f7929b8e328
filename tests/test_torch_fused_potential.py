"""K4's counterpart: the plain ``fused_potential_hmc_run`` against the JAX
``fused_potential_hmc_run`` in interpret mode, draw for draw.

Both sides get the same host noise: the test rebuilds the JAX kernel's
``jax.random`` stream (``fused_potential.py:1008-1012``) and hands it to
the port through ``noise=``.  The JAX side runs the density traced from
its scalar form (``tile_potential_from_scalar``); the port runs the device
density (``LinregDensity`` for the linear-regression posterior,
``DiagGaussianDensity`` for the Gaussian of ``tests/test_chees_fused.py``).
With step sizes well inside the stable range, two float32 trajectories
that start together stay within ~3e-5 over 100 steps as long as no MH
decision flips; each seed is chosen so that no decision lies within 5e-5
of its threshold (asserted), and the draws are held to 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.fused_hmc import linreg_unconstrained_logdensity
from binf_tpu.ops.pallas.fused_potential import (
    fused_potential_hmc_run as jax_run,
    tile_potential_from_scalar,
)
from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity, LinregDensity
from binf_tpu_torch.ops.kernels.fused_potential import (
    chees_leapfrog_counts,
    fused_potential_hmc_plain,
    fused_potential_hmc_run,
)

C = 64
BC = 32
STEPS = 100
SCALES = np.array([0.5, 1.0, 2.0, 4.0], np.float32)


@pytest.fixture(scope="module")
def linreg():
    rng = np.random.default_rng(0)
    x = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(x, 4, increasing=True).astype(np.float32)
    truth = np.array([2.0, -4.0, 1.0, 1.5])
    y = (V @ truth + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    prior_var = np.full(4, 5.0, np.float32)
    q0 = np.concatenate([truth + 0.1 * rng.normal(size=(C, 4)),
                         np.log(2.5) + 0.1 * rng.normal(size=(C, 1))], axis=1).astype(np.float32)
    eps = (0.15 + 0.05 * rng.random(C)).astype(np.float32)
    im = (np.array([0.05, 0.1, 0.02, 0.02, 0.1])
          * (1 + 0.1 * rng.random((C, 5)))).astype(np.float32)
    ld = linreg_unconstrained_logdensity(jnp.asarray(V), jnp.asarray(y), jnp.asarray(prior_var),
                                         1.0, 0.2)
    template = {"coefficients": jnp.zeros(4), "precision": jnp.zeros(())}
    potential, consts, _ = tile_potential_from_scalar(ld, template)
    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2)
    return dict(potential=potential, consts=consts, density=density, q0=q0, eps=eps, im=im)


@pytest.fixture(scope="module")
def gauss():
    s = jnp.asarray(SCALES)
    potential, consts, _ = tile_potential_from_scalar(
        lambda p: -0.5 * jnp.sum((p["x"] / s) ** 2), {"x": jnp.zeros(4)})
    rng = np.random.default_rng(1)
    return dict(potential=potential, consts=consts,
                density=DiagGaussianDensity(np.zeros(4), SCALES),
                q0=(0.5 * rng.normal(size=(C, 4))).astype(np.float32),
                eps=np.full(C, 0.9, np.float32),
                im=np.broadcast_to(SCALES ** 2, (C, 4)).copy())


def _noise(seed, steps):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    return (torch.tensor(np.asarray(jax.random.normal(k1, (steps, 8, C), jnp.float32))),
            torch.tensor(np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32))))


def _dense_metric():
    M = np.diag([0.05, 0.1, 0.02, 0.02, 0.1]).astype(np.float32)
    M[0, 1] = M[1, 0] = 0.01
    return M


CASES = [
    ("fixed", "linreg", 1, {}),
    ("thin", "linreg", 1, dict(thin=2)),
    ("moments", "linreg", 1, dict(collect="moments")),
    ("dense", "linreg", 0, dict(dense_mass=True)),
    ("chees", "linreg", 1, dict(trajectory="chees", traj_length=1.5, max_leapfrog=16)),
    ("gauss", "gauss", 3, {}),
    ("gauss_chees", "gauss", 0, dict(trajectory="chees", max_leapfrog=16,
                                     traj_length=np.linspace(1, 3, C).astype(np.float32))),
]


@pytest.mark.parametrize("name, problem, seed, kw", CASES, ids=[c[0] for c in CASES])
def test_plain_run_matches_jax(linreg, gauss, name, problem, seed, kw):
    p = linreg if problem == "linreg" else gauss
    im = _dense_metric() if kw.get("dense_mass") else p["im"]
    jr = jax_run(p["potential"], jnp.asarray(p["q0"]), seed, jnp.asarray(p["eps"]),
                 jnp.asarray(im), p["consts"], num_steps=STEPS, block_chains=BC,
                 steps_per_block=50, interpret=True, host_noise=True, **kw)
    trace = fused_potential_hmc_plain(p["density"], torch.tensor(p["q0"]), seed,
                                      torch.tensor(p["eps"]), torch.tensor(im),
                                      num_steps=STEPS, block_chains=BC,
                                      noise=_noise(seed, STEPS), **kw)
    assert float(trace.margin.abs().min()) > 5e-5
    got = trace.result
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    np.testing.assert_allclose(got.final_positions.numpy(), np.asarray(jr.final_positions),
                               atol=2e-4)
    if kw.get("collect") == "moments":
        assert got.draws is None and jr.draws is None
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(jr.mean), atol=2e-4)
        np.testing.assert_allclose(got.variance.numpy(), np.asarray(jr.variance), rtol=1e-3,
                                   atol=1e-6)
    else:
        assert got.draws.shape == jr.draws.shape == (STEPS // kw.get("thin", 1), C, p["q0"].shape[1])
        np.testing.assert_allclose(got.draws.numpy(), np.asarray(jr.draws), atol=2e-4)
    # the run wrapper on the CPU is the plain version
    again = fused_potential_hmc_run(p["density"], p["q0"], seed, p["eps"], im,
                                    num_steps=STEPS, block_chains=BC,
                                    noise=_noise(seed, STEPS), device="cpu", **kw)
    assert torch.equal(again.final_positions, got.final_positions)


@pytest.mark.parametrize("collect", ["draws", "moments"])
def test_block_offset_resume_is_bitwise(gauss, collect):
    """Two calls chained through final_positions, with block_offset advanced,
    reproduce one uninterrupted call bit for bit (Philox indexes the
    absolute step); moments restart with each call, as the reference's."""
    p = gauss
    kw = dict(block_chains=BC, steps_per_block=10, device="cpu")
    one = fused_potential_hmc_run(p["density"], p["q0"], 7, p["eps"], p["im"], num_steps=60,
                                  **kw)
    a = fused_potential_hmc_run(p["density"], p["q0"], 7, p["eps"], p["im"], num_steps=30,
                                collect=collect, **kw)
    b = fused_potential_hmc_run(p["density"], a.final_positions, 7, p["eps"], p["im"],
                                num_steps=30, block_offset=3, collect=collect, **kw)
    assert torch.equal(b.final_positions, one.final_positions)
    if collect == "draws":
        assert torch.equal(torch.cat([a.draws, b.draws]), one.draws)
    else:
        torch.testing.assert_close(b.mean, one.draws[30:].mean(0), rtol=1e-5, atol=1e-6)
    c = fused_potential_hmc_run(p["density"], a.final_positions, 7, p["eps"], p["im"],
                                num_steps=30, block_offset=0, **kw)
    assert not torch.equal(c.final_positions, one.final_positions)


def test_chees_sampling_preserves_target(gauss):
    """tests/test_chees_fused.py:30 on the port: jittered trajectories keep
    the stationary distribution (moments of an anisotropic Gaussian), and
    the leapfrog counts are the Halton table's."""
    p = gauss
    q0 = torch.zeros((C, 4))
    counts = torch.zeros((600, C // BC), dtype=torch.int32)
    res = fused_potential_hmc_run(p["density"], q0, 3, 0.9, SCALES ** 2, num_steps=600,
                                  block_chains=BC, trajectory="chees", traj_length=2.0,
                                  max_leapfrog=16, leapfrog_counts=counts, device="cpu")
    assert 0.5 < float(res.accept_rate) <= 1.0
    draws = res.draws[200:].reshape(-1, 4).numpy()
    np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.12)
    expected, _ = chees_leapfrog_counts(torch.full((2,), 2.0), torch.full((2,), 0.9), 600, 16)
    assert torch.equal(counts, expected)
    assert 1 <= int(counts.min()) and int(counts.max()) <= 5  # ceil(h * 4.44)


def test_divergence_guard_rejects(gauss):
    """NaN or |dE| > 1000 rejects outright: a step size far beyond the
    stable range never moves a chain."""
    p = gauss
    res = fused_potential_hmc_run(p["density"], p["q0"], 0, 50.0, p["im"], num_steps=10,
                                  steps_per_block=10, block_chains=BC, device="cpu")
    assert float(res.accept_rate) == 0.0
    assert torch.equal(res.final_positions, torch.tensor(p["q0"]))


@pytest.mark.parametrize("bad", [
    dict(collect="bogus"), dict(trajectory="bogus"), dict(num_steps=45),
    dict(thin=3), dict(trajectory="chees"), dict(dense_mass=True),
], ids=["collect", "trajectory", "steps_per_block", "thin", "chees_no_T", "dense_shape"])
def test_bad_options_raise(gauss, bad):
    p = gauss
    kw = dict(num_steps=50, block_chains=BC, steps_per_block=10, device="cpu")
    kw.update(bad)
    with pytest.raises(ValueError):
        fused_potential_hmc_run(p["density"], p["q0"], 0, 0.5, p["im"], **kw)


@pytest.mark.parametrize("n", [7, 20, 33])
@pytest.mark.parametrize("d", [1, 4, 7])
def test_linreg_density_matches_float64_and_jax(n, d):
    """``LinregDensity.potential_and_grad``, the plain versions' density on
    every device, at the row counts and dimensions the card tests split
    over lane groups (n = 7, 20, 33; D = 2, 5, 8): U and grad U within 1e-6
    of the largest magnitude of a float64 evaluation (float32 rounding of
    sums of 7-33 rows), and the float64 U within 1e-5 of the JAX package's
    log density."""
    rng = np.random.default_rng(10 * n + d)
    V = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    density = LinregDensity.from_numpy(V, y, np.full(d, 5.0, np.float32), 1.0, 0.2)
    q = rng.normal(size=(16, d + 1)).astype(np.float32)
    U, g = density.potential_and_grad(torch.tensor(q))
    logdensity = linreg_unconstrained_logdensity(jnp.asarray(V), jnp.asarray(y),
                                                 jnp.full(d, 5.0), 1.0, 0.2)
    ref_u = np.array([-float(logdensity({"coefficients": jnp.asarray(r[:d]),
                                         "precision": jnp.asarray(r[d])})) for r in q])
    d64 = LinregDensity.from_numpy(V, y, np.full(d, 5.0, np.float32), 1.0, 0.2).double()
    U64, g64 = d64.potential_and_grad(torch.tensor(q, dtype=torch.float64))
    np.testing.assert_allclose(U.double().numpy(), U64.numpy(),
                               atol=1e-6 * float(U64.abs().max()))
    np.testing.assert_allclose(g.double().numpy(), g64.numpy(),
                               atol=1e-6 * float(g64.abs().max()))
    np.testing.assert_allclose(ref_u, U64.numpy(), rtol=1e-5)
