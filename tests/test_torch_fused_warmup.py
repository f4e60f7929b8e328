"""Plain K3 (``binf_tpu_torch.ops.kernels.fused_potential.fused_warmup_run``
on the CPU) against the JAX ``fused_warmup_run`` in interpret mode, on the
linear-regression potential built by ``tile_potential_from_scalar``, with
fixed and with ChEES trajectories.

Both get the same host noise: the test rebuilds the JAX kernel's
``jax.random`` stream (``fused_potential.py:799-806``) and hands it to the
port through ``noise=``.

The pooled warmup is chaotic in float32: the early steps try step sizes far
beyond the stable range and every chain's step size depends on all chains'
acceptance, so a change of 1e-6 in the start grows to O(1) in the
positions within about 12 steps (measured with the plain version).  Two
float32 implementations that sum in different orders therefore agree step
for step only over a short horizon, checked tightly below; over a full
warmup they agree as two independent adaptations do, checked with
tolerances taken from 12 seeded runs (largest step-size difference 15%,
inverse-mass ratio 0.82-1.13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.fused_hmc import linreg_unconstrained_logdensity
from binf_tpu.ops.pallas.fused_potential import (
    fused_warmup_run as jax_fused_warmup_run,
    tile_potential_from_scalar,
)
from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity
from binf_tpu_torch.ops.kernels.fused_potential import (
    fused_warmup_plain,
    fused_warmup_run,
    pack_positions,
    pack_template,
    unpack_draws,
)

C = 64
BC = 32
SEARCH_TRIALS = 20


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(x, 4, increasing=True).astype(np.float32)
    truth = np.array([2.0, -4.0, 1.0, 1.5])
    y = (V @ truth + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    prior_var = np.full(4, 5.0, np.float32)
    q0 = np.concatenate(
        [truth + 0.1 * rng.normal(size=(C, 4)),
         np.log(2.5) + 0.1 * rng.normal(size=(C, 1))], axis=1).astype(np.float32)
    logdensity = linreg_unconstrained_logdensity(
        jnp.asarray(V), jnp.asarray(y), jnp.asarray(prior_var), 1.0, 0.2)
    template = {"coefficients": jnp.zeros((4,), jnp.float32),
                "precision": jnp.zeros((), jnp.float32)}
    potential, consts, _ = tile_potential_from_scalar(logdensity, template)
    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2)
    return potential, consts, density, q0


def _host_noise(seed, n_noise, d_pad=8):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    mom = jax.random.normal(k1, (n_noise, d_pad, C), jnp.float32)
    unif = jax.random.uniform(k2, (n_noise, 1, C), jnp.float32)
    return np.asarray(mom), np.asarray(unif)


def _run_both(problem, seed, num_warmup, init_search):
    potential, consts, density, q0 = problem
    jq, jeps, jim = jax_fused_warmup_run(
        potential, jnp.asarray(q0), seed, 0.1, consts, num_warmup=num_warmup,
        num_leapfrog=10, block_chains=BC, interpret=True, host_noise=True,
        init_search=init_search)
    noise = _host_noise(seed, num_warmup + (SEARCH_TRIALS + 1 if init_search else 0))
    margins = []
    fused_warmup_plain(density, torch.tensor(q0), seed, 0.1, num_warmup=num_warmup,
                       num_leapfrog=10, block_chains=BC, target_accept=0.8,
                       init_search=init_search,
                       noise=tuple(torch.tensor(a) for a in noise), margins=margins)
    tq, teps, tim = fused_warmup_run(density, q0, seed, 0.1, num_warmup=num_warmup,
                                     block_chains=BC, init_search=init_search,
                                     noise=noise, device="cpu")
    out = [(np.asarray(a), b.numpy()) for a, b in ((jq, tq), (jeps, teps), (jim, tim))]
    return out, torch.stack(margins).abs().min().item()


@pytest.mark.parametrize("init_search", [False, True])
def test_plain_warmup_matches_jax_step_by_step(problem, init_search):
    """Six steps: the window fold, the harvest at the last boundary and the
    step-size search all run; no MH decision is within 1e-4 of its
    threshold, so both sides take the same decisions and differ only by
    float32 rounding."""
    (q, eps, im), margin = _run_both(problem, seed=0, num_warmup=6,
                                     init_search=init_search)
    assert margin > 1e-4
    np.testing.assert_allclose(q[1], q[0], atol=1e-4)
    np.testing.assert_allclose(eps[1], eps[0], rtol=1e-4)
    # below 20 steps the final buffer is one step long and ends on the last
    # window boundary, whose reset zeroes the step-size average: both sides
    # return exp(0) whatever the adaptation found
    np.testing.assert_array_equal(eps[0], 1.0)
    np.testing.assert_allclose(im[1], im[0], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("init_search", [False, True])
def test_plain_warmup_matches_jax_adaptation(problem, init_search):
    """150 steps: the same adaptation to the tolerance two independent
    adaptations show (see the module docstring)."""
    (q, eps, im), _ = _run_both(problem, seed=2, num_warmup=150,
                                init_search=init_search)
    assert eps[1].shape == (C,) and im[1].shape == (C, 5) and q[1].shape == (C, 5)
    for tile in (slice(0, BC), slice(BC, C)):
        # one step size and one metric per tile, broadcast to its chains
        assert np.ptp(eps[1][tile]) == 0.0 and np.ptp(im[1][tile], axis=0).max() == 0.0
    np.testing.assert_allclose(eps[1], eps[0], rtol=0.3)
    np.testing.assert_allclose(im[1], im[0], rtol=0.4)
    # warmed positions: the same posterior, means within 5 standard errors
    sd = q[0].std(axis=0)
    np.testing.assert_array_less(np.abs(q[1].mean(0) - q[0].mean(0)),
                                 5 * sd * np.sqrt(2.0 / C))


def _run_chees(problem, seed, num_warmup, init_search):
    potential, consts, density, q0 = problem
    jout = jax_fused_warmup_run(
        potential, jnp.asarray(q0), seed, 0.1, consts, num_warmup=num_warmup,
        num_leapfrog=10, block_chains=BC, interpret=True, host_noise=True,
        init_search=init_search, trajectory="chees", max_leapfrog=32, target_accept=0.651)
    noise = _host_noise(seed, num_warmup + (SEARCH_TRIALS + 1 if init_search else 0))
    margins, leap_args = [], []
    tout = fused_warmup_plain(density, torch.tensor(q0), seed, 0.1, num_warmup=num_warmup,
                              num_leapfrog=10, block_chains=BC, target_accept=0.651,
                              init_search=init_search, trajectory="chees", max_leapfrog=32,
                              noise=tuple(torch.tensor(a) for a in noise), margins=margins,
                              leap_args=leap_args)
    return ([(np.asarray(a), b.numpy()) for a, b in zip(jout, tout)],
            torch.stack(margins).abs().min().item(), torch.stack(leap_args))


@pytest.mark.parametrize("init_search", [False, True])
def test_chees_warmup_matches_jax_step_by_step(problem, init_search):
    """Six ChEES warmup steps (search, Halton-jittered trajectories, the
    pooled surrogate gradient and Adam on log T, window fold and harvest):
    no MH decision within 1e-3 of its threshold, so both sides take the
    same decisions; positions agree to 2e-4 and the metric to 1e-4.  The
    first step's leapfrog count is ceil(1/2 * 2 * 10 eps0 / eps0), whose
    argument is 10 to within a rounding: both sides run the same count
    (the positions show it), a float32 implementation with other exp and
    log roundings may run 11.  Six steps leave a one-step final buffer:
    eps is exp(0) and T its clamp, 1, on both sides."""
    (q, eps, im, T), margin, leap_args = _run_chees(problem, seed=1, num_warmup=6,
                                                    init_search=init_search)
    assert margin > 1e-3
    assert abs(float(leap_args[0, 0]) - 10.0) < 1e-5
    np.testing.assert_allclose(q[1], q[0], atol=2e-4)
    np.testing.assert_array_equal(eps[1], eps[0])
    np.testing.assert_allclose(im[1], im[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(T[1], T[0])


def test_chees_warmup_matches_jax_adaptation(problem):
    """150 ChEES warmup steps: the same adaptation to the tolerance two
    independent runs show.  A 1e-6 relative change of the start moves the
    plain version's per-tile eps by up to 19%, the metric by 43% and T by
    57% at this size (6 perturbations, 3 seeds); the bounds are 1.5 times
    those.  T stays in its band [eps, 32 eps] on both sides."""
    (q, eps, im, T), _, leap_args = _run_chees(problem, seed=0, num_warmup=150,
                                               init_search=False)
    assert leap_args.shape == (150, C // BC)
    assert T[1].shape == (C,) and np.ptp(T[1][:BC]) == 0.0
    for side in (0, 1):
        assert np.all(T[side] >= eps[side] * (1 - 1e-6))
        assert np.all(T[side] <= 32 * eps[side] * (1 + 1e-6))
    np.testing.assert_allclose(eps[1], eps[0], rtol=0.3)
    np.testing.assert_allclose(im[1], im[0], rtol=0.65)
    np.testing.assert_allclose(T[1], T[0], rtol=0.85)
    sd = q[0].std(axis=0)
    np.testing.assert_array_less(np.abs(q[1].mean(0) - q[0].mean(0)),
                                 5 * sd * np.sqrt(2.0 / C))


def test_philox_warmup_is_deterministic_and_tile_local(problem):
    """Device-PRNG mode on the CPU: the same seed gives the same result, and
    a tile's adaptation depends only on its own chains (moving the second
    tile's start leaves the first tile's result bit for bit)."""
    _, _, density, q0 = problem
    kwargs = dict(num_warmup=20, block_chains=BC, device="cpu")
    a = fused_warmup_run(density, q0, 3, 0.1, **kwargs)
    b = fused_warmup_run(density, q0, 3, 0.1, **kwargs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    moved = q0.copy()
    moved[BC:] += 0.05
    c = fused_warmup_run(density, moved, 3, 0.1, **kwargs)
    for x, y in zip(a, c):
        assert torch.equal(x[:BC], y[:BC]) and not torch.equal(x[BC:], y[BC:])
    assert torch.isfinite(a[0]).all() and (a[1] > 0).all() and (a[2] > 0).all()


def test_pack_roundtrip_matches_jax_layout():
    from binf_tpu.ops.pallas.fused_potential import (
        pack_positions as jax_pack,
        pack_template as jax_template,
    )

    rng = np.random.default_rng(3)
    pos = {"precision": rng.normal(size=(6,)).astype(np.float32),
           "coefficients": rng.normal(size=(6, 4)).astype(np.float32)}
    spec = pack_template({k: v[0] for k, v in pos.items()})
    assert spec == jax_template({k: jnp.asarray(v[0]) for k, v in pos.items()})
    flat = pack_positions({k: torch.tensor(v) for k, v in pos.items()})
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jax_pack({k: jnp.asarray(v) for k, v in pos.items()})))
    back = unpack_draws(flat, spec)
    for k in pos:
        np.testing.assert_array_equal(back[k].numpy(), pos[k])
