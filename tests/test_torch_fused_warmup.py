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


# -- K3's launch geometry and its slice-partial reduction ----------------------


@pytest.mark.parametrize("n, lanes", [(2, 1), (7, 1), (12, 1), (13, 2), (20, 2), (24, 2),
                                      (25, 4), (48, 4), (49, 8), (400, 8)])
def test_lanes_follow_the_data_rows(n, lanes):
    """G is the narrowest of 1, 2, 4, 8 whose lanes hold all rows in their
    registers: 12 rows of 3 coefficients and y (50 floats) a lane."""
    from binf_tpu_torch.ops.kernels.fused_potential import lanes_for

    rng = np.random.default_rng(n)
    density = LinregDensity.from_numpy(rng.normal(size=(n, 3)).astype(np.float32),
                                       rng.normal(size=n).astype(np.float32),
                                       np.ones(3, np.float32), 1.0, 0.2)
    assert lanes_for(density) == lanes


def test_a_density_without_data_rows_takes_one_lane():
    from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity
    from binf_tpu_torch.ops.kernels.fused_potential import lanes_for

    assert lanes_for(DiagGaussianDensity([0.0, 1.0], [1.0, 2.0])) == 1


@pytest.mark.parametrize("C, bc, lanes, fit, cap, expect", [
    # the main path: one tile of 16,384 chains, G = 4, two CTAs on each of 132 SMs
    (16384, 16384, 4, 264, None, dict(slice_chains=64, slices_per_tile=256, chains_per_cta=64,
                                      ctas=256, rounds=1, tiles_per_cta=1, resident=True)),
    (16384, 512, 4, 264, None, dict(slice_chains=64, slices_per_tile=8, ctas=256, rounds=1,
                                    tiles_per_cta=1)),
    (16384, 2048, 2, 264, None, dict(slice_chains=128, chains_per_cta=128, ctas=128, rounds=1)),
    # capped below the chunks: rounds, and as few CTAs as they allow
    (16384, 16384, 4, 264, 100, dict(ctas=86, rounds=3, resident=False)),
    (256, 64, 4, 264, 1, dict(ctas=1, rounds=4, tiles_per_cta=4, resident=False)),
    # a tile smaller than a CTA round's chains: the slice halves until it divides
    (240, 12, 4, 264, None, dict(slice_chains=4, slices_per_tile=3, ctas=4, tiles_per_cta=6)),
    (96, 3, 1, 264, None, dict(slice_chains=1, slices_per_tile=3, ctas=1, tiles_per_cta=32)),
    # a CTA's chains span more tiles than its shared memory holds states
    # for: they go to device memory
    (1024, 16, 4, 264, 1, dict(ctas=1, rounds=16, tiles_per_cta=64, resident=False)),
    (1 << 20, 128, 2, 128, None, dict(slice_chains=128, ctas=128, rounds=64, tiles_per_cta=64)),
    # a prime count of chains, one chain a tile (auto_block_chains' choice)
    (16411, 1, 2, 128, None, dict(slice_chains=1, slices_per_tile=1, ctas=65, rounds=2,
                                  tiles_per_cta=256, resident=False)),
])
def test_warmup_geometry(C, bc, lanes, fit, cap, expect):
    from binf_tpu_torch.ops.kernels.fused_potential import warmup_geometry

    geo = warmup_geometry(C, bc, lanes, fit, cta_cap=cap)
    assert geo.lanes == lanes and geo.barriers_per_step == 1
    for key, value in expect.items():
        assert getattr(geo, key) == value, key
    # every chain has a place, and the grid has no idle CTA
    assert geo.ctas * geo.rounds * geo.chains_per_cta >= C
    assert (geo.ctas - 1) * geo.rounds * geo.chains_per_cta < C
    assert warmup_geometry(C, bc, lanes, fit, cta_cap=cap,
                           trajectory="chees").barriers_per_step == 2


@pytest.mark.parametrize("C, bc, lanes, fit, cap, match", [
    (1000, 300, 4, 264, None, "divide"),
    (1024, 0, 4, 264, None, "divide"),
    (1024, 512, 3, 264, None, "instantiated"),
    (1024, 512, 4, 0, None, "does not fit"),
    (1024, 512, 4, 264, 0, "does not fit"),
])
def test_warmup_geometry_refuses(C, bc, lanes, fit, cap, match):
    from binf_tpu_torch.ops.kernels.fused_potential import warmup_geometry

    with pytest.raises(ValueError, match=match):
        warmup_geometry(C, bc, lanes, fit, cta_cap=cap)


@pytest.mark.parametrize("search, barriers, per_step", [(0, 500, 1.0), (0, 1000, 2.0),
                                                        (21, 521, 1.0)])
def test_launch_record_counts_barriers_from_the_generation_word(search, barriers, per_step):
    """A K3 launch record reads the barriers its run passed from the grid
    barrier's generation word, less the step-size search's trials; a launch
    that is not cooperative passed none."""
    from binf_tpu_torch.ops.kernels._build import LaunchRecord

    bar = torch.tensor([0, barriers], dtype=torch.int32)
    rec = LaunchRecord(2, 128, 256, True, 1, 500, search, bar)
    assert rec.barriers() == barriers and rec.barriers_per_step() == per_step
    assert LaunchRecord(2, 256, 128, False, 1, 4000, 0, None).barriers_per_step() == 0.0


def _chan(sums: torch.Tensor, m2: torch.Tensor, n: int):
    """Chan's combine, in order along dim -2, of groups of n chains each
    given by their sums and M2 about their own means: the total sum, and
    the M2 of all of them (the groups' M2 plus n times the squared
    distances of the group means from the overall mean)."""
    total = sums.sum(-2)
    mean = total / (n * sums.shape[-2])
    between = ((sums / n - mean[..., None, :]) ** 2).sum(-2)
    return total, m2.sum(-2) + n * between


def _slice_moments(q: torch.Tensor, S: int, Sw: int):
    """The kernel's tile moments, modelled in torch: each warp's share of
    Sw chains gives its sum and its sum of squared deviations from its own
    mean (sum / Sw); the S / Sw shares of a slice are combined in warp
    order, the slices of a tile in slice order, each by :func:`_chan`.
    ``q`` is ``(tiles, bc, D)``; returns the tile means and M2."""
    T, bc, D = q.shape
    w = q.reshape(T, bc // S, S // Sw, Sw, D)
    w_sum = w.sum(-2)
    w_m2 = ((w - (w_sum / Sw)[..., None, :]) ** 2).sum(-2)
    s_sum, s_m2 = _chan(w_sum, w_m2, Sw)
    total, m2 = _chan(s_sum, s_m2, S)
    return total / bc, m2


@pytest.mark.parametrize("bc, S, Sw", [(16384, 64, 8), (512, 64, 8), (2048, 128, 16),
                                       (512, 256, 32), (12, 4, 4)])
def test_slice_chan_combine_matches_two_pass_variance(bc, S, Sw):
    """Chan's combine of per-share and per-slice (count, mean, M2) in warp
    and slice order equals
    the plain version's two-pass tile M2 (``fused_warmup_plain``: sum of
    (q - tile mean)^2) to float32 tolerance: both lie within 2e-4 relative
    of the float64 two-pass value, on positions shaped like the main
    path's warmup (means up to 4 with spreads of 0.02-0.3, and a
    coordinate whose spread is 1e-3 of its mean: a float32 ulp of that
    mean is 6e-5 of its deviations, which sets the tolerance)."""
    rng = np.random.default_rng(bc + S)
    tiles = max(1, 16384 // bc // 8)
    loc = np.array([2.0, -4.0, 1.0, 1.5, 0.9])
    scale = np.array([0.3, 0.1, 0.02, 0.05, 1e-3])
    q = (loc + scale * rng.normal(size=(tiles, bc, 5))).astype(np.float32)
    q32 = torch.tensor(q)
    mean, m2 = _slice_moments(q32, S, Sw)
    q64 = torch.tensor(q, dtype=torch.float64)
    mean64 = q64.mean(1)
    ref = ((q64 - mean64[:, None, :]) ** 2).sum(1)
    plain_mean = q32.mean(1)
    plain = ((q32 - plain_mean[:, None, :]) ** 2).sum(1)
    for got in (m2, plain):
        np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=2e-4)
    np.testing.assert_allclose(mean.double().numpy(), mean64.numpy(), rtol=1e-6)
