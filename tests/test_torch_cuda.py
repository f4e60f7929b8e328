"""The CUDA kernels against their plain versions, at small shapes, on the
card.  Marked ``cuda``: each test skips on a host without a CUDA card.
On the card: ``python -m pytest tests/test_torch_cuda.py -q``.  The
full-width comparisons are ``chip_smoke.py``'s.  Each test has a time
limit (``_TIME_LIMIT_S``, the kernels' build apart): past it the run stops
with every thread's traceback."""

import faulthandler

import numpy as np
import pytest
import torch

from binf_tpu_torch.ops.kernels import _build, prng
from binf_tpu_torch.ops.kernels.fused_hmc import (
    LinregDensity,
    fused_linreg_hmc_run,
    linreg_hmc_plain,
)
from binf_tpu_torch.ops.kernels.fused_potential import fused_warmup_plain, fused_warmup_run
from binf_tpu_torch.ops.math import vandermonde

pytestmark = pytest.mark.cuda

C = 256


# seconds a test may take once the kernels are built; the tests that run
# plain versions over many chains or steps get more
_TIME_LIMIT_S = 60
_LONGER_S = {"test_k3_tiles_beyond_shared_memory_match_plain": 180,
             "test_k3_rounds_beyond_the_card_match_plain": 120,
             "test_k7_kernel_matches_plain": 120}


@pytest.fixture
def dev(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    faulthandler.dump_traceback_later(
        _LONGER_S.get(request.node.originalname, _TIME_LIMIT_S), exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _problem(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.linspace(-2, 2, 20)
    V = vandermonde(x, 4)
    y = V @ torch.tensor([2.0, -4.0, 1.0, 1.5]) + torch.randn(20, generator=g) / 2.5 ** 0.5
    density = LinregDensity(V, y, torch.full((4,), 5.0), 1.0, 0.2).to(dev)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((C, 5), generator=g)).to(dev)
    return density, q0


def test_philox_kernels_match_plain(dev):
    ctr = torch.tensor([[0, 0, 0, 0], [0xFFFFFFFF] * 4,
                        [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344]], device=dev)
    for seed in (0, 0xFFFFFFFF_FFFFFFFF, 0x299F31D0_A4093822):
        assert torch.equal(prng.philox_bits(ctr, seed),
                           prng.philox4x32_10(ctr, prng._key(seed)))
    before = _build.LAUNCHES["philox"]
    z_k, u_k = prng.philox_noise(9, prng.TAG_WARMUP, C, 4, 5, step0=3, device=dev)
    assert _build.LAUNCHES["philox"] == before + 1
    z_p, u_p = prng.philox_noise_plain(9, prng.TAG_WARMUP, C, 4, 5, step0=3, device=dev)
    assert torch.equal(u_k, u_p)
    assert float((z_k - z_p).abs().max()) <= 1e-5


@pytest.mark.parametrize("staged", [False, True])
def test_k2_kernel_matches_plain(dev, staged):
    """50 sampling steps on one noise stream.  Seed 7 keeps every MH decision
    more than 1e-4 from its threshold (asserted), so both take the same
    decisions; the draws then agree to 2e-3, ten times the spread that a
    1e-6 relative change of the start gives the plain version here."""
    density, q0 = _problem(dev)
    seed = 7
    eps = torch.tensor([0.2], device=dev)
    im = torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    noise = None
    if staged:
        g = torch.Generator().manual_seed(seed)
        noise = (torch.randn((50, 8, C), generator=g).to(dev),
                 torch.rand((50, 1, C), generator=g).to(dev))
    draws, acc = fused_linreg_hmc_run(q0, seed, density.V, density.y, density.prior_var,
                                      1.0, 0.2, eps, inverse_mass=im, num_steps=50,
                                      block_chains=C, steps_per_block=50, noise=noise,
                                      device=dev)
    plain = linreg_hmc_plain(density, q0, eps, im, num_steps=50, num_leapfrog=10,
                             seed=seed, noise=noise)
    assert float(plain.margin.abs().min()) > 1e-4
    assert float((draws - plain.draws).abs().max()) < 2e-3
    assert float(acc) == pytest.approx(float(plain.accepts.sum()) / (50 * C), abs=1e-7)
    rec = _build.last_launch["fused_linreg_hmc"]
    assert (rec.ctas, rec.threads, rec.rows_in_registers) == (C // 128, 384, True)


@pytest.mark.parametrize("n, d, chains, staged", [(33, 3, 200, False), (7, 6, 77, True),
                                                  (20, 4, 77, False), (20, 5, 130, True),
                                                  (12, 7, 300, False)])
def test_k2_generic_rows_and_ragged_chains_match_plain(dev, n, d, chains, staged):
    """K2 where the rows stay in shared memory (any n and d but n = 20, d =
    4) and at chain counts that leave a CTA's pairs of warps part empty,
    on Philox and on staged noise: on chains with no MH decision within
    1e-4 of its threshold in the plain version (at least 90%), the draws
    agree to 2e-3, or to ten times the spread a 1e-6 relative change of the
    start gives the plain version where that is larger (7 points and 6
    coefficients make a stiff, ill-conditioned posterior whose trajectories
    carry rounding to O(1)), and the accept counts to the near decisions."""
    g = torch.Generator().manual_seed(n + d)
    V = vandermonde(torch.linspace(-1.5, 1.5, n), d)
    truth = torch.linspace(1.0, -1.0, d)
    y = V @ truth + 0.5 * torch.randn(n, generator=g)
    density = LinregDensity(V, y, torch.full((d,), 5.0), 1.0, 0.2).to(dev)
    q0 = (torch.cat([truth, torch.tensor([1.0])]) + 0.05 * torch.randn((chains, d + 1),
                                                                      generator=g)).to(dev)
    eps = torch.tensor([0.05], device=dev)
    im = torch.full((d + 1,), 0.1, device=dev)
    noise = None
    if staged:
        noise = (torch.randn((40, 8, chains), generator=g).to(dev),
                 torch.rand((40, 1, chains), generator=g).to(dev))
    draws, acc = fused_linreg_hmc_run(q0, 5, density.V, density.y, density.prior_var, 1.0, 0.2,
                                      eps, inverse_mass=im, num_steps=40, block_chains=chains,
                                      steps_per_block=40, noise=noise, d=d, device=dev)
    rec = _build.last_launch["fused_linreg_hmc"]
    assert rec.rows_in_registers == (n == 20 and d == 4)
    assert rec.ctas == -(-chains // 128)
    kw = dict(num_steps=40, num_leapfrog=10, seed=5, noise=noise)
    plain = linreg_hmc_plain(density, q0, eps, im, **kw)
    moved = q0 * (1.0 + 1e-6 * torch.randn(q0.shape, generator=g).to(dev))
    pert = linreg_hmc_plain(density, moved, eps, im, **kw)
    calm = _calm(plain.margin) & ((plain.margin < 0) == (pert.margin < 0)).all(dim=0)
    assert float(calm.float().mean()) >= 0.9
    spread = float((pert.draws - plain.draws)[:, calm].abs().max())
    assert float((draws - plain.draws)[:, calm].abs().max()) < max(2e-3, 10 * spread)
    near = int((plain.margin.abs() <= 1e-4).sum())
    assert abs(float(acc) * 40 * chains - float(plain.accepts.sum())) <= near + 0.5


@pytest.mark.parametrize("init_search, seed", [(False, 10), (True, 3)])
def test_k3_kernel_matches_plain_short(dev, init_search, seed):
    """Six warmup steps (search, window fold, harvest) before the pooled
    adaptation's chaos sets in.  The seeds keep every MH decision more than
    1e-3 from its threshold (asserted); the positions then agree to 1e-3,
    ten times the spread a 1e-6 relative change of the start gives the plain
    version here.  Six steps leave a final buffer of one step, so the step
    size is the reference's reset value exp(0) on both sides."""
    density, q0 = _problem(dev)
    kw = dict(num_warmup=6, num_leapfrog=10, block_chains=128)
    q_k, eps_k, im_k = fused_warmup_run(density, q0, seed, 0.1, init_search=init_search,
                                        device=dev, **kw)
    margins = []
    q_p, eps_p, im_p = fused_warmup_plain(density, q0, seed, 0.1, target_accept=0.8,
                                          init_search=init_search, margins=margins, **kw)
    assert float(torch.stack(margins).abs().min()) > 1e-3
    assert float((q_k - q_p).abs().max()) < 1e-3
    torch.testing.assert_close(eps_k, eps_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(im_k, im_p, rtol=1e-3, atol=1e-6)


def _calm(margin, tol=1e-4):
    """Chains none of whose MH decisions lay within ``tol`` of the
    threshold in the plain version: there both take the same decisions."""
    return (margin.abs() > tol).all(dim=0)


@pytest.mark.parametrize("variant", ["fixed", "thin", "moments", "dense", "chees", "gauss",
                                     "staged"])
def test_k4_kernel_matches_plain(dev, variant):
    """60 sampling steps on one noise stream.  On chains that took no
    decision within 1e-4 of its threshold in the plain version (at least 90%
    of them) the kernel agrees to 2e-3; with ChEES the leapfrog counts are
    equal (the same float32 arithmetic on the same per-tile T and eps)."""
    from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
    )

    density, q0 = _problem(dev)
    g = torch.Generator().manual_seed(1)
    eps = (0.15 + 0.05 * torch.rand(C, generator=g)).to(dev)
    im = (torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1]) * (1 + 0.1 * torch.rand((C, 5), generator=g))).to(dev)
    kw = dict(num_steps=60, block_chains=64)
    if variant == "gauss":
        density = DiagGaussianDensity([0.3, -1.0, 0.0, 2.0, 1.0], [0.5, 1.0, 2.0, 4.0, 1.0]).to(dev)
        eps, im = torch.full((C,), 0.9, device=dev), density.scale ** 2
    elif variant == "thin":
        kw["thin"] = 3
    elif variant == "moments":
        kw["collect"] = "moments"
    elif variant == "dense":
        M = torch.diag(torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1]))
        M[0, 1] = M[1, 0] = 0.01
        im, kw["dense_mass"] = M.to(dev), True
    elif variant == "chees":
        kw.update(trajectory="chees", traj_length=torch.linspace(1, 2, C, device=dev),
                  max_leapfrog=16)
    elif variant == "staged":
        kw["noise"] = (torch.randn((60, 8, C), generator=g).to(dev),
                       torch.rand((60, 1, C), generator=g).to(dev))
    counts_k = torch.zeros((60, C // 64), dtype=torch.int32, device=dev)
    counts_p = torch.zeros_like(counts_k)
    chees = variant == "chees"
    before = _build.LAUNCHES["fused_potential_hmc"]
    res = fused_potential_hmc_run(density, q0, 5, eps, im, steps_per_block=60, device=dev,
                                  leapfrog_counts=counts_k if chees else None, **kw)
    assert _build.LAUNCHES["fused_potential_hmc"] == before + 1
    kw.pop("traj_length", None)
    plain = fused_potential_hmc_plain(density, q0, 5, eps, im,
                                      traj_length=torch.linspace(1, 2, C, device=dev) if chees else None,
                                      leapfrog_counts=counts_p if chees else None, **kw)
    torch.cuda.synchronize()
    calm = _calm(plain.margin)
    assert float(calm.float().mean()) >= 0.9
    ref = plain.result
    assert float((res.final_positions - ref.final_positions)[calm].abs().max()) < 2e-3
    if variant == "moments":
        assert float((res.mean - ref.mean)[calm].abs().max()) < 2e-3
    else:
        assert float((res.draws - ref.draws)[:, calm].abs().max()) < 2e-3
    if chees:
        assert torch.equal(counts_k, counts_p)


def test_k4_resume_is_bitwise(dev):
    """Two chained kernel calls with block_offset advanced equal one call
    bit for bit."""
    from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_run

    density, q0 = _problem(dev)
    eps, im = torch.full((C,), 0.2, device=dev), torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    kw = dict(block_chains=64, steps_per_block=20, device=dev)
    one = fused_potential_hmc_run(density, q0, 3, eps, im, num_steps=80, **kw)
    a = fused_potential_hmc_run(density, q0, 3, eps, im, num_steps=40, **kw)
    b = fused_potential_hmc_run(density, a.final_positions, 3, eps, im, num_steps=40,
                                block_offset=2, **kw)
    assert torch.equal(torch.cat([a.draws, b.draws]), one.draws)
    assert torch.equal(b.final_positions, one.final_positions)


@pytest.mark.parametrize("init_search", [False, True])
def test_k3_chees_matches_plain_short(dev, init_search):
    """Six ChEES warmup steps.  The leapfrog counts are equal wherever their
    argument lies clear of an integer.  Trajectories of up to 32 steps at
    step sizes dual averaging is still searching for let float32 rounding
    grow, so the positions (90th percentile over a tile's chains) and the
    metric are held to ten times the distance a 1e-6 relative change of the
    start moves the plain version's (plus 1e-4), on every tile with no MH
    decision within 1e-4 of its threshold."""
    density, q0 = _problem(dev)
    kw = dict(num_warmup=6, num_leapfrog=10, block_chains=64, trajectory="chees",
              max_leapfrog=32, target_accept=0.651, init_search=init_search)
    counts_k = torch.zeros((6, C // 64), dtype=torch.int32, device=dev)
    counts_p = torch.zeros_like(counts_k)
    q_k, eps_k, im_k, T_k = fused_warmup_run(density, q0, 4, 0.1, leapfrog_counts=counts_k,
                                             device=dev, **kw)
    margins, args = [], []
    q_p, eps_p, im_p, T_p = fused_warmup_plain(density, q0, 4, 0.1, margins=margins,
                                               leap_args=args, leapfrog_counts=counts_p, **kw)
    g = torch.Generator().manual_seed(5)
    q_s, _, im_s, _ = fused_warmup_plain(
        density, q0 * (1 + 1e-6 * torch.randn(q0.shape, generator=g).to(dev)), 4, 0.1, **kw)
    x = torch.stack(args)
    integral = (x - torch.round(x)).abs() < 1e-5 * x
    assert bool(((counts_k == counts_p) | integral).all())
    tiles = C // 64
    calm = ~(torch.stack(margins).abs() < 1e-4).reshape(6, tiles, 64).any(2).any(0)
    calm &= (counts_k == counts_p).all(0)
    dq = lambda a: (a - q_p).abs().amax(1).reshape(tiles, 64).quantile(0.9, dim=1)
    dm = lambda a: ((a - im_p).abs() / im_p).reshape(tiles, 64 * 5).amax(1)
    assert bool(calm.any())
    assert bool((dq(q_k) <= 10 * dq(q_s) + 1e-4)[calm].all())
    assert bool((dm(im_k) <= 10 * dm(im_s) + 1e-4)[calm].all())
    torch.testing.assert_close(eps_k, eps_p, rtol=1e-4, atol=0)
    assert bool((T_k >= eps_k * (1 - 1e-6)).all()) and bool((T_k <= 32 * eps_k * (1 + 1e-6)).all())


@pytest.mark.parametrize("trajectory, init_search", [("fixed", False), ("fixed", True),
                                                    ("chees", False)])
def test_k3_bits_do_not_depend_on_the_grid(dev, trajectory, init_search):
    """K3's slice partials are summed in an order fixed by (C, block_chains,
    G) alone: the whole grid (every chain in registers), half of it and
    one CTA (rounds through device memory) give the same bits, and so does
    a repeat."""
    from binf_tpu_torch.ops.kernels.fused_potential import fused_warmup_geometry

    density, q0 = _problem(dev)
    kw = dict(num_warmup=30, num_leapfrog=10, block_chains=128, trajectory=trajectory,
              max_leapfrog=32, init_search=init_search, device=dev)
    full = fused_warmup_geometry(density, C, 128, trajectory=trajectory, device=dev)
    assert full.resident and full.ctas == C * full.lanes // 256 and full.ctas > 1
    runs = [fused_warmup_run(density, q0, 6, 0.1, cta_cap=cap, **kw)
            for cap in (None, None, full.ctas // 2, 1)]
    assert not fused_warmup_geometry(density, C, 128, cta_cap=1, device=dev).resident
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert torch.equal(x, y)
    assert bool(torch.isfinite(runs[0][0]).all())


def test_k3_rounds_beyond_the_card_match_plain(dev):
    """Twice the chains the card holds at once (C x G over occupancy x SMs x
    256 threads): CTAs loop over rounds of chains kept in device memory.
    Six steps against the plain version, as chip_smoke.py's K3 check
    (:func:`_six_steps`, 512-chain tiles)."""
    from binf_tpu_torch.ops.kernels.fused_potential import (
        _max_ctas,
        fused_warmup_geometry,
        lanes_for,
    )

    density, _ = _problem(dev)
    G = lanes_for(density)
    n = 2 * _max_ctas(density, 5, G, density.V.device) * 256 // G
    n -= n % 512
    assert not fused_warmup_geometry(density, n, 512, device=dev).resident
    g = torch.Generator().manual_seed(11)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((n, 5), generator=g)).to(dev)
    ok, summary, eps_k, eps_p = _six_steps(density, q0, 10, 512, dev)
    assert ok, summary
    assert torch.equal(eps_k, eps_p)


def _six_steps(density, q0, seed, bc, dev):
    """chip_smoke.py's six-step K3 check, kernel against plain version: a
    tile agrees when at most 1% of its chains part by more than 1e-3 and
    its metric lies within 1e-2, or when its positions and metric lie
    within ten times the distance a 1e-6 relative change of the start
    moves the plain version's (plus 1e-4: a tile of few chains adapts its
    step size to each chain's acceptance, which a trajectory amplifies),
    unless one of its decisions lay within reach of rounding (within 1e-4
    of its threshold, or within ten times the distance the moved start
    shifted it: a flipped decision moves the tile's pooled step size); at
    most a quarter of the tiles may be excused so.  The distances are the
    largest over three random changes of the start: one change may move a
    chain's sensitive direction by little, three rarely all do.  Returns
    whether the check holds, a summary, and the two step sizes."""
    kw = dict(num_warmup=6, num_leapfrog=10, block_chains=bc)
    q_k, eps_k, im_k = fused_warmup_run(density, q0, seed, 0.1, device=dev, **kw)
    margins = []
    pk = dict(target_accept=0.8, init_search=False, **kw)
    q_p, eps_p, im_p = fused_warmup_plain(density, q0, seed, 0.1, margins=margins, **pk)
    m_p = torch.stack(margins)
    tiles = q0.shape[0] // bc

    def dist(q, im):
        return ((q - q_p).abs().amax(1).reshape(tiles, bc).amax(1),
                ((im - im_p).abs() / im_p).reshape(tiles, bc * 5).amax(1))

    shifts, q_dists, rel_dists = [], [], []
    for k in range(3):
        noise = torch.randn(q0.shape, generator=torch.Generator().manual_seed(6 + k))
        margins_s = []
        q_s, _, im_s = fused_warmup_plain(density, q0 * (1.0 + 1e-6 * noise.to(dev)), seed, 0.1,
                                          margins=margins_s, **pk)
        shifts.append(torch.nan_to_num((torch.stack(margins_s) - m_p).abs(), nan=0.0))
        q_dist, rel_dist = dist(q_s, im_s)
        q_dists.append(q_dist)
        rel_dists.append(rel_dist)
    shift = torch.stack(shifts).amax(0)
    q_ds, rel_s = torch.stack(q_dists).amax(0), torch.stack(rel_dists).amax(0)
    near = (m_p.abs() < 1e-4 + 10.0 * shift).reshape(-1, tiles, bc).any(2).any(0)
    parted = ((q_k - q_p).abs().amax(1) > 1e-3).reshape(tiles, bc).float().mean(1)
    q_dk, rel_i = dist(q_k, im_k)
    agree = (((parted <= 0.01) & (rel_i <= 1e-2))
             | ((q_dk <= 10 * q_ds + 1e-4) & (rel_i <= 10 * rel_s + 1e-4)))
    excused = int((~agree & near).sum())
    ok = bool(torch.isfinite(q_k).all()) and bool((agree | near).all()) and excused <= tiles // 4
    bad = torch.nonzero(~agree & ~near).flatten()[:4]
    summary = (f"{int(agree.sum())} of {tiles} tiles agree, {excused} excused, "
               f"{int((~agree & ~near).sum())} not: tiles {bad.tolist()}, positions "
               f"{q_dk[bad].tolist()} (moved start {q_ds[bad].tolist()}), metric "
               f"{rel_i[bad].tolist()} (moved start {rel_s[bad].tolist()})")
    return ok, summary, eps_k, eps_p


@pytest.mark.parametrize("n, bc", [(1 << 20, 128), (16411, 1)])
def test_k3_tiles_beyond_shared_memory_match_plain(dev, n, bc):
    """A CTA whose chains span more tiles than its shared memory holds
    states for (2^20 chains in tiles of 128; a prime count of chains, one
    chain a tile, as auto_block_chains picks it) keeps them in device
    memory: six steps against the plain version (:func:`_six_steps`)."""
    from binf_tpu_torch.ops.kernels.fused_potential import (
        K3_MAX_CTA_TILES,
        fused_warmup_geometry,
    )
    from binf_tpu_torch.samplers.fused import auto_block_chains

    density, _ = _problem(dev)
    assert fused_warmup_geometry(density, n, bc, device=dev).tiles_per_cta > K3_MAX_CTA_TILES
    if bc == 1:
        assert auto_block_chains(n) == 1
    g = torch.Generator().manual_seed(12)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((n, 5), generator=g)).to(dev)
    ok, summary, eps_k, eps_p = _six_steps(density, q0, 10, bc, dev)
    assert ok, summary
    assert torch.equal(eps_k, eps_p)


@pytest.mark.parametrize("trajectory", ["fixed", "chees"])
def test_k3_tile_states_in_device_memory_give_the_same_bits(dev, trajectory):
    """Tiles of 16 chains: on the whole grid each CTA's chains span 8 tiles
    (states in shared memory); on 4 CTAs, 256 (states in device memory).
    The bits depend on (C, block_chains, G) alone, so both give the same."""
    from binf_tpu_torch.ops.kernels.fused_potential import (
        K3_MAX_CTA_TILES,
        fused_warmup_geometry,
    )

    density, _ = _problem(dev)
    n = 16384
    g = torch.Generator().manual_seed(13)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((n, 5), generator=g)).to(dev)
    assert fused_warmup_geometry(density, n, 16, device=dev).tiles_per_cta <= K3_MAX_CTA_TILES
    assert fused_warmup_geometry(density, n, 16, cta_cap=4,
                                 device=dev).tiles_per_cta > K3_MAX_CTA_TILES
    kw = dict(num_warmup=30, num_leapfrog=10, block_chains=16, trajectory=trajectory,
              max_leapfrog=32, device=dev)
    shared = fused_warmup_run(density, q0, 6, 0.1, **kw)
    spilled = fused_warmup_run(density, q0, 6, 0.1, cta_cap=4, **kw)
    for x, y in zip(shared, spilled):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(shared[0]).all())


@pytest.mark.parametrize("trajectory, init_search, per_step", [
    ("fixed", False, 1.0), ("fixed", True, 1.0), ("chees", False, 2.0)])
def test_launch_records_report_the_grid(dev, trajectory, init_search, per_step):
    """K3 and K4 record the grid their launch reported: K3 cooperative on
    the geometry's CTAs of 256 threads, one grid barrier a fixed step and
    two a ChEES step counted by its barrier word (plus one a search trial);
    K4 on C G / 128 CTAs of 128 threads, not cooperative, no barrier."""
    from binf_tpu_torch.ops.kernels._build import last_launch
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_run,
        fused_warmup_geometry,
        lanes_for,
    )

    density, q0 = _problem(dev)
    out = fused_warmup_run(density, q0, 3, 0.1, num_warmup=30, block_chains=128,
                           trajectory=trajectory, max_leapfrog=32, init_search=init_search,
                           device=dev)
    geo = fused_warmup_geometry(density, C, 128, trajectory=trajectory, device=dev)
    rec = last_launch["fused_warmup"]
    assert (rec.lanes, rec.ctas, rec.threads, rec.cooperative, rec.rounds) == (
        geo.lanes, geo.ctas, 256, True, geo.rounds)
    assert rec.barriers_per_step() == per_step == geo.barriers_per_step
    assert rec.barriers() == 30 * per_step + (21 if init_search else 0)
    fused_potential_hmc_run(density, out[0], 4, out[1], out[2], num_steps=20,
                            steps_per_block=20, block_chains=128, device=dev)
    rec = last_launch["fused_potential_hmc"]
    G = lanes_for(density)
    assert (rec.lanes, rec.ctas, rec.threads, rec.cooperative) == (G, C * G // 128, 128, False)
    assert rec.barriers_per_step() == 0.0


def test_other_kernels_record_their_grid(dev):
    """K1, K5, K6 and K8 record the grid (CTAs, threads a CTA) their launch
    reported, as the C entry points compute it."""
    from binf_tpu_torch.ops.kernels.fused_gibbs import fused_linreg_gibbs_run
    from binf_tpu_torch.ops.kernels.leapfrog import quadratic_leapfrog
    from binf_tpu_torch.ops.kernels.pairwise import (
        _scratch,
        pairwise_forces_cuda,
        pairwise_loss_cuda,
    )

    def grid(name):
        rec = _build.last_launch[name]
        return rec.ctas, rec.threads

    prng.philox_noise(1, prng.TAG_SAMPLE, 1000, 3, 5, device=dev)
    assert grid("philox") == (-(-3000 // 256), 256)
    density, q0 = _gibbs_problem(dev)
    fused_linreg_gibbs_run(q0, 8, density.V, density.y, density.prior_var, 1.0, 0.2,
                           num_steps=10, block_chains=64, steps_per_block=10, device=dev)
    assert grid("fused_gibbs") == (-(-C // 128), 128)
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randn((300, 3), generator=g, device=dev)
    logD = torch.randn((300, 300), generator=g, device=dev)
    W = (torch.rand((300, 300), generator=g, device=dev) < 0.3).float()
    pairwise_loss_cuda(X, logD, W)
    pairwise_forces_cuda(X, logD, W)
    tiles = _scratch("binf_pairwise_tiles", 300)
    assert grid("pairwise_fwd") == (tiles, 256)
    # K6b: a warp a row, 8 rows a CTA; 300 is a multiple of 4
    assert grid("pairwise_bwd") == (-(-300 // 8), 256)
    assert _build.last_launch["pairwise_bwd"].route == "vector"
    A = torch.eye(64, device=dev)
    q = torch.zeros((100, 64), device=dev)
    quadratic_leapfrog(q, q, A, torch.zeros(64, device=dev), 0.1, 4, device=dev)
    # K8's tensor route: 4 warps of 16 chains a CTA
    assert grid("quadratic_leapfrog") == (-(-100 // 64), 128)
    assert _build.last_launch["quadratic_leapfrog"].route == "tensor"
    q = torch.zeros((100, 200), device=dev)
    quadratic_leapfrog(q, q, torch.eye(200, device=dev), torch.zeros(200, device=dev), 0.1, 4,
                       device=dev)
    ctas, threads = grid("quadratic_leapfrog")
    assert threads == 256 and 1 <= ctas <= 100
    assert _build.last_launch["quadratic_leapfrog"].route == "simt"
    torch.cuda.synchronize()


def _linreg(dev, n, D, chains=C):
    """A random linear regression of n rows and D - 1 coefficients, chains
    near the truth, and a diagonal metric from the posterior's curvature."""
    rng = np.random.default_rng(10 * n + D)
    V = rng.normal(size=(n, D - 1)).astype(np.float32)
    truth = rng.normal(size=D - 1)
    y = (V @ truth + rng.normal(size=n) / 2.0).astype(np.float32)
    density = LinregDensity(torch.tensor(V), torch.tensor(y), torch.full((D - 1,), 5.0),
                            1.0, 0.2).to(dev)
    start = np.append(truth, np.log(4.0))
    q0 = torch.tensor(start + 0.05 * rng.normal(size=(chains, D)), dtype=torch.float32)
    im = np.append(1.0 / (4.0 * (V ** 2).sum(0) + 0.2), 2.0 / n)
    return density, q0.to(dev), torch.tensor(im, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("n", [7, 20, 33])
@pytest.mark.parametrize("D", [2, 5, 8])
def test_k4_lane_split_matches_plain(dev, monkeypatch, n, D):
    """K4 with a chain's rows split over G lanes (G = 2, 4, 8 at n = 7, 20,
    33, set for the test; 7 and 33 rows leave lanes with unequal counts)
    against the plain version, which adds the rows in their natural order,
    over 60 steps: on chains with no decision within 1e-4 of its threshold
    (at least 90%) the draws agree to 2e-3."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
    )

    density, q0, im = _linreg(dev, n, D)
    monkeypatch.setattr(fp, "lanes_for", lambda density: {7: 2, 20: 4, 33: 8}[n])
    kw = dict(num_steps=60, block_chains=64)
    res = fused_potential_hmc_run(density, q0, 9, 0.2, im, steps_per_block=60, device=dev, **kw)
    plain = fused_potential_hmc_plain(density, q0, 9, 0.2, im, **kw)
    torch.cuda.synchronize()
    calm = _calm(plain.margin)
    assert float(calm.float().mean()) >= 0.9
    assert 0.2 < float(plain.result.accept_rate) < 1.0
    assert float((res.draws - plain.result.draws)[:, calm].abs().max()) < 2e-3
    assert float((res.final_positions - plain.result.final_positions)[calm].abs().max()) < 2e-3


def test_k4_uninstantiated_width_raises(dev, monkeypatch):
    """A lane width the kernels were not instantiated for is refused by
    the launch, with the CUDA error's name; nothing falls back."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp

    density, q0 = _problem(dev)
    monkeypatch.setattr(fp, "lanes_for", lambda density: 3)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        fp.fused_potential_hmc_run(density, q0, 1, 0.2, torch.ones(5, device=dev),
                                   num_steps=10, steps_per_block=10, block_chains=64,
                                   device=dev)


def test_k3_refused_cooperative_launch_raises(dev, monkeypatch):
    """A grid larger than the card holds at once is refused by the
    cooperative launch and raises with the CUDA error's name."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp

    density, _ = _problem(dev)
    G = fp.lanes_for(density)
    n = 2 * fp._max_ctas(density, 5, G, density.V.device) * 256 // G
    q0 = torch.zeros((n, 5), device=dev)
    monkeypatch.setattr(fp, "_max_ctas", lambda *args: 10 ** 6)
    with pytest.raises(RuntimeError, match="cudaErrorCooperativeLaunchTooLarge"):
        fp.fused_warmup_run(density, q0, 1, 0.1, num_warmup=2, block_chains=n, device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        fp.fused_warmup_run(density, q0[:256], 1, 0.1, num_warmup=2, block_chains=128,
                            cta_cap=0, device=dev)


def _gibbs_problem(dev, chains=C):
    density, _ = _problem(dev)
    g = torch.Generator().manual_seed(2)
    q0 = torch.cat([1.0 + 0.1 * torch.randn((chains, 4), generator=g), torch.ones((chains, 1))],
                   1).to(dev)
    return density, q0


@pytest.mark.parametrize("staged", [False, True])
def test_k5_kernel_matches_plain(dev, staged):
    """100 collapsed-Gibbs sweeps on one noise stream.  A Gamma round's
    decision flips between the two only within rounding of its threshold;
    on chains none of whose decisions lay within 1e-5 of it in the plain
    version (at least 90% of them) the draws agree to 1e-4, against a
    spread of ~1e-6 that float32 rounding gives here."""
    from binf_tpu_torch.ops.kernels.fused_gibbs import (
        fused_linreg_gibbs_plain,
        fused_linreg_gibbs_run,
    )

    density, q0 = _gibbs_problem(dev)
    noise = None
    if staged:
        g = torch.Generator().manual_seed(8)
        noise = tuple(f((100, 8, C), generator=g).to(dev)
                      for f in (torch.randn, torch.rand, torch.randn))
    before = _build.LAUNCHES["fused_gibbs"]
    draws = fused_linreg_gibbs_run(q0, 8, density.V, density.y, density.prior_var, 1.0, 0.2,
                                   num_steps=100, block_chains=64, noise=noise, device=dev)
    assert _build.LAUNCHES["fused_gibbs"] == before + 1
    plain = fused_linreg_gibbs_plain(density, q0, num_steps=100, seed=8, noise=noise)
    torch.cuda.synchronize()
    calm = (plain.margin > 1e-5).all(dim=0)
    assert float(calm.float().mean()) >= 0.9
    err = ((draws - plain.draws).abs() / plain.draws.abs().clamp_min(1.0))[:, calm]
    assert float(err.max()) < 1e-4
    again = fused_linreg_gibbs_run(q0, 8, density.V, density.y, density.prior_var, 1.0, 0.2,
                                   num_steps=100, block_chains=C, noise=noise, device=dev)
    assert torch.equal(draws, again)


@pytest.mark.parametrize("n", [256, 384, 1001, 4100])
def test_k6_kernels_match_plain(dev, n):
    """The restraint loss within 1e-5 relative of the plain version and the
    gradient within 1e-4 of its largest component (sums in other orders),
    two calls bit for bit equal; N = 384 leaves a ragged column tile of the
    loss, N = 1001 a ragged CTA of the forces (8 rows a CTA) and a row of
    no 16-byte loads, N = 4100 stages the beads for the forces in two
    chunks (4,096 columns at a time)."""
    from binf_tpu_torch.ops.kernels.pairwise import (
        pairwise_forces_plain,
        pairwise_loss_plain,
        pairwise_restraint_loss,
    )

    g = torch.Generator().manual_seed(n)
    X = torch.cumsum(torch.randn((n, 3), generator=g), 0)
    diff = X[:, None] - X[None]
    logD = (0.5 * torch.log((diff * diff).sum(-1) + torch.eye(n))
            + 0.1 * torch.randn((n, n), generator=g))
    logD = 0.5 * (logD + logD.T)
    raw = torch.rand((n, n), generator=g)
    W = ((raw + raw.T) < 0.6).float() * (1 - torch.eye(n))
    X, logD, W = X.to(dev), logD.to(dev), W.to(dev)
    block = 128 if n % 128 == 0 else n
    before = dict(_build.LAUNCHES)
    x = X.clone().requires_grad_()
    loss = pairwise_restraint_loss(x, logD, W, block=block)
    loss.backward()
    assert _build.LAUNCHES["pairwise_fwd"] == before["pairwise_fwd"] + 1
    assert _build.LAUNCHES["pairwise_bwd"] == before["pairwise_bwd"] + 1
    assert _build.last_launch["pairwise_bwd"].route == ("vector" if n % 4 == 0 else "scalar")
    want = pairwise_loss_plain(X, logD, W)
    assert abs(float(loss.detach()) / float(want) - 1.0) < 1e-5
    grad_p = 2.0 * pairwise_forces_plain(X, logD, W)
    assert float((x.grad - grad_p).abs().max()) < 1e-4 * float(grad_p.abs().max())
    x2 = X.clone().requires_grad_()
    loss2 = pairwise_restraint_loss(x2, logD, W, block=block)
    loss2.backward()
    assert torch.equal(loss, loss2) and torch.equal(x.grad, x2.grad)
    g3 = torch.func.grad(lambda q: pairwise_restraint_loss(q, logD, W, block=block))(X)
    assert torch.equal(g3, x.grad)


def test_gamma_draw_on_the_card(dev):
    """A Gamma draw for a tensor on the card happens there, with a generator
    of the card; a CPU generator raises."""
    from binf_tpu_torch.pdf.distributions import gamma_sample

    alpha = torch.full((1000,), 11.0, device=dev)
    with pytest.raises(ValueError, match="cannot draw"):
        gamma_sample(torch.Generator().manual_seed(0), alpha)
    draw = gamma_sample(torch.Generator(device=dev).manual_seed(0), alpha, 2.0)
    assert draw.device == alpha.device
    assert abs(float(draw.mean()) - 5.5) < 0.3


def test_chromatin_sweeps_on_the_card(dev):
    """Three sweeps of the chromatin Gibbs composition at 256 beads on the
    card: each launches K6a L + 2 times (HMC init, L leapfrog steps, the
    precision block) and K6b L + 1 times."""
    from binf_tpu_torch.example.chromatin import (
        make_chromatin_posterior,
        restraint_precision_block,
        synthetic_restraints,
    )
    from binf_tpu_torch.samplers.gibbs import gibbs, hmc_block

    g = torch.Generator(device=dev).manual_seed(0)
    X, D, W = synthetic_restraints(g, 256, observe_frac=0.3, device=dev)
    post = make_chromatin_posterior(D, W, block=256)
    kernel = gibbs({"structure": hmc_block(post, "structure", step_size=3e-3,
                                           num_integration_steps=5),
                    "precision": restraint_precision_block(post)})
    state = kernel.init({"structure": X + 0.3 * torch.randn(X.shape, generator=g, device=dev),
                         "precision": torch.tensor(5.0, device=dev)})
    before = dict(_build.LAUNCHES)
    for _ in range(3):
        state, infos = kernel.step(g, state)
    assert _build.LAUNCHES["pairwise_fwd"] - before["pairwise_fwd"] == 3 * 7
    assert _build.LAUNCHES["pairwise_bwd"] - before["pairwise_bwd"] == 3 * 6
    assert bool(torch.isfinite(state.position["structure"]).all())
    assert state.position["precision"].device.type == "cuda"


def _k7_geometry(chains):
    """K7's launch (csrc/chain_grid.cu::cg_geometry): warps a chain G and
    chains a CTA, as (threads a chain, threads a CTA, CTAs)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G = max(1, (16 * sms) // chains)
    G = 8 if G >= 8 else 4 if G >= 4 else 2 if G >= 2 else 1
    cpc = min(max(1, -(-chains // sms)), 8 // G)
    return 32 * G, 32 * G * cpc, -(-chains // cpc)


def _gram_problem(dev, n=24, chains=16):
    from binf_tpu_torch.example.chromatin import make_gram_logdensity, synthetic_restraints

    g = torch.Generator(device=dev).manual_seed(n)
    X, logD, W = synthetic_restraints(g, n, observe_frac=0.4, device=dev)
    q0 = {"structure": X + 0.05 * torch.randn((chains, n, 3), generator=g, device=dev),
          "precision": torch.full((chains,), float(np.log(20.0)), device=dev)}
    im = {"structure": torch.full((n, 3), 0.5, device=dev), "precision": torch.tensor(0.3, device=dev)}
    return make_gram_logdensity(logD, W, device=dev), q0, im


@pytest.mark.parametrize("n, chains", [(24, 16), (160, 16), (64, 301), (256, 40),
                                       (24, 1100), (40, 1100)])
def test_k7_functor_matches_plain(dev, n, chains):
    """K7's functor alone against the plain potential_and_grad: U within
    1e-5 relative, the gradient within 1e-4 of its largest component (sums
    of up to N^2 terms in other orders).  A group of warps a position: 16
    and 40 positions get 8 warps each, 301 four warps two to a CTA (the
    last CTA holding one), 1,100 one warp eight to a CTA (the last holding
    four), the CTA's positions sharing the staged matrices; one warp a
    position takes each unordered pair once, in tiles of 32 beads (40 beads:
    a second tile of 8); N = 160 and 256 read W and logD from device
    memory, not shared memory."""
    from binf_tpu_torch.ops.kernels.chain_grid import gram_value_and_grad

    gram, q0, _ = _gram_problem(dev, n, chains)
    flat = torch.cat([q0["precision"][:, None], q0["structure"].reshape(chains, -1)],
                     1).contiguous()
    before = _build.LAUNCHES["gram_eval"]
    U, g = gram_value_and_grad(gram, flat)
    assert _build.LAUNCHES["gram_eval"] == before + 1
    rec = _build.last_launch["gram_eval"]
    assert (rec.lanes, rec.threads, rec.ctas) == _k7_geometry(chains)
    U_p, g_p = gram.potential_and_grad(q0)
    torch.cuda.synchronize()
    assert float(((U - U_p).abs() / U_p.abs()).max()) < 1e-5
    gp = torch.cat([g_p["precision"][:, None], g_p["structure"].reshape(chains, -1)], 1)
    assert float((g - gp).abs().max()) < 1e-4 * float(gp.abs().max())
    U2, g2 = gram_value_and_grad(gram, flat)
    assert torch.equal(U, U2) and torch.equal(g, g2)


@pytest.mark.parametrize("collect, staged, n, chains", [
    ("draws", False, 24, 16), ("moments", False, 24, 16), ("draws", True, 24, 16),
    ("draws", False, 64, 301), ("moments", True, 64, 301), ("draws", False, 256, 40),
    ("draws", True, 24, 1100)])
def test_k7_kernel_matches_plain(dev, collect, staged, n, chains):
    """Ten K7 steps at L = 5 on one Philox stream, or on staged noise in the
    JAX layout: on chains with no MH decision within 1e-4 of its threshold
    in the plain version (at least 90%), the kernel agrees to 2e-3.  At 64
    and 256 beads, whose stiffer fields carry rounding further, those
    chains must also keep every decision of the plain version under a 1e-6
    relative change of the start.  Each case prints the spread that change
    gives the plain version and the kernel's error.  The launch's geometry
    is as for the functor: 16 chains run eight warps each, 1,100 one warp
    each, 8 to a CTA sharing the staged matrices, the last CTA holding
    four; 256 beads read them from device memory.  The step shrinks as 1 /
    sqrt(N / 24)."""
    from binf_tpu_torch.ops.kernels.chain_grid import chain_grid_hmc_plain, chain_grid_hmc_run

    gram, q0, im = _gram_problem(dev, n, chains)
    eps = torch.linspace(0.01, 0.02, chains, device=dev) * (24 / n) ** 0.5
    noise = None
    if staged:
        g = torch.Generator(device=dev).manual_seed(4)
        noise = ([torch.randn((10, chains, 1, 1), generator=g, device=dev),
                  torch.randn((10, chains, n, 3), generator=g, device=dev)],
                 torch.rand((10, chains, 1), generator=g, device=dev))
    before = _build.LAUNCHES["chain_grid_hmc"]
    res = chain_grid_hmc_run(gram, q0, 3, eps, im, {}, num_steps=10, num_leapfrog=5,
                             block_chains=1, steps_per_block=5, collect=collect, noise=noise,
                             device=dev)
    assert _build.LAUNCHES["chain_grid_hmc"] == before + 1
    rec = _build.last_launch["chain_grid_hmc"]
    assert (rec.lanes, rec.threads, rec.ctas) == _k7_geometry(chains)
    assert rec.rounds == 1
    kw = dict(num_steps=10, num_leapfrog=5, collect=collect, noise=noise)
    plain = chain_grid_hmc_plain(gram, q0, 3, eps, im, **kw)
    g6 = torch.Generator(device=dev).manual_seed(6)
    moved = {k: v * (1.0 + 1e-6 * torch.randn(v.shape, generator=g6, device=dev))
             for k, v in q0.items()}
    pert = chain_grid_hmc_plain(gram, moved, 3, eps, im, **kw)
    torch.cuda.synchronize()
    calm = _calm(plain.margin)
    kept = calm & ((plain.margin < 0) == (pert.margin < 0)).all(dim=0)
    spread = 0.0
    for k in ("structure", "precision"):
        moved_by = (pert.result.final_positions[k] - plain.result.final_positions[k])[kept]
        spread = max(spread, float(moved_by.abs().max()) if moved_by.numel() else 0.0)
    if n > 24:
        calm = kept
    assert float(calm.float().mean()) >= 0.9
    err = 0.0
    for k in ("structure", "precision"):
        err = max(err, float((res.final_positions[k] - plain.result.final_positions[k])[calm]
                             .abs().max()))
        if collect == "draws":
            err = max(err, float((res.draws[k] - plain.result.draws[k])[:, calm].abs().max()))
    print(f"K7 {collect} staged={staged} N={n} C={chains}: spread {spread:.3g}, "
          f"error {err:.3g}, {int(calm.sum())} of {chains} chains held")
    assert err < 2e-3


@pytest.mark.parametrize("n, chains", [(24, 16), (64, 301), (24, 1100)])
def test_k7_resume_and_repeat_are_bitwise(dev, n, chains):
    from binf_tpu_torch.ops.kernels.chain_grid import chain_grid_hmc_run

    gram, q0, im = _gram_problem(dev, n, chains)
    kw = dict(num_leapfrog=5, block_chains=1, steps_per_block=5, device=dev)
    one = chain_grid_hmc_run(gram, q0, 7, 0.015, im, {}, num_steps=20, **kw)
    again = chain_grid_hmc_run(gram, q0, 7, 0.015, im, {}, num_steps=20, **kw)
    a = chain_grid_hmc_run(gram, q0, 7, 0.015, im, {}, num_steps=10, **kw)
    b = chain_grid_hmc_run(gram, a.final_positions, 7, 0.015, im, {}, num_steps=10,
                           block_offset=2, **kw)
    for k in ("structure", "precision"):
        assert torch.equal(one.draws[k], again.draws[k])
        assert torch.equal(torch.cat([a.draws[k], b.draws[k]]), one.draws[k])


@pytest.mark.parametrize("n, small, big", [(24, 16, 40), (64, 1100, 2048)])
def test_k7_chain_bits_follow_the_launch_geometry(dev, n, small, big):
    """A chain's bits depend on its warps G and on whether the matrices are
    staged, which K7 picks from the chain count, the bead count and the
    card's SM count, not on the other chains: two calls that pick the same
    geometry (16 and 40 chains: eight warps a chain; 1,100 and 2,048 at 64
    beads: one warp a chain, 8 to a CTA, staged) give the first ``small``
    chains the same bits."""
    from binf_tpu_torch.ops.kernels.chain_grid import chain_grid_hmc_run

    gram, q0, im = _gram_problem(dev, n, big)
    kw = dict(num_steps=10, num_leapfrog=5, block_chains=1, steps_per_block=5, device=dev)
    whole = chain_grid_hmc_run(gram, q0, 7, 0.015 * (24 / n) ** 0.5, im, {}, **kw)
    rec_big = _build.last_launch["chain_grid_hmc"]
    part = chain_grid_hmc_run(gram, {k: v[:small].contiguous() for k, v in q0.items()}, 7,
                              0.015 * (24 / n) ** 0.5, im, {}, **kw)
    rec_small = _build.last_launch["chain_grid_hmc"]
    assert rec_small.lanes == rec_big.lanes == _k7_geometry(small)[0] == _k7_geometry(big)[0]
    assert rec_small.threads == rec_big.threads
    for k in ("structure", "precision"):
        assert torch.equal(part.draws[k], whole.draws[k][:, :small])
        assert torch.equal(part.final_positions[k], whole.final_positions[k][:small])


@pytest.mark.parametrize("C_, D_", [(512, 128), (70, 200), (33, 8), (40, 900)])
def test_k8_kernel_matches_plain(dev, C_, D_):
    """K8 against the plain leapfrog (float32, TF32 off) over L = 16 steps,
    and its potential at the final positions against the plain one, within
    1e-4 of the largest value: the tensor route's 3xTF32 products at D =
    128 and 8, the SIMT route's float32 FMA at D = 200, with its 32-chain
    tiles cut to fit A, and at D = 900, which streams A through shared
    memory in chunks of rows; a ragged last tile (C = 70, 33, 40)."""
    from binf_tpu_torch.ops.kernels.leapfrog import (
        quadratic_leapfrog,
        quadratic_leapfrog_reference,
        quadratic_potential,
    )

    g = torch.Generator().manual_seed(D_)
    M = 0.05 * torch.randn((D_, D_), generator=g)
    A = (M @ M.T + torch.eye(D_)).to(dev)
    b, im = torch.randn(D_, generator=g).to(dev), (0.5 + torch.rand(D_, generator=g)).to(dev)
    q, p = (torch.randn((C_, D_), generator=g).to(dev) for _ in range(2))
    before = _build.LAUNCHES["quadratic_leapfrog"]
    qk, pk, Uk = quadratic_leapfrog(q, p, A, b, 0.1, 16, inv_mass=im, device=dev,
                                    return_potential=True)
    assert _build.LAUNCHES["quadratic_leapfrog"] == before + 1
    assert _build.last_launch["quadratic_leapfrog"].route == ("tensor" if D_ <= 128 else "simt")
    qp, pp = quadratic_leapfrog_reference(q, p, A, b, 0.1, 16, im)
    Up = quadratic_potential(qp, A, b)
    torch.cuda.synchronize()
    for x, y in ((qk, qp), (pk, pp), (Uk, Up)):
        assert float((x - y).abs().max()) < 1e-4 * float(y.abs().max())


@pytest.mark.parametrize("case", ["nonsymmetric", "ragged_d", "no_steps"])
def test_k8_tensor_route_matches_plain(dev, case):
    """K8's tensor route against the plain leapfrog within 1e-4 of the
    largest value, and two calls equal bit for bit: a non-symmetric A (the
    gradient is q A - b, a row vector times A), D = 37 (padded to 40
    columns inside the kernel) with a ragged last warp, and num_steps = 0
    (one product serves both half kicks and U at the start)."""
    from binf_tpu_torch.ops.kernels.leapfrog import (
        quadratic_leapfrog,
        quadratic_leapfrog_reference,
        quadratic_potential,
    )

    C_, D_, L_ = {"nonsymmetric": (300, 64, 16), "ragged_d": (101, 37, 16),
                  "no_steps": (80, 128, 0)}[case]
    g = torch.Generator().manual_seed(7 + D_)
    M = 0.05 * torch.randn((D_, D_), generator=g)
    A = M @ M.T + torch.eye(D_)
    if case == "nonsymmetric":
        A = A + 0.05 * torch.randn((D_, D_), generator=g)
    A = A.to(dev)
    b, im = torch.randn(D_, generator=g).to(dev), (0.5 + torch.rand(D_, generator=g)).to(dev)
    q, p = (torch.randn((C_, D_), generator=g).to(dev) for _ in range(2))
    eps = torch.tensor(0.1, device=dev)
    out = quadratic_leapfrog(q, p, A, b, eps, L_, inv_mass=im, device=dev,
                             return_potential=True)
    assert _build.last_launch["quadratic_leapfrog"].route == "tensor"
    again = quadratic_leapfrog(q, p, A, b, eps, L_, inv_mass=im, device=dev,
                               return_potential=True)
    qp, pp = quadratic_leapfrog_reference(q, p, A, b, 0.1, L_, im)
    Up = quadratic_potential(qp, A, b)
    torch.cuda.synchronize()
    for x, y in zip(out, (qp, pp, Up)):
        assert float((x - y).abs().max()) < 1e-4 * float(y.abs().max())
    assert all(torch.equal(x, y) for x, y in zip(out, again))


def test_quadratic_hmc_on_the_card(dev):
    """``quadratic_hmc`` with ``use_pallas=None`` on the card: K8 once at
    init and once a step, the state's potential K8's own, equal to the plain
    potential of the state's positions within 1e-4 of its largest value."""
    from binf_tpu_torch.ops.kernels.leapfrog import quadratic_potential
    from binf_tpu_torch.samplers.quadratic_hmc import quadratic_hmc

    g = torch.Generator(device=dev).manual_seed(0)
    M = 0.05 * torch.randn((64, 64), generator=g, device=dev)
    A, b = M @ M.T + torch.eye(64, device=dev), torch.randn(64, generator=g, device=dev)
    kernel = quadratic_hmc(A, b, 0.15, 16)
    before = _build.LAUNCHES["quadratic_leapfrog"]
    state = kernel.init(torch.randn((300, 64), generator=g, device=dev))
    for _ in range(5):
        state, info = kernel.step(g, state)
    assert _build.LAUNCHES["quadratic_leapfrog"] == before + 6
    want = quadratic_potential(state.position, A, b)
    torch.cuda.synchronize()
    assert float((state.potential - want).abs().max()) < 1e-4 * float(want.abs().max())
    assert float(info.accepted.float().mean()) > 0.8


def _polynomial_xla(device, key, **kw):
    from binf_tpu_torch.example.polynomial import make_posterior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    rng = np.random.default_rng(3)
    xs = np.linspace(-2, 2, 20).astype(np.float32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    init = {"coefficients": (0.1 * rng.normal(size=(64, 4))).astype(np.float32),
            "precision": np.zeros(64, np.float32)}
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    return fused_model_hmc(tld, init, key, block_chains=32, warmup="xla", device=device, **kw)


def test_fused_model_hmc_xla_warmup_on_the_card(dev):
    """``fused_model_hmc(warmup="xla")`` on the card: the eager window warmup
    there, then one K4 launch; the polynomial posterior's moments agree
    with the same call on the CPU (other noise) within five times their
    Monte Carlo error at 64 chains x 150 kept draws, as the CPU test holds
    them against the JAX package."""
    kw = dict(num_warmup=150, num_samples=200)
    before = _build.LAUNCHES["fused_potential_hmc"]
    card = _polynomial_xla(dev, 0, **kw)
    assert _build.LAUNCHES["fused_potential_hmc"] == before + 1
    host = _polynomial_xla("cpu", 0, **kw)
    assert card.samples["coefficients"].device.type == "cuda"
    assert card.step_size.dim() == 0 and card.inverse_mass.shape == (5,)

    def summary(s):
        c = s["coefficients"][50:].reshape(-1, 4).cpu().numpy()
        return c.mean(0), c.std(0), np.exp(s["precision"][50:].cpu().numpy()).mean()

    (cm, cs, cp), (hm, hs, hp) = summary(card.samples), summary(host.samples)
    np.testing.assert_allclose(cm, hm, atol=0.05)
    np.testing.assert_allclose(cs, hs, rtol=0.15)
    assert cp == pytest.approx(hp, rel=0.1)
    assert 0.6 < float(card.accept_rate) < 0.95


def test_fused_model_hmc_xla_per_chain_step_size_on_the_card(dev):
    """``warmup="xla"`` with ``per_chain_step_size``: a step size per chain
    on the card, positive, and K4 launched once with them."""
    before = _build.LAUNCHES["fused_potential_hmc"]
    res = _polynomial_xla(dev, 1, num_warmup=60, num_samples=50, per_chain_step_size=True)
    assert _build.LAUNCHES["fused_potential_hmc"] == before + 1
    assert res.step_size.shape == (64,) and res.step_size.device.type == "cuda"
    assert bool((res.step_size > 0).all())
    assert bool(torch.isfinite(res.samples["coefficients"]).all())
