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
from binf_tpu_torch.ops.kernels.fused_potential import (
    FAMILY_WIDTHS,
    fused_warmup_plain,
    fused_warmup_run,
)
from binf_tpu_torch.ops.math import vandermonde

pytestmark = pytest.mark.cuda

C = 256


# seconds a test may take once the kernels are built; the tests that run
# plain versions over many chains or steps get more
_TIME_LIMIT_S = 60
_LONGER_S = {"test_k3_tiles_beyond_shared_memory_match_plain": 180,
             "test_k3_rounds_beyond_the_card_match_plain": 120,
             "test_k7_kernel_matches_plain": 120,
             "test_k5_shapes_match_plain": 120,
             # the first use of a traced density builds its two units
             "test_traced_density_on_the_card": 300,
             # the first use of a traced density in K7 builds its unit
             "test_k7_traced_group_form_matches_torch_func": 300,
             "test_k7_traced_constants_past_shared_memory": 300,
             # the first use of a wide traced density builds its units
             "test_wide_functor_matches_torch_func": 600,
             "test_wide_k4_matches_plain": 600,
             "test_wide_k3_matches_plain": 600,
             "test_wide_k7_matches_plain": 600}


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


@pytest.mark.parametrize("C,steps,d", [(256, 5, 1), (100, 7, 2), (33, 4, 3), (160, 3, 4),
                                        (1000, 9, 5), (64, 2, 6), (77, 5, 7), (31, 6, 8)])
def test_philox_noise_shapes_match_plain(dev, C, steps, d):
    """Every D and ragged chain counts (a last warp part full: its rows go
    out as floats, the full warps' as 16-byte stores)."""
    z_k, u_k = prng.philox_noise(21, prng.TAG_RUN, C, steps, d, step0=5, device=dev)
    z_p, u_p = prng.philox_noise_plain(21, prng.TAG_RUN, C, steps, d, step0=5, device=dev)
    assert z_k.shape == (steps, C, d) and torch.equal(u_k, u_p)
    assert float((z_k - z_p).abs().max()) <= 1e-5


def test_philox_uniforms_every_23_bit_value(dev):
    """The device functions' uniforms equal the plain version's over every
    23-bit value, whatever the 9 high bits."""
    k = torch.arange(1 << 23, dtype=torch.int64, device=dev)
    bits = k | (torch.randint(0, 1 << 9, k.shape, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(3)) << 23)
    assert torch.equal(prng.noise_parts("uniform", bits), prng.bits_to_uniform(bits))


def test_philox_conversions_against_float64(dev):
    """Box-Muller's radius over every 23-bit value of u1 and its cosine over
    every value of u2 against float64 on the same bits, and the normal on
    2^24 drawn pairs: no larger an error than the previous logf/cosf/sqrtf
    form's (radius ~2.5e-7 against ~3.5e-7, cosine ~1.9e-7 against ~3.8e-7,
    normal ~8e-7 against ~1.8e-6 on an H100)."""
    k = torch.arange(1 << 23, dtype=torch.int64, device=dev)
    u = (2.0 * k.double() + 1.0) / 2.0 ** 24
    for part, ref in (("radius", torch.sqrt(-2.0 * torch.log(u))),
                      ("cosine", torch.cos(2.0 * np.pi * u))):
        new, old = (float((prng.noise_parts(part, k, reference=r).double() - ref).abs().max())
                    for r in (False, True))
        assert new <= old, (part, new, old)
    g = torch.Generator(device=dev).manual_seed(4)
    b1, b2 = (torch.randint(0, 1 << 32, (1 << 24,), generator=g, device=dev) for _ in range(2))
    u1, u2 = ((2.0 * (b & 0x7FFFFF).double() + 1.0) / 2.0 ** 24 for b in (b1, b2))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
    new, old = (float((prng.noise_parts("normal", b1, b2, reference=r).double() - z).abs().max())
                for r in (False, True))
    assert new <= old, (new, old)
    assert float((prng.noise_parts("normal", b1, b2) - prng.bits_to_normal(b1, b2)).abs().max()) \
        <= 1e-5


def test_philox_step_cycles_fall(dev):
    """One step's noise at D = 5 takes fewer cycles than in the previous
    logf/cosf/sqrtf form (~1,770 cycles a step on an H100)."""
    new, old = (float(prng.step_noise_cycles(r, 32, 32, 200, device=dev).double().median())
                for r in (False, True))
    assert new < old, (new, old)


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
    """K1, K5, K6 and K8 record the grid (CTAs, threads a CTA; K5 also its
    lanes a chain and whether its rows sat in registers) their launch
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

    # K1: 256 chains a CTA, 16 steps a thread (csrc/philox.cu): 4 x 1 CTAs
    prng.philox_noise(1, prng.TAG_SAMPLE, 1000, 3, 5, device=dev)
    assert grid("philox") == (-(-1000 // 256) * -(-3 // 16), 256)
    prng.philox_noise(1, prng.TAG_SAMPLE, 1000, 40, 5, device=dev)
    assert grid("philox") == (4 * 3, 256)
    density, q0 = _gibbs_problem(dev)
    fused_linreg_gibbs_run(q0, 8, density.V, density.y, density.prior_var, 1.0, 0.2,
                           num_steps=10, block_chains=64, steps_per_block=10, device=dev)
    # K5: 4 lanes a chain at n = 20, d = 4, every row in registers, CTAs of 128
    rec = _build.last_launch["fused_gibbs"]
    assert (rec.lanes, rec.ctas, rec.threads, rec.rows_in_registers) == (4, C * 4 // 128, 128,
                                                                        True)
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


def _k5_run(density, q0, seed, steps, noise, lanes):
    from binf_tpu_torch.ops.kernels.fused_gibbs import _gibbs_cuda

    return _gibbs_cuda(density, q0, num_steps=steps, seed=seed, noise=noise, lanes=lanes)


def _k5_against_plain(density, q0, seed, steps, noise, lanes, calm_share=0.9):
    """K5 at each forced G against the plain version on one noise stream: a
    Gamma round's decision flips between the two only within rounding of
    its threshold; on chains none of whose decisions lay within 1e-5 of it
    in the plain version the draws agree to 1e-4, against a spread of
    ~1e-6 that float32 rounding gives here.  Every G gives the same bits,
    and so does the entry point (its own G, any block_chains)."""
    from binf_tpu_torch.ops.kernels.fused_gibbs import (
        fused_linreg_gibbs_plain,
        fused_linreg_gibbs_run,
    )

    C_ = q0.shape[0]
    before = _build.LAUNCHES["fused_gibbs"]
    runs = [_k5_run(density, q0, seed, steps, noise, G) for G in lanes]
    assert _build.LAUNCHES["fused_gibbs"] == before + len(lanes)
    assert [_build.last_launch["fused_gibbs"].lanes] == lanes[-1:]
    plain = fused_linreg_gibbs_plain(density, q0, num_steps=steps, seed=seed, noise=noise)
    torch.cuda.synchronize()
    calm = (plain.margin > 1e-5).all(dim=0)
    assert float(calm.float().mean()) >= calm_share
    err = ((runs[0] - plain.draws).abs() / plain.draws.abs().clamp_min(1.0))[:, calm]
    assert float(err.max()) < 1e-4
    for G, draws in zip(lanes[1:], runs[1:]):
        assert torch.equal(draws, runs[0]), f"G={G} parts from G={lanes[0]}"
    for bc in (C_ if C_ % 64 else 64, C_):
        entry = fused_linreg_gibbs_run(q0, seed, density.V, density.y, density.prior_var, 1.0,
                                       0.2, num_steps=steps, d=density.d, block_chains=bc,
                                       steps_per_block=steps, noise=noise, device=q0.device)
        assert torch.equal(entry, runs[0])


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("lanes", [4, 8])
def test_k5_kernel_matches_plain(dev, staged, lanes):
    """100 collapsed-Gibbs sweeps on one noise stream at the forced G, held
    to the plain version (``_k5_against_plain``) and, bit for bit, to the
    other widths and the entry point."""
    density, q0 = _gibbs_problem(dev)
    noise = None
    if staged:
        g = torch.Generator().manual_seed(8)
        noise = tuple(f((100, 8, C), generator=g).to(dev)
                      for f in (torch.randn, torch.rand, torch.randn))
    others = [G for G in (4, 8) if G != lanes]
    _k5_against_plain(density, q0, 8, 100, noise, [lanes] + others)


def _k5_problem(dev, n, d, chains):
    """A random regression of n rows and d coefficients, chains near the
    truth, for K5."""
    rng = np.random.default_rng(100 * n + d)
    V = rng.normal(size=(n, d)).astype(np.float32)
    truth = rng.normal(size=d)
    y = (V @ truth + rng.normal(size=n) / 2.0).astype(np.float32)
    density = LinregDensity(torch.tensor(V), torch.tensor(y), torch.full((d,), 5.0),
                            1.0, 0.2).to(dev)
    start = np.append(truth + 0.05 * rng.normal(size=(chains, d)), np.ones((chains, 1)), 1)
    return density, torch.tensor(start, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("n, d, chains", [(20, 1, 256), (20, 7, 256), (1001, 4, 256),
                                          (37, 7, 77), (20, 4, 77), (1001, 2, 133)])
def test_k5_shapes_match_plain(dev, n, d, chains):
    """d = 1 and 7; n = 20 (every row in registers at G = 4) and 1,001 (most
    rows from shared memory); 77 and 133 chains leave a partial group of 8
    chains a warp and a partial CTA: 60 Philox sweeps at every G against
    the plain version and bit for bit across G and the entry point."""
    density, q0 = _k5_problem(dev, n, d, chains)
    _k5_against_plain(density, q0, 3, 60, None, [4, 8], calm_share=0.8)
    # the entry point's launch: 4 lanes a chain at every n, every row in
    # registers up to 24 rows
    rec = _build.last_launch["fused_gibbs"]
    assert (rec.lanes, rec.rows_in_registers) == (4, n <= 24)


def test_k5_later_rounds_read_only_when_needed(dev):
    """Staged noise whose Gamma rounds 1-3 are NaN wherever round 0
    accepts gives the same draws as the clean noise: the kernel reads a
    later round only after the earlier ones rejected."""
    from binf_tpu_torch.ops.kernels.fused_gibbs import (
        _round_margin,
        gamma_constants,
        fused_linreg_gibbs_run,
    )

    density, q0 = _gibbs_problem(dev)
    g = torch.Generator().manual_seed(12)
    gz, gu, cz = (f((40, 8, C), generator=g).to(dev) for f in (torch.randn, torch.rand,
                                                               torch.randn))
    d, c = gamma_constants(1.0 + 0.5 * density.n)
    v, m = _round_margin(d, c, gz[:, 0], gu[:, 0])
    # round 0 accepts, more than 1e-4 from its threshold (no flip possible)
    took = ((v > 0) & (m < -1e-4))[:, None, :] & (torch.arange(8, device=dev) >= 1)[None, :, None]
    assert 0 < float(took.float().mean())
    poison = (gz.masked_fill(took, float("nan")), gu.masked_fill(took, float("nan")), cz)
    kw = dict(num_steps=40, block_chains=C, steps_per_block=40, device=dev)
    args = (density.V, density.y, density.prior_var, 1.0, 0.2)
    clean = fused_linreg_gibbs_run(q0, 0, *args, noise=(gz, gu, cz), **kw)
    assert torch.equal(fused_linreg_gibbs_run(q0, 0, *args, noise=poison, **kw), clean)
    assert bool(torch.isfinite(clean).all())


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
    from binf_tpu_torch.ops.kernels.chain_grid import group_value_and_grad

    gram, q0, _ = _gram_problem(dev, n, chains)
    flat = torch.cat([q0["precision"][:, None], q0["structure"].reshape(chains, -1)],
                     1).contiguous()
    before = _build.LAUNCHES["group_eval"]
    U, g = group_value_and_grad(gram, flat)
    assert _build.LAUNCHES["group_eval"] == before + 1
    rec = _build.last_launch["group_eval"]
    assert (rec.lanes, rec.threads, rec.ctas) == _k7_geometry(chains)
    U_p, g_p = gram.potential_and_grad(q0)
    torch.cuda.synchronize()
    assert float(((U - U_p).abs() / U_p.abs()).max()) < 1e-5
    gp = torch.cat([g_p["precision"][:, None], g_p["structure"].reshape(chains, -1)], 1)
    assert float((g - gp).abs().max()) < 1e-4 * float(gp.abs().max())
    U2, g2 = group_value_and_grad(gram, flat)
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


def _k7_traced_problem(dev, rows=100, d=3):
    """A logistic regression over ``rows`` data rows with a log-sum-exp and
    a minimum of its scores (the group form strides their sum, maximum and
    minimum over a chain's group): its TracedPotential and log density."""
    from binf_tpu_torch.ops.kernels.chain_grid import (
        TracedPotential,
        chain_grid_potential_from_scalar,
    )

    g = torch.Generator(device=dev).manual_seed(rows)
    X = torch.randn((rows, d), generator=g, device=dev)
    y = (torch.rand(rows, generator=g, device=dev) < 0.5).float()

    def ld(p):
        s = X @ p["w"]
        return (torch.sum(y * s - torch.nn.functional.softplus(s)) - 0.1 * torch.logsumexp(s, 0)
                + 0.01 * torch.amin(s) - 0.5 * torch.sum(p["w"] ** 2))

    pot = chain_grid_potential_from_scalar(ld, {"w": torch.zeros(d, device=dev)})[0]
    assert isinstance(pot, TracedPotential) and pot.compiled.group_rows == rows
    return pot, ld


@pytest.mark.parametrize("warps", [0, 1, 2, 8])
def test_k7_traced_group_form_matches_torch_func(dev, warps):
    """The group form alone (its unit of csrc/chain_grid_shape.cu, built at
    first use) at 300 positions against torch.func: U and grad U within
    1e-5 of the largest |U| and |grad U|; ``warps`` a position (0: K7's
    geometry, no more warps than the 100 rows use); two calls equal bit for
    bit."""
    from binf_tpu_torch.ops.kernels.chain_grid import group_value_and_grad
    from binf_tpu_torch.ops.kernels.densities import CallableDensity

    pot, ld = _k7_traced_problem(dev)
    q = torch.randn((300, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    before = _build.LAUNCHES["group_eval"]
    U, g = group_value_and_grad(pot, q, warps=warps)
    assert _build.LAUNCHES["group_eval"] == before + 1
    lanes = _build.last_launch["group_eval"].lanes
    assert lanes == 32 * warps if warps else lanes == 128
    U_f, g_f = CallableDensity(ld, {"w": q[0]}).potential_and_grad(q)
    torch.cuda.synchronize()
    assert float((U - U_f).abs().max()) <= 1e-5 * float(U_f.abs().max())
    assert float((g - g_f).abs().max()) <= 1e-5 * float(g_f.abs().max())
    U2, g2 = group_value_and_grad(pot, q, warps=warps)
    assert torch.equal(U, U2) and torch.equal(g, g2)


@pytest.mark.parametrize("staged, chains", [(False, 64), (True, 64), (False, 2048)])
def test_k7_traced_kernel_matches_plain(dev, staged, chains):
    """Ten K7 steps at L = 5 on a traced density, on one Philox stream or
    on staged noise: on the chains with no MH decision within 1e-4 of its
    threshold in the plain version (at least 90%), the kernel agrees to
    1e-4; 64 chains run four warps each (the rows' cap), 2,048 one; two
    calls, and two chained calls with block_offset, equal one call bit for
    bit."""
    from binf_tpu_torch.ops.kernels.chain_grid import chain_grid_hmc_plain, chain_grid_hmc_run

    pot, _ = _k7_traced_problem(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    q0 = {"w": 0.3 * torch.randn((chains, 3), generator=g, device=dev)}
    im = {"w": torch.full((3,), 0.5, device=dev)}
    eps = torch.linspace(0.1, 0.3, chains, device=dev)
    noise = None
    if staged:
        noise = ([torch.randn((10, chains, 1, 3), generator=g, device=dev)],
                 torch.rand((10, chains, 1), generator=g, device=dev))
    kw = dict(num_leapfrog=5, block_chains=1, steps_per_block=5, noise=noise, device=dev)
    before = _build.LAUNCHES["chain_grid_hmc"]
    res = chain_grid_hmc_run(pot, q0, 3, eps, im, {}, num_steps=10, **kw)
    assert _build.LAUNCHES["chain_grid_hmc"] == before + 1
    rec = _build.last_launch["chain_grid_hmc"]
    assert rec.lanes == (128 if chains == 64 else 32) and rec.route == "staged"
    plain = chain_grid_hmc_plain(pot, q0, 3, eps, im, num_steps=10, num_leapfrog=5,
                                 noise=noise)
    torch.cuda.synchronize()
    calm = _calm(plain.margin)
    assert float(calm.float().mean()) >= 0.9
    err = float((res.draws["w"] - plain.result.draws["w"])[:, calm].abs().max())
    print(f"K7 traced staged={staged} C={chains}: error {err:.3g}, {int(calm.sum())} of "
          f"{chains} chains held, accept {float(res.accept_rate):.3f}")
    assert err < 1e-4
    again = chain_grid_hmc_run(pot, q0, 3, eps, im, {}, num_steps=10, **kw)
    assert torch.equal(again.draws["w"], res.draws["w"])
    if not staged:
        a = chain_grid_hmc_run(pot, q0, 3, eps, im, {}, num_steps=5, **kw)
        b = chain_grid_hmc_run(pot, a.final_positions, 3, eps, im, {}, num_steps=5,
                               block_offset=1, **kw)
        assert torch.equal(torch.cat([a.draws["w"], b.draws["w"]]), res.draws["w"])


def test_k7_traced_constants_past_shared_memory(dev):
    """A traced density whose constants do not fit a CTA's shared memory (a
    logistic regression over 12,000 rows of 5 features: 72,000 floats)
    runs with them read from device memory: the group form alone at 300
    positions within 1e-5 of torch.func's largest |U| and |grad U|, and ten
    K7 steps at L = 5 on 64 chains (eight warps each) within 1e-4 of the
    plain version on the chains with no MH decision within 1e-4 of its
    threshold (at least 90%)."""
    from binf_tpu_torch.ops.kernels.chain_grid import (
        chain_grid_hmc_plain,
        chain_grid_hmc_run,
        group_value_and_grad,
    )
    from binf_tpu_torch.ops.kernels.densities import CallableDensity

    pot, ld = _k7_traced_problem(dev, rows=12000, d=5)
    assert pot.compiled.operands.numel() * 4 > 232448
    g = torch.Generator(device=dev).manual_seed(5)
    q = 0.3 * torch.randn((300, 5), generator=g, device=dev)
    U, grad = group_value_and_grad(pot, q)
    assert _build.last_launch["group_eval"].route == "streamed"
    U_f, g_f = CallableDensity(ld, {"w": q[0]}).potential_and_grad(q)
    q0 = {"w": 0.02 * torch.randn((64, 5), generator=g, device=dev)}
    im = {"w": torch.ones(5, device=dev)}
    eps = torch.linspace(0.004, 0.008, 64, device=dev)
    kw = dict(num_steps=10, num_leapfrog=5)
    res = chain_grid_hmc_run(pot, q0, 3, eps, im, {}, block_chains=1, steps_per_block=5,
                             device=dev, **kw)
    rec = _build.last_launch["chain_grid_hmc"]
    assert rec.route == "streamed" and rec.lanes == 256
    plain = chain_grid_hmc_plain(pot, q0, 3, eps, im, **kw)
    torch.cuda.synchronize()
    assert float((U - U_f).abs().max()) <= 1e-5 * float(U_f.abs().max())
    assert float((grad - g_f).abs().max()) <= 1e-5 * float(g_f.abs().max())
    calm = _calm(plain.margin)
    assert float(calm.float().mean()) >= 0.9
    err = float((res.draws["w"] - plain.result.draws["w"])[:, calm].abs().max())
    print(f"K7 traced, streamed constants: error {err:.3g}, {int(calm.sum())} of 64 chains "
          f"held, accept {float(res.accept_rate):.3f}")
    assert err < 1e-4


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


def _polynomial_density(n_chains):
    from binf_tpu_torch.example.polynomial import make_posterior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    rng = np.random.default_rng(3)
    xs = np.linspace(-2, 2, 20).astype(np.float32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    init = {"coefficients": torch.tensor(1.0 + 0.1 * rng.normal(size=(n_chains, 4)),
                                         dtype=torch.float32),
            "precision": torch.zeros(n_chains)}
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    return tld, init


def test_run_fused_blocks_resume_on_the_card(dev, tmp_path):
    """``run_fused_blocks(warmup="fused")`` at 2,048 chains: K3 once, one
    K4 launch a block; a run checkpointed after block 2 and resumed to
    block 4 ends where the uninterrupted 4-block run ends, and so does one
    K4 call of all the steps, bit for bit."""
    from binf_tpu_torch.parallel.production import run_fused_blocks

    tld, init = _polynomial_density(2048)
    kw = dict(num_steps=400, block_size=100, num_warmup=200, initial_step_size=0.1,
              block_chains=2048, warmup="fused", device=dev)
    path = str(tmp_path / "blocks.pt")
    k3, k4 = _build.LAUNCHES["fused_warmup"], _build.LAUNCHES["fused_potential_hmc"]
    full = run_fused_blocks(tld, init, 3, **kw)
    assert _build.LAUNCHES["fused_warmup"] == k3 + 1
    assert _build.LAUNCHES["fused_potential_hmc"] == k4 + 4
    assert full.carry.positions.device.type == "cuda"
    run_fused_blocks(tld, init, 3, checkpoint_path=path, checkpoint_every_blocks=2,
                     **dict(kw, num_steps=200))
    resumed = run_fused_blocks(tld, init, 3, checkpoint_path=path, resume=True, **kw)
    assert int(resumed.carry.block) == 4
    for field in ("positions", "mean", "m2", "count", "step_size", "inverse_mass"):
        assert torch.equal(getattr(full.carry, field), getattr(resumed.carry, field)), field
    one = run_fused_blocks(tld, init, 3, **dict(kw, block_size=400))
    assert torch.equal(one.carry.positions, full.carry.positions)
    assert 0.6 < full.accept_rate < 0.95


def test_fused_model_hmc_dense_on_the_card(dev, monkeypatch):
    """``fused_model_hmc(warmup="dense")`` on the card: the eager dense
    warmup there, then one K4 launch with the (D, D) metric.  The same K4
    inputs through the plain version on the CPU: on chains that took no
    decision within 1e-4 of its threshold (at least 90% of them) the draws
    agree to 2e-3 over these 60 steps."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.samplers import fused as fused_mod

    tld, init = _polynomial_density(256)
    calls = []
    run = fused_mod.fused_potential_hmc_run
    monkeypatch.setattr(fused_mod, "fused_potential_hmc_run",
                        lambda *a, **k: calls.append((a, k)) or run(*a, **k))
    before = _build.LAUNCHES["fused_potential_hmc"]
    res = fused_mod.fused_model_hmc(tld, init, 4, num_warmup=150, num_samples=60,
                                    block_chains=64, warmup="dense", device=dev)
    assert _build.LAUNCHES["fused_potential_hmc"] == before + 1
    assert res.inverse_mass.shape == (5, 5) and res.inverse_mass.device.type == "cuda"
    (density, q0, seed, eps, minv), kw = calls[0]
    assert kw["dense_mass"]
    kw = {k: v for k, v in kw.items()
          if k in ("num_steps", "num_leapfrog", "block_chains", "thin", "collect")}
    plain = fp.fused_potential_hmc_plain(density.to("cpu"), q0.cpu(), seed, eps.cpu(),
                                         minv.cpu(), dense_mass=True, **kw)
    calm = _calm(plain.margin).to(dev)
    assert float(calm.float().mean()) >= 0.9
    draws = torch.cat([res.samples["coefficients"], res.samples["precision"][..., None]], -1)
    assert float((draws - plain.result.draws.to(dev))[:, calm].abs().max()) < 2e-3


def test_adaptive_hmc_decisions_on_the_card(dev):
    """The router on the card: the polynomial density runs K3 then K4; a
    plain callable runs them too, through the functor the density compiler
    emits; a callable the compiler refuses (an op with no lowering rule)
    runs the eager path there, every tensor on the card and no kernel
    launched."""
    from binf_tpu_torch.samplers.auto import adaptive_hmc

    tld, init = _polynomial_density(256)
    k3, k4 = _build.LAUNCHES["fused_warmup"], _build.LAUNCHES["fused_potential_hmc"]
    res, d = adaptive_hmc(tld, init, 5, num_warmup=100, num_samples=50, warmup="fused",
                          device=dev)
    assert d.path == "fused" and d.reason.startswith("device density")
    assert (_build.LAUNCHES["fused_warmup"], _build.LAUNCHES["fused_potential_hmc"]) == (k3 + 1,
                                                                                       k4 + 1)
    assert res.samples["coefficients"].device.type == "cuda"

    scale = torch.tensor([1.0, 2.0, 0.5], device=dev)
    k3, k4 = _build.LAUNCHES["fused_warmup"], _build.LAUNCHES["fused_potential_hmc"]
    res, d = adaptive_hmc(lambda p: -0.5 * torch.sum((p["x"] / scale) ** 2),
                          {"x": torch.zeros((128, 3))}, 6, num_warmup=150, num_samples=100,
                          warmup="fused", device=dev)
    assert d.path == "fused" and d.reason.startswith("device density: TracedDensity")
    assert (_build.LAUNCHES["fused_warmup"], _build.LAUNCHES["fused_potential_hmc"]) == (k3 + 1,
                                                                                       k4 + 1)
    assert bool(torch.isfinite(res.samples["x"]).all())
    before = dict(_build.LAUNCHES)
    res, d = adaptive_hmc(
        lambda p: -0.5 * torch.linalg.eigvalsh(torch.diag((p["x"] / scale) ** 2)).sum(),
        {"x": torch.zeros((128, 3))}, 6, num_warmup=150, num_samples=100, device=dev)
    assert d.path == "xla" and d.reason.startswith("not tile-compilable")
    assert _build.LAUNCHES == before
    for x in (res.samples["x"], res.accept_rate, res.step_size, res.inverse_mass,
              res.final_positions["x"]):
        assert x.device.type == "cuda"
    assert bool(torch.isfinite(res.samples["x"]).all())


def _hierarchical(dev, chains, groups, g, s):
    """The hierarchical posterior of ``groups`` groups (data drawn from
    ``g``) under LogTransform, and a start near its bulk (from ``s``)."""
    from binf_tpu_torch.example import hierarchical
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    x, y, c, _ = hierarchical.synthetic_hierarchical_data(g, groups, device=dev)
    ld = transform_logdensity(hierarchical.make_hierarchical_posterior(x, y, c, groups,
                                                                       device=dev).log_prob,
                              {"precision": LogTransform})

    def z(*shape):
        return 0.2 * torch.randn(shape, generator=s).to(dev)

    start = {"group_params": torch.tensor([0.8, 1.2], device=dev) + z(chains, groups, 2),
             "log_tau": -1.3 + z(chains, 2), "mu": torch.tensor([0.8, 1.2], device=dev)
             + z(chains, 2), "precision": 3.2 + z(chains)}
    return ld, start


def _family(name, dev, chains=C):
    """A family with a device density at its published size, its data drawn
    on the card from a fixed seed: (log density, start (chains, D) packed,
    device density)."""
    from binf_tpu_torch.example import logistic, mixture, statespace
    from binf_tpu_torch.ops.kernels.densities import device_density
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    g = torch.Generator(device=dev).manual_seed(7)
    s = torch.Generator().manual_seed(8)
    if name == "logistic":
        X, y = logistic.synthetic_logistic_data(g, device=dev)
        ld = logistic.make_logistic_posterior(X, y, device=dev).log_prob
        start = logistic.initial_positions(chains, s, device=dev)
        start["weights"] = start["weights"] + torch.tensor([1.5, -2.0, 0.75, 0.0, 1.0],
                                                           device=dev)
    elif name == "ar1":
        post = statespace.make_ar1_posterior(statespace.synthetic_ar1_data(g, device=dev),
                                             device=dev)
        ld = transform_logdensity(post.log_prob, {"precision": LogTransform})
        p = statespace.initial_positions(chains, s, device=dev)
        start = {"dynamics": p["dynamics"] + torch.tensor([0.9, 0.5, -1.0], device=dev),
                 "precision": torch.log(p["precision"]) + 3.2}
    elif name == "mixture":
        ld = mixture.make_mixture_posterior(mixture.synthetic_mixture_data(g, device=dev),
                                            device=dev).log_prob
        start = mixture.initial_positions(chains, generator=s, device=dev)
        start["means"] = start["means"] + torch.tensor([-2.0, 0.5, 3.0], device=dev)
    else:
        ld, start = _hierarchical(dev, chains, 8, g, s)
    template = {k: v[0] for k, v in start.items()}
    return ld, pack_positions(start).contiguous(), device_density(ld, template).to(dev)


# each family at every width its functor is instantiated for
# (fused_potential.FAMILY_WIDTHS): one lane and the chosen width
_FAMILY_WIDTHS = [(name, G) for name, functor in (("logistic", "LogisticDensity"),
                                                  ("ar1", "AR1Density"),
                                                  ("mixture", "MixtureDensity"),
                                                  ("hierarchical", "HierarchicalDensity"))
                  for G in FAMILY_WIDTHS[functor]]


@pytest.mark.parametrize("name, G", _FAMILY_WIDTHS)
def test_family_functor_matches_plain_and_torch_func(dev, name, G):
    """One launch of the family's functor (``density_eval``, G lanes a
    point) at 256 points against its plain version and torch.func of the
    posterior, at 1e-4 relative to the largest |U| and |grad U|."""
    from binf_tpu_torch.ops.kernels.densities import CallableDensity, density_eval
    from binf_tpu_torch.ops.kernels.fused_potential import pack_template

    ld, q, density = _family(name, dev)
    q = q + 0.3 * torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    before = _build.LAUNCHES["density_eval"]
    U, g = density_eval(density, q, device=dev, lanes=G)
    assert _build.LAUNCHES["density_eval"] == before + 1
    assert _build.last_launch["density_eval"].lanes == G
    Up, gp = density.potential_and_grad(q)
    names = pack_template({"logistic": {"weights": torch.zeros(5)},
                           "ar1": {"dynamics": torch.zeros(3), "precision": torch.zeros(())},
                           "mixture": {"log_sigma": torch.zeros(()),
                                       "log_weights": torch.zeros(3),
                                       "means": torch.zeros(3)},
                           "hierarchical": {"group_params": torch.zeros((8, 2)),
                                            "log_tau": torch.zeros(2), "mu": torch.zeros(2),
                                            "precision": torch.zeros(())}}[name])
    template = {n: torch.zeros(shape) for n, shape, _ in names}
    Uf, gf = CallableDensity(ld, template).potential_and_grad(q)
    for a, b in ((U, Up), (g, gp), (U, Uf), (g, gf)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


@pytest.mark.parametrize("name, G", [(n, G) for n, G in _FAMILY_WIDTHS if n != "hierarchical"])
def test_family_k3_k4_match_plain(dev, monkeypatch, name, G):
    """K3 (6 steps) and K4 (30 steps) with the family's functor at G lanes
    a chain against their plain versions on one Philox stream: on chains
    that took no decision within 1e-4 of its threshold in the plain
    version (at least 90% of them) the positions agree to 2e-3, and the
    six-step warmup's step size is the reset value on both sides.  K4
    runs from a warmed state (200 K3 steps at the chosen width, as
    chip_smoke.py's family check starts it), where the chains held are
    those whose decisions lay beyond 1e-3 of the threshold, the reach
    chip_smoke.py's flip_check gives rounding (there the one-lane
    mixture flipped a decision just past 1e-4 of its threshold: its |U|
    is a few hundred, so its sums' order moves an energy by more than at
    the cold start), and at one lane also
    from the cold start: there a lane group's order of the row sums parts
    chains by more than rounding (the plain mixture's own draws move by
    3-6e-3 when that start moves by 1e-6 relative)."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
    )

    eps = {"logistic": 0.12, "ar1": 0.01, "mixture": 0.04}[name]
    _, q0, density = _family(name, dev)
    kw = dict(num_warmup=6, num_leapfrog=10, block_chains=128)
    warm = fused_warmup_run(density, q0, 10, eps, num_warmup=200, num_leapfrog=10,
                            block_chains=128, device=dev)
    monkeypatch.setattr(fp, "lanes_for", lambda density: G)
    q_k, eps_k, im_k = fused_warmup_run(density, q0, 11, eps, device=dev, **kw)
    margins = []
    q_p, eps_p, im_p = fused_warmup_plain(density, q0, 11, eps, target_accept=0.8,
                                          init_search=False, margins=margins, **kw)
    calm = _calm(torch.stack(margins))
    assert float(calm.float().mean()) >= 0.9
    assert float((q_k - q_p)[calm].abs().max()) < 2e-3
    torch.testing.assert_close(eps_k, eps_p, rtol=1e-4, atol=0)
    assert _build.last_launch["fused_warmup"].lanes == G

    cold = (q0, torch.full((C,), eps, device=dev), torch.ones_like(q0))
    run = dict(num_steps=30, block_chains=64)
    starts = {"warm": (*warm, 1e-3), "cold": (*cold, 1e-4)}
    for start, (q, e, im, reach) in starts.items():
        if start == "cold" and G > 1:
            continue
        before = _build.LAUNCHES["fused_potential_hmc"]
        res = fused_potential_hmc_run(density, q, 5, e, im, steps_per_block=30, device=dev, **run)
        assert _build.LAUNCHES["fused_potential_hmc"] == before + 1
        assert _build.last_launch["fused_potential_hmc"].lanes == G
        plain = fused_potential_hmc_plain(density, q, 5, e, im, **run)
        torch.cuda.synchronize()
        calm = _calm(plain.margin, reach)
        assert float(calm.float().mean()) >= 0.9, start
        assert 0.2 < float(res.accept_rate) < 1.0, start
        err = float((res.draws - plain.result.draws)[:, calm].abs().max())
        assert err < 2e-3, (start, err)


@pytest.mark.parametrize("name, G", [("logistic", 3), ("mixture", 64), ("ar1", 64),
                                     ("hierarchical", 16), ("hierarchical", 32)])
def test_family_width_not_instantiated_raises(dev, monkeypatch, name, G):
    """A width no kernel takes (a lane group is a power of two up to 32
    lanes, and the hierarchical posterior's lanes own whole groups of its
    8) is refused by K4's launch and by density_eval with the CUDA error's
    name, and by K3's geometry first where the width is past any lane
    group; nothing is built for it and nothing falls back to another width
    or to the plain version.  Any other width runs, built at first use
    (``test_family_width_built_at_first_use``)."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.densities import density_eval

    _, q0, density = _family(name, dev)
    monkeypatch.setattr(fp, "lanes_for", lambda density: G)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        fp.fused_potential_hmc_run(density, q0, 1, 0.05, torch.ones_like(q0), num_steps=5,
                                   steps_per_block=5, block_chains=64, device=dev)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        density_eval(density, q0, device=dev)
    with pytest.raises((RuntimeError, ValueError), match="cudaErrorInvalidValue|instantiated"):
        fp.fused_warmup_run(density, q0, 1, 0.05, num_warmup=2, block_chains=64, device=dev)


@pytest.mark.parametrize("name, G", [("logistic", 4), ("mixture", 16), ("ar1", 8),
                                     ("hierarchical", 2)])
def test_family_width_built_at_first_use(dev, monkeypatch, name, G):
    """A width no unit of csrc instantiates is built at first use
    (``_build.shape_libraries``): the functor (``density_eval``) at 256
    points against the plain version at 1e-4 relative, and K4 (30 steps
    from a warmed state; the hierarchical posterior at half the adapted
    step, as ``test_hierarchical_k3_k4_match_plain`` runs it) against its
    plain version, to 2e-3 on the chains whose decisions lay beyond 1e-3 of
    their threshold and whose plain draws a 1e-6 move of the start moves
    by at most 2e-4 (``_plain_spread``; at least 70% of them)."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.densities import FAMILIES, density_eval
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
    )

    eps = {"logistic": 0.12, "ar1": 0.01, "mixture": 0.04, "hierarchical": 0.02}[name]
    _, q0, density = _family(name, dev)
    assert G not in FAMILY_WIDTHS[density.functor]
    q, e, im = fused_warmup_run(density, q0, 10, eps, num_warmup=200, num_leapfrog=10,
                                block_chains=128, device=dev)
    monkeypatch.setattr(fp, "lanes_for", lambda density: G)
    assert fp._libraries(density, G) == _build.shape_names(FAMILIES[density.functor],
                                                           density.D, G)
    pts = q0 + 0.3 * torch.randn(q0.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    U, g = density_eval(density, pts, device=dev)
    assert _build.last_launch["density_eval"].lanes == G
    Up, gp = density.potential_and_grad(pts)
    for a, b in ((U, Up), (g, gp)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    run = dict(num_steps=30, block_chains=64)
    e = 0.5 * e if name == "hierarchical" else e
    res = fused_potential_hmc_run(density, q, 5, e, im, steps_per_block=30, device=dev, **run)
    assert _build.last_launch["fused_potential_hmc"].lanes == G
    plain = fused_potential_hmc_plain(density, q, 5, e, im, **run)
    torch.cuda.synchronize()
    held = _calm(plain.margin, 1e-3) & (_plain_spread(density, q, 5, e, im, run) <= 2e-4)
    err = (res.draws - plain.result.draws).abs().amax(dim=(0, 2))
    assert float(held.float().mean()) >= 0.7
    assert float(err[held].max()) < 2e-3


def test_family_fused_model_hmc_on_the_card(dev):
    """``fused_model_hmc(warmup="fused")`` runs each family on the card
    through K3 and K4 (no CallableDensity), at a sane acceptance, the
    hierarchical posterior of 8 groups among them; at 20 groups, past the
    2 to 16 the kernels run, it has no functor and raises there, and does
    not run eager instead."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_template, unpack_draws
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    for name in ("logistic", "ar1", "mixture", "hierarchical"):
        ld, q0, density = _family(name, dev, chains=512)
        names = {"logistic": {"weights": (5,)}, "ar1": {"dynamics": (3,), "precision": ()},
                 "mixture": {"log_sigma": (), "log_weights": (3,), "means": (3,)},
                 "hierarchical": {"group_params": (8, 2), "log_tau": (2,), "mu": (2,),
                                  "precision": ()}}[name]
        start = unpack_draws(q0, pack_template({k: torch.zeros(s) for k, s in names.items()}))
        before = dict(_build.LAUNCHES)
        res = fused_model_hmc(ld, start, 3, num_warmup=200, num_samples=100, warmup="fused",
                              device=dev)
        for k in ("fused_warmup", "fused_potential_hmc"):
            assert _build.LAUNCHES[k] == before[k] + 1
        assert 0.5 < float(res.accept_rate) < 1.0
        assert all(bool(torch.isfinite(v).all()) for v in res.samples.values())
    ld, start = _hierarchical(dev, 8, 20, torch.Generator(device=dev).manual_seed(1),
                              torch.Generator().manual_seed(2))
    before = dict(_build.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no CUDA functor"):
        fused_model_hmc(ld, start, 0, warmup="fused", device=dev)
    assert dict(_build.LAUNCHES) == before


def _plain_spread(density, q, seed, eps, im, run, reps=3, **kw):
    """Per chain, the largest move of the plain K4's draws when its start
    moves by 1e-6 relative (``reps`` moves): where a trajectory amplifies
    rounding, the plain version parts from itself this far."""
    from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_plain

    base = fused_potential_hmc_plain(density, q, seed, eps, im, **run, **kw).result.draws
    spread = torch.zeros(q.shape[0], device=q.device)
    for k in range(reps):
        g = torch.Generator(device=q.device).manual_seed(100 + k)
        moved = q * (1.0 + 1e-6 * torch.randn(q.shape, generator=g, device=q.device))
        d = fused_potential_hmc_plain(density, moved, seed, eps, im, **run, **kw).result.draws
        spread = torch.maximum(spread, (d - base).abs().amax(dim=(0, 2)))
    return spread


@pytest.mark.parametrize("G", FAMILY_WIDTHS["HierarchicalDensity"])
def test_hierarchical_k3_k4_match_plain(dev, monkeypatch, G):
    """K3 (6 steps) and K4 (30 steps) with the hierarchical functor (D =
    21) at G lanes a chain against their plain versions on one Philox
    stream.  K3 as the families' (chains whose decisions lay past 1e-4 of
    their thresholds, at least 90%, to 2e-3; the reset step size).  K4
    from a state warmed by 200 K3 steps, twice: at half the adapted step,
    where the leapfrog is stable at nearly every chain, and at the
    adapted step, where the funnel in log_tau makes more trajectories
    unstable and rounding grows through them to O(1).  At both, every
    chain that the plain version itself keeps within 2e-4 under three
    1e-6 relative moves of the start, and whose decisions lay past 1e-3
    of their thresholds, agrees to 2e-3, ten times that; such chains are
    at least 70% at half the step and 25% at the full one.  (On an NVIDIA
    H100 80GB HBM3 at 700 W: 87% and 37%, the kernel within 1.2e-4 and 1.7e-4 on them; the plain
    version parted from itself by more than 2e-3 on 10 and 66 chains, by
    up to 2.0, and every chain where kernel and plain parted by more than
    2e-3 was among those.)  The data and the start come from seeded
    generators: two draws of them are equal."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
    )

    _, q0, density = _family("hierarchical", dev)
    _, q0_again, density_again = _family("hierarchical", dev)
    assert torch.equal(q0, q0_again) and all(
        torch.equal(a, b) for a, b in zip(density.buffers(), density_again.buffers()))
    kw = dict(num_warmup=6, num_leapfrog=10, block_chains=128)
    q, e, im = fused_warmup_run(density, q0, 10, 0.02, num_warmup=200, num_leapfrog=10,
                                block_chains=128, device=dev)
    monkeypatch.setattr(fp, "lanes_for", lambda density: G)
    q_k, eps_k, _ = fused_warmup_run(density, q0, 11, 0.02, device=dev, **kw)
    margins = []
    q_p, eps_p, _ = fused_warmup_plain(density, q0, 11, 0.02, target_accept=0.8,
                                       init_search=False, margins=margins, **kw)
    calm = _calm(torch.stack(margins))
    assert float(calm.float().mean()) >= 0.9
    assert float((q_k - q_p)[calm].abs().max()) < 2e-3
    torch.testing.assert_close(eps_k, eps_p, rtol=1e-4, atol=0)
    assert _build.last_launch["fused_warmup"].lanes == G
    run = dict(num_steps=30, block_chains=64)
    for scale in (0.5, 1.0):
        res = fused_potential_hmc_run(density, q, 5, scale * e, im, steps_per_block=30,
                                      device=dev, **run)
        assert _build.last_launch["fused_potential_hmc"].lanes == G
        plain = fused_potential_hmc_plain(density, q, 5, scale * e, im, **run)
        calm = _calm(plain.margin, 1e-3)
        err = (res.draws - plain.result.draws).abs().amax(dim=(0, 2))
        assert 0.2 < float(res.accept_rate) < 1.0, scale
        spread = _plain_spread(density, q, 5, scale * e, im, run)
        held = calm & (spread <= 2e-4)
        print(f"G={G}, step x {scale}: {int((spread > 2e-3).sum())} of {q.shape[0]} chains part "
              f"from the plain version's own draws by > 2e-3 under a 1e-6 move of the start "
              f"(largest {float(spread.max()):.3g}); kernel and plain part by > 2e-3 on "
              f"{int((err > 2e-3).sum())}, of them {int(((err > 2e-3) & held).sum())} held; "
              f"{int(calm.sum())} calm; {int(held.sum())} held, on them the largest error "
              f"{float(err[held].max()):.3g}")
        assert float(held.float().mean()) >= (0.7 if scale < 1.0 else 0.25), scale
        assert float(err[held].max()) < 2e-3, (scale, float(err[held].max()))


@pytest.mark.parametrize("G", FAMILY_WIDTHS["HierarchicalDensity"])
def test_hierarchical_dense_and_chees_match_plain(dev, monkeypatch, G):
    """K4's dense metric (DenseMetric<21>) and K3's and K4's ChEES branches
    at D = 21 against their plain versions, at half the adapted step (the
    leapfrog's stable range at every chain; at the full step the funnel
    amplifies rounding, test_hierarchical_k3_k4_match_plain): on chains
    whose decisions lay beyond 1e-3 of their thresholds in the plain
    version (at least 90% of them) the positions agree to 2e-3; ChEES's
    leapfrog counts agree.  ChEES's jittered trajectories (up to 64
    leapfrogs) can still amplify rounding on a chain: there the kernel's
    normals, which round differently from torch's log/cos/sqrt (by up to
    ~2e-6), part the draws as a 1e-6 move of the start parts the plain
    version from itself, so a calm chain whose plain draws such a move
    shifts by 2e-4 or more is held to twice that shift where it exceeds
    2e-3 (_plain_spread)."""
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
    )

    _, q0, density = _family("hierarchical", dev)
    warm = fused_warmup_run(density, q0, 10, 0.02, num_warmup=200, block_chains=128,
                            device=dev)
    monkeypatch.setattr(fp, "lanes_for", lambda density: G)
    draws = warm[0]
    cov = torch.cov(draws.T.double()).float() + 1e-4 * torch.eye(21, device=dev)
    eps = 0.5 * float(warm[1][0])
    run = dict(num_steps=20, block_chains=64)
    res = fused_potential_hmc_run(density, draws, 5, eps, cov, dense_mass=True,
                                  steps_per_block=20, device=dev, **run)
    plain = fused_potential_hmc_plain(density, draws, 5, eps, cov, dense_mass=True, **run)
    calm = _calm(plain.margin, 1e-3)
    assert float(calm.float().mean()) >= 0.9 and 0.2 < float(res.accept_rate) <= 1.0
    assert float((res.draws - plain.result.draws)[:, calm].abs().max()) < 2e-3
    T = torch.full((C,), 10 * eps, device=dev)
    counts_k = torch.zeros((20, C // 64), dtype=torch.int32, device=dev)
    counts_p = torch.zeros_like(counts_k)
    res = fused_potential_hmc_run(density, draws, 6, eps, warm[2], trajectory="chees",
                                  traj_length=T, max_leapfrog=64, steps_per_block=20,
                                  leapfrog_counts=counts_k, device=dev, **run)
    plain = fused_potential_hmc_plain(density, draws, 6, eps, warm[2], trajectory="chees",
                                      traj_length=T, max_leapfrog=64, leapfrog_counts=counts_p,
                                      **run)
    assert torch.equal(counts_k, counts_p)
    calm = _calm(plain.margin, 1e-3)
    assert float(calm.float().mean()) >= 0.9
    err = (res.draws - plain.result.draws).abs().amax(dim=(0, 2))
    spread = _plain_spread(density, draws, 6, eps, warm[2], run, trajectory="chees",
                           traj_length=T, max_leapfrog=64)
    stable = spread < 2e-4
    print(f"G={G}, ChEES: {int(calm.sum())} of {C} chains calm, {int((calm & ~stable).sum())} "
          f"of them shifted by >= 2e-4 under a 1e-6 move of the start; kernel and plain part "
          f"by > 2e-3 on {int((calm & (err > 2e-3)).sum())} calm chains: err "
          f"{err[calm & (err > 2e-3)].tolist()}, shift {spread[calm & (err > 2e-3)].tolist()}")
    assert float(err[calm & stable].max()) < 2e-3
    assert bool((err[calm & ~stable] <= torch.clamp(2.0 * spread[calm & ~stable],
                                                    min=2e-3)).all())
    # K3's ChEES branch: four steps, its trajectory length and step size
    kw = dict(num_warmup=4, num_leapfrog=10, block_chains=128, trajectory="chees",
              max_leapfrog=64)
    out_k = fused_warmup_run(density, q0, 12, 0.02, target_accept=0.651, device=dev, **kw)
    margins = []
    out_p = fused_warmup_plain(density, q0, 12, 0.02, target_accept=0.651, init_search=False,
                               margins=margins, **kw)
    calm = _calm(torch.stack(margins), 1e-3)
    assert float(calm.float().mean()) >= 0.9
    assert float((out_k[0] - out_p[0])[calm].abs().max()) < 2e-3
    # T pools the tile's chains: one decision taken the other way moves it
    rtol = 1e-3 if bool(calm.all()) else 0.1
    torch.testing.assert_close(out_k[3], out_p[3], rtol=rtol, atol=0)


def test_eager_samplers_on_the_card(dev):
    """MALA, NUTS, both slice samplers and parallel tempering step a chain
    batch on the card with a card generator; a CPU generator raises."""
    from binf_tpu_torch.samplers import mala, nuts, slice, tempering

    def target(p):
        return -0.5 * (p["x"] ** 2).sum(-1)

    start = {"x": torch.zeros((64, 3), device=dev)}
    g = torch.Generator(device=dev).manual_seed(0)
    for kernel in (mala.mala(target, 0.5), nuts.nuts(target, 0.5, 5),
                   slice.slice_sampler(target), slice.elliptical_slice(
                       lambda p: torch.zeros(p["x"].shape[:-1], device=dev),
                       {"x": torch.zeros(3, device=dev)}, {"x": 1.0})):
        state = kernel.init(start)
        for _ in range(3):
            state, _ = kernel.step(g, state)
        assert state.position["x"].device.type == "cuda"
        assert bool(torch.isfinite(state.position["x"]).all())
        with pytest.raises(RuntimeError):
            kernel.step(torch.Generator().manual_seed(0), state)
    pt = tempering.parallel_tempering(target, tempering.geometric_betas(4, 0.1))
    state = pt.init({"x": torch.zeros((16, 4, 3), device=dev)})
    state, info = pt.step(g, state)
    assert info.swap_accepted.shape == (16, 3) and state.positions["x"].device.type == "cuda"


def test_cli_hierarchical_auto_fused_warmup_launches_k3_and_k4(dev):
    """``python -m binf_tpu_torch --model hierarchical --algorithm auto
    --warmup-mode fused`` on the card: routed to the fused kernels, one
    launch each of K3 (the warmup) and K4 (the sampling)."""
    from binf_tpu_torch.cli import main

    before = dict(_build.LAUNCHES)
    out = main(["--model", "hierarchical", "--algorithm", "auto", "--warmup-mode", "fused",
                "--chains", "256", "--warmup", "100", "--samples", "100"])
    assert out["routed_to"] == "fused"
    assert _build.LAUNCHES["fused_warmup"] == before["fused_warmup"] + 1
    assert _build.LAUNCHES["fused_potential_hmc"] == before["fused_potential_hmc"] + 1
    assert 0.3 < out["accept_rate"] <= 1.0


def test_cli_fused_without_a_functor_raises(dev):
    """``--algorithm fused`` on a model with no CUDA functor (the chromatin
    posterior) raises on the card, as ``fused_model_hmc`` does, and falls
    back to nothing: no kernel is launched."""
    from binf_tpu_torch.cli import main

    before = dict(_build.LAUNCHES)
    with pytest.raises(NotImplementedError):
        main(["--model", "chromatin", "--algorithm", "fused", "--chains", "16", "--warmup", "10",
              "--samples", "10"])
    assert _build.LAUNCHES == before


def test_traced_density_on_the_card(dev):
    """A model no family takes (a Student-t polynomial regression with a
    half-normal prior on its scale, under LogTransform) through the density
    compiler: the functor (one density_eval launch at 256 points) against
    torch.func within 1e-4 of the largest |U| and |grad U|, then K3 and K4
    with it, one launch each, at a sane acceptance and finite draws."""
    from binf_tpu_torch.model import PolynomialForwardModel, StudentTErrorModel
    from binf_tpu_torch.ops.kernels import densities
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions
    from binf_tpu_torch.pdf import Likelihood, Posterior
    from binf_tpu_torch.pdf.priors import GaussianPrior, HalfNormalPrior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    g = torch.Generator().manual_seed(0)
    x = torch.linspace(-2, 2, 20)
    y = (vandermonde(x, 4) @ torch.tensor([2.0, -4.0, 1.0, 1.5])
         + 0.5 * torch.randn(20, generator=g)).to(dev)
    lik = Likelihood.create("points", PolynomialForwardModel.create(x.to(dev), 4),
                            StudentTErrorModel.create(y, df=4.0))
    post = Posterior.create({"points": lik}, {
        "c": GaussianPrior.create(torch.zeros(4, device=dev), torch.full((4,), 5.0, device=dev),
                                  variable="coefficients"),
        "s": HalfNormalPrior.create(torch.tensor(1.0, device=dev), variable="scale")})
    ld = transform_logdensity(post.log_prob, {"scale": LogTransform})
    start = {"coefficients": (1.0 + 0.1 * torch.randn((C, 4), generator=g)).to(dev),
             "scale": (-0.5 + 0.1 * torch.randn(C, generator=g)).to(dev)}
    template = {k: v[0] for k, v in start.items()}
    dens = densities.device_density(ld, template).to(dev)
    assert isinstance(dens, densities.TracedDensity)
    q = pack_positions(start) + 0.3 * torch.randn((C, 5), generator=g).to(dev)
    U, gU = densities.density_eval(dens, q, device=dev)
    Uf, gf = densities.CallableDensity(ld, template).potential_and_grad(q)
    assert float((U - Uf).abs().max()) <= 1e-4 * float(Uf.abs().max())
    assert float((gU - gf).abs().max()) <= 1e-4 * float(gf.abs().max())
    before = dict(_build.LAUNCHES)
    res = fused_model_hmc(ld, start, 3, num_warmup=200, num_samples=100, warmup="fused",
                          device=dev)
    for k in ("fused_warmup", "fused_potential_hmc"):
        assert _build.LAUNCHES[k] == before[k] + 1
    assert 0.5 < float(res.accept_rate) < 1.0
    assert all(bool(torch.isfinite(v).all()) for v in res.samples.values())



# -- the wide branches: traced densities past 32 coordinates -------------------------

# the wide models: at one warp a chain (D = 69, 256) and at a group of W
# warps (D = 261: W = 2; 1,024: W = 4; MAX_D_WIDE: W = 8)
_WIDE_ONE_WARP = ["hierarchical32", "gauss256"]
_WIDE_WARPS = ["hierarchical128", "gauss1024"]


def _wide_d(name):
    """D of a wide model by name: hierarchical<G> (2 G + 5), gauss<D>, or
    "cap", a standard normal at density_compiler.MAX_D_WIDE."""
    from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE

    if name == "cap":
        return MAX_D_WIDE
    if name.startswith("hierarchical"):
        return 2 * int(name[len("hierarchical"):]) + 5
    return int(name[len("gauss"):])


def _wide_problem(name, dev, chains):
    """A traced density past 32 coordinates: the hierarchical posterior of
    G groups with a start near its bulk, a D-dimensional Gaussian callable
    (means from seed 0, scales log-spaced 0.1 to 10) with a start drawn
    from it, or ("cap") a standard normal at MAX_D_WIDE coordinates:
    (start (chains, D) packed, TracedDensity, whose plain version is
    torch.func on the callable)."""
    from binf_tpu_torch.ops.kernels.densities import TracedDensity, device_density
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    D = _wide_d(name)
    g = torch.Generator().manual_seed(0)
    if name.startswith("hierarchical"):
        ld, start = _hierarchical(dev, chains, (D - 5) // 2,
                                  torch.Generator(device=dev).manual_seed(7),
                                  torch.Generator().manual_seed(8))
    elif name == "cap":
        def ld(p):
            return -0.5 * torch.sum(p["x"] ** 2)

        start = {"x": torch.randn((chains, D), generator=g).to(dev)}
    else:
        mean = torch.randn(D, generator=g).to(dev)
        scale = torch.logspace(-1, 1, D).to(dev)

        def ld(p):
            return -0.5 * torch.sum(((p["x"] - mean) / scale) ** 2)

        start = {"x": mean + scale * torch.randn((chains, D), generator=g).to(dev)}
    template = {k: v[0] for k, v in start.items()}
    density = device_density(ld, template).to(dev)
    assert isinstance(density, TracedDensity) and density.wide
    return pack_positions(start).contiguous(), density


@pytest.mark.parametrize("name", _WIDE_ONE_WARP + _WIDE_WARPS + ["cap"])
def test_wide_functor_matches_torch_func(dev, name):
    """The wide form (a group of W warps a point, the width K3 and K4 take;
    its K3/K4 units built at first use) at 1,024 points (256 at the cap)
    against torch.func: U and grad U within 1e-5 of the largest |U| and
    |grad U|; two calls equal bit for bit."""
    from binf_tpu_torch.ops.kernels.densities import density_eval
    from binf_tpu_torch.ops.kernels.fused_potential import wide_warps

    q, density = _wide_problem(name, dev, 256 if name == "cap" else 1024)
    q = q + 0.1 * torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(2),
                              device=dev)
    before = _build.LAUNCHES["density_eval"]
    U, g = density_eval(density, q, device=dev)
    assert _build.LAUNCHES["density_eval"] == before + 1
    assert _build.last_launch["density_eval"].warps == wide_warps(density.D)
    U2, g2 = density_eval(density, q, device=dev)
    U_f, g_f = density.potential_and_grad(q)
    torch.cuda.synchronize()
    u_err = float((U - U_f).abs().max() / U_f.abs().max())
    g_err = float((g - g_f).abs().max() / g_f.abs().max())
    print(f"wide functor {name}: U {u_err:.3g}, grad {g_err:.3g} of the largest")
    assert u_err <= 1e-5 and g_err <= 1e-5
    assert torch.equal(U, U2) and torch.equal(g, g2)


_WIDE_K4 = ["staged", "philox", "dense", "chees", "moments", "thin", "resume"]
# at a group of warps: the dense metric (D^2 floats read from device memory)
# at D = 261 only
_WIDE_K4_CASES = ([(n, v) for n in _WIDE_ONE_WARP for v in _WIDE_K4]
                  + [(n, v) for n in _WIDE_WARPS for v in _WIDE_K4
                     if v != "dense" or n == "hierarchical128"]
                  + [("cap", v) for v in ("staged", "philox", "chees")])


@pytest.mark.parametrize("name, variant", _WIDE_K4_CASES)
def test_wide_k4_matches_plain(dev, name, variant):
    """K4's wide branch (a group of W warps a chain) against its plain
    version, 64 chains, 20 steps at L = 10 from a start near the bulk at
    small step sizes: on the chains none of whose decisions lay within 1e-4
    of the threshold in the plain version (at least 90%) the draws agree to
    1e-4 of the scale; staged noise or the kernel's Philox stream, a
    per-chain step size and metric, a dense metric read from device memory,
    ChEES with per-tile T (the leapfrog counts equal), in-kernel moments
    against the run's own draws, thinning and resume bit for bit."""
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_potential_hmc_plain,
        fused_potential_hmc_run,
        wide_warps,
    )

    chains, S = 64, 20
    q0, density = _wide_problem(name, dev, chains)
    D = density.D
    W = wide_warps(D)
    g = torch.Generator().manual_seed(9)
    # ChEES trajectory lengths a tile, scaled with the step below so that
    # the trajectories keep PR 19's leapfrog counts (the dynamics amplify
    # the sums' rounding along a trajectory: at 128 groups T of 1 and 2.5
    # at the smaller step parted calm chains by 1.5e-3 of the scale)
    T_tiles = [1.0, 2.5]
    if name.startswith("hierarchical"):
        # at 128 groups (D = 261) the step of 32 groups accepted 0.23
        step = 0.2 if D <= 256 else 0.1
        T_tiles = [t * step / 0.2 for t in T_tiles]
        im = (0.01 * (1 + 0.1 * torch.rand((chains, D), generator=g))).to(dev)
        eps = (step + 0.1 * torch.rand(chains, generator=g)).to(dev)
    elif name == "cap":
        im = (1 + 0.1 * torch.rand((chains, D), generator=g)).to(dev)
        eps = (0.1 + 0.05 * torch.rand(chains, generator=g)).to(dev)
    else:
        step = 0.3 if D <= 256 else 0.2
        im = (torch.logspace(-1, 1, D) ** 2 * (1 + 0.1 * torch.rand((chains, D),
                                                                     generator=g))).to(dev)
        eps = (step + 0.1 * torch.rand(chains, generator=g)).to(dev)
    kw = dict(num_steps=S, num_leapfrog=10, block_chains=32)
    if variant == "dense":
        A = 0.02 * torch.randn((D, D), generator=g)
        M = torch.diag(im[0].cpu()) + A @ A.T * float(im[0].min())
        kw.update(dense_mass=True)
        im = M.to(dev)
    noise = None
    if variant == "staged":
        gn = torch.Generator(device=dev).manual_seed(12)
        d_pad = (D + 7) // 8 * 8
        noise = (torch.randn((S, d_pad, chains), generator=gn, device=dev),
                 torch.rand((S, 1, chains), generator=gn, device=dev))
    counts_k = counts_p = None
    if variant == "chees":
        T = torch.tensor(T_tiles, device=dev).repeat_interleave(32)
        counts_k = torch.zeros((S, 2), dtype=torch.int32, device=dev)
        counts_p = torch.zeros_like(counts_k)
        kw.update(trajectory="chees", traj_length=T, max_leapfrog=64)
    before = _build.LAUNCHES["fused_potential_hmc"]
    res = fused_potential_hmc_run(density, q0, 21, eps, im, steps_per_block=S // 2,
                                  noise=noise, leapfrog_counts=counts_k, device=dev, **kw)
    assert _build.LAUNCHES["fused_potential_hmc"] == before + 1
    rec = _build.last_launch["fused_potential_hmc"]
    per_cta = max(1, 4 // W)
    assert rec.warps == W and rec.threads == 32 * W * per_cta and rec.ctas == chains // per_cta
    if variant in ("thin", "moments", "resume"):
        if variant == "thin":
            thin = fused_potential_hmc_run(density, q0, 21, eps, im, steps_per_block=S // 2,
                                           thin=2, device=dev, **kw)
            assert torch.equal(thin.draws, res.draws[1::2])
        elif variant == "moments":
            mom = fused_potential_hmc_run(density, q0, 21, eps, im, steps_per_block=S // 2,
                                          collect="moments", device=dev, **kw)
            assert float((mom.mean - res.draws.mean(0)).abs().max()) <= 1e-4 * float(
                res.draws.abs().max())
            v_ref = res.draws.var(0)
            assert float(((mom.variance - v_ref).abs() / v_ref.clamp_min(1e-12)).max()) <= 1e-3
            assert torch.equal(mom.final_positions, res.final_positions)
        else:
            half = dict(kw, num_steps=S // 2)
            a = fused_potential_hmc_run(density, q0, 21, eps, im, steps_per_block=S // 2,
                                        device=dev, **half)
            b = fused_potential_hmc_run(density, a.final_positions, 21, eps, im,
                                        steps_per_block=S // 2, block_offset=1, device=dev,
                                        **half)
            assert torch.equal(torch.cat([a.draws, b.draws]), res.draws)
            assert torch.equal(b.final_positions, res.final_positions)
        return
    plain = fused_potential_hmc_plain(density, q0, 21, eps, im, noise=noise,
                                      leapfrog_counts=counts_p, **kw)
    torch.cuda.synchronize()
    if counts_k is not None:
        assert torch.equal(counts_k, counts_p)
    calm = _calm(plain.margin)
    scale = float(res.draws.abs().max())
    err = float((res.draws - plain.result.draws)[:, calm].abs().max())
    print(f"wide K4 {name} {variant}: {int(calm.sum())} of {chains} calm, error {err:.3g} "
          f"(scale {scale:.3g}), accept {float(res.accept_rate):.3f}, W {W}")
    assert float(calm.float().mean()) >= 0.9
    assert 0.3 < float(res.accept_rate) <= 1.0
    assert err <= 1e-4 * scale


_WIDE_K3_CASES = ([(n, t) for n in _WIDE_ONE_WARP + _WIDE_WARPS for t in ("fixed", "chees")]
                  + [("cap", "fixed")])


@pytest.mark.parametrize("name, trajectory", _WIDE_K3_CASES)
def test_wide_k3_matches_plain(dev, name, trajectory):
    """K3's wide branch against its plain version, 20 warmup steps of 64
    chains in two tiles of 32 (slices of 8 / W chains, the
    tile sums over slices; the final buffer's two steps follow the last
    window boundary), with the step-size search (fixed) or ChEES
    trajectories, one step at a time: before each step the plain version
    restarts from the kernel's state, and after it the positions, Welford
    sums, metric and the adaptation's scalars agree within 1e-4 (decisions
    and counts within 1e-3 of rounding followed, no count apart beyond it),
    the outputs within 1e-5 of the kernel's final state; the same grid with
    rounds (cta_cap 2) gives the same bits.  The adaptation's scalars are
    held to 1e-4 x max(1, D / 1,024): they follow the chains' acceptance
    from E0 - E1, a difference of energies ~D / 2 whose float32 spacing
    grows with D, amplified by dual averaging's sqrt(t) / 0.05 (at D =
    1,024 they moved 2.3e-5, at the cap 1.2e-4)."""
    from binf_tpu_torch.ops.kernels.fused_potential import (
        fused_warmup_run,
        wide_warmup_stepwise,
        wide_warps,
    )

    chains, steps = 64, 20
    q0, density = _wide_problem(name, dev, chains)
    kw = dict(num_warmup=steps, num_leapfrog=10, block_chains=32)
    if trajectory == "chees":
        kw.update(trajectory="chees", max_leapfrog=32, target_accept=0.651)
    else:
        kw.update(init_search=True)
    eps0 = 0.05
    before = _build.LAUNCHES["fused_warmup"]
    out_k = fused_warmup_run(density, q0, 11, eps0, device=dev, **kw)
    assert _build.LAUNCHES["fused_warmup"] == before + 1
    rec = _build.last_launch["fused_warmup"]
    assert rec.warps == wide_warps(density.D) and rec.cooperative
    again = fused_warmup_run(density, q0, 11, eps0, device=dev, cta_cap=2, **kw)
    assert _build.last_launch["fused_warmup"].rounds > 1
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    records = wide_warmup_stepwise(density, q0, 11, eps0, **kw)
    torch.cuda.synchronize()
    worst = {k: max(r[k] for r in records) for k in ("q", "mean", "m2", "im", "scalars")}
    print(f"wide K3 {name} {trajectory}: worst step {worst}, followed "
          f"{sum(r['followed'] for r in records)}, outputs {records[-1]['out']}, eps "
          f"{out_k[1][::32].tolist()}")
    assert len(records) == steps + 1
    scalars = 1e-4 * max(1.0, density.D / 1024)
    assert all(v <= (scalars if k == "scalars" else 1e-4) for k, v in worst.items())
    assert sum(r["counts_off"] for r in records) == 0
    assert all(v <= 1e-5 for v in records[-1]["out"].values())


@pytest.mark.parametrize("name", ["hierarchical32"] + _WIDE_WARPS + ["cap"])
@pytest.mark.parametrize("staged", [False, True])
def test_wide_k7_matches_plain(dev, name, staged):
    """K7 on the wide form of the hierarchical posterior of 32 groups (D =
    69) and of the wide models past 256 coordinates: ten steps at L = 5 of
    64 chains (more warps a chain) on staged noise or the kernel's Philox
    stream; on the chains none of whose decisions lay within 1e-4 of the
    threshold (at least 90%) the draws agree to 1e-4 of the scale; two
    calls equal bit for bit."""
    from binf_tpu_torch.ops.kernels.chain_grid import (
        TracedPotential,
        _noise_shape,
        chain_grid_hmc_plain,
        chain_grid_hmc_run,
        chain_grid_potential_from_scalar,
    )
    from binf_tpu_torch.ops.kernels.fused_potential import unpack_draws

    chains = 64
    if name.startswith("hierarchical"):
        ld, start = _hierarchical(dev, chains, (_wide_d(name) - 5) // 2,
                                  torch.Generator(device=dev).manual_seed(7),
                                  torch.Generator().manual_seed(8))
        im = {k: torch.full(v.shape[1:], 0.01, device=dev) for k, v in start.items()}
        eps = torch.linspace(0.15, 0.25, chains, device=dev)
    else:
        q0_flat, density = _wide_problem(name, dev, chains)
        ld = density._plain.logdensity_fn
        start = unpack_draws(q0_flat, density._plain.spec)
        D = density.D
        im = {"x": torch.ones(D, device=dev) if name == "cap"
              else torch.logspace(-1, 1, D, device=dev) ** 2}
        eps = torch.linspace(0.1, 0.15, chains, device=dev)
    pot = chain_grid_potential_from_scalar(ld, {k: v[0] for k, v in start.items()})[0]
    assert isinstance(pot, TracedPotential) and pot.compiled.wide
    q0 = {k: v.contiguous() for k, v in start.items()}
    noise = None
    if staged:
        g = torch.Generator(device=dev).manual_seed(3)
        noise = ([torch.randn((10, chains) + _noise_shape(shape), generator=g, device=dev)
                  for _, shape, _ in pot.spec], torch.rand((10, chains, 1), generator=g,
                                                           device=dev))
    kw = dict(num_leapfrog=5, block_chains=1, steps_per_block=5, noise=noise, device=dev)
    before = _build.LAUNCHES["chain_grid_hmc"]
    res = chain_grid_hmc_run(pot, q0, 3, eps, im, {}, num_steps=10, **kw)
    assert _build.LAUNCHES["chain_grid_hmc"] == before + 1
    plain = chain_grid_hmc_plain(pot, q0, 3, eps, im, num_steps=10, num_leapfrog=5,
                                 noise=noise)
    again = chain_grid_hmc_run(pot, q0, 3, eps, im, {}, num_steps=10, **kw)
    torch.cuda.synchronize()
    calm = _calm(plain.margin)
    flat_k = torch.cat([res.draws[n].reshape(10, chains, -1) for n, _, _ in pot.spec], -1)
    flat_p = torch.cat([plain.result.draws[n].reshape(10, chains, -1) for n, _, _ in pot.spec],
                       -1)
    scale = float(flat_p.abs().max())
    err = float((flat_k - flat_p)[:, calm].abs().max())
    print(f"wide K7 {name} staged={staged}: {int(calm.sum())} of {chains} calm, error "
          f"{err:.3g} (scale {scale:.3g}), accept {float(res.accept_rate):.3f}, "
          f"{_build.last_launch['chain_grid_hmc'].lanes} lanes a chain")
    assert float(calm.float().mean()) >= 0.9
    assert err <= 1e-4 * scale
    assert all(torch.equal(res.draws[n], again.draws[n]) for n in res.draws)
