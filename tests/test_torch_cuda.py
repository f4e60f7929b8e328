"""The CUDA kernels against their plain versions, at small shapes, on the
card.  Marked ``cuda``: each test skips on a host without a CUDA card.
On the card: ``python -m pytest tests/test_torch_cuda.py -q``.  The
full-width comparisons are ``chip_smoke.py``'s."""

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


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
