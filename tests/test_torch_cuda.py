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
