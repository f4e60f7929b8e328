"""Philox4x32-10 (K1's counterpart): known-answer vectors, the exact
uniform construction of ``prng.py::_uniform``, and normal moments."""

import numpy as np
import pytest
import torch

from binf_tpu_torch.ops.kernels.prng import (
    TAG_SAMPLE,
    TAG_WARMUP,
    UNIFORM_SLOT,
    bits_to_normal,
    bits_to_uniform,
    philox4x32_10,
    philox_bits,
    philox_noise,
    step_noise,
)

_M = 0xFFFFFFFF


@pytest.mark.parametrize(
    "ctr,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((_M, _M, _M, _M), (_M, _M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(ctr, key, expected):
    """Random123's known-answer vectors for philox4x32-10."""
    out = philox4x32_10(torch.tensor([ctr], dtype=torch.int64), key)
    assert tuple(out[0].tolist()) == expected
    seed = key[0] | (key[1] << 32)
    assert tuple(philox_bits(torch.tensor([ctr], dtype=torch.int64), seed)[0].tolist()) == expected


def test_uniforms_are_offset_23_bit_grid():
    """u = (2k + 1) / 2^24 exactly: never 0 or 1, half an ulp from the grid."""
    bits = torch.tensor([0, 1, (1 << 23) - 1, 1 << 23, _M, 0x12345678], dtype=torch.int64)
    u = bits_to_uniform(bits)
    assert u.dtype == torch.float32
    scaled = u.double() * (1 << 24)
    np.testing.assert_array_equal(scaled.numpy(),
                                  (2 * (bits & ((1 << 23) - 1)) + 1).double().numpy())
    assert float(u.min()) == 2.0 ** -24 and float(u.max()) == 1.0 - 2.0 ** -24
    z, uu = step_noise(3, TAG_SAMPLE, torch.arange(20000), 0, 5)
    assert float(uu.min()) > 0.0 and float(uu.max()) < 1.0


def test_normal_moments():
    z, u = step_noise(11, TAG_WARMUP, torch.arange(100000), 7, 5)
    assert z.shape == (100000, 5) and u.shape == (100000,)
    flat = z.double().flatten()
    n = flat.numel()
    # 5 sigma bounds for the sample mean, variance, skew and uniform mean
    assert abs(float(flat.mean())) < 5 / n ** 0.5
    assert abs(float(flat.var()) - 1.0) < 5 * (2 / n) ** 0.5
    assert abs(float((flat ** 3).mean())) < 5 * (15 / n) ** 0.5
    assert abs(float(u.double().mean()) - 0.5) < 5 * (1 / 12 / 100000) ** 0.5
    # coordinates are uncorrelated
    corr = np.corrcoef(z.double().numpy().T)
    assert np.abs(corr - np.eye(5)).max() < 5 / 100000 ** 0.5


def test_step_noise_layout():
    """Normals 2s, 2s+1 come from slot s; the uniform from UNIFORM_SLOT;
    the counter is (chain, step, slot, tag)."""
    seed, tag, step, chain = 0x1234_5678_9ABC, TAG_SAMPLE, 42, 17
    z, u = step_noise(seed, tag, torch.tensor([chain]), step, 3)
    key = (seed & _M, seed >> 32)
    for s in range(2):
        b = philox4x32_10(torch.tensor([[chain, step, s, tag]]), key)[0]
        assert float(z[0, 2 * s]) == float(bits_to_normal(b[0], b[1]))
        if 2 * s + 1 < 3:
            assert float(z[0, 2 * s + 1]) == float(bits_to_normal(b[2], b[3]))
    b = philox4x32_10(torch.tensor([[chain, step, UNIFORM_SLOT, tag]]), key)[0]
    assert float(u[0]) == float(bits_to_uniform(b[0]))


def test_noise_does_not_depend_on_chain_batching():
    """A chain's noise is a function of (seed, chain, step) alone."""
    z_all, u_all = philox_noise(5, TAG_SAMPLE, 64, 3, 5, step0=10, device="cpu")
    z_one, u_one = step_noise(5, TAG_SAMPLE, torch.tensor([37]), 12, 5)
    assert torch.equal(z_all[2, 37], z_one[0]) and torch.equal(u_all[2, 37], u_one[0])
    z_other, _ = philox_noise(6, TAG_SAMPLE, 64, 3, 5, step0=10, device="cpu")
    assert not torch.equal(z_all, z_other)
