"""Philox4x32-10 (K1's counterpart): known-answer vectors, the exact
uniform construction of ``prng.py::_uniform``, normal moments, the plain
conversions against the JAX package's ``_uniform``/``_normal`` on the same
bits, and the exact reductions the device conversions (``csrc/philox.cuh``)
rest on, mirrored in torch over every 23-bit value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from binf_tpu.ops.pallas import prng as jax_prng
from binf_tpu_torch.ops.kernels.prng import (
    TAG_SAMPLE,
    TAG_WARMUP,
    UNIFORM_SLOT,
    bits_to_normal,
    bits_to_uniform,
    noise_parts,
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


def _edge_bits(n_random: int, seed: int) -> np.ndarray:
    """uint32 bits whose 23 low bits hold k = 0, 2^23 - 1, the quadrant
    boundaries of u2 (k = 2^21 j - 1, 2^21 j) and random values, under
    random high bits."""
    rng = np.random.default_rng(seed)
    edges = [0, (1 << 23) - 1] + [(j << 21) + d for j in range(1, 4) for d in (-1, 0)]
    k = np.concatenate([np.array(edges, dtype=np.int64),
                        rng.integers(0, 1 << 23, n_random, dtype=np.int64)])
    return k | (rng.integers(0, 1 << 9, k.shape[0], dtype=np.int64) << 23)


def _jax_draws(monkeypatch, fn, *words):
    """The JAX package's ``fn`` (``_uniform`` or ``_normal``) with
    ``pltpu.prng_random_bits`` handing back ``words`` in turn (u1's bits,
    then u2's), as int32."""
    queue = [jnp.asarray(w.astype(np.uint32).view(np.int32)) for w in words]

    def bits(shape):
        out = queue.pop(0)
        assert tuple(shape) == out.shape
        return out

    monkeypatch.setattr(pltpu, "prng_random_bits", bits)
    out = np.asarray(fn(words[0].shape))
    assert not queue
    return out


def test_uniforms_equal_jax_uniform_on_the_same_bits(monkeypatch):
    bits = _edge_bits(32768, 0)
    ours = bits_to_uniform(torch.from_numpy(bits)).numpy()
    theirs = _jax_draws(monkeypatch, jax_prng._uniform, bits)
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))


def test_normals_match_jax_normal_on_the_same_bits(monkeypatch):
    """XLA's and PyTorch's float32 log, cos and sqrt differ by an ulp or two
    on normals up to ~5.8 in magnitude: 1e-6 absolute (~4.8e-7 seen, most
    values equal bit for bit)."""
    b1, b2 = _edge_bits(32768, 1), _edge_bits(32768, 2)
    # the edges of u1 against every edge of u2 too
    b1 = np.concatenate([b1, np.repeat(b1[:8], 8)])
    b2 = np.concatenate([b2, np.tile(b2[:8], 8)])
    ours = bits_to_normal(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    theirs = _jax_draws(monkeypatch, jax_prng._normal, b1, b2)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    assert np.mean(ours == theirs) > 0.5


def test_uniform_construction_of_the_device_code_is_exact():
    """csrc/philox.cuh::bits_to_uniform: the 23 low bits under the exponent
    of 1, less 1 - 2^-24, equal (k + 0.5) 2^-23 over every 23-bit value."""
    k = torch.arange(1 << 23, dtype=torch.int32)
    device_form = (k | 0x3F800000).view(torch.float32) - torch.tensor(1.0 - 2.0 ** -24)
    assert torch.equal(device_form, bits_to_uniform(k.to(torch.int64)))


def test_angle_reduction_of_the_device_code_is_exact():
    """csrc/philox.cuh::normal_cosine: with ks the 23-bit k read as signed and
    h = 3 + ks 2^-22 from the bits, (h - 3) + (h - (3 - 2^-22)) is exactly
    4 (u - round(u)) and 1 - |that| lies in [-1, 1], over every 23-bit
    value; so cos(2 pi u) = sin(pi/2 v) needs no reduction in float."""
    k = torch.arange(1 << 23, dtype=torch.int32)
    ks = (k << 9) >> 9
    h = (0x40400000 + ks).view(torch.float32)
    a = (h - torch.tensor(3.0)) + (h - torch.tensor(3.0 - 2.0 ** -22))
    u = bits_to_uniform(k.to(torch.int64)).double()
    assert torch.equal(a.double(), 4.0 * (u - torch.round(u)))
    v = torch.tensor(1.0) - a.abs()
    assert float(v.abs().max()) <= 1.0
    np.testing.assert_allclose(torch.sin(0.5 * np.pi * v.double()).numpy(),
                               torch.cos(2.0 * np.pi * u).numpy(), rtol=0, atol=1e-12)


def test_log_reduction_of_the_device_code_is_exact():
    """csrc/philox.cuh::normal_radius: u = 2^e m with m in [2/3, 4/3), e
    read from the bits (i = bits(u) - 0x3F2AAAAB) through the float
    1.5 2^23 + e, and f = m - 1 exact, over every 23-bit value."""
    k = torch.arange(1 << 23, dtype=torch.int32)
    u = bits_to_uniform(k.to(torch.int64))
    i = u.view(torch.int32) - 0x3F2AAAAB
    e = (0x4B400000 + (i >> 23)).view(torch.float32) - torch.tensor(12582912.0)
    m = (u.view(torch.int32) - (i & -8388608)).view(torch.float32)
    f = m - torch.tensor(1.0)
    assert float(m.min()) >= 2.0 / 3.0 - 1e-7 and float(m.max()) < 4.0 / 3.0
    assert torch.equal(u.double(), m.double() * torch.exp2(e.double()))
    assert torch.equal(f.double(), m.double() - 1.0)


def test_noise_parts_plain_on_the_cpu():
    b1 = torch.from_numpy(_edge_bits(1000, 3))
    b2 = torch.from_numpy(_edge_bits(1000, 4))
    r, c = noise_parts("radius", b1), noise_parts("cosine", b1, b2)
    assert torch.equal(noise_parts("normal", b1, b2), bits_to_normal(b1, b2))
    assert torch.equal(noise_parts("uniform", b1), bits_to_uniform(b1))
    np.testing.assert_allclose((r * c).numpy(), bits_to_normal(b1, b2).numpy(), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError):
        noise_parts("sine", b1)
