"""Philox4x32-10: the counter-based generator every whole-run kernel draws
its noise from (K1; replaces ``binf_tpu/ops/pallas/prng.py``).

The TPU kernels seed a hardware generator per (tile, step block) and draw
from it in sequence.  Here each value is a pure function of the seed and a
counter ``(global chain index, absolute step, slot, stream tag)``, so the
noise of a chain does not depend on how chains are tiled or how a run is cut
into calls.  Slots ``0 .. ceil(D/2)-1`` give the momentum normals (two per
slot), :data:`UNIFORM_SLOT` the accept uniform.  Uniforms and normals are
built exactly as ``prng.py::_uniform`` / ``_normal``: 23 bits offset by half
an ulp, and the cosine branch of Box-Muller with ``max(u1, 1e-12)``.

The plain versions here compute the same bits as ``csrc/philox.cuh`` in
int64 tensor arithmetic; :func:`philox_bits` and :func:`philox_noise` launch
the CUDA kernels of ``csrc/philox.cu`` for tensors on the card.  The
kernels' uniforms equal the plain ones bit for bit; their normals come from
conversions written for these bits (``csrc/philox.cuh``) and differ from
the plain ``log``/``cos``/``sqrt`` by rounding.  :func:`noise_parts` and
:func:`step_noise_cycles` expose the conversions and their previous form to
the checks and cycle probes.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build

__all__ = [
    "TAG_CHAIN_GRID", "TAG_GIBBS", "TAG_RUN", "TAG_SAMPLE", "TAG_WARMUP", "TAG_SEARCH",
    "UNIFORM_SLOT",
    "philox4x32_10", "bits_to_uniform", "bits_to_normal", "chain_grid_noise", "gibbs_noise",
    "step_noise",
    "philox_bits", "philox_noise", "philox_noise_plain", "staged_noise",
    "noise_parts", "step_noise_cycles",
]

# stream tags, as in csrc/philox.cuh
TAG_SAMPLE = 1  # fused_linreg_hmc sampling steps
TAG_WARMUP = 2  # fused_warmup adaptation steps
TAG_SEARCH = 3  # fused_warmup initial step-size search
TAG_RUN = 4  # fused_potential_hmc sampling steps
TAG_GIBBS = 5  # fused_linreg_gibbs sweeps
TAG_CHAIN_GRID = 6  # chain_grid_hmc sampling steps
UNIFORM_SLOT = 0xFFFFFFFF

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 2.0 * math.pi


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64,
    without overflowing int64: a = a_hi 2^16 + a_lo."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def _key(seed: int) -> tuple[int, int]:
    seed &= (1 << 64) - 1
    return seed & _MASK, seed >> 32


def philox4x32_10(ctr: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32 with 10 rounds.  ``ctr`` is an int64 tensor ``(..., 4)``
    of uint32 values, ``key`` two uint32 ints; returns ``(..., 4)`` int64."""
    x, y, z, w = ctr.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(x, _M0)
        hi1, lo1 = _mulhilo(z, _M1)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
    return torch.stack([x, y, z, w], dim=-1)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Uniforms in (0, 1): 23 low bits, offset by half an ulp (exact in f32)."""
    return (bits & ((1 << 23) - 1)).to(torch.float32) * (1.0 / (1 << 23)) + (
        0.5 / (1 << 23)
    )


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    u1 = torch.clamp_min(bits_to_uniform(b1), 1e-12)
    u2 = bits_to_uniform(b2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def step_noise(seed: int, tag: int, chains: torch.Tensor, step: int, d: int):
    """Noise of one HMC step for the chains with global indices ``chains``
    (int64, any shape ``S``): normals ``S + (d,)`` and uniforms ``S``."""
    n_slots = (d + 1) // 2
    slots = torch.tensor(list(range(n_slots)) + [UNIFORM_SLOT], dtype=torch.int64,
                         device=chains.device)
    c = chains[..., None].expand(*chains.shape, n_slots + 1)
    ctr = torch.stack(
        [c, torch.full_like(c, step), slots.expand_as(c), torch.full_like(c, tag)],
        dim=-1,
    )
    bits = philox4x32_10(ctr, _key(seed))
    normal_bits = bits[..., :n_slots, :]
    z = torch.stack(
        [bits_to_normal(normal_bits[..., 0], normal_bits[..., 1]),
         bits_to_normal(normal_bits[..., 2], normal_bits[..., 3])],
        dim=-1,
    ).reshape(*chains.shape, 2 * n_slots)[..., :d]
    u = bits_to_uniform(bits[..., n_slots, 0])
    return z, u


def chain_grid_noise(seed: int, chains: torch.Tensor, step: int, d: int):
    """Noise of one chain-grid step (``TAG_CHAIN_GRID``) for the chains
    ``chains`` (int64 ``(C,)``): normals ``(C, d)`` over the flat position
    (variables in sorted-name order, two normals per slot) and uniforms
    ``(C,)``, as ``csrc/chain_grid.cu`` draws them, for any ``d``."""
    return step_noise(seed, TAG_CHAIN_GRID, chains, step, d)


def gibbs_noise(seed: int, chains: torch.Tensor, sweep, d: int):
    """Noise of one collapsed-Gibbs sweep (``TAG_GIBBS``) for the chains
    ``chains`` (int64 ``(C,)``) at ``sweep`` (an int, or an int64 ``(C,)``
    of each entry's sweep): the Gamma draw's normals and uniforms, each
    ``(4, C)`` (slots 0-1 and 2), and the coefficient normals ``(d, C)``
    (slots 3.., two per slot), as ``csrc/philox.cuh::gibbs_noise``."""
    n_slots = 3 + (d + 1) // 2
    c = chains[:, None].expand(-1, n_slots)
    s = torch.as_tensor(sweep, dtype=torch.int64, device=chains.device)
    s = s.expand(chains.shape)[:, None].expand(-1, n_slots)
    slots = torch.arange(n_slots, dtype=torch.int64, device=chains.device).expand_as(c)
    ctr = torch.stack([c, s, slots, torch.full_like(c, TAG_GIBBS)], dim=-1)
    b = philox4x32_10(ctr, _key(seed)).permute(1, 2, 0)  # (slot, word, C)

    def normals(s):
        return [bits_to_normal(b[s, 0], b[s, 1]), bits_to_normal(b[s, 2], b[s, 3])]

    gz = torch.stack(normals(0) + normals(1))
    cz = torch.stack([z for s in range(3, n_slots) for z in normals(s)])[:d]
    return gz, bits_to_uniform(b[2]), cz


def philox_noise_plain(seed: int, tag: int, n_chains: int, num_steps: int, d: int,
                       step0: int = 0, device=None):
    """Plain version of :func:`philox_noise`."""
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)
    zs, us = [], []
    for s in range(num_steps):
        z, u = step_noise(seed, tag, chains, step0 + s, d)
        zs.append(z)
        us.append(u)
    return torch.stack(zs), torch.stack(us)


_NOISE_ARGS = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]
_BITS_ARGS = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p]


def philox_noise(seed: int, tag: int, n_chains: int, num_steps: int, d: int,
                 step0: int = 0, device=None):
    """The noise stream of ``num_steps`` steps from ``step0`` for chains
    ``0 .. n_chains-1``: normals ``(num_steps, n_chains, d)`` and uniforms
    ``(num_steps, n_chains)``, exactly what the whole-run kernels draw."""
    dev = resolve_device(device)
    if not 1 <= d <= 8:
        raise ValueError(f"philox_noise supports 1 <= d <= 8, got {d}")
    if dev.type != "cuda":
        return philox_noise_plain(seed, tag, n_chains, num_steps, d, step0, dev)
    z = torch.empty((num_steps, n_chains, d), dtype=torch.float32, device=dev)
    u = torch.empty((num_steps, n_chains), dtype=torch.float32, device=dev)
    fn = _build.bind("philox", "binf_philox_noise", _NOISE_ARGS)
    grid = (ctypes.c_int * 2)()
    _build.count_launch("philox")
    err = fn(d, seed & ((1 << 64) - 1), tag, n_chains, num_steps, step0,
             _build.ptr(z), _build.ptr(u), _build.stream_ptr(dev), grid)
    _build.check("philox", err, "philox_noise launch")
    _build.record_grid("philox", grid, num_steps)
    return z, u


def philox_bits(ctr: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of counters ``ctr`` (int64 ``(N, 4)`` of uint32 values)
    under the key of ``seed``; the kernel for a tensor on the card, the
    plain version for one on the CPU."""
    if ctr.dim() != 2 or ctr.shape[1] != 4 or ctr.dtype != torch.int64:
        raise ValueError("ctr must be an int64 tensor of shape (N, 4)")
    key = _key(seed)
    if ctr.device.type != "cuda":
        return philox4x32_10(ctr, key)
    ctr32 = torch.where(ctr >= 1 << 31, ctr - (1 << 32), ctr).to(torch.int32).contiguous()
    out = torch.empty_like(ctr32)
    fn = _build.bind("philox", "binf_philox_bits", _BITS_ARGS)
    _build.count_launch("philox")
    err = fn(_build.ptr(ctr32), key[0], key[1], ctr32.shape[0], _build.ptr(out),
             _build.stream_ptr(ctr.device))
    _build.check("philox", err, "philox_bits launch")
    return out.to(torch.int64) & _MASK


_PARTS_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p]
_CYCLES_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
NOISE_PARTS = ("radius", "cosine", "normal", "uniform")


def _noise_parts_plain(part: str, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if part == "radius":
        return torch.sqrt(-2.0 * torch.log(torch.clamp_min(bits_to_uniform(b1), 1e-12)))
    if part == "cosine":
        return torch.cos(_TWO_PI * bits_to_uniform(b2))
    if part == "normal":
        return bits_to_normal(b1, b2)
    return bits_to_uniform(b1)


def noise_parts(part: str, b1: torch.Tensor, b2: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
    """One conversion of the noise on given bits (int64 tensors of uint32
    values): ``"radius"`` sqrt(-2 ln u1) of ``b1``, ``"cosine"`` cos(2 pi
    u2) of ``b2`` (default ``b1``), ``"normal"`` the Box-Muller normal of
    both, ``"uniform"`` the uniform of ``b1``; float32, ``b1``'s shape.  On
    the card the kernels' device functions (``reference``: their previous
    logf/cosf/sqrtf form), on the CPU the plain version."""
    if part not in NOISE_PARTS:
        raise ValueError(f"part must be one of {NOISE_PARTS}, got {part!r}")
    b2 = b1 if b2 is None else b2
    if b1.shape != b2.shape:
        raise ValueError(f"b1 and b2 differ in shape: {tuple(b1.shape)}, {tuple(b2.shape)}")
    if b1.device.type != "cuda":
        return _noise_parts_plain(part, b1, b2)
    if b1.numel() == 0:
        return torch.empty(b1.shape, dtype=torch.float32, device=b1.device)
    w1, w2 = (torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32).contiguous()
              for b in (b1, b2))
    out = torch.empty(b1.shape, dtype=torch.float32, device=b1.device)
    fn = _build.bind("philox", "binf_philox_parts", _PARTS_ARGS)
    _build.count_launch("philox")
    err = fn(NOISE_PARTS.index(part), int(reference), _build.ptr(w1), _build.ptr(w2), w1.numel(),
             _build.ptr(out), _build.stream_ptr(b1.device))
    _build.check("philox", err, "noise_parts launch")
    return out


def step_noise_cycles(reference: bool, n_chains: int, threads: int, reps: int, device=None):
    """Cycles of one step's noise at D = 5 (clock64() around ``reps``
    dependent steps a thread) for chains ``0 .. n_chains-1`` in CTAs of
    ``threads``: int64 ``(n_chains,)`` on the card, in the kernels' form or
    (``reference``) the previous one.  A probe of the card; no plain version."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("step_noise_cycles measures the card: it needs a CUDA device")
    sink = torch.empty(n_chains, dtype=torch.float32, device=dev)
    cycles = torch.zeros(n_chains, dtype=torch.int64, device=dev)
    fn = _build.bind("philox", "binf_philox_step_cycles", _CYCLES_ARGS)
    _build.count_launch("philox")
    err = fn(int(reference), n_chains, threads, reps, _build.ptr(sink), _build.ptr(cycles),
             _build.stream_ptr(dev))
    _build.check("philox", err, "step_noise_cycles launch")
    return cycles


def staged_noise(noise, host_noise: bool, seed: int, num_steps: int, d_pad: int,
                 n_chains: int, device):
    """Noise handed to a whole-run kernel instead of Philox, in the JAX
    host-noise layout: momenta ``(num_steps, d_pad, C)`` and uniforms
    ``(num_steps, 1, C)``.  ``noise=(mom, unif)`` is used as given;
    ``host_noise`` draws both from a ``torch.Generator`` seeded with
    ``seed``; otherwise ``None`` (the kernels draw from Philox)."""
    if noise is not None:
        mom, unif = (a.to(device=device, dtype=torch.float32).contiguous()
                     if torch.is_tensor(a) else
                     torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
                     for a in noise)
        if mom.shape != (num_steps, d_pad, n_chains) or unif.shape != (num_steps, 1, n_chains):
            raise ValueError(
                f"noise must be ((steps, d_pad, C), (steps, 1, C)) = "
                f"({(num_steps, d_pad, n_chains)}, {(num_steps, 1, n_chains)}); got "
                f"({tuple(mom.shape)}, {tuple(unif.shape)})"
            )
        return mom, unif
    if host_noise:
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        mom = torch.randn((num_steps, d_pad, n_chains), generator=g, device=device)
        unif = torch.rand((num_steps, 1, n_chains), generator=g, device=device)
        return mom, unif
    return None
