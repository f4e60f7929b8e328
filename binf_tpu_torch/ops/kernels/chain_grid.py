"""Whole-run HMC with one chain per group of warps: the chain-grid kernel K7 (port of
``binf_tpu/ops/pallas/chain_grid.py``).

The JAX package traces any scalar log density into its chain-grid kernel
and evaluates it at each chain's natural shapes.  A CUDA kernel cannot take
a Python function, so on the card K7 runs a device functor: the Gram-form
chromatin density (``example/chromatin.py::GramChromatinDensity``,
``csrc/gram_density.cuh``), the density the JAX package built this kernel
for.  :func:`chain_grid_potential_from_scalar` returns that module itself;
for any other callable it returns a ``torch.func`` potential that only the
plain version (CPU) runs.

:func:`chain_grid_hmc_run` keeps the JAX contract: per-variable positions
``(C, *shape)``, a step size per chain, a shared inverse mass at natural
shapes, draws ``(num_steps // thin, C, *shape)`` or Welford moments, the
NaN / |dE| > 1000 guard, and resume through ``block_offset``.  Noise comes
from Philox under ``TAG_CHAIN_GRID``, keyed by (chain, absolute step, slot),
so two chained calls replay one run bit for bit; ``noise=`` takes the JAX
host-noise layout (``chain_grid.py:536-547``).  The plain version
:func:`chain_grid_hmc_plain` does the same arithmetic in PyTorch; a tensor
on the CPU runs it, a tensor on the card launches ``csrc/chain_grid.cu``
(a group of warps a chain, one warp at 2,048 chains, up to 8 chains a CTA
sharing the staged matrices),
which leaves its grid in ``_build.last_launch["chain_grid_hmc"]``.

The kernel's summation order is fixed for a given geometry, so repeats and
chained calls give the same bits, but the geometry is not fixed: the warps
a chain (``lanes / 32``) and whether the matrices are staged in shared
memory follow the chain count, the bead count and the card's SM count.  A
chain's bits at 16 chains (eight warps each) and at 2,048 (one warp each)
may differ by rounding; two calls that pick the same geometry agree bit for
bit whatever the other chains are.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.densities import CallableDensity
from binf_tpu_torch.ops.kernels.fused_potential import pack_positions, pack_template, unpack_draws
from binf_tpu_torch.ops.kernels.prng import chain_grid_noise

__all__ = [
    "ChainGridResult",
    "ChainGridTrace",
    "ScalarPotential",
    "chain_grid_hmc_plain",
    "chain_grid_hmc_run",
    "chain_grid_potential_from_scalar",
    "gram_value_and_grad",
]

GRAM_FUNCTOR = "GramChromatinDensity"
_SMEM_LIMIT = 232448  # 227 KB of dynamic shared memory a block on the H100

NO_FUNCTOR = (
    "this log density has no CUDA functor, so the chain-grid kernel cannot run it "
    "on the card; the functor that exists is the Gram-form chromatin density "
    "(example/chromatin.py::make_gram_logdensity).  A functor for another density "
    "goes in csrc/ beside gram_density.cuh, not written yet (ROADMAP section 1); on "
    "the CPU (device='cpu') any callable runs through the plain version")


class ScalarPotential(CallableDensity):
    """A :class:`CallableDensity` read and written at the variables' natural
    shapes, ``potential_and_grad(position dict)``.  It has no CUDA functor:
    only the plain version runs it."""

    def potential_and_grad(self, pos: dict):
        U, g = super().potential_and_grad(pack_positions(pos, self.spec))
        return U, unpack_draws(g, self.spec)


def _is_gram(potential) -> bool:
    return getattr(potential, "functor", None) == GRAM_FUNCTOR


def chain_grid_potential_from_scalar(logdensity_fn, template: dict):
    """``(potential, consts, spec)`` for the chain grid, as the JAX package's
    function returns them, so that its callers port line for line.

    ``spec`` is the sorted ``(name, shape, size)`` packing spec.  A
    :class:`GramChromatinDensity` is its own potential; any other callable
    becomes a :class:`ScalarPotential`, which the kernel cannot run on the
    card.  ``consts`` is empty: the potential holds its own data.
    Variables of more than 2 dimensions raise, as in the JAX package."""
    spec = pack_template(template)
    for name, shape, _ in spec:
        if len(shape) > 2:
            raise ValueError(f"the chain-grid kernel supports variables up to 2-D; {name!r} has "
                             f"shape {shape} (reshape upstream)")
    if _is_gram(logdensity_fn):
        want = [("precision", (), 1), ("structure", (logdensity_fn.n_beads, 3),
                                       3 * logdensity_fn.n_beads)]
        if spec != want:
            raise ValueError(f"the Gram chromatin density takes {want}; the template is {spec}")
        return logdensity_fn, {}, spec
    return ScalarPotential(logdensity_fn, template), {}, spec


class ChainGridResult(NamedTuple):
    """``draws[v]`` is ``(num_steps // thin, C, *shape)``; ``mean`` and
    ``variance`` are Welford moments ``(C, *shape)`` over the call's steps
    (``collect="moments"``); ``final_positions[v]`` is ``(C, *shape)``."""

    draws: dict | None
    mean: dict | None
    variance: dict | None
    accept_rate: torch.Tensor
    final_positions: dict


class ChainGridTrace(NamedTuple):
    """Output of :func:`chain_grid_hmc_plain`: the result, accepted steps per
    chain ``(C,)`` int32, and ``log u - dE`` per step and chain (an MH
    decision flips under rounding only where this is near 0)."""

    result: ChainGridResult
    accepts: torch.Tensor
    margin: torch.Tensor


def _noise_shape(shape) -> tuple:
    """The JAX host-noise shape of a variable: () -> (1, 1); (n,) -> (1, n);
    (n, m) stays (``chain_grid.py:274-282``)."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, shape[0])
    return tuple(shape)


def _f32(x, dev) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def _per_chain(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (leaf.dim() - 1))


def _finish(draws, mean, m2, qf, accepts, num_steps, C, spec) -> ChainGridResult:
    unpack = (lambda a: None if a is None else unpack_draws(a, spec))
    variance = None if m2 is None else m2 / max(num_steps - 1.0, 1.0)
    accept_rate = accepts.sum(dtype=torch.int64).to(torch.float32) / (num_steps * C)
    return ChainGridResult(unpack(draws), unpack(mean), unpack(variance), accept_rate,
                           unpack(qf))


def _staged(noise, host_noise, seed, num_steps, spec, C, dev):
    """Staged noise in the JAX host-noise layout, as ``(normals, uniforms)``:
    one ``(num_steps, C, *noise_shape)`` tensor per variable in sorted-name
    order and ``(num_steps, C, 1)``; or None (Philox)."""
    shapes = [(num_steps, C) + _noise_shape(shape) for _, shape, _ in spec]
    if noise is not None:
        mom, unif = noise
        mom = [_f32(m, dev) for m in mom]
        unif = _f32(unif, dev)
        got = [tuple(m.shape) for m in mom]
        if got != shapes or tuple(unif.shape) != (num_steps, C, 1):
            raise ValueError(f"noise must be ({shapes}, {(num_steps, C, 1)}); got ({got}, "
                             f"{tuple(unif.shape)})")
        return mom, unif
    if host_noise:
        g = torch.Generator(device=dev).manual_seed(seed)
        mom = [torch.randn(s, generator=g, device=dev) for s in shapes]
        return mom, torch.rand((num_steps, C, 1), generator=g, device=dev)
    return None


def chain_grid_hmc_plain(potential, q0: dict, seed: int, step_size, inverse_mass: dict, *,
                         num_steps: int, num_leapfrog: int = 10, thin: int = 1,
                         collect: str = "draws", step_offset: int = 0,
                         noise=None) -> ChainGridTrace:
    """Plain PyTorch version of K7 on any device: the arithmetic of
    ``_cg_kernel.hmc_step`` (``chain_grid.py:365-424``) on all chains at
    once, with the Philox stream from absolute step ``step_offset`` or the
    staged ``noise`` (JAX layout, see :func:`chain_grid_hmc_run`).
    ``potential.potential_and_grad(pos)`` gives ``(U (C,), grad dict)``."""
    spec = pack_template({k: v[0] for k, v in q0.items()})
    names = [name for name, _, _ in spec]
    D = sum(size for _, _, size in spec)
    first = q0[names[0]]
    C, dev = first.shape[0], first.device
    eps = torch.broadcast_to(_f32(step_size, dev).reshape(-1), (C,))
    im = {k: _f32(inverse_mass[k], dev) for k in names}
    chains = torch.arange(C, dtype=torch.int64, device=dev)
    q = {k: _f32(q0[k], dev) for k in names}
    moments = collect == "moments"
    flat = pack_positions(q, spec)
    draws = None if moments else torch.empty((num_steps // thin, C, D), device=dev)
    mean = torch.zeros_like(flat) if moments else None
    m2 = torch.zeros_like(flat) if moments else None
    margin = torch.empty((num_steps, C), dtype=torch.float32, device=dev)
    accepts = torch.zeros(C, dtype=torch.int32, device=dev)

    def kinetic(p):
        ke = torch.zeros(C, device=dev)
        for k in names:
            ke = ke + 0.5 * torch.sum((p[k] * p[k] * im[k]).reshape(C, -1), dim=1)
        return ke

    for t in range(num_steps):
        if noise is None:
            z_flat, u = chain_grid_noise(seed, chains, step_offset + t, D)
            z = unpack_draws(z_flat, spec)
        else:
            z = {name: noise[0][v][t].reshape((C,) + shape)
                 for v, (name, shape, _) in enumerate(spec)}
            u = noise[1][t, :, 0]
        p = {k: z[k] / torch.sqrt(torch.clamp_min(im[k], 1e-20)) for k in names}
        U0, g = potential.potential_and_grad(q)
        E0 = U0 + kinetic(p)
        p = {k: p[k] - 0.5 * _per_chain(eps, p[k]) * g[k] for k in names}
        qn, U1 = q, U0
        for _ in range(num_leapfrog):
            qn = {k: qn[k] + _per_chain(eps, p[k]) * p[k] * im[k] for k in names}
            U1, g = potential.potential_and_grad(qn)
            p = {k: p[k] - _per_chain(eps, p[k]) * g[k] for k in names}
        p = {k: p[k] + 0.5 * _per_chain(eps, p[k]) * g[k] for k in names}
        dE = E0 - (U1 + kinetic(p))
        dE = torch.where(torch.isnan(dE) | (dE.abs() > 1000.0), -torch.inf, dE)
        log_u = torch.log(torch.clamp_min(u, 1e-30))
        accept = log_u < dE
        q = {k: torch.where(_per_chain(accept, q[k]), qn[k], q[k]) for k in names}
        margin[t] = log_u - dE
        accepts += accept.to(torch.int32)
        flat = pack_positions(q, spec)
        if moments:
            delta = flat - mean
            mean = mean + delta / float(t + 1)
            m2 = m2 + delta * (flat - mean)
        elif t % thin == thin - 1:
            draws[t // thin] = flat
    return ChainGridTrace(_finish(draws, mean, m2, flat, accepts, num_steps, C, spec),
                          accepts, margin)


# -- the kernel -----------------------------------------------------------------------


class _GramOperands(ctypes.Structure):
    """``csrc/gram_density.cuh::GramOperands``."""

    _fields_ = [("W", ctypes.c_void_p), ("logD", ctypes.c_void_p), ("Wt", ctypes.c_void_p),
                ("logDt", ctypes.c_void_p), ("n", ctypes.c_int), ("resident", ctypes.c_int),
                ("k_obs", ctypes.c_float), ("gamma_shape", ctypes.c_float),
                ("gamma_rate", ctypes.c_float), ("d0", ctypes.c_float),
                ("k_spring", ctypes.c_float), ("k_center", ctypes.c_float)]


class _CgArgs(ctypes.Structure):
    """``csrc/chain_grid.cu::CgArgs``."""

    _fields_ = [("q0", ctypes.c_void_p), ("eps", ctypes.c_void_p), ("im", ctypes.c_void_p),
                ("n_chains", ctypes.c_int), ("D", ctypes.c_int), ("num_steps", ctypes.c_int),
                ("num_leapfrog", ctypes.c_int), ("thin", ctypes.c_int),
                ("moments", ctypes.c_int), ("step_offset", ctypes.c_uint32),
                ("seed", ctypes.c_uint64), ("mom", ctypes.c_void_p), ("unif", ctypes.c_void_p),
                ("draws", ctypes.c_void_p), ("mean", ctypes.c_void_p), ("m2", ctypes.c_void_p),
                ("qf", ctypes.c_void_p), ("accepts", ctypes.c_void_p)]


def _gram_operands(density, dev, D):
    """The functor's operands as the C struct (the launch decides whether
    the matrices are staged in shared memory), and the tensors it points
    into (keep them alive until the launch)."""
    if not _is_gram(density):
        raise NotImplementedError(NO_FUNCTOR)
    W, logD = density.W, density.logD
    for name, t in (("W", W), ("logD", logD)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the density's {name} must be a contiguous float32 tensor on {dev}")
    n = W.shape[0]
    # a chain's state with moments, its scratch and the metric, matrices in device memory
    if 4 * (4 * n + 8 * D + 4) > _SMEM_LIMIT:
        raise ValueError(f"{n} beads need more shared memory a chain than the card's "
                         f"{_SMEM_LIMIT} bytes")
    Wt, logDt = W.T.contiguous(), logD.T.contiguous()
    ops = _GramOperands(_build.ptr(W), _build.ptr(logD), _build.ptr(Wt), _build.ptr(logDt), n,
                        0, float(density.k_obs), density.gamma_shape, density.gamma_rate,
                        density.d0, density.k_spring, density.k_center)
    return ops, [W, logD, Wt, logDt]


def _record(grid, steps):
    """The launch's grid as a LaunchRecord: ``lanes`` the threads a chain
    (32 x its warps), ``rounds`` the rounds of CTAs the card runs;
    ``cooperative`` False."""
    return _build.LaunchRecord(32 * grid[4], grid[0], grid[1], False, grid[3], steps, 0, None)


def _chain_grid_cuda(density, q0, seed, eps, im, *, num_steps, num_leapfrog, thin, collect,
                     step_offset, noise, spec) -> ChainGridResult:
    C, D = q0.shape
    dev = q0.device
    moments = collect == "moments"
    ops, keep = _gram_operands(density, dev, D)
    if not 0 <= step_offset + num_steps <= 0xFFFFFFFF:
        raise ValueError("the absolute step exceeds the Philox counter's 32 bits")
    mom = unif = None
    if noise is not None:
        mom = torch.cat([m.reshape(num_steps, C, -1) for m in noise[0]], dim=2).contiguous()
        unif = noise[1].reshape(num_steps, C).contiguous()
    keep += [q0, eps, im, mom, unif]
    draws = None if moments else torch.empty((num_steps // thin, C, D), device=dev)
    mean = torch.empty_like(q0) if moments else None
    m2 = torch.empty_like(q0) if moments else None
    qf = torch.empty_like(q0)
    accepts = torch.empty(C, dtype=torch.int32, device=dev)
    args = _CgArgs(_build.ptr(q0), _build.ptr(eps), _build.ptr(im), C, D, num_steps,
                   num_leapfrog, thin, int(moments), step_offset, seed & ((1 << 64) - 1),
                   _build.nullable_ptr(mom), _build.nullable_ptr(unif),
                   _build.nullable_ptr(draws), _build.nullable_ptr(mean),
                   _build.nullable_ptr(m2), _build.ptr(qf), _build.ptr(accepts))
    grid = (ctypes.c_int * 5)()
    fn = _build.bind("chain_grid", "binf_chain_grid_hmc",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    _build.count_launch("chain_grid_hmc", *(() if noise is not None else ("philox",)))
    err = fn(ctypes.byref(ops), ctypes.byref(args), _build.stream_ptr(dev), grid)
    _build.check("chain_grid", err, "chain_grid_hmc launch")
    _build.last_launch["chain_grid_hmc"] = _record(grid, num_steps)
    del keep
    return _finish(draws, mean, m2, qf, accepts, num_steps, C, spec)


def gram_value_and_grad(density, q: torch.Tensor):
    """``(U (B,), grad U (B, D))`` of the Gram chromatin density at flat
    positions ``q (B, D)`` (log precision, then the structure): K7's functor
    alone, a group of warps a position, for a tensor on the card; the plain
    ``potential_and_grad`` for one on the CPU."""
    B, D = q.shape
    spec = [("precision", (), 1), ("structure", ((D - 1) // 3, 3), D - 1)]
    if q.device.type != "cuda":
        U, g = density.potential_and_grad(unpack_draws(q, spec))
        return U, pack_positions(g, spec)
    if q.dtype != torch.float32 or not q.is_contiguous() or (D - 1) % 3:
        raise ValueError("q must be a contiguous float32 tensor (B, 1 + 3 N)")
    ops, keep = _gram_operands(density, q.device, D)
    U = torch.empty(B, dtype=torch.float32, device=q.device)
    grad = torch.empty_like(q)
    grid = (ctypes.c_int * 5)()
    fn = _build.bind("chain_grid", "binf_gram_eval",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    _build.count_launch("gram_eval")
    err = fn(ctypes.byref(ops), _build.ptr(q), B, D, _build.ptr(U), _build.ptr(grad),
             _build.stream_ptr(q.device), grid)
    _build.check("chain_grid", err, "gram_eval launch")
    _build.last_launch["gram_eval"] = _record(grid, 1)
    del keep
    return U, grad


def chain_grid_hmc_run(potential, q0: dict, seed: int, step_size, inverse_mass: dict,
                       consts: dict, *, num_steps: int, num_leapfrog: int = 10,
                       block_chains: int = 8, steps_per_block: int = 50, thin: int = 1,
                       collect: str = "draws", block_offset: int = 0, host_noise: bool = False,
                       noise=None, device=None) -> ChainGridResult:
    """Whole-run HMC of ``exp(-U)`` with each chain at its natural shapes.

    ``q0`` holds per-variable positions ``(C, *shape)`` (at most 2-D
    shapes); ``step_size`` is a scalar or per chain ``(C,)``;
    ``inverse_mass`` a dict of diagonal metrics at the variables' shapes,
    shared by all chains; ``consts`` is what
    :func:`chain_grid_potential_from_scalar` returned (empty: the potential
    holds its data).  Each step draws ``p = z / sqrt(max(im, 1e-20))``, runs
    ``num_leapfrog`` leapfrog steps and accepts ``log(max(u, 1e-30)) < E0 -
    E1``, rejecting NaN and ``|E0 - E1| > 1000``.  ``thin`` keeps every
    thin-th state; ``collect="moments"`` keeps per-chain Welford moments
    over the call's steps instead.  ``accept_rate`` is the mean over chains
    and steps.

    ``block_chains`` must divide C and ``steps_per_block`` num_steps, as in
    the JAX package; the TPU's rule that ``block_chains`` be a multiple of 8
    (a Mosaic tiling limit) is dropped, and on the card each chain has warps
    of its own whatever ``block_chains`` is.  ``block_offset``: Philox is
    indexed by the absolute step ``block_offset * steps_per_block + t``, so
    calls chained through ``final_positions`` with ``block_offset``
    advanced reproduce one call bit for bit.  ``host_noise`` draws the noise
    from a ``torch.Generator`` seeded with ``seed``; ``noise=(normals,
    uniforms)`` takes it in the JAX layout: one ``(num_steps, C,
    *noise_shape)`` per variable in sorted-name order (``()`` -> ``(1, 1)``,
    ``(n,)`` -> ``(1, n)``) and ``(num_steps, C, 1)``.  Runs on the card
    unless ``device="cpu"``; there the potential must be the Gram chromatin
    density.
    """
    if collect not in ("draws", "moments"):
        raise ValueError(f"unknown collect={collect!r}")
    dev = resolve_device(device)
    if dev.type == "cuda" and not _is_gram(potential):
        raise NotImplementedError(NO_FUNCTOR)
    spec = pack_template({k: torch.as_tensor(v)[0] for k, v in q0.items()})
    q0 = {k: _f32(q0[k], dev) for k, _, _ in spec}
    C = q0[spec[0][0]].shape[0]
    if C % block_chains or num_steps % steps_per_block or steps_per_block % thin:
        raise ValueError("C must divide by block_chains, num_steps by steps_per_block and "
                         "steps_per_block by thin")
    im = {k: _f32(inverse_mass[k], dev) for k, _, _ in spec}
    for k, shape, _ in spec:
        if tuple(im[k].shape) != shape:
            raise ValueError(f"inverse_mass[{k!r}] must have shape {shape}")
    staged = _staged(noise, host_noise, seed, num_steps, spec, C, dev)
    kwargs = dict(num_steps=num_steps, num_leapfrog=num_leapfrog, thin=thin, collect=collect,
                  step_offset=block_offset * steps_per_block, noise=staged)
    if dev.type == "cuda":
        eps = torch.broadcast_to(_f32(step_size, dev).reshape(-1), (C,)).contiguous()
        return _chain_grid_cuda(potential, pack_positions(q0, spec).contiguous(), seed, eps,
                                pack_positions({k: v[None] for k, v in im.items()}, spec)[0]
                                .contiguous(), spec=spec, **kwargs)
    return chain_grid_hmc_plain(potential, q0, seed, step_size, im, **kwargs).result
