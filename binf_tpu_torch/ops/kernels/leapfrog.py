"""Leapfrog for quadratic potentials over a chain batch (K8; port of
``binf_tpu/ops/pallas/leapfrog.py``).

For ``U(q) = q^T A q / 2 - b^T q`` on chains ``q (C, D)`` the gradient is
``q @ A - b`` (a row vector times A, as the JAX package computes it, so a
non-symmetric A acts as there).  :func:`quadratic_leapfrog` integrates the
whole L-step trajectory in one kernel (``csrc/leapfrog.cu``) for tensors on
the card (products on the tensor cores in 3xTF32 up to D = 128, in float32
FMA past it); :func:`quadratic_leapfrog_reference` is the plain version, the JAX
package's ``lax.scan`` reference as a loop, which the CPU runs.
:func:`quadratic_potential` is the plain ``U``; the kernel forms it at the
final positions on request, from its last product.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build

__all__ = ["quadratic_leapfrog", "quadratic_leapfrog_reference", "quadratic_potential"]


def quadratic_leapfrog_reference(q: torch.Tensor, p: torch.Tensor, A: torch.Tensor,
                                 b: torch.Tensor, step_size, num_steps: int,
                                 inv_mass: torch.Tensor | None = None):
    """Plain version: half kick, ``num_steps`` x (drift, kick), then the
    trailing kick corrected to a half, on ``(C, D)`` chains."""
    eps = torch.as_tensor(step_size, dtype=q.dtype, device=q.device)
    im = torch.ones(q.shape[-1], dtype=q.dtype, device=q.device) if inv_mass is None else inv_mass

    def grad_U(q):
        return q @ A - b[None, :]

    p = p - 0.5 * eps * grad_U(q)
    for _ in range(num_steps):
        q = q + eps * (p * im[None, :])
        p = p - eps * grad_U(q)
    p = p + 0.5 * eps * grad_U(q)
    return q, p


def quadratic_potential(q: torch.Tensor, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain ``U(q) = q^T A q / 2 - b^T q`` for chains ``q (C, D)``: ``(C,)``."""
    return 0.5 * torch.sum(q * (q @ A), dim=-1) - q @ b


def _f32(x, dev) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(x, np.float32), device=dev)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
# the kernel's routes by the code its launch reports
ROUTES = ("simt", "tensor")


def quadratic_leapfrog(q, p, A, b, step_size, num_steps: int, inv_mass=None,
                       block_chains: int = 256, device=None, return_potential: bool = False):
    """Integrate ``num_steps`` leapfrog steps of ``grad U = q @ A - b`` for
    every chain of ``q, p (C, D)``; returns ``(q, p)``, and with
    ``return_potential`` also ``U (C,)`` at the final ``q`` (the kernel
    forms it from its last product; ``num_steps=0`` gives U at ``q``).

    Runs on the card unless ``device="cpu"`` (there: the plain version).
    Any C and D: up to D = 128 the products run on the tensor cores in
    3xTF32 (float32 accuracy), 16 chains a warp with q and p in registers;
    wider D takes the float32 SIMT route, which streams A in chunks of rows
    when it does not fit beside its tile.  The launch records its route in
    ``_build.last_launch["quadratic_leapfrog"].route``.  ``block_chains`` is
    the JAX package's tile and must be positive; the card's tiles are set
    by ``csrc/leapfrog.cu``.
    ``step_size`` may be a tensor on the card: the kernel reads it there,
    with no wait for the host."""
    if block_chains <= 0:
        raise ValueError(f"block_chains={block_chains} must be positive")
    dev = resolve_device(device)
    q, p, A, b = (_f32(x, dev) for x in (q, p, A, b))
    C, D = q.shape
    if p.shape != (C, D) or A.shape != (D, D) or b.shape != (D,):
        raise ValueError(f"q, p must be (C, D), A (D, D) and b (D,); got {tuple(q.shape)}, "
                         f"{tuple(p.shape)}, {tuple(A.shape)}, {tuple(b.shape)}")
    im = torch.ones(D, device=dev) if inv_mass is None else _f32(inv_mass, dev)
    if im.shape != (D,):
        raise ValueError(f"inv_mass must be ({D},)")
    if dev.type != "cuda":
        q, p = quadratic_leapfrog_reference(q, p, A, b, step_size, num_steps, im)
        return (q, p, quadratic_potential(q, A, b)) if return_potential else (q, p)
    eps = _f32(step_size, dev).reshape(1)
    if _build.bind("leapfrog", "binf_quadratic_leapfrog_route", [ctypes.c_int])(D) < 0:
        raise ValueError(f"D={D} is too wide for the kernel's shared memory")
    q_out, p_out = torch.empty_like(q), torch.empty_like(p)
    u_out = torch.empty(C, device=dev) if return_potential else None
    fn = _build.bind("leapfrog", "binf_quadratic_leapfrog", _ARGS)
    grid = (ctypes.c_int * 3)()
    _build.count_launch("quadratic_leapfrog")
    err = fn(_build.ptr(q), _build.ptr(p), _build.ptr(A), _build.ptr(b), _build.ptr(im),
             _build.ptr(eps), C, D, num_steps, _build.ptr(q_out), _build.ptr(p_out),
             _build.nullable_ptr(u_out), _build.stream_ptr(dev), grid)
    _build.check("leapfrog", err, "quadratic_leapfrog launch")
    _build.record_grid("quadratic_leapfrog", grid, num_steps, ROUTES[grid[2]])
    return (q_out, p_out, u_out) if return_potential else (q_out, p_out)
