"""Pairwise-distance restraint loss and its forces (K6a, K6b; port of
``binf_tpu/ops/pallas/pairwise.py``).

For bead coordinates ``X (N, 3)``, target log-distances ``logD (N, N)`` and
weights ``W (N, N)`` (symmetric, zero diagonal):

    loss(X) = sum_ij W_ij (1/2 log(d2_ij + eps) - logD_ij)^2,  d2_ij = |x_i - x_j|^2

over all ordered pairs (each unordered pair counts twice).  Its gradient is
``4 sum_j (W r / d2)_ij (x_i - x_j)``: the row forces ``2 sum_j (...)`` of
K6b, doubled because W is symmetric (``pairwise.py:218-226``).

:func:`pairwise_restraint_loss` is a ``torch.autograd.Function``
(:class:`PairwiseRestraintLoss`, in the form ``torch.func.grad`` accepts)
whose forward is K6a and whose backward is K6b (``csrc/pairwise.cu``) for
tensors on the card, or their plain versions.  The XLA reference of the
JAX package, which floors ``d2`` with ``max(d2, eps)`` where the kernels
add ``eps``, is :func:`pairwise_restraint_loss_reference`; the two differ
only for coincident beads.
"""

from __future__ import annotations

import ctypes

import torch

from binf_tpu_torch.ops.kernels import _build

__all__ = [
    "EPS",
    "PairwiseRestraintLoss",
    "pairwise_forces_plain",
    "pairwise_loss_plain",
    "pairwise_restraint_block",
    "pairwise_restraint_loss",
    "pairwise_restraint_loss_pallas",
    "pairwise_restraint_loss_reference",
]

EPS = 1e-12


def pairwise_restraint_loss_reference(X, logD, W) -> torch.Tensor:
    """The XLA reference: the full (N, N) field with ``max(d2, eps)``."""
    diff = X[:, None, :] - X[None, :, :]
    d2 = torch.clamp_min(torch.sum(diff * diff, dim=-1), EPS)
    r = 0.5 * torch.log(d2) - logD
    return torch.sum(W * r * r)


def pairwise_restraint_block(X_rows, X_all, logD_rows, W_rows):
    """Rows of a sharded restraint field against all beads: ``(loss of the
    rows, d loss_total / d X_rows)``, the latter assuming the whole W is
    symmetric (``max(d2, eps)``, as the JAX package's block)."""
    diff = X_rows[:, None, :] - X_all[None, :, :]
    d2 = torch.clamp_min(torch.sum(diff * diff, dim=-1), EPS)
    r = 0.5 * torch.log(d2) - logD_rows
    loss = torch.sum(W_rows * r * r)
    coef = W_rows * r / d2
    return loss, 4.0 * torch.einsum("mn,mnc->mc", coef, diff)


def _field(X, logD):
    """``diff (N, N, 3)``, ``d2 + eps`` summed in the kernels' order, and
    the residuals ``r``."""
    diff = X[:, None, :] - X[None, :, :]
    d2 = EPS + diff[..., 0] * diff[..., 0]
    d2 = d2 + diff[..., 1] * diff[..., 1]
    d2 = d2 + diff[..., 2] * diff[..., 2]
    return diff, d2, 0.5 * torch.log(d2) - logD


def pairwise_loss_plain(X, logD, W) -> torch.Tensor:
    """Plain version of K6a."""
    _, _, r = _field(X, logD)
    return torch.sum(W * r * r)


def pairwise_forces_plain(X, logD, W) -> torch.Tensor:
    """Plain version of K6b: row forces ``2 sum_j (W r / d2)_ij diff_ij``,
    ``(N, 3)``."""
    diff, d2, r = _field(X, logD)
    coef = W * r / d2
    return 2.0 * torch.sum(coef[..., None] * diff, dim=1)


def _check_operands(X, logD, W):
    n = X.shape[0]
    if X.shape != (n, 3) or logD.shape != (n, n) or W.shape != (n, n):
        raise ValueError(f"X must be (N, 3) and logD, W (N, N); got {tuple(X.shape)}, "
                         f"{tuple(logD.shape)}, {tuple(W.shape)}")
    for name, t in (("X", X), ("logD", logD), ("W", W)):
        if t.device != X.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {X.device}")


_LOSS_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_FORCES_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _scratch(fn_name: str, n: int) -> int:
    """Scratch floats of K6a (its tiles) at ``n`` beads, as the CUDA source
    tiles them."""
    return _build.bind("pairwise", fn_name, [ctypes.c_int])(n)


def pairwise_loss_cuda(X, logD, W) -> torch.Tensor:
    """K6a on the card: the loss as a 0-d tensor."""
    _check_operands(X, logD, W)
    n = X.shape[0]
    partial = torch.empty(_scratch("binf_pairwise_tiles", n), dtype=torch.float32,
                          device=X.device)
    out = torch.empty((), dtype=torch.float32, device=X.device)
    fn = _build.bind("pairwise", "binf_pairwise_loss", _LOSS_ARGS)
    grid = (ctypes.c_int * 2)()
    _build.count_launch("pairwise_fwd")
    err = fn(_build.ptr(X), _build.ptr(logD), _build.ptr(W), n, _build.ptr(partial),
             _build.ptr(out), _build.stream_ptr(X.device), grid)
    _build.check("pairwise", err, "pairwise restraint loss launch")
    _build.record_grid("pairwise_fwd", grid)
    return out


def pairwise_forces_cuda(X, logD, W) -> torch.Tensor:
    """K6b on the card: the row forces ``(N, 3)``, one kernel a launch (a
    warp a row).  Its route, 16-byte loads (N a multiple of 4) or one
    column at a time, is ``_build.last_launch["pairwise_bwd"].route``."""
    _check_operands(X, logD, W)
    n = X.shape[0]
    forces = torch.empty((n, 3), dtype=torch.float32, device=X.device)
    fn = _build.bind("pairwise", "binf_pairwise_forces", _FORCES_ARGS)
    grid = (ctypes.c_int * 3)()
    _build.count_launch("pairwise_bwd")
    err = fn(_build.ptr(X), _build.ptr(logD), _build.ptr(W), n, _build.ptr(forces),
             _build.stream_ptr(X.device), grid)
    _build.check("pairwise", err, "pairwise restraint forces launch")
    _build.record_grid("pairwise_bwd", grid, route="vector" if grid[2] else "scalar")
    return forces


class _PairwiseForces(torch.autograd.Function):
    """K6b as a Function of its own, so that the backward of
    :class:`PairwiseRestraintLoss` hands the kernel plain tensors under
    ``torch.func`` transforms."""

    @staticmethod
    def forward(X, logD, W, use_kernel):
        if use_kernel:
            return pairwise_forces_cuda(X, logD, W)
        return pairwise_forces_plain(X, logD, W)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("the restraint forces have no derivative of their own")


class PairwiseRestraintLoss(torch.autograd.Function):
    """``loss(X)`` with K6a forward and K6b backward; differentiable with
    respect to ``X`` only."""

    @staticmethod
    def forward(X, logD, W, use_kernel):
        if use_kernel:
            return pairwise_loss_cuda(X, logD, W)
        return pairwise_loss_plain(X, logD, W)

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, logD, W, use_kernel = inputs
        ctx.save_for_backward(X, logD, W)
        ctx.use_kernel = use_kernel

    @staticmethod
    def backward(ctx, g):
        X, logD, W = ctx.saved_tensors
        # W symmetric: the column terms equal the row terms, a factor 2
        forces = _PairwiseForces.apply(X, logD, W, ctx.use_kernel)
        return 2.0 * forces * g, None, None, None


def _use_kernel(X, block: int, use_pallas) -> bool:
    """None: the kernels for tensors on the card, their plain versions on
    the CPU.  False: the plain versions.  True: the kernels, which need the
    card and N a multiple of ``block``."""
    if use_pallas is None:
        use_pallas = X.device.type == "cuda"
    if not use_pallas:
        return False
    if X.device.type != "cuda":
        raise ValueError("the restraint kernels need tensors on the card; pass "
                         "use_pallas=None or False on the CPU")
    if X.shape[0] % block:
        raise ValueError(f"N = {X.shape[0]} must be a multiple of block = {block}")
    return True


def pairwise_restraint_loss(X, logD, W, block: int = 256,
                            use_pallas: bool | None = None) -> torch.Tensor:
    """loss(X) = sum_ij W_ij (log|x_i - x_j| - logD_ij)^2 with the kernels'
    ``d2 + eps``.  ``X (N, 3)`` float32; W symmetric with zero diagonal.
    Differentiable with respect to ``X`` only (``torch.autograd`` and
    ``torch.func.grad``)."""
    return PairwiseRestraintLoss.apply(X, logD, W, _use_kernel(X, block, use_pallas))


def pairwise_restraint_loss_pallas(X, logD, W, block: int = 256) -> torch.Tensor:
    """The kernel path (K6a forward, K6b backward); tensors on the card."""
    return pairwise_restraint_loss(X, logD, W, block, True)
