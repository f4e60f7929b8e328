"""A rank's rows of the chain axis, for the eager samplers' noise.

Under a mesh (``parallel/mesh.py``) every rank holds the same generator
and steps rows ``lo:hi`` of ``n`` chains.  The JAX package keeps one key
and GSPMD keeps the values of the unsharded program; here each rank draws
the noise of all ``n`` chains and keeps its own rows, so the generators
stay in lockstep with no communication and a sharded eager run equals
the unsharded one up to the order of the cross-chain sums.  A loop whose
end depends on every chain (the Gamma rejection rounds, the NUTS
doublings, the slice samplers' loops) asks every rank through
:func:`any_row` and :func:`every_row`.

Outside :func:`drawing_rows` each function is the plain torch call, so
the single-device path does not change by a bit.  Only draws whose
leading axis is the chain axis go through here.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch

__all__ = ["any_row", "drawing_rows", "every_row", "one_chain", "rand", "randn"]


class _Rows(NamedTuple):
    lo: int
    hi: int
    n: int
    group: object  # the process group of the mesh's chain axis


_STACK: list = []


def _active() -> _Rows | None:
    return _STACK[-1] if _STACK else None


@contextmanager
def drawing_rows(lo: int, hi: int, n: int, group=None):
    """Chain-axis draws inside the block take rows ``lo:hi`` of a draw for
    ``n`` chains; ``any_row``/``every_row`` reduce over ``group``."""
    _STACK.append(_Rows(lo, hi, n, group))
    try:
        yield
    finally:
        _STACK.pop()


@contextmanager
def one_chain():
    """Draws inside the block are not chain-batched (a search on one
    chain's state, the same on every rank): the plain calls."""
    _STACK.append(None)
    try:
        yield
    finally:
        _STACK.pop()


def _draw(fn, shape, generator, dtype, device):
    rows = _active()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if rows is None:
        return fn(shape, generator=generator, dtype=dtype, device=device)
    if not shape or shape[0] != rows.hi - rows.lo:
        raise ValueError(f"a chain-axis draw of shape {shape} on a rank holding "
                         f"{rows.hi - rows.lo} of {rows.n} chains")
    full = fn((rows.n,) + shape[1:], generator=generator, dtype=dtype, device=device)
    return full[rows.lo:rows.hi]


def randn(shape, generator: torch.Generator, dtype=None, device=None) -> torch.Tensor:
    """``torch.randn`` of a chain-batched shape (this rank's rows)."""
    return _draw(torch.randn, shape, generator, dtype, device)


def rand(shape, generator: torch.Generator, dtype=None, device=None) -> torch.Tensor:
    """``torch.rand`` of a chain-batched shape (this rank's rows)."""
    return _draw(torch.rand, shape, generator, dtype, device)


def _reduce_flag(flag: bool, like: torch.Tensor, op) -> bool:
    rows = _active()
    if rows is None or rows.group is None:
        return flag
    import torch.distributed as dist

    t = torch.tensor(float(flag), dtype=torch.float32, device=like.device)
    dist.all_reduce(t, op=op, group=rows.group)
    return bool(t)


def any_row(x: torch.Tensor) -> bool:
    """``bool(x.any())`` over every rank's rows (one host sync)."""
    import torch.distributed as dist

    return _reduce_flag(bool(x.any()), x, dist.ReduceOp.MAX)


def every_row(x: torch.Tensor) -> bool:
    """``bool(x.all())`` over every rank's rows (one host sync)."""
    import torch.distributed as dist

    return _reduce_flag(bool(x.all()), x, dist.ReduceOp.MIN)
