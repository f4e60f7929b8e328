"""Explicit collectives over a mesh's chain axis (port of
``binf_tpu/parallel/collectives.py``).

The JAX package lets XLA insert most collectives from sharding
annotations and schedules a few by hand in ``shard_map``; here every
collective is an explicit call, made where XLA inserted one:

* :func:`distributed_systematic_indices`: each rank all-gathers the
  ``(N,)`` log-weights only (4 bytes a particle), builds the global CDF
  and searches its own output slots with one shared ``u``;
* :func:`take_along_chain`: particles move once, by an all-gather of the
  particles and an index (the simple version; an owner-keyed
  ``all_to_all`` would move only the rows that change rank);
* :func:`pmean_over_chains` and the chain reductions of the eager
  adaptation (:func:`chain_sum`, :func:`chain_mean`, :func:`chain_m2`),
  and :func:`all_gather_rows` for SMC's bisection on the gathered
  log-likelihoods.  With ``mesh=None`` each reduction is the plain torch
  call it stands for, so the single-device path does not change;
* :func:`reduce_from_shards` and :func:`copy_to_shards`, the pair that a
  log density sums its shards with (Megatron's g and f): the sum's
  backward is the identity and the copy's backward all-reduces, so each
  rank's gradient with respect to a replicated parameter is the sum of
  the shards' gradients, as JAX's ``psum`` under ``shard_map`` gives it.
  Both are ``torch.autograd.Function``\\ s with an explicit ``vmap`` rule
  (the batch dimension moved to 0, then one collective on the batched
  tensor), since c10d ops have no batching rule and the eager samplers
  evaluate log densities under ``torch.func.vmap``.
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the
  cotangent and so multiplies such a gradient by the world size.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from binf_tpu_torch.ops.tree import tree_leaves, tree_map
from binf_tpu_torch.parallel.mesh import (
    _is_dtensor,
    local_rows,
    mesh_axis,
    row_range,
    shard_rows,
)

__all__ = [
    "all_gather_rows",
    "broadcast_chain",
    "chain_count",
    "chain_m2",
    "chain_mean",
    "chain_sum",
    "copy_to_shards",
    "distributed_systematic_indices",
    "pmean_over_chains",
    "pooled_mean",
    "reduce_from_shards",
    "sum_over_ranks",
    "take_along_chain",
]


def _gather0(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0, in group order (c10d's
    all-gather: a ``DTensor``'s ``full_tensor()`` crashed on a gloo group
    of CUDA tensors on the card, torch 2.11.0+cu128)."""
    x = x.contiguous()
    if size == 1:
        return x.clone()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather_rows(x: torch.Tensor, mesh, dim: int = 0, axis: str | None = None) -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim`` gathered with every rank's,
    in mesh order: the whole tensor on every rank.  ``mesh=None``: ``x``."""
    if mesh is None:
        return x
    group, _, size = mesh_axis(mesh, axis)
    return _gather0(x.movedim(dim, 0), group, size).movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def sum_over_ranks(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    """``x`` summed over the ranks (one all-reduce); ``mesh=None``: ``x``."""
    return x if mesh is None else _all_reduce(x, mesh_axis(mesh, axis)[0])


def chain_sum(x: torch.Tensor, mesh, dim: int = 0, axis: str | None = None) -> torch.Tensor:
    """The sum over ``dim``, the chain axis, of every rank's rows."""
    return sum_over_ranks(torch.sum(x, dim=dim), mesh, axis)


def chain_count(n_local: int, mesh, axis: str | None = None) -> int:
    """The chains of every rank, ``n_local`` a rank (the shards are even);
    ``mesh=None``: ``n_local``."""
    return n_local if mesh is None else n_local * mesh_axis(mesh, axis)[2]


def chain_mean(x: torch.Tensor, mesh, dim: int = 0, axis: str | None = None) -> torch.Tensor:
    """The mean over ``dim``, the chain axis, of every rank's rows."""
    if mesh is None:
        return torch.mean(x, dim=dim)
    return chain_sum(x, mesh, dim, axis) / float(chain_count(x.shape[dim], mesh, axis))


def pooled_mean(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    """The mean of every entry of every rank's ``x`` (``torch.mean(x)``
    without a mesh): a pooled acceptance rate, or a scalar's mean over
    the ranks."""
    if mesh is None:
        return torch.mean(x)
    return chain_sum(x.reshape(-1), mesh, 0, axis) / float(chain_count(x.numel(), mesh, axis))


def chain_m2(x: torch.Tensor, mean: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    """``sum_c (x_c - mean)^2`` over every rank's chains (leading axis),
    about a global ``mean``: the batch M2 of a pooled Welford update."""
    return chain_sum((x - mean) ** 2, mesh, 0, axis)


def broadcast_chain(tree: Any, index: int, mesh, axis: str | None = None) -> Any:
    """Global chain ``index``'s leaves (without the chain axis) on every
    rank, sent from the rank that holds it; ``mesh=None``: ``x[index]``."""
    if mesh is None:
        return tree_map(lambda x: x[index], tree)
    group = mesh_axis(mesh, axis)[0]
    m = next(x for x in tree_leaves(tree) if x.dim()).shape[0]
    owner = index // m
    src = dist.get_global_rank(group, owner) if group is not dist.group.WORLD else owner

    def send(x):
        if not x.dim():
            return x
        row = x[index % m].clone(memory_format=torch.contiguous_format)
        dist.broadcast(row, src=src, group=group)
        return row

    return tree_map(send, tree)


def pmean_over_chains(tree: Any, mesh, axis: str = "chain") -> Any:
    """The mean over the sharded chain axis (every mesh axis, as the JAX
    package's psum over each) of every leaf, one all-reduce a leaf; the
    same plain tensor on every rank.  Leaves are ``DTensor``\\ s or global
    tensors (this rank takes its rows)."""
    return tree_map(lambda x: chain_mean(x, mesh), local_rows(tree, mesh))


def _u_of(key, like: torch.Tensor) -> torch.Tensor:
    """The systematic offset: drawn from a generator (the same draw as
    ``smc/resampling.py::systematic_resample``) or given."""
    if isinstance(key, torch.Generator):
        return torch.rand((), generator=key, dtype=like.dtype, device=like.device)
    return torch.as_tensor(key, dtype=like.dtype).to(like.device)


def _systematic_rows(u: torch.Tensor, lw_full: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Ancestors of output slots ``lo:hi`` against the global CDF, the
    operations of ``systematic_resample`` on those slots."""
    from binf_tpu_torch.smc.resampling import _cdf, _resample_indices

    n = lw_full.shape[0]
    slots = torch.arange(lo, hi, dtype=lw_full.dtype, device=lw_full.device)
    return _resample_indices(_cdf(lw_full), (slots + u) / n)


def distributed_systematic_indices(key, log_weights, mesh, axis: str = "chain"):
    """Systematic-resampling ancestor indices for a sharded weight vector:
    the values of ``smc/resampling.py::systematic_resample`` with the same
    offset, scheduled as the JAX package schedules them (one all-gather of
    the weights, the search of this rank's slots).  ``key`` is a
    ``torch.Generator`` (every rank holds the same one) or the offset
    ``u`` itself.  Returns global indices as a ``DTensor`` sharded like the
    weights."""
    lw = local_rows(log_weights, mesh)
    lw_full = all_gather_rows(lw, mesh)
    lo, hi = row_range(lw_full.shape[0], mesh)
    return shard_rows(_systematic_rows(_u_of(key, lw), lw_full, lo, hi), mesh)


def take_along_chain(particles: Any, indices, mesh=None) -> Any:
    """Gather particles by global ancestor index along the leading axis.
    With a mesh (or ``DTensor`` leaves, whose mesh it reads) every rank
    all-gathers the particles and takes the rows its indices name; the
    result is sharded as the indices are."""
    if mesh is None:
        leaves = [x for x in tree_leaves(particles) + [indices] if _is_dtensor(x)]
        mesh = leaves[0].device_mesh if leaves else None
    if mesh is None:
        return tree_map(lambda x: x[indices], particles)
    return shard_rows(_take_rows(local_rows(particles, mesh), local_rows(indices, mesh), mesh),
                      mesh)


def _take_rows(particles: Any, indices: torch.Tensor, mesh) -> Any:
    """:func:`take_along_chain` on this rank's rows, plain tensors in and
    out: the all-gathered particles at this rank's global indices."""
    return tree_map(lambda x: all_gather_rows(x, mesh)[indices], particles)


# -- the sum of a log density's shards: Megatron's f/g pair ------------------------


class _ReduceFromShards(torch.autograd.Function):
    """Forward: all-reduce (sum) over the group.  Backward: the identity."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _ReduceFromShards.apply(x, group), None
        return _ReduceFromShards.apply(x.movedim(in_dims[0], 0), group), 0


class _CopyToShards(torch.autograd.Function):
    """Forward: the identity (a replicated value entering a shard's
    computation).  Backward: all-reduce of the cotangent."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromShards.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _CopyToShards.apply(x, group), None
        return _CopyToShards.apply(x.movedim(in_dims[0], 0), group), 0


def reduce_from_shards(x: torch.Tensor, mesh, axis: str | None = None) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axis``; the gradient passes unchanged
    to each shard.  ``mesh=None``: ``x``."""
    return x if mesh is None else _ReduceFromShards.apply(x, mesh_axis(mesh, axis)[0])


def copy_to_shards(tree: Any, mesh, axis: str | None = None) -> Any:
    """Replicated values entering per-shard work: their gradient is summed
    over the ranks of ``axis``.  ``mesh=None``: ``tree``."""
    if mesh is None:
        return tree
    group = mesh_axis(mesh, axis)[0]
    return tree_map(lambda x: _CopyToShards.apply(x, group) if torch.is_tensor(x) else x, tree)
