"""Device meshes and chain sharding on ``torch.distributed`` (port of
``binf_tpu/parallel/mesh.py``).

The JAX package's ``Mesh`` and ``shard_map`` are single-controller SPMD:
one program, XLA inserting collectives from sharding annotations.  The
counterpart here is one process per device, with
``torch.distributed.device_mesh.DeviceMesh`` as the mesh (dimension names
``("chain",)``, ``("host", "chain")`` or ``("data",)``).  The contract of
every entry point that takes ``mesh=``:

* every rank calls the same function with the same global inputs and the
  same seed, as every JAX host does;
* each function takes its rank's rows of the chain axis
  (:func:`local_rows`: a ``DTensor`` is unwrapped with ``to_local()``, a
  plain tensor is the global array and is sliced) and runs the
  single-device code on them, the CUDA kernels included;
* chain-axis outputs come back as ``DTensor``\\ s placed ``Shard(dim)``
  (:func:`shard_rows`, no communication), the counterpart of JAX's global
  arrays sharded on ``"chain"``; replicated results (a pooled step size, a
  metric, the mean acceptance) are plain tensors, equal on every rank.
  :func:`gather_chains` gathers them whole.  Between the port's own
  layers the rows travel as plain tensors: only a public entry point
  unwraps and wraps;
* collectives are explicit calls in ``parallel/collectives.py``, made
  where XLA inserted one; with ``mesh=None`` each is the identity;
* a rank's index is its flat position in the mesh, host-major, and the
  kernel paths give shard ``r`` the seed ``seed + r`` as the JAX package
  gives ``seed + axis_index("chain")``; the eager paths draw every chain's
  noise on every rank and keep their rows (``ops/chain_rows.py``).

Backends follow the device: NCCL for CUDA tensors, gloo for CPU tensors
(``"cpu:gloo,cuda:nccl"``), unless ``initialize_distributed(backend=...)``
names one.  NCCL refuses two ranks on one card; such a run passes
``backend="gloo"``, which moves CUDA tensors itself.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from binf_tpu_torch.ops.tree import tree_map

CHAIN_AXIS = "chain"
HOST_AXIS = "host"
DATA_AXIS = "data"

__all__ = [
    "CHAIN_AXIS",
    "DATA_AXIS",
    "HOST_AXIS",
    "chain_sharding",
    "drawing_chain_rows",
    "gather_chains",
    "initialize_distributed",
    "local_rows",
    "make_chain_mesh",
    "make_data_mesh",
    "mesh_axis",
    "replicate",
    "row_range",
    "shard_chains",
    "shard_rows",
    "to_local",
]


def _default_backend() -> str:
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, backend: str | None = None,
                           timeout: float | None = None) -> int:
    """Join the process group and return the world size.

    With no ``init_method`` it reads what ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); a
    single process with none of it becomes a world of one, so ``--mesh``
    runs on one card as ``make_chain_mesh()`` does on one TPU.  With a
    card, the rank's device is ``LOCAL_RANK`` (mod the cards present).
    ``timeout`` (seconds) bounds every collective.  A process already in
    a group keeps it."""
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    kw = {"backend": backend or _default_backend()}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and not env and world_size in (None, 1):
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        dist.init_process_group(init_method=init_method or "env://", world_size=world_size,
                                rank=rank, **kw)
    return dist.get_world_size()


def _device_type(device) -> str:
    from binf_tpu_torch._device import resolve_device

    return resolve_device(device).type


def make_chain_mesh(devices: list | None = None, host_axis: bool = False, device=None):
    """A 1-D ``("chain",)`` mesh over the ranks ``devices`` (default: every
    rank, in order), or with ``host_axis`` a 2-D ``("host", "chain")`` mesh
    of (nodes, ranks a node), ranks a node from ``LOCAL_WORLD_SIZE``.
    Joins a world of one first when no group exists.  ``device``: where
    the mesh's tensors live, the card unless ``"cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh

    initialize_distributed()
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    if ranks != sorted(ranks):
        raise ValueError(f"mesh ranks must ascend, got {ranks}")
    dtype = _device_type(device)
    if host_axis:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
        grid = torch.tensor(ranks).reshape(-1, per_node)
        return DeviceMesh(dtype, grid, mesh_dim_names=(HOST_AXIS, CHAIN_AXIS))
    return DeviceMesh(dtype, torch.tensor(ranks), mesh_dim_names=(CHAIN_AXIS,))


def make_data_mesh(devices: list | None = None, device=None):
    """A 1-D ``("data",)`` mesh (``parallel/data_parallel.py``)."""
    from torch.distributed.device_mesh import DeviceMesh

    initialize_distributed()
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    return DeviceMesh(_device_type(device), torch.tensor(sorted(ranks)),
                      mesh_dim_names=(DATA_AXIS,))


_FLAT_GROUPS: dict = {}


def mesh_axis(mesh, axis: str | None = None) -> tuple[Any, int, int]:
    """``(group, index, size)`` of this rank along ``axis``, or along every
    axis of the mesh flattened host-major (``axis=None``, the chain
    axis of a 2-D mesh)."""
    if axis is not None and mesh.ndim > 1:
        return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(
            mesh.mesh_dim_names.index(axis))
    if mesh.ndim == 1:
        return mesh.get_group(), mesh.get_local_rank(), mesh.size()
    ranks = tuple(mesh.mesh.flatten().tolist())
    group = _FLAT_GROUPS.get(ranks)
    if group is None:
        whole = ranks == tuple(range(dist.get_world_size()))
        group = _FLAT_GROUPS[ranks] = dist.group.WORLD if whole else dist.new_group(list(ranks))
    return group, ranks.index(dist.get_rank()), len(ranks)


def row_range(n: int, mesh, axis: str | None = None) -> tuple[int, int]:
    """This rank's rows ``(lo, hi)`` of ``n``, with the JAX package's
    message when the mesh does not divide them."""
    _, index, size = mesh_axis(mesh, axis)
    if n % size:
        raise ValueError(f"n_chains={n} must be divisible by mesh chain axis {size}")
    m = n // size
    return index * m, (index + 1) * m


def drawing_chain_rows(mesh, n_local: int):
    """A context in which the eager samplers' chain-axis draws take this
    rank's rows of every chain's draw (``ops/chain_rows.py``); with
    ``mesh=None``, one that changes nothing."""
    import contextlib

    from binf_tpu_torch.ops.chain_rows import drawing_rows

    if mesh is None:
        return contextlib.nullcontext()
    group, index, size = mesh_axis(mesh)
    return drawing_rows(index * n_local, (index + 1) * n_local, n_local * size, group)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_rows(tree: Any, mesh, axis: str | None = None, dim: int = 0) -> Any:
    """This rank's rows along ``dim`` of every leaf: a ``DTensor``'s local
    shard, or the slice of a global tensor; ``mesh=None``: ``tree``."""
    if mesh is None:
        return tree

    def take(x):
        if not torch.is_tensor(x):
            return x
        if _is_dtensor(x):
            # data sharded as a DTensor is read inside log densities under
            # torch.func, where to_local() (an autograd.Function with no
            # functorch rule) refuses to run: the local tensor itself
            return x._local_tensor
        if x.dim() <= dim:
            return x
        lo, hi = row_range(x.shape[dim], mesh, axis)
        return x.narrow(dim, lo, hi - lo)

    return tree_map(take, tree)


def to_local(tree: Any) -> Any:
    """Each ``DTensor`` leaf's local shard; plain leaves pass (they are
    this rank's already, or replicated)."""
    return tree_map(lambda x: x.to_local() if _is_dtensor(x) else x, tree)


def _placements(mesh, dim: int):
    from torch.distributed.tensor import Shard

    return [Shard(dim)] * mesh.ndim


def shard_rows(tree: Any, mesh, dim: int = 0) -> Any:
    """Local rows as ``DTensor``\\ s sharded on ``dim`` over every mesh
    axis (no communication).  Leaves with no ``dim`` (a scalar carried by
    a kernel state) stay plain, as replicated values; ``mesh=None``:
    ``tree``."""
    from torch.distributed.tensor import DTensor

    if mesh is None:
        return tree

    def wrap(x):
        if not torch.is_tensor(x) or _is_dtensor(x) or x.dim() <= dim:
            return x
        return DTensor.from_local(x, mesh, _placements(mesh, dim), run_check=False)

    return tree_map(wrap, tree)


def chain_sharding(mesh) -> list:
    """The placements of a chain-batched tensor: the leading axis split
    over every mesh axis.  A ``DTensor``'s placements name no tensor axis
    that is not split, so the JAX package's ``ndim_extra`` has no
    counterpart."""
    return _placements(mesh, 0)


def shard_chains(tree: Any, mesh) -> Any:
    """A chain-batched global tree (leading axis = chains) as ``DTensor``\\ s
    sharded over the mesh: each rank keeps its rows."""
    return shard_rows(local_rows(tree, mesh), mesh)


def replicate(tree: Any, mesh) -> Any:
    """A tree replicated over the mesh (model constants), as ``DTensor``\\ s."""
    from torch.distributed.tensor import DTensor, Replicate

    return tree_map(lambda x: DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                                 run_check=False), tree)


def gather_chains(tree: Any) -> Any:
    """Every ``DTensor`` leaf gathered whole on every rank (through
    ``parallel/collectives.py``'s all-gather); plain leaves pass."""
    from binf_tpu_torch.parallel.collectives import all_gather_rows
    from torch.distributed.tensor import Shard

    def full(x):
        if not _is_dtensor(x):
            return x
        shards = [p for p in x.placements if isinstance(p, Shard)]
        local = x.to_local()
        if not shards:
            return local
        return all_gather_rows(local, x.device_mesh, dim=shards[0].dim)

    return tree_map(full, tree)
