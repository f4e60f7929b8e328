"""Within-model parallelism: shard the DATA axis of a log-likelihood (port
of ``binf_tpu/parallel/data_parallel.py``).

A log-likelihood that sums over data items partitions cleanly: each rank
evaluates its rows of the (data, mock-data) pair and one all-reduce gives
the scalar.  Two entry points:

* :func:`sharded_sum` lifts ``per_shard_fn(params, local_data) -> scalar``
  into a function of the replicated parameters and the data that returns
  the global sum;
* :class:`DataShardedLikelihood` wraps a likelihood: the same free
  variables, its log prob evaluated with the error model's data (and any
  forward-model fields on the same axis) split over the mesh axis.

Both evaluate under the eager samplers' ``torch.func.vmap`` and
``torch.func.grad``: the parameters enter through
``collectives.copy_to_shards`` and the partial sums leave through
``collectives.reduce_from_shards``, so every rank's gradient is the
gradient of the global sum (``parallel/collectives.py``).  Every rank
holds the parameters and evaluates every chain; the data is what is
split.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from binf_tpu_torch.core.density import MOCK_DATA, Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.parallel.collectives import copy_to_shards, reduce_from_shards
from binf_tpu_torch.parallel.mesh import local_rows, shard_rows

__all__ = ["DataShardedLikelihood", "shard_data", "sharded_sum"]


def shard_data(tree: Any, mesh, axis: str = "data") -> Any:
    """Global arrays as ``DTensor``\\ s with their leading axis sharded over
    ``axis`` (each rank keeps its rows)."""
    return shard_rows(local_rows(tree, mesh, axis), mesh)


def sharded_sum(per_shard_fn: Callable[[Any, Any], torch.Tensor], mesh, axis: str = "data"):
    """``per_shard_fn(params, local_data) -> scalar`` lifted into
    ``fn(params, data) -> global sum``: one all-reduce forward, one for the
    parameters' gradient backward.  ``data`` leaves are ``DTensor``\\ s or
    the global arrays (each rank takes its rows of the leading axis)."""

    def inner(params, data):
        local = local_rows(data, mesh, axis)
        return reduce_from_shards(per_shard_fn(copy_to_shards(params, mesh, axis), local),
                                  mesh, axis)

    return inner


@frozen_dataclass
class DataShardedLikelihood(Density):
    """A Likelihood evaluated with its observed-data axis sharded.

    The forward model runs on each rank's rows of the data-axis inputs
    named in ``fwm_data_fields`` (e.g. the Vandermonde rows of the
    polynomial model), the error model on its rows of the data, and the
    partial log probs are summed over the mesh.  The wrapped likelihood's
    forward-model output and error-model data share their leading (data)
    axis, and the error model's log prob adds over it (every iid error
    model)."""

    base: Density  # a Likelihood
    fixed: ValueDict
    mesh: Any = static_field(default=None)
    axis: str = static_field(default="data")
    fwm_data_fields: tuple = static_field(default=())
    name: str = static_field(default="sharded_likelihood")
    temper: float | torch.Tensor = 1.0

    @classmethod
    def create(cls, base, mesh, axis: str = "data", fwm_data_fields: tuple = ()):
        return cls(base=base, fixed={}, mesh=mesh, axis=axis,
                   fwm_data_fields=tuple(fwm_data_fields), name=f"sharded_{base.name}")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return self.base.variable_specs

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        base = self.base
        fwm, em = base.forward_model, base.error_model
        data_tree = {"__y__": em.data, **{f: getattr(fwm, f) for f in self.fwm_data_fields}}
        fwm_vals, em_vals = base._split_values(values)

        def per_shard(params, local):
            fwm_local_vals, em_local_vals = params
            local_fwm = dataclasses.replace(fwm, **{f: local[f]
                                                    for f in self.fwm_data_fields})
            mock = local_fwm._evaluate(fwm_local_vals)
            local_em = dataclasses.replace(em, data=local["__y__"])
            return local_em._log_prob({**local_em.fixed, **em_local_vals, MOCK_DATA: mock})

        fn = sharded_sum(per_shard, self.mesh, self.axis)
        return self.temper * fn((fwm_vals, em_vals), data_tree)
