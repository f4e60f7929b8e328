"""Random-walk Metropolis kernel (port of ``binf_tpu/samplers/rwm.py``):
a uniform(-step, step) or a normal perturbation of every variable, accepted
when ``u < exp(logp_new - logp_old)``.  The step size is a scalar or a dict
of per-variable scales.  A log density with one value per chain steps every
chain at once (``samplers/base.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.math import safe_exp
from binf_tpu_torch.ops.tree import tree_map, tree_where
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel

__all__ = ["RWMInfo", "RWMState", "rwm"]


class RWMState(NamedTuple):
    position: Position
    logdensity: torch.Tensor


class RWMInfo(NamedTuple):
    accepted: torch.Tensor
    acceptance_prob: torch.Tensor
    proposal_logdensity: torch.Tensor


def rwm(logdensity_fn: LogDensityFn, step_size, proposal: str = "uniform") -> SamplerKernel:
    """Build a random-walk Metropolis kernel; ``proposal`` is 'uniform'
    (the reference's) or 'normal'."""
    if proposal not in ("uniform", "normal"):
        raise ValueError(f"unknown proposal {proposal!r}")

    def init(position: Position) -> RWMState:
        return RWMState(position, logdensity_fn(position))

    def noise(generator, x):
        if proposal == "uniform":
            u = chain_rows.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            return -1.0 + 2.0 * u
        return chain_rows.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)

    def step(generator: torch.Generator, state: RWMState) -> tuple[RWMState, RWMInfo]:
        ld0 = state.logdensity
        moves = tree_map(lambda x: noise(generator, x), state.position)
        if isinstance(step_size, dict):
            scaled = tree_map(lambda s, m: s * m, step_size, moves)
        else:
            scaled = tree_map(lambda m: step_size * m, moves)
        proposal_pos = tree_map(torch.add, state.position, scaled)
        proposal_ld = logdensity_fn(proposal_pos)
        p_accept = torch.clamp_max(safe_exp(proposal_ld - ld0), 1.0)
        u = chain_rows.rand(ld0.shape, generator=generator, device=ld0.device)
        accepted = u < p_accept
        new = RWMState(tree_where(accepted, proposal_pos, state.position),
                       torch.where(accepted, proposal_ld, ld0))
        return new, RWMInfo(accepted, p_accept, proposal_ld)

    return SamplerKernel(init=init, step=step)
