"""Metropolis-adjusted Langevin algorithm (port of
``binf_tpu/samplers/mala.py``).

A proposal ``q + eps^2/2 grad + eps z`` accepted with the reverse-proposal
correction of the asymmetric Langevin kernel, through ``safe_exp``.  The
gradient comes from ``torch.func`` (``samplers/hmc.py::value_and_grad``);
a log density with one value per chain steps every chain at once, each
with its own noise and decision (``samplers/base.py``).  The proposal and
the log ratio are the pure functions :func:`mala_proposal` and
:func:`mala_log_ratio`, which a step feeds with its draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.math import safe_exp
from binf_tpu_torch.ops.tree import tree_leaves, tree_map, tree_where
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel
from binf_tpu_torch.samplers.hmc import _chain_sum, _per_chain, value_and_grad

__all__ = ["MALAInfo", "MALAState", "mala", "mala_log_ratio", "mala_proposal"]


class MALAState(NamedTuple):
    position: Position
    logdensity: torch.Tensor
    logdensity_grad: Position


class MALAInfo(NamedTuple):
    accepted: torch.Tensor
    acceptance_prob: torch.Tensor


def _axpy(c, x: Position, y: Position) -> Position:
    """y + c x leafwise, ``c`` a scalar or one value per chain."""
    return tree_map(lambda xi, yi: yi + _per_chain(c, yi) * xi, x, y)


def _chain_dot(a: Position, b: Position, batch_ndim: int) -> torch.Tensor:
    return torch.stack([_chain_sum(x * y, batch_ndim)
                        for x, y in zip(tree_leaves(a), tree_leaves(b))]).sum(0)


def mala_proposal(position: Position, grad: Position, noise: Position, eps) -> Position:
    """``position + eps^2/2 grad + eps noise``, in the JAX package's order."""
    return _axpy(eps, noise, _axpy(0.5 * eps ** 2, grad, position))


def _transition_logdensity(to_pos, from_pos, from_grad, eps, batch_ndim):
    """log q(to | from) for the proposal N(from + eps^2/2 grad, eps^2 I),
    up to its constant."""
    mean = _axpy(0.5 * eps ** 2, from_grad, from_pos)
    diff = tree_map(torch.sub, to_pos, mean)
    return -_chain_dot(diff, diff, batch_ndim) / (2.0 * eps ** 2)


def mala_log_ratio(state: MALAState, proposal: Position, proposal_ld, proposal_grad, eps):
    """log of the Metropolis-Hastings ratio of a MALA move from ``state`` to
    ``proposal``, the reverse-proposal correction included."""
    nb = state.logdensity.dim()
    eps = torch.as_tensor(eps, dtype=torch.float32, device=state.logdensity.device)
    return (proposal_ld - state.logdensity
            + _transition_logdensity(state.position, proposal, proposal_grad, eps, nb)
            - _transition_logdensity(proposal, state.position, state.logdensity_grad, eps, nb))


def mala(logdensity_fn: LogDensityFn, step_size=0.1) -> SamplerKernel:
    """Build a MALA kernel with step size ``eps`` (a scalar or one per
    chain)."""
    vg = value_and_grad(logdensity_fn)

    def init(position: Position) -> MALAState:
        ld, grad = vg(position)
        return MALAState(position, ld, grad)

    def step(generator: torch.Generator, state: MALAState) -> tuple[MALAState, MALAInfo]:
        ld0 = state.logdensity
        eps = torch.as_tensor(step_size, dtype=torch.float32, device=ld0.device)
        noise = tree_map(lambda x: chain_rows.randn(x.shape, generator=generator, dtype=x.dtype,
                                                    device=x.device), state.position)
        proposal = mala_proposal(state.position, state.logdensity_grad, noise, eps)
        prop_ld, prop_grad = vg(proposal)
        log_ratio = mala_log_ratio(state, proposal, prop_ld, prop_grad, eps)
        p_accept = torch.clamp_max(safe_exp(log_ratio), 1.0)
        u = chain_rows.rand(ld0.shape, generator=generator, device=ld0.device)
        accepted = u < p_accept
        new_state = MALAState(tree_where(accepted, proposal, state.position),
                              torch.where(accepted, prop_ld, ld0),
                              tree_where(accepted, prop_grad, state.logdensity_grad))
        return new_state, MALAInfo(accepted, p_accept)

    return SamplerKernel(init=init, step=step)
