"""Parallel tempering, replica exchange (port of
``binf_tpu/samplers/tempering.py``).

K temperatures run at once: a state's positions carry the ladder as their
last batch axis, ``(K, ...)`` for one chain and ``(C, K, ...)`` for C
chains, so the K x C replicas are one batch and beta is a tensor over the
ladder axis.  A step moves every replica with the within-temperature kernel
``make_kernel(beta)`` (default: Gaussian random-walk Metropolis with step
``step_size / sqrt(beta)``), then swaps adjacent temperatures in an even or
odd sweep by the step's parity, each pair accepted with probability
``min(1, exp((beta_i - beta_j)(logp_j - logp_i)))``.  The inner kernel's
states are built afresh from the positions at every step, so any cached
log density or gradient stays exact across swaps.  The log density must
take the replica batch, returning one value per replica.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.math import safe_exp
from binf_tpu_torch.ops.tree import tree_map
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel

__all__ = ["PTInfo", "PTState", "geometric_betas", "parallel_tempering", "swap_log_ratio"]


class PTState(NamedTuple):
    positions: Position  # leaves (..., K, *event)
    logps: torch.Tensor  # (..., K) untempered log densities
    step_parity: torch.Tensor  # alternates even/odd swap sweeps


class PTInfo(NamedTuple):
    swap_accepted: torch.Tensor  # (..., K - 1) adjacent-pair swaps of this sweep
    swap_prob: torch.Tensor  # (..., K - 1)
    inner_info: Any  # the inner kernel's info over the replicas


def geometric_betas(k: int, beta_min: float = 0.05) -> torch.Tensor:
    """Geometric temperature ladder from 1 down to ``beta_min`` (K values,
    float32), on the CPU; move it with the positions."""
    return torch.tensor(np.geomspace(1.0, beta_min, k), dtype=torch.float32)


def _partners(K: int, parity: int, device):
    """Each replica's partner under the sweep of this parity, and whether
    it has one."""
    idx = torch.arange(K, device=device)
    partner = torch.where((idx - parity) % 2 == 0, idx + 1, idx - 1).clamp(0, K - 1)
    return idx, partner, partner != idx


def swap_log_ratio(betas: torch.Tensor, logps: torch.Tensor, parity: int) -> torch.Tensor:
    """``(beta_k - beta_partner)(logp_partner - logp_k)`` for every replica
    of ``logps (..., K)`` under the sweep of ``parity``."""
    _, partner, _ = _partners(betas.shape[0], parity, logps.device)
    return (betas - betas[partner]) * (logps[..., partner] - logps)


def parallel_tempering(logdensity_fn: LogDensityFn, betas,
                       make_kernel: Callable[[torch.Tensor], SamplerKernel] | None = None,
                       step_size: float = 0.5) -> SamplerKernel:
    """A PT kernel over the ladder ``betas`` (``betas[0]``, conventionally
    1.0, is the target).  ``make_kernel(beta)`` builds the within-
    temperature kernel for ``beta`` of shape ``(K,)``, broadcast over the
    replicas' ladder axis."""
    betas = torch.as_tensor(betas, dtype=torch.float32)
    K = betas.shape[0]

    def inner_kernel(b, positions, nb):
        if make_kernel is not None:
            return make_kernel(b)
        from binf_tpu_torch.samplers.rwm import rwm

        # hotter replicas take larger steps: step_size / sqrt(beta) over the
        # ladder axis of each variable
        scale = step_size / torch.sqrt(b)
        steps = {k: scale.reshape((K,) + (1,) * (v.dim() - nb)) for k, v in positions.items()}
        return rwm(lambda pos: b * logdensity_fn(pos), steps, proposal="normal")

    def init(positions: Position) -> PTState:
        logps = logdensity_fn(positions)
        return PTState(positions, logps, torch.zeros((), dtype=torch.int32))

    def step(generator: torch.Generator, state: PTState) -> tuple[PTState, PTInfo]:
        logps0 = state.logps
        dev, nb = logps0.device, logps0.dim()
        b = betas.to(dev)
        kernel = inner_kernel(b, state.positions, nb)
        inner, inner_info = kernel.step(generator, kernel.init(state.positions))
        positions = inner.position
        logps = logdensity_fn(positions)

        # even/odd adjacent swaps, one uniform per pair (the lower index's)
        parity = int(state.step_parity) % 2
        idx, partner, valid = _partners(K, parity, dev)
        p_swap = torch.clamp_max(safe_exp(swap_log_ratio(b, logps, parity)), 1.0)
        u = chain_rows.rand(logps.shape, generator=generator, device=dev)
        accept = (u[..., torch.minimum(idx, partner)] < p_swap) & valid
        take_from = torch.where(accept, partner, idx)
        positions = tree_map(lambda x: torch.gather(
            x, nb - 1, take_from.reshape(take_from.shape + (1,) * (x.dim() - nb))
            .expand(x.shape)), positions)
        logps = torch.gather(logps, nb - 1, take_from)

        pair = torch.arange(K - 1, device=dev)
        active = (pair - parity) % 2 == 0
        pair_prob = torch.where(active, p_swap[..., :K - 1], 0.0)
        pair_acc = active & accept[..., :K - 1]
        return (PTState(positions, logps, state.step_parity + 1),
                PTInfo(pair_acc, pair_prob, inner_info))

    return SamplerKernel(init=init, step=step)
