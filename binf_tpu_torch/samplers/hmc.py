"""Hamiltonian Monte Carlo with a leapfrog integrator (port of
``binf_tpu/samplers/hmc.py``).

* leapfrog: half kick, ``num_steps`` x (drift, kick), the last kick
  corrected to a half kick: one gradient per step;
* positions are dicts of named tensors with a diagonal (per-variable)
  inverse mass, or none;
* a divergence guard: NaN energy errors count as +inf, and ``|dE| > 1000``
  marks a transition divergent;
* ``jitter`` perturbs the step size uniformly in ``eps [1-j, 1+j]``.

Gradients come from ``torch.func.grad_and_value``.  A log density that
returns one value per chain (shape ``B``) steps ``B`` chains at once, each
with its own momentum, energy and accept decision (``samplers/base.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from binf_tpu_torch.ops.math import safe_exp
from binf_tpu_torch.ops.tree import tree_leaves, tree_map, tree_where
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel

__all__ = [
    "DIVERGENCE_THRESHOLD", "DenseMetric", "HMCInfo", "HMCState", "hmc", "kinetic_energy",
    "leapfrog", "metric_velocity", "sample_momentum", "value_and_grad",
]

DIVERGENCE_THRESHOLD = 1000.0


class HMCState(NamedTuple):
    position: Position
    logdensity: torch.Tensor
    logdensity_grad: Position


class HMCInfo(NamedTuple):
    accepted: torch.Tensor
    acceptance_prob: torch.Tensor
    energy_error: torch.Tensor
    is_divergent: torch.Tensor
    proposal_logdensity: torch.Tensor


class DenseMetric:
    """A full inverse mass matrix over a position template: not ported yet."""

    def __init__(self, matrix, template):
        raise NotImplementedError(
            "dense metrics come with samplers/dense.py, not ported yet (ROADMAP section 1)")


def _per_chain(x, leaf: torch.Tensor) -> torch.Tensor:
    """``x``, one value per chain, viewed to broadcast against a leaf of
    shape ``chains + event``."""
    x = torch.as_tensor(x)
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def _chain_sum(x: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    return x.sum(dim=tuple(range(batch_ndim, x.dim()))) if x.dim() > batch_ndim else x


def value_and_grad(logdensity_fn: LogDensityFn) -> Callable[[Position], tuple]:
    """``position -> (logdensity, grad dict)``.  A chain-batched log density
    is differentiated through its sum, which gives each chain its own
    gradient."""

    def summed(position):
        ld = logdensity_fn(position)
        return ld.sum(), ld

    vg = torch.func.grad_and_value(summed, has_aux=True)

    def fn(position):
        grad, (_, ld) = vg(position)
        return ld, grad

    return fn


def sample_momentum(generator: torch.Generator, position: Position,
                    inverse_mass: Any) -> Position:
    """p ~ N(0, M) with M given by its (diagonal, per-variable) inverse,
    drawn on each variable's device in sorted-name order."""
    eps = tree_map(lambda x: torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                         device=x.device), position)
    if inverse_mass is None:
        return eps
    return tree_map(lambda e, mi: e / torch.sqrt(torch.as_tensor(mi)), eps, inverse_mass)


def kinetic_energy(momentum: Position, inverse_mass: Any, batch_ndim: int = 0) -> torch.Tensor:
    """0.5 p^T M^-1 p, one value per chain of ``batch_ndim`` leading axes."""
    parts = [_chain_sum(p * v, batch_ndim) for p, v in
             zip(tree_leaves(momentum), tree_leaves(metric_velocity(momentum, inverse_mass)))]
    return 0.5 * torch.stack(parts).sum(0)


def metric_velocity(momentum: Position, inverse_mass: Any) -> Position:
    """dq/dt = M^-1 p."""
    if inverse_mass is None:
        return momentum
    return tree_map(lambda p, mi: p * mi, momentum, inverse_mass)


def leapfrog(value_and_grad_fn, position: Position, momentum: Position, grad: Position,
             step_size, num_steps: int, inverse_mass: Any):
    """Velocity-Verlet: half kick, ``num_steps`` x (drift, kick), the last
    kick corrected to a half; returns (position, momentum, logdensity,
    grad) at the end.  ``step_size`` is a scalar or one per chain."""

    def axpy(c, x, y):
        return tree_map(lambda xi, yi: yi + _per_chain(c, yi) * xi, x, y)

    momentum = axpy(0.5 * step_size, grad, momentum)
    ld = torch.zeros(())
    for _ in range(num_steps):
        position = axpy(step_size, metric_velocity(momentum, inverse_mass), position)
        ld, grad = value_and_grad_fn(position)
        momentum = axpy(step_size, grad, momentum)
    momentum = axpy(-0.5 * step_size, grad, momentum)
    return position, momentum, ld, grad


def hmc(logdensity_fn: LogDensityFn, step_size=0.1, num_integration_steps: int = 10,
        inverse_mass: Any = None, divergence_threshold: float = DIVERGENCE_THRESHOLD,
        jitter: float = 0.0) -> SamplerKernel:
    """Build an HMC kernel.

    ``inverse_mass``: None (identity) or a dict matching the position with
    per-variable inverse masses (diagonal metric).  ``jitter``: per-step
    uniform step-size perturbation ``eps U[1-j, 1+j]`` (0 disables).
    """
    vg = value_and_grad(logdensity_fn)

    def init(position: Position) -> HMCState:
        ld, grad = vg(position)
        return HMCState(position, ld, grad)

    def step(generator: torch.Generator, state: HMCState) -> tuple[HMCState, HMCInfo]:
        ld0 = state.logdensity
        nb = ld0.dim()
        p0 = sample_momentum(generator, state.position, inverse_mass)
        eps = torch.as_tensor(step_size, dtype=torch.float32, device=ld0.device)
        if jitter > 0:
            u_eps = torch.rand(ld0.shape, generator=generator, device=ld0.device)
            eps = eps * (1.0 + jitter * (2.0 * u_eps - 1.0))
        energy_before = -ld0 + kinetic_energy(p0, inverse_mass, nb)
        q, p, ld, grad = leapfrog(vg, state.position, p0, state.logdensity_grad, eps,
                                  num_integration_steps, inverse_mass)
        delta = (-ld + kinetic_energy(p, inverse_mass, nb)) - energy_before
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        is_divergent = delta.abs() > divergence_threshold
        p_accept = torch.clamp_max(safe_exp(-delta), 1.0)
        u = torch.rand(ld0.shape, generator=generator, device=ld0.device)
        accepted = u < p_accept
        new_state = HMCState(tree_where(accepted, q, state.position),
                             torch.where(accepted, ld, ld0),
                             tree_where(accepted, grad, state.logdensity_grad))
        return new_state, HMCInfo(accepted, p_accept, delta, is_divergent, ld)

    return SamplerKernel(init=init, step=step)
