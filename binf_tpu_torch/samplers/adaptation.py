"""Warmup adaptation: dual-averaging step size and a diagonal mass matrix
(port of ``binf_tpu/samplers/adaptation.py``).

* **Dual averaging** drives the cross-chain mean acceptance probability to
  the target (or, with ``per_chain=True``, each chain's own);
* **mass matrix**: a batched Welford update pools every chain's position
  (Chan's parallel combine), in Stan's expanding windows;
* the schedule is static, so each warmup step is one batched
  ``kernel.step(generator, states)`` followed by tensor updates on the
  chains' device: no host sync and no branch on a tensor per step.

The order of operations is the JAX package's (``adaptation.py:263-301``):
step, dual averaging, then at each window boundary harvest the metric,
reset Welford and restart dual averaging, so the boundary quirk of ROADMAP
section 3 (the reset at the end of the boundary step) carries over.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from binf_tpu_torch.ops.math import WelfordState, welford_init, welford_variance
from binf_tpu_torch.ops.tree import tree_leaves, tree_map

__all__ = [
    "DualAveragingState",
    "WindowAdaptationResult",
    "dual_averaging_init",
    "dual_averaging_step_size",
    "dual_averaging_update",
    "find_reasonable_step_size",
    "welford_batch_update",
    "window_adaptation",
]


# -- dual averaging -----------------------------------------------------------


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    gradient_avg: torch.Tensor
    count: torch.Tensor
    mu: torch.Tensor


def dual_averaging_init(initial_step_size, device=None) -> DualAveragingState:
    """Initialize dual averaging from a scalar (one pooled step size) or a
    ``(n_chains,)`` tensor (one per chain); every field takes its shape."""
    if torch.is_tensor(initial_step_size):
        eps = initial_step_size.to(dtype=torch.float32)
    else:
        eps = torch.tensor(initial_step_size, dtype=torch.float32, device=device)
    log_eps = torch.log(eps)
    zeros = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps, zeros, zeros, zeros, math.log(10.0) + log_eps)


def dual_averaging_update(state: DualAveragingState, acceptance_prob, target: float = 0.8,
                          t0: float = 10.0, gamma: float = 0.05,
                          kappa: float = 0.75) -> DualAveragingState:
    """One Nesterov dual-averaging step on H = target - accept_prob."""
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    grad_avg = (1.0 - w) * state.gradient_avg + w * (target - acceptance_prob)
    log_step = state.mu - torch.sqrt(count) / gamma * grad_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_avg, count, state.mu)


def dual_averaging_step_size(state: DualAveragingState, final: bool = False) -> torch.Tensor:
    return torch.exp(state.log_step_avg if final else state.log_step)


# -- batched Welford (cross-chain pooling) ------------------------------------


def welford_batch_update(state: WelfordState, batch, mesh=None) -> WelfordState:
    """Fold a chain batch of positions (leading axis = chains) into the
    running moments by Chan's parallel-combine formula.  With a mesh,
    ``batch`` is this rank's rows and the batch's mean and M2 pool every
    rank's chains (two all-reduces a leaf)."""
    from binf_tpu_torch.parallel.collectives import chain_count, chain_m2, chain_mean

    n_b = float(chain_count(tree_leaves(batch)[0].shape[0], mesh))
    n_a = state.count
    n = n_a + n_b
    batch_mean = tree_map(lambda x: chain_mean(x, mesh), batch)
    batch_m2 = tree_map(lambda x, m: chain_m2(x, m, mesh), batch, batch_mean)
    delta = tree_map(lambda bm, m: bm - m, batch_mean, state.mean)
    mean = tree_map(lambda m, d: m + d * (n_b / n), state.mean, delta)
    m2 = tree_map(lambda a, b, d: a + b + d * d * (n_a * n_b / n), state.m2, batch_m2, delta)
    return WelfordState(count=n, mean=mean, m2=m2)


# -- reasonable initial step size ---------------------------------------------


def find_reasonable_step_size(kernel_builder: Callable[[Any], Any], generator: torch.Generator,
                              state: Any, initial_step_size: float = 1.0,
                              target_accept: float = 0.8,
                              max_doublings: int = 20) -> torch.Tensor:
    """Double or halve the step size until the acceptance probability
    crosses 0.5 (Hoffman & Gelman 2011, Algorithm 4), at most
    ``max_doublings`` times.  Every trial draws the same noise, as the JAX
    package's trials share one key: the generator's state is restored
    before each.  The search decides on the host after each trial; it runs
    once, before the warmup's steps."""
    snapshot = generator.get_state()

    def try_eps(eps):
        generator.set_state(snapshot)
        _, info = kernel_builder(eps).step(generator, state)
        return info.acceptance_prob

    eps = torch.tensor(initial_step_size, dtype=torch.float32,
                       device=tree_leaves(state)[0].device)
    p = try_eps(eps)
    direction = 1.0 if float(p) > 0.5 else -1.0
    for _ in range(max_doublings):
        p = float(p)
        if (p <= 0.5) if direction > 0 else (p >= 0.5):
            break
        eps = eps * (2.0 if direction > 0 else 0.5)
        p = try_eps(eps)
    return eps


# -- window adaptation --------------------------------------------------------


class WindowAdaptationResult(NamedTuple):
    step_size: torch.Tensor
    inverse_mass: Any
    final_states: Any  # chain batch of kernel states at the end of warmup
    da_state: DualAveragingState


def _stan_boundaries(num_steps: int, initial_buffer=75, final_buffer=50, first_window=25):
    """Stan warmup partition: ``(initial_buffer, final_buffer, boundaries)``.

    ``boundaries`` are the steps where the mass estimate is harvested into
    the metric, the Welford accumulator is reset, and dual averaging is
    restarted at the current step size.  Expanding windows (25, 50, 100, ...)
    with the LAST window extended so its boundary lands exactly at
    ``num_steps - final_buffer``: the final buffer then re-adapts the step
    size under the final metric (Stan semantics)."""
    if num_steps < initial_buffer + final_buffer + first_window:
        initial_buffer = max(1, int(0.15 * num_steps))
        final_buffer = max(1, int(0.1 * num_steps))
    slow_end = num_steps - final_buffer
    boundaries = []
    pos, w = initial_buffer, first_window
    while pos < slow_end:
        end = pos + w
        if end + 2 * w > slow_end:  # too little room for the next window
            end = slow_end
        boundaries.append(min(end, slow_end))
        pos, w = end, w * 2
    return initial_buffer, final_buffer, tuple(boundaries)


def _stan_window_schedule(num_steps: int, initial_buffer=75, final_buffer=50,
                          first_window=25) -> tuple[list[bool], list[bool]]:
    """Per step: (inside a slow/mass window, window boundary)."""
    initial_buffer, final_buffer, boundaries = _stan_boundaries(
        num_steps, initial_buffer, final_buffer, first_window)
    slow = [initial_buffer <= t < num_steps - final_buffer for t in range(num_steps)]
    reset = [t in boundaries for t in range(num_steps)]
    return slow, reset


def window_adaptation(kernel_builder: Callable[[Any, Any], Any], initial_states: Any,
                      generator: torch.Generator, num_steps: int = 500,
                      initial_step_size: float | None = 0.1, target_accept: float = 0.8,
                      position_template: Any = None,
                      per_chain: bool = False, mesh=None) -> WindowAdaptationResult:
    """Stan-style warmup over a chain batch of states.

    ``kernel_builder(step_size, inverse_mass)`` returns a kernel whose step
    info has ``acceptance_prob``; ``initial_states`` carries a leading chain
    axis and the kernel steps all chains at once.  Per step: the kernel
    step, the dual-averaging update on the mean acceptance across chains
    (``per_chain=True``: on each chain's own, with a ``(n_chains,)`` step
    size), the Welford fold of every chain's position in slow windows, and
    at window boundaries the harvest, reset and restart.  The metric stays
    pooled across chains either way.

    ``initial_step_size=None`` seeds dual averaging with
    :func:`find_reasonable_step_size` on chain 0's state.  Returns the
    frozen ``(step_size, inverse_mass)`` and the warmed-up states.

    ``mesh``: the chains are sharded over it (``parallel/mesh.py``): each
    rank steps its rows of ``initial_states`` (a ``DTensor`` tree or the
    global states), the mean acceptance and the Welford moments pool every
    rank's chains, the step-size search runs on global chain 0 on every
    rank, and the warmed states (and per-chain step sizes) come back as
    ``DTensor``\\ s; the step size and metric are the same on every rank.
    """
    if mesh is None:
        return _window_adaptation(kernel_builder, initial_states, generator, num_steps,
                                  initial_step_size, target_accept, position_template,
                                  per_chain)
    from binf_tpu_torch.parallel.mesh import local_rows

    res = _window_adaptation(kernel_builder, local_rows(initial_states, mesh), generator,
                             num_steps, initial_step_size, target_accept, position_template,
                             per_chain, mesh)
    return _shard_adaptation(res, mesh, per_chain)


def _shard_adaptation(res: WindowAdaptationResult, mesh, per_chain: bool):
    """A rank's warmup result as the mesh's: the states (and per-chain step
    sizes) as ``DTensor``\\ s."""
    from binf_tpu_torch.parallel.mesh import shard_rows

    return res._replace(final_states=shard_rows(res.final_states, mesh),
                        step_size=shard_rows(res.step_size, mesh) if per_chain else res.step_size,
                        da_state=shard_rows(res.da_state, mesh) if per_chain else res.da_state)


def _window_adaptation(kernel_builder, initial_states, generator, num_steps=500,
                       initial_step_size=0.1, target_accept=0.8, position_template=None,
                       per_chain=False, mesh=None) -> WindowAdaptationResult:
    """:func:`window_adaptation` on this rank's rows, plain tensors in and
    out (all the rows without a mesh): the port's samplers call it."""
    from binf_tpu_torch.parallel.mesh import drawing_chain_rows

    with drawing_chain_rows(mesh, tree_leaves(initial_states)[0].shape[0]):
        return _window_loop(kernel_builder, initial_states, generator, num_steps,
                            initial_step_size, target_accept, position_template, per_chain,
                            mesh)


def _window_loop(kernel_builder, initial_states, generator, num_steps, initial_step_size,
                 target_accept, position_template, per_chain, mesh) -> WindowAdaptationResult:
    from binf_tpu_torch.ops.chain_rows import one_chain
    from binf_tpu_torch.parallel.collectives import broadcast_chain, pooled_mean

    if position_template is None:
        position_template = tree_map(lambda x: x[0], initial_states.position)
    n_chains = tree_leaves(initial_states.position)[0].shape[0]
    device = tree_leaves(position_template)[0].device
    slow_mask, reset_mask = _stan_window_schedule(num_steps)

    if initial_step_size is None:
        state0 = broadcast_chain(initial_states, 0, mesh)
        with one_chain():
            initial_step_size = find_reasonable_step_size(
                lambda eps: kernel_builder(eps, None), generator, state0,
                target_accept=target_accept)

    eps0 = torch.as_tensor(initial_step_size, dtype=torch.float32).to(device)
    if per_chain and eps0.dim() == 0:
        eps0 = eps0.expand(n_chains).clone()
    da = dual_averaging_init(eps0)
    wf = welford_init(position_template)
    inverse_mass = tree_map(torch.ones_like, position_template)
    states = initial_states
    for is_slow, is_reset in zip(slow_mask, reset_mask):
        eps = torch.exp(da.log_step)
        states, infos = kernel_builder(eps, inverse_mass).step(generator, states)
        accept_stat = (infos.acceptance_prob if per_chain
                       else pooled_mean(infos.acceptance_prob, mesh))
        da = dual_averaging_update(da, accept_stat, target=target_accept)
        if is_slow:  # mass-matrix accumulation in slow windows
            wf = welford_batch_update(wf, states.position, mesh)
        if is_reset:
            # harvest the variance into the metric, reset Welford, and
            # restart dual averaging at the current step size
            inverse_mass = welford_variance(wf)
            wf = welford_init(position_template)
            da = dual_averaging_init(torch.exp(da.log_step))
    # the last boundary sits at num_steps - final_buffer (_stan_boundaries):
    # the final buffer re-adapted the step size under the harvested metric
    return WindowAdaptationResult(dual_averaging_step_size(da, final=True), inverse_mass,
                                  states, da)
