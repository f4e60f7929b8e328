"""ChEES-HMC: a trajectory length adapted across chains (port of
``binf_tpu/samplers/chees.py``).

The trajectory length T is tuned by gradient ascent on the ChEES criterion
(Hoffman, Radul & Sountsov 2021),

    ChEES(T) = E[ (||q' - mu'||^2 - ||q - mu||^2)^2 ] / 4,

whose per-chain surrogate gradient uses only what a transition computes
(the proposal and its final momentum).  The expectation is a mean over the
chain axis and every chain shares one (eps, T), so each step runs one
leapfrog count L for the whole batch: the eager loop needs no per-chain
mask, and reads L on the host once a step.

* :func:`leapfrog_dynamic`: the leapfrog with a run-time step count;
* :func:`chees_adaptation`: the warmup over a chain batch: dual averaging
  of the step size (target 0.651, the paper's), Adam on log T over
  Halton-jittered trajectories, the batched Welford metric;
* :func:`chees_hmc`: the sampling kernel with frozen (eps, T, metric), the
  Halton position carried in its state;
* :func:`halton_sequence`: the jitter table, which the fused kernels
  share.

As the port's other eager samplers, a kernel steps a whole batch per call:
the log density returns one value per chain and the generator lies on the
chains' device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.math import safe_exp, welford_init, welford_variance
from binf_tpu_torch.ops.tree import tree_leaves, tree_map, tree_where
from binf_tpu_torch.samplers.adaptation import (
    dual_averaging_init,
    dual_averaging_step_size,
    dual_averaging_update,
    welford_batch_update,
)
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel
from binf_tpu_torch.samplers.hmc import (
    kinetic_energy,
    leapfrog,
    metric_velocity,
    sample_momentum,
    value_and_grad,
)

__all__ = [
    "ChEESHMCInfo",
    "ChEESHMCState",
    "ChEESResult",
    "chees_adaptation",
    "chees_hmc",
    "halton_sequence",
    "leapfrog_dynamic",
]


def halton_sequence(n: int, base: int = 2) -> np.ndarray:
    """Van der Corput / Halton sequence in (0, 1), float64."""
    out = np.zeros(n)
    for i in range(n):
        f, r, x = 1.0, 0.0, i + 1
        while x > 0:
            f /= base
            r += f * (x % base)
            x //= base
        out[i] = r
    return out


def leapfrog_dynamic(value_and_grad_fn, position, momentum, grad, step_size, num_steps,
                     inverse_mass):
    """The leapfrog with a step count known only at run time (an int or a
    0-d tensor, read once on the host); returns ``(q, p, ld, grad)``."""
    return leapfrog(value_and_grad_fn, position, momentum, grad, step_size, int(num_steps),
                    inverse_mass)


def _leapfrog_count(h, T, eps, max_leapfrog: int) -> torch.Tensor:
    """``clip(ceil(h 2T / eps), 1, max_leapfrog)`` in float32, as the JAX
    package computes it (``chees.py:163-166``)."""
    x = torch.ceil(h * 2.0 * T / eps)
    return torch.clamp(torch.nan_to_num(x, nan=1.0), 1.0, float(max_leapfrog)).to(torch.int32)


class _HMCOut(NamedTuple):
    position: Position
    logdensity: torch.Tensor
    grad: Position
    proposal: Position
    final_velocity: Position
    accept_prob: torch.Tensor
    accepted: torch.Tensor


def _dynamic_hmc_step(value_and_grad_fn, inverse_mass):
    """One HMC transition of the chain batch with a run-time (eps, L);
    returns what the ChEES gradient needs besides the new state."""

    def step(generator, position, logdensity, grad, eps, n_steps) -> _HMCOut:
        nb = logdensity.dim()
        p0 = sample_momentum(generator, position, inverse_mass)
        e0 = -logdensity + kinetic_energy(p0, inverse_mass, nb)
        q, p, ld, g = leapfrog_dynamic(value_and_grad_fn, position, p0, grad, eps, n_steps,
                                       inverse_mass)
        e1 = -ld + kinetic_energy(p, inverse_mass, nb)
        delta = torch.where(torch.isnan(e1 - e0), torch.inf, e1 - e0)
        p_acc = torch.clamp_max(safe_exp(-delta), 1.0)
        accepted = chain_rows.rand(logdensity.shape, generator=generator,
                                   device=logdensity.device) < p_acc
        return _HMCOut(tree_where(accepted, q, position), torch.where(accepted, ld, logdensity),
                       tree_where(accepted, g, grad), q, metric_velocity(p, inverse_mass),
                       p_acc, accepted)

    return step


class ChEESResult(NamedTuple):
    step_size: torch.Tensor
    trajectory_length: torch.Tensor
    inverse_mass: Any
    final_positions: Position  # chain batch
    mean_accept: torch.Tensor


def _chain_dot(a: Position, b: Position, n_chains: int) -> torch.Tensor:
    """Per-chain ``<a, b>`` over every non-chain axis of every leaf."""
    parts = tree_leaves(tree_map(lambda x, y: (x * y).reshape(n_chains, -1).sum(1), a, b))
    return torch.stack(parts).sum(0)


def _chain_center(x: torch.Tensor, mesh) -> torch.Tensor:
    """The cross-chain mean of ``x``, kept as a leading axis of one."""
    if mesh is None:
        return torch.mean(x, dim=0, keepdim=True)
    from binf_tpu_torch.parallel.collectives import chain_mean

    return chain_mean(x, mesh)[None]


def chees_adaptation(logdensity_fn: LogDensityFn, initial_positions: Position,
                     generator: torch.Generator, num_steps: int = 500,
                     initial_step_size: float = 0.1,
                     initial_trajectory_length: float | None = None,
                     target_accept: float = 0.651, learning_rate: float = 0.025,
                     max_leapfrog: int = 1000, adapt_mass: bool = True,
                     mesh=None) -> ChEESResult:
    """ChEES warmup over a chain batch; every adaptation statistic is a
    cross-chain mean.

    The first half runs with the identity metric, the second with the
    Welford variance harvested from the first (``adapt_mass``), dual
    averaging restarted at the current step size.  Each step's leapfrog
    count is ``clip(ceil(h_t 2T / eps), 1, max_leapfrog)``, h_t the
    Halton sequence; T starts at ``initial_trajectory_length`` (default 10
    times the first step size) and is kept in ``[eps, max_leapfrog eps]``.

    ``mesh``: each rank steps its rows of the chains (``DTensor``\\ s or the
    global positions), every cross-chain mean pools every rank's, and the
    warmed positions come back as ``DTensor``\\ s."""
    args = (num_steps, initial_step_size, initial_trajectory_length, target_accept,
            learning_rate, max_leapfrog, adapt_mass)
    if mesh is None:
        return _chees_adaptation(logdensity_fn, initial_positions, generator, *args)
    from binf_tpu_torch.parallel.mesh import local_rows, shard_rows

    res = _chees_adaptation(logdensity_fn, local_rows(initial_positions, mesh), generator,
                            *args, mesh=mesh)
    return res._replace(final_positions=shard_rows(res.final_positions, mesh))


def _chees_adaptation(logdensity_fn, initial_positions, generator, num_steps=500,
                      initial_step_size=0.1, initial_trajectory_length=None,
                      target_accept=0.651, learning_rate=0.025, max_leapfrog=1000,
                      adapt_mass=True, mesh=None) -> ChEESResult:
    """:func:`chees_adaptation` on this rank's rows, plain tensors in and
    out (all the rows without a mesh): ``fused_model_hmc`` calls it."""
    from binf_tpu_torch.parallel.mesh import drawing_chain_rows

    with drawing_chain_rows(mesh, tree_leaves(initial_positions)[0].shape[0]):
        return _chees_loop(logdensity_fn, initial_positions, generator, num_steps,
                           initial_step_size, initial_trajectory_length, target_accept,
                           learning_rate, max_leapfrog, adapt_mass, mesh)


def _chees_loop(logdensity_fn, initial_positions, generator, num_steps, initial_step_size,
                initial_trajectory_length, target_accept, learning_rate, max_leapfrog,
                adapt_mass, mesh) -> ChEESResult:
    from binf_tpu_torch.parallel.collectives import chain_sum, pooled_mean

    vg = value_and_grad(logdensity_fn)
    n_chains = tree_leaves(initial_positions)[0].shape[0]
    dev = tree_leaves(initial_positions)[0].device
    halton = torch.tensor(halton_sequence(num_steps), dtype=torch.float32, device=dev)
    if initial_trajectory_length is None:
        initial_trajectory_length = 10.0 * initial_step_size
    template = tree_map(lambda x: x[0], initial_positions)

    positions = initial_positions
    lds, grads = vg(positions)
    da = dual_averaging_init(initial_step_size, device=dev)
    log_T = torch.log(torch.tensor(initial_trajectory_length, dtype=torch.float32, device=dev))
    adam_m = adam_v = torch.zeros((), device=dev)
    wf = welford_init(template)
    inverse_mass = None
    n1 = num_steps // 2
    accs = []
    for t in range(num_steps):
        if t == n1:  # phase 2: freeze the harvested metric, restart the moments
            inverse_mass = welford_variance(wf) if adapt_mass else None
            da = dual_averaging_init(torch.exp(da.log_step))
            wf = welford_init(template)
            accs = []
        h = halton[t]
        eps = torch.exp(da.log_step)
        L = _leapfrog_count(h, torch.exp(log_T), eps, max_leapfrog)
        out = _dynamic_hmc_step(vg, inverse_mass)(generator, positions, lds, grads, eps, L)

        # dual averaging on the pooled acceptance
        mean_acc = pooled_mean(out.accept_prob, mesh)
        accs.append(mean_acc)
        da = dual_averaging_update(da, mean_acc, target=target_accept)

        # the ChEES surrogate gradient (cross-chain means)
        qc_old = tree_map(lambda x: x - _chain_center(x, mesh), positions)
        qc_new = tree_map(lambda x: x - _chain_center(x, mesh), out.proposal)
        sq_old = _chain_dot(qc_old, qc_old, n_chains)
        sq_new = _chain_dot(qc_new, qc_new, n_chains)
        dots = _chain_dot(qc_new, out.final_velocity, n_chains)
        per_chain = out.accept_prob * (sq_new - sq_old) * dots * h
        # divergent proposals give inf * 0 = nan: they leave the mean
        per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
        g_T = (chain_sum(per_chain, mesh)
               / torch.clamp_min(chain_sum(out.accept_prob, mesh), 1e-6))
        # scale-free, so the learning rate does not depend on the problem
        g_T = g_T / (g_T.abs() + 1e-10) * torch.tanh(g_T.abs())
        g_T = torch.where(torch.isfinite(g_T), g_T, 0.0)

        # Adam ascent on log T, kept in [log eps, log(max_leapfrog eps)]
        adam_m = 0.9 * adam_m + 0.1 * g_T
        adam_v = 0.999 * adam_v + 0.001 * g_T ** 2
        mhat = adam_m / (1.0 - 0.9 ** (t + 1.0))
        vhat = adam_v / (1.0 - 0.999 ** (t + 1.0))
        log_T = log_T + learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)
        log_T = torch.minimum(torch.maximum(log_T, torch.log(eps)),
                              torch.log(eps * max_leapfrog))

        wf = welford_batch_update(wf, out.position, mesh)
        positions, lds, grads = out.position, out.logdensity, out.grad

    return ChEESResult(
        step_size=dual_averaging_step_size(da, final=True),
        trajectory_length=torch.exp(log_T),
        inverse_mass=inverse_mass,
        final_positions=positions,
        mean_accept=torch.stack(accs[-50:]).mean(),
    )


class ChEESHMCState(NamedTuple):
    position: Position
    logdensity: torch.Tensor
    logdensity_grad: Position
    counter: torch.Tensor  # () int32: the Halton position, shared by the batch


class ChEESHMCInfo(NamedTuple):
    accepted: torch.Tensor
    acceptance_prob: torch.Tensor
    num_integration_steps: torch.Tensor


def chees_hmc(logdensity_fn: LogDensityFn, step_size, trajectory_length,
              inverse_mass: Any = None, max_leapfrog: int = 1000,
              halton_length: int = 256) -> SamplerKernel:
    """The frozen-parameter ChEES-HMC kernel: trajectories jittered around
    the mean length ``trajectory_length`` (``L_t = ceil(h_t 2T / eps)``,
    h_t the Halton sequence, clipped to ``[1, max_leapfrog]``).  One
    counter steps the whole batch, so every chain runs the same L in a
    step, as chains started together do in the JAX package."""
    vg = value_and_grad(logdensity_fn)
    step_fn = _dynamic_hmc_step(vg, inverse_mass)
    table = halton_sequence(halton_length)

    def init(position: Position) -> ChEESHMCState:
        ld, g = vg(position)
        return ChEESHMCState(position, ld, g, torch.zeros((), dtype=torch.int32,
                                                          device=ld.device))

    def step(generator: torch.Generator, state: ChEESHMCState):
        dev = state.logdensity.device
        eps = torch.as_tensor(step_size, dtype=torch.float32).to(dev)
        T = torch.as_tensor(trajectory_length, dtype=torch.float32).to(dev)
        h = torch.tensor(table[int(state.counter) % halton_length], dtype=torch.float32,
                         device=dev)
        L = _leapfrog_count(h, T, eps, max_leapfrog)
        out = step_fn(generator, state.position, state.logdensity, state.logdensity_grad, eps,
                      L)
        new_state = ChEESHMCState(out.position, out.logdensity, out.grad, state.counter + 1)
        return new_state, ChEESHMCInfo(out.accepted, out.accept_prob, L)

    return SamplerKernel(init=init, step=step)
