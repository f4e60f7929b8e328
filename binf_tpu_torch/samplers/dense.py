"""Dense-metric HMC: a full-covariance mass matrix, adapted in Stan's
windows (port of ``binf_tpu/samplers/dense.py``).

* positions are flattened to one ``(D,)`` vector per chain in sorted-name
  order (:func:`flatten_spec`, the fused kernels' pack order), so every
  metric operation is a dense matrix product;
* momenta ``p = W z`` (``W W^T = M``, precomputed from the Cholesky factor
  of the inverse metric) and velocities ``v = M^-1 p`` are ``(D, D)``
  products over the whole chain batch;
* the warmup reuses the Stan window schedule and dual averaging of
  ``samplers/adaptation.py`` and folds each step's chain batch into a
  dense Welford state (Chan's combine; the batch scatter is one
  ``(Q - mu)^T (Q - mu)`` product over the chain axis).

As the port's other eager samplers, a kernel steps a whole batch of chains
per call: the log density takes a chain-batched position dict and returns
one value per chain, and the generator lies on the chains' device.
:func:`dense_hmc` builds a ``SamplerKernel`` over position dicts
(``parallel/runner.py::run_chains`` drives it);
:func:`dense_window_adaptation` returns the step size, the ``(D, D)``
inverse metric and the warmed positions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.math import safe_exp
from binf_tpu_torch.samplers.adaptation import (
    _stan_window_schedule,
    dual_averaging_init,
    dual_averaging_step_size,
    dual_averaging_update,
)
from binf_tpu_torch.samplers.base import LogDensityFn, SamplerKernel
from binf_tpu_torch.samplers.hmc import DIVERGENCE_THRESHOLD, HMCInfo, value_and_grad

__all__ = [
    "DenseAdaptationResult",
    "DenseHMCState",
    "dense_hmc",
    "dense_window_adaptation",
    "flatten_spec",
]


def flatten_spec(template: dict):
    """``(pack, unpack, D)`` for a position dict template.

    Sorted-name order, the fused kernels' pack order
    (``ops/kernels/fused_potential.py::pack_template``).  ``pack`` maps a
    position dict (with or without leading batch axes) to ``(..., D)``;
    ``unpack`` inverts it."""
    names = sorted(template)
    shapes = [tuple(torch.as_tensor(template[n]).shape) for n in names]
    sizes = [math.prod(s) for s in shapes]

    def pack(position: dict) -> torch.Tensor:
        cols = []
        for n, s, size in zip(names, shapes, sizes):
            x = torch.as_tensor(position[n])
            cols.append(x.reshape(x.shape[: x.dim() - len(s)] + (size,)))
        return torch.cat(cols, dim=-1)

    def unpack(q: torch.Tensor) -> dict:
        out, off = {}, 0
        for n, s, size in zip(names, shapes, sizes):
            out[n] = q[..., off: off + size].reshape(q.shape[:-1] + s)
            off += size
        return out

    return pack, unpack, sum(sizes)


def _metric_ops(inverse_mass_matrix: torch.Tensor) -> torch.Tensor:
    """The momentum factor W with ``W W^T = M``, the inverse of
    ``inverse_mass_matrix``: with ``M^-1 = C C^T`` (C lower Cholesky),
    ``W = C^-T``, so ``p = W z`` has covariance M."""
    chol = torch.linalg.cholesky(inverse_mass_matrix)
    eye = torch.eye(inverse_mass_matrix.shape[0], dtype=inverse_mass_matrix.dtype,
                    device=inverse_mass_matrix.device)
    return torch.linalg.solve_triangular(chol.T, eye, upper=True)


class DenseHMCState(NamedTuple):
    position: dict
    logdensity: torch.Tensor
    logdensity_grad: torch.Tensor  # flat (..., D)


def _flat_value_and_grad(logdensity_fn: LogDensityFn, unpack):
    """``q (..., D) -> (logdensity (...), grad (..., D))``."""
    return value_and_grad(lambda q: logdensity_fn(unpack(q)))


def _kinetic(P: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum((P @ minv) * P, dim=-1)


def _trajectory(vg, q, p0, ld, g, eps, num_steps: int, minv):
    """Velocity Verlet over flat positions with velocities ``p M^-1``: half
    kick, ``num_steps`` x (drift, kick), the last kick corrected to a half;
    returns ``(q, p, ld, g)`` at the end."""
    p = p0 + 0.5 * eps * g
    for _ in range(num_steps):
        q = q + eps * (p @ minv)
        ld, g = vg(q)
        p = p + eps * g
    return q, p - 0.5 * eps * g, ld, g


def _guarded_accept(delta: torch.Tensor, threshold: float):
    """Stan's divergence guard: a NaN energy error counts as +inf, and one
    past ``threshold`` in magnitude is divergent and rejected."""
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    bad = delta.abs() > threshold
    p_accept = torch.where(bad, 0.0, torch.clamp_max(safe_exp(-delta), 1.0))
    return delta, bad, p_accept


def dense_hmc(logdensity_fn: LogDensityFn, template: dict, step_size=0.1,
              num_integration_steps: int = 10, inverse_mass_matrix=None,
              divergence_threshold: float = DIVERGENCE_THRESHOLD) -> SamplerKernel:
    """HMC kernel with a dense ``(D, D)`` inverse mass matrix.

    ``logdensity_fn`` takes a position dict (one value per chain for a
    chain batch); ``template``, an unbatched position dict, fixes the
    flattening order.  ``inverse_mass_matrix=None`` means the identity.
    Divergent transitions (NaN or ``|dE| > divergence_threshold``) are
    rejected outright."""
    pack, unpack, dim = flatten_spec(template)
    device = torch.as_tensor(next(iter(template.values()))).device
    minv = (torch.eye(dim, device=device) if inverse_mass_matrix is None
            else torch.as_tensor(inverse_mass_matrix, dtype=torch.float32).to(device))
    W = _metric_ops(minv)
    vg = _flat_value_and_grad(logdensity_fn, unpack)

    def init(position: dict) -> DenseHMCState:
        ld, g = vg(pack(position))
        return DenseHMCState(position, ld, g)

    def step(generator: torch.Generator, state: DenseHMCState):
        q = pack(state.position)
        ld0 = state.logdensity
        z = chain_rows.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
        p0 = z @ W.T  # N(0, M) per chain
        eps = torch.as_tensor(step_size, dtype=torch.float32, device=q.device)
        qn, p, ld, g = _trajectory(vg, q, p0, ld0, state.logdensity_grad, eps,
                                   num_integration_steps, minv)
        delta = (-ld + _kinetic(p, minv)) - (-ld0 + _kinetic(p0, minv))
        delta, is_divergent, p_accept = _guarded_accept(delta, divergence_threshold)
        accepted = chain_rows.rand(ld0.shape, generator=generator, device=q.device) < p_accept
        q_new = torch.where(accepted[..., None], qn, q)
        new_state = DenseHMCState(unpack(q_new), torch.where(accepted, ld, ld0),
                                  torch.where(accepted[..., None], g, state.logdensity_grad))
        return new_state, HMCInfo(accepted, p_accept, delta, is_divergent, ld)

    return SamplerKernel(init=init, step=step)


# -- dense warmup -------------------------------------------------------------


class DenseAdaptationResult(NamedTuple):
    step_size: torch.Tensor
    inverse_mass_matrix: torch.Tensor  # (D, D) regularised covariance estimate
    final_positions: dict  # chain-batched warmed positions
    accept_rate: torch.Tensor


def _batch_cov_update(n, mean, m2, Q: torch.Tensor, mesh=None):
    """Chan combine of a full ``(C, D)`` batch into a dense Welford state
    ``(n, mean (D,), m2 (D, D))``; the batch scatter is one product.  With
    a mesh, ``Q`` is this rank's rows and the batch is every rank's."""
    from binf_tpu_torch.parallel.collectives import chain_count, chain_mean, sum_over_ranks

    c = float(chain_count(Q.shape[0], mesh))
    b_mean = chain_mean(Q, mesh)
    dev = Q - b_mean[None, :]
    b_m2 = sum_over_ranks(dev.T @ dev, mesh)
    delta = b_mean - mean
    tot = n + c
    mean_new = mean + delta * (c / tot)
    m2_new = m2 + b_m2 + torch.outer(delta, delta) * (n * c / tot)
    return tot, mean_new, m2_new


def _harvest_cov(n, m2: torch.Tensor, shrink_to: float = 1e-3) -> torch.Tensor:
    """The regularised covariance: Stan's shrinkage toward a small
    diagonal, plus a positive-definite jitter."""
    d = m2.shape[0]
    eye = torch.eye(d, dtype=m2.dtype, device=m2.device)
    cov = m2 / torch.clamp_min(torch.as_tensor(n - 1.0, device=m2.device), 1.0)
    w = n / (n + 5.0)
    return w * cov + (1.0 - w) * shrink_to * eye + 1e-8 * eye


def dense_window_adaptation(logdensity_fn: LogDensityFn, initial_positions: dict,
                            generator: torch.Generator, num_steps: int = 500,
                            num_integration_steps: int = 10,
                            initial_step_size: float = 0.1,
                            target_accept: float = 0.8, mesh=None) -> DenseAdaptationResult:
    """Stan-window warmup estimating a full covariance metric over a chain
    batch.

    The schedule and the pooled dual averaging are the diagonal
    ``window_adaptation``'s; the mass accumulator is the dense scatter
    matrix of (chains x slow-window steps) positions, harvested with
    shrinkage at each window boundary, where dual averaging restarts so the
    final buffer re-adapts the step size under the final metric.  Each
    step draws the chains' momenta, then their uniforms, from
    ``generator`` (on the chains' device); the loop never waits for the
    card.  ``mesh``: each rank steps its rows of the chains (``DTensor``\\ s
    or the global positions), the acceptance and the scatter pool every
    rank's, and the warmed positions come back as ``DTensor``\\ s."""
    args = (num_steps, num_integration_steps, initial_step_size, target_accept)
    if mesh is None:
        return _dense_window_adaptation(logdensity_fn, initial_positions, generator, *args)
    from binf_tpu_torch.parallel.mesh import local_rows, shard_rows

    res = _dense_window_adaptation(logdensity_fn, local_rows(initial_positions, mesh),
                                   generator, *args, mesh)
    return res._replace(final_positions=shard_rows(res.final_positions, mesh))


def _dense_window_adaptation(logdensity_fn, initial_positions, generator, num_steps=500,
                             num_integration_steps=10, initial_step_size=0.1,
                             target_accept=0.8, mesh=None) -> DenseAdaptationResult:
    """:func:`dense_window_adaptation` on this rank's rows, plain tensors in
    and out (all the rows without a mesh): ``fused_model_hmc`` calls it."""
    from binf_tpu_torch.parallel.mesh import drawing_chain_rows

    with drawing_chain_rows(mesh, next(iter(initial_positions.values())).shape[0]):
        return _dense_loop(logdensity_fn, initial_positions, generator, num_steps,
                           num_integration_steps, initial_step_size, target_accept, mesh)


def _dense_loop(logdensity_fn, initial_positions, generator, num_steps, num_integration_steps,
                initial_step_size, target_accept, mesh) -> DenseAdaptationResult:
    from binf_tpu_torch.parallel.collectives import pooled_mean

    template = {k: v[0] for k, v in initial_positions.items()}
    pack, unpack, d = flatten_spec(template)
    Q = pack(initial_positions)
    dev = Q.device
    n_chains = Q.shape[0]
    slow_mask, reset_mask = _stan_window_schedule(num_steps)
    vg = _flat_value_and_grad(logdensity_fn, unpack)
    ld, g = vg(Q)

    da = dual_averaging_init(initial_step_size, device=dev)
    wf_n, wf_mean, wf_m2 = 0.0, torch.zeros(d, device=dev), torch.zeros((d, d), device=dev)
    minv, W = torch.eye(d, device=dev), torch.eye(d, device=dev)
    accs = []
    for is_slow, is_reset in zip(slow_mask, reset_mask):
        eps = torch.exp(da.log_step)
        Z = chain_rows.randn(Q.shape, generator=generator, dtype=Q.dtype, device=dev)
        P0 = Z @ W.T  # momenta with covariance M per chain
        Qn, P, ldn, gn = _trajectory(vg, Q, P0, ld, g, eps, num_integration_steps, minv)
        delta = (-ldn + _kinetic(P, minv)) - (-ld + _kinetic(P0, minv))
        # the guard keeps float32 overflow at wild positions from cancelling
        # into a spuriously good energy that would poison the covariance
        p_accept = _guarded_accept(delta, DIVERGENCE_THRESHOLD)[2]
        accepted = chain_rows.rand(n_chains, generator=generator, device=dev) < p_accept
        Q = torch.where(accepted[:, None], Qn, Q)
        ld = torch.where(accepted, ldn, ld)
        g = torch.where(accepted[:, None], gn, g)
        mean_acc = pooled_mean(p_accept, mesh)
        accs.append(mean_acc)
        da = dual_averaging_update(da, mean_acc, target=target_accept)
        if is_slow:
            wf_n, wf_mean, wf_m2 = _batch_cov_update(wf_n, wf_mean, wf_m2, Q, mesh)
        if is_reset:
            # harvest the metric, refresh W, reset the accumulator and DA
            minv = _harvest_cov(wf_n, wf_m2)
            W = _metric_ops(minv)
            wf_n, wf_mean, wf_m2 = 0.0, torch.zeros_like(wf_mean), torch.zeros_like(wf_m2)
            da = dual_averaging_init(torch.exp(da.log_step))
    return DenseAdaptationResult(
        step_size=dual_averaging_step_size(da, final=True),
        inverse_mass_matrix=minv,
        final_positions=unpack(Q),
        accept_rate=torch.stack(accs[-50:]).mean(),
    )
