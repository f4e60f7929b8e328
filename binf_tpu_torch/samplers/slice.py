"""Slice sampling kernels: elliptical slice sampling and random-direction
slice sampling (port of ``binf_tpu/samplers/slice.py``).

Both are rejection-free and need only log-density evaluations.

* :func:`elliptical_slice` (Murray, Adams & MacKay 2010) samples
  ``N(x | mean, diag(scale^2)) exp(loglik(x))``: the Gaussian prior is
  sampled on an ellipse through the current point, and the angle's bracket
  shrinks toward 0 until a point lies above the slice, at most
  ``max_shrink`` times (a step that hits the cap stays put).
* :func:`slice_sampler` (Neal 2003) steps out along a random unit
  direction, in ``width`` steps with a budget of ``max_stepout - 1`` split
  at random between the two ends (that split keeps the capped procedure a
  valid slice update), then shrinks toward 0, at most ``max_shrink``
  times.

On a batch of chains (a log density with one value per chain) the loops
run in lockstep with masks, as the JAX package's ``vmap`` of its
``while_loop``s does: a chain that is done keeps its carry, and a loop ends
when every chain is done or the cap is reached, one host sync an
iteration.  A step draws all of its uniforms first; the loops themselves
are :func:`elliptical_slice_from_draws` and :func:`slice_from_draws`.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.tree import tree_leaves, tree_map, tree_where
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel
from binf_tpu_torch.samplers.hmc import _chain_sum, _per_chain

__all__ = [
    "EllipticalSliceInfo",
    "EllipticalSliceState",
    "SliceInfo",
    "SliceState",
    "elliptical_slice",
    "elliptical_slice_from_draws",
    "point_on_ellipse",
    "slice_from_draws",
    "slice_sampler",
]

_TWO_PI = 2.0 * math.pi


class EllipticalSliceState(NamedTuple):
    position: Position
    loglikelihood: torch.Tensor


class EllipticalSliceInfo(NamedTuple):
    """Shrinkage iterations used and the accepted ellipse angle."""

    num_shrinks: torch.Tensor
    theta: torch.Tensor


class SliceState(NamedTuple):
    position: Position
    logdensity: torch.Tensor


class SliceInfo(NamedTuple):
    num_stepout: torch.Tensor
    num_shrinks: torch.Tensor
    interval_width: torch.Tensor


def _rand(generator, shape, device):
    return chain_rows.rand(shape, generator=generator, device=device)


def _normal_like(generator, position: Position) -> Position:
    return tree_map(lambda x: chain_rows.randn(x.shape, generator=generator, dtype=x.dtype,
                                               device=x.device), position)


def _uniform_between(u, lo, hi):
    """``jax.random.uniform(minval=lo, maxval=hi)`` from a standard uniform."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def point_on_ellipse(centered: Position, nu: Position, mean: Position, theta) -> Position:
    """``x0 cos(theta) + nu sin(theta) + mean``, leafwise, one angle per
    chain."""
    return tree_map(lambda x0, n, m: x0 * _per_chain(torch.cos(theta), x0)
                    + n * _per_chain(torch.sin(theta), x0) + m, centered, nu, mean)


def elliptical_slice_from_draws(loglikelihood_fn, state: EllipticalSliceState, nu: Position,
                                prior_mean: Position, u_height, u_theta, u_shrink):
    """One elliptical slice step from its draws: the ellipse's auxiliary
    point ``nu ~ N(0, Sigma)``, the uniforms of the slice height and of the
    first angle (one per chain), and ``u_shrink (max_shrink, ...)``, the
    uniform of each shrinkage draw."""
    ll0 = state.loglikelihood
    centered = tree_map(torch.sub, state.position, prior_mean)
    log_y = ll0 + torch.log(torch.clamp_min(u_height, 1e-38))
    theta = u_theta * _TWO_PI
    lo, hi = theta - _TWO_PI, theta
    ll = ll0
    done = torch.zeros(ll0.shape, dtype=torch.bool, device=ll0.device)
    iters = torch.zeros(ll0.shape, dtype=torch.int32, device=ll0.device)
    for i in range(u_shrink.shape[0]):
        if i and chain_rows.every_row(done):  # one host sync an iteration
            break
        live = ~done
        ll_new = loglikelihood_fn(point_on_ellipse(centered, nu, prior_mean, theta))
        hit = ll_new > log_y
        ll = torch.where(live, ll_new, ll)
        # shrink the bracket toward theta0 = 0 (Murray et al. alg. 1)
        lo = torch.where(live & ~hit & (theta < 0.0), theta, lo)
        hi = torch.where(live & ~hit & (theta >= 0.0), theta, hi)
        theta = torch.where(live & ~hit, _uniform_between(u_shrink[i], lo, hi), theta)
        iters = iters + live.to(torch.int32)
        done = done | hit
    new_pos = tree_where(done, point_on_ellipse(centered, nu, prior_mean, theta),
                         state.position)
    return (EllipticalSliceState(new_pos, torch.where(done, ll, ll0)),
            EllipticalSliceInfo(iters, theta))


def elliptical_slice(loglikelihood_fn: LogDensityFn, prior_mean: Position, prior_scale: Any,
                     max_shrink: int = 32) -> SamplerKernel:
    """An elliptical slice sampling kernel for the target
    ``N(x | prior_mean, diag(prior_scale^2)) exp(loglikelihood(x))``.
    ``prior_mean`` and ``prior_scale`` are dicts matching the position
    (scalars broadcast per variable)."""

    def init(position: Position) -> EllipticalSliceState:
        return EllipticalSliceState(position, loglikelihood_fn(position))

    def step(generator: torch.Generator, state: EllipticalSliceState):
        ll0 = state.loglikelihood
        eps = _normal_like(generator, state.position)
        nu = tree_map(lambda e, s: e * torch.as_tensor(s, device=e.device), eps, prior_scale)
        u_height = _rand(generator, ll0.shape, ll0.device)
        u_theta = _rand(generator, ll0.shape, ll0.device)
        u_shrink = _rand(generator, (max_shrink,) + ll0.shape, ll0.device)
        mean = tree_map(lambda x, m: torch.as_tensor(m, dtype=x.dtype, device=x.device),
                        state.position, prior_mean)
        return elliptical_slice_from_draws(loglikelihood_fn, state, nu, mean, u_height,
                                           u_theta, u_shrink)

    return SamplerKernel(init=init, step=step)


def _along(position: Position, direction: Position, t) -> Position:
    return tree_map(lambda x, d: x + _per_chain(t, x) * d, position, direction)


def slice_from_draws(logdensity_fn, state: SliceState, raw_direction: Position, width: float,
                     max_stepout: int, u_height, u_place, u_budget, u_shrink):
    """One random-direction slice step from its draws: the unnormalised
    direction, the uniforms of the slice height, the bracket's placement
    and the step-out budget's split (one per chain each), and
    ``u_shrink (max_shrink, ...)``, the uniform of each shrinkage draw."""
    ld0 = state.logdensity
    nb = ld0.dim()
    norm = torch.sqrt(torch.stack([_chain_sum(x * x, nb)
                                   for x in tree_leaves(raw_direction)]).sum(0))
    inv = 1.0 / torch.clamp_min(norm, 1e-30)
    direction = tree_map(lambda x: _per_chain(inv, x) * x, raw_direction)
    log_y = ld0 + torch.log(torch.clamp_min(u_height, 1e-38))

    def ld_at(t):
        return logdensity_fn(_along(state.position, direction, t))

    # stepping out (Neal 2003, fig. 3): a width-sized bracket placed
    # uniformly around 0, each end extended in width-sized steps; the
    # budget max_stepout - 1 is split at random between the ends
    lo, hi = -u_place * width, (1.0 - u_place) * width
    j_budget = torch.floor(max_stepout * u_budget).to(torch.int32)
    k_budget = max_stepout - 1 - j_budget
    j, k = j_budget, k_budget
    for end in ("lo", "hi"):
        going = (j if end == "lo" else k) > 0
        for _ in range(max_stepout):
            if not chain_rows.any_row(going):
                break
            at = lo if end == "lo" else hi
            going = going & (ld_at(at) > log_y)
            if end == "lo":
                lo, j = torch.where(going, lo - width, lo), j - going.to(torch.int32)
                going = going & (j > 0)
            else:
                hi, k = torch.where(going, hi + width, hi), k - going.to(torch.int32)
                going = going & (k > 0)
    n_out = (j_budget - j) + (k_budget - k)
    width_out = hi - lo  # the info reports the stepped-out bracket

    # shrinkage: t ~ U(lo, hi); a miss shrinks the bracket toward 0
    t = torch.zeros_like(ld0)
    ld = ld0
    done = torch.zeros(ld0.shape, dtype=torch.bool, device=ld0.device)
    n_shrink = torch.zeros(ld0.shape, dtype=torch.int32, device=ld0.device)
    for i in range(u_shrink.shape[0]):
        if i and chain_rows.every_row(done):  # one host sync an iteration
            break
        live = ~done
        t = torch.where(live, _uniform_between(u_shrink[i], lo, hi), t)
        ld_new = ld_at(t)
        hit = ld_new > log_y
        ld = torch.where(live, ld_new, ld)
        lo = torch.where(live & ~hit & (t < 0.0), t, lo)
        hi = torch.where(live & ~hit & (t >= 0.0), t, hi)
        n_shrink = n_shrink + live.to(torch.int32)
        done = done | hit
    new_pos = tree_where(done, _along(state.position, direction, t), state.position)
    return (SliceState(new_pos, torch.where(done, ld, ld0)),
            SliceInfo(n_out, n_shrink, width_out))


def slice_sampler(logdensity_fn: LogDensityFn, width: float = 1.0, max_stepout: int = 8,
                  max_shrink: int = 32) -> SamplerKernel:
    """Random-direction slice sampler (Neal 2003's stepping out and
    shrinkage along a uniformly random direction each step).  ``width`` is
    the initial bracket; ``max_stepout`` bounds the bracket at ``width *
    max_stepout``."""

    def init(position: Position) -> SliceState:
        return SliceState(position, logdensity_fn(position))

    def step(generator: torch.Generator, state: SliceState):
        ld0 = state.logdensity
        raw = _normal_like(generator, state.position)
        u = _rand(generator, (3,) + ld0.shape, ld0.device)
        u_shrink = _rand(generator, (max_shrink,) + ld0.shape, ld0.device)
        return slice_from_draws(logdensity_fn, state, raw, width, max_stepout, u[0], u[1], u[2],
                                u_shrink)

    return SamplerKernel(init=init, step=step)
