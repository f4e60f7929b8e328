"""No-U-Turn Sampler, multinomial, in the iterative form (port of
``binf_tpu/samplers/nuts.py``).

The same tree as the JAX package's: each doubling extends the trajectory
by a subtree of ``2^depth`` leaves in a random direction, and a subtree is
built leaf by leaf with a checkpoint stack of ``max_doublings`` slots.
Leaf ``i`` opens ``depth`` slots if it is the first, else
``trailing_zeros(i)`` if ``i`` is even, storing its momentum and the
momentum sum before it; it closes ``trailing_ones(i)`` slots, each a U-turn
check of the binary subtree that ends there.  The proposal is drawn by
progressive multinomial sampling within a subtree and biased progressive
sampling between the trajectory and a new subtree; a subtree that turns or
diverges is discarded whole.

On a batch of chains (a log density with one value per chain) the loops
run in lockstep with masks, as the JAX package's ``vmap`` of its
``while_loop``s does: a doubling runs all of its ``2^depth`` leaves for
every chain, chains that have turned or diverged keep their state, and the
step stops at the first doubling in which no chain is left, one host sync
a doubling.  The lockstep leapfrog count of a step is therefore
``2^max(num_doublings) - 1`` over the batch, whatever each chain needs.
The inner position is the flat ``(..., D)`` vector of sorted names
(``samplers/dense.py::flatten_spec``); gradients come from ``torch.func``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.samplers.base import LogDensityFn, Position, SamplerKernel
from binf_tpu_torch.samplers.dense import flatten_spec
from binf_tpu_torch.samplers.hmc import DenseMetric, sample_momentum, value_and_grad

__all__ = ["DIVERGENCE_THRESHOLD", "NUTSInfo", "NUTSState", "Subtree", "build_subtree", "nuts"]

DIVERGENCE_THRESHOLD = 1000.0


class NUTSState(NamedTuple):
    position: Position
    logdensity: torch.Tensor
    logdensity_grad: Position


class NUTSInfo(NamedTuple):
    acceptance_prob: torch.Tensor  # mean leaf acceptance statistic (for dual averaging)
    is_divergent: torch.Tensor
    is_turning: torch.Tensor
    num_doublings: torch.Tensor
    num_integration_steps: torch.Tensor
    energy: torch.Tensor


class Subtree(NamedTuple):
    """A subtree of :func:`build_subtree`: its last leaf's ``(q, p, ld,
    grad)``, the proposal ``(q, ld, grad)``, its log-weight, momentum sum
    and summed acceptance statistic, the leaves it took, and its flags."""

    end: tuple
    proposal: tuple
    log_weight: torch.Tensor
    momentum_sum: Any
    sum_alpha: torch.Tensor
    num_leaves: torch.Tensor
    turning: torch.Tensor
    divergent: torch.Tensor


def _trailing_zeros(i: int) -> int:
    """Number of trailing zero bits of i (i > 0)."""
    return ((i & -i) - 1).bit_count()


class _Flat:
    """The log density, its gradient and the metric on flat positions
    ``(..., D)`` of a position template's sorted names."""

    def __init__(self, logdensity_fn, position: Position, batch_ndim: int, inverse_mass):
        template = {k: v[(0,) * batch_ndim] for k, v in position.items()}
        self.pack, self.unpack, self.dim = flatten_spec(template)
        self.vg = value_and_grad(logdensity_fn)
        self.inverse_mass = inverse_mass
        if inverse_mass is None or isinstance(inverse_mass, DenseMetric):
            self.im = None
        else:
            self.im = self.pack({k: torch.broadcast_to(torch.as_tensor(v), template[k].shape)
                                 for k, v in inverse_mass.items()})

    def value_and_grad(self, q: torch.Tensor):
        ld, g = self.vg(self.unpack(q))
        return ld, self.pack(g)

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        if isinstance(self.inverse_mass, DenseMetric):
            return p @ self.inverse_mass.matrix.T
        return p if self.im is None else p * self.im

    def kinetic(self, p: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(p * self.velocity(p), dim=-1)

    def is_turning(self, rho, p_first, p_last) -> torch.Tensor:
        return ((torch.sum(rho * self.velocity(p_first), -1) < 0)
                | (torch.sum(rho * self.velocity(p_last), -1) < 0))

    def leapfrog(self, q, p, g, eps):
        e = eps[..., None]
        p = p + 0.5 * e * g
        q = q + e * self.velocity(p)
        ld, g = self.value_and_grad(q)
        p = p + 0.5 * e * g
        return q, p, ld, g


def _where(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def _build_subtree(flat: _Flat, generator, q, p, g, depth: int, eps_signed, h0, active,
                   max_doublings: int, threshold: float) -> Subtree:
    """``2^depth`` leaves from ``(q, p, g)`` on flat tensors, masked by
    ``active`` and by each chain's own turn or divergence.  Leaf ``i`` is
    the same for every live chain, so the stack's top is one number."""
    bshape = h0.shape
    stack_p = torch.zeros((max_doublings,) + p.shape, dtype=p.dtype, device=p.device)
    stack_s = torch.zeros_like(stack_p)
    S = torch.zeros_like(p)
    ld = torch.zeros(bshape, device=p.device)
    prop = (q, torch.full(bshape, -torch.inf, device=p.device), g)
    lw_sub = torch.full(bshape, -torch.inf, device=p.device)
    sum_alpha = torch.zeros(bshape, device=p.device)
    count = torch.zeros(bshape, dtype=torch.int32, device=p.device)
    turning = torch.zeros(bshape, dtype=torch.bool, device=p.device)
    divergent = torch.zeros_like(turning)
    top = 0
    for i in range(1 << depth):
        live = active & ~turning & ~divergent
        qn, pn, ldn, gn = flat.leapfrog(q, p, g, eps_signed)
        h = -ldn + flat.kinetic(pn)
        dh = torch.where(torch.isnan(h), torch.inf, h) - h0
        div_leaf = dh > threshold
        lw_leaf = -dh
        alpha = torch.clamp_max(torch.exp(-dh), 1.0)

        # open checkpoints: p_a and S_{a-1}
        opens = (depth if i == 0 else _trailing_zeros(i)) if i % 2 == 0 else 0
        for k in range(top, top + opens):
            stack_p[k] = _where(live, pn, stack_p[k])
            stack_s[k] = _where(live, S, stack_s[k])
        top += opens
        S_new = S + pn
        # close the subtrees that end at this leaf: their U-turn checks
        closes = _trailing_zeros(i + 1)
        turn_leaf = torch.zeros_like(turning)
        for k in range(top - closes, top):
            turn_leaf = turn_leaf | flat.is_turning(S_new - stack_s[k], stack_p[k], pn)
        top -= closes

        # progressive multinomial sampling within the subtree
        lw_new = torch.logaddexp(lw_sub, lw_leaf)
        p_take = torch.exp(lw_leaf - torch.where(torch.isfinite(lw_new), lw_new, 0.0))
        u = chain_rows.rand(bshape, generator=generator, device=p.device)
        take = (u < p_take) & ~div_leaf & live
        prop = (_where(take, qn, prop[0]), torch.where(take, ldn, prop[1]),
                _where(take, gn, prop[2]))
        q, p, g = _where(live, qn, q), _where(live, pn, p), _where(live, gn, g)
        ld = torch.where(live, ldn, ld)
        S = _where(live, S_new, S)
        lw_sub = torch.where(live, lw_new, lw_sub)
        sum_alpha = sum_alpha + torch.where(live, alpha, 0.0)
        count = count + live.to(torch.int32)
        turning = torch.where(live, turn_leaf, turning)
        divergent = torch.where(live, div_leaf, divergent)
    return Subtree((q, p, ld, g), prop, lw_sub, S, sum_alpha, count, turning, divergent)


def build_subtree(logdensity_fn: LogDensityFn, q: Position, p: Position, grad: Position,
                  depth: int, eps_signed, h0, generator: torch.Generator, *,
                  inverse_mass: Any = None, max_doublings: int = 8,
                  divergence_threshold: float = DIVERGENCE_THRESHOLD) -> Subtree:
    """One subtree of ``2^depth`` leaves from ``(q, p, grad)`` with the
    signed step ``eps_signed`` against the starting energy ``h0``, on
    position dicts (one value of ``h0`` per chain); the end state, the
    proposal and the momentum sum come back as dicts.  ``generator`` draws
    the multinomial proposal's uniforms only."""
    h0 = torch.as_tensor(h0, dtype=torch.float32)
    nb = h0.dim()
    flat = _Flat(logdensity_fn, q, nb, inverse_mass)
    eps = torch.broadcast_to(torch.as_tensor(eps_signed, dtype=torch.float32,
                                             device=h0.device), h0.shape)
    active = torch.ones(h0.shape, dtype=torch.bool, device=h0.device)
    t = _build_subtree(flat, generator, flat.pack(q), flat.pack(p), flat.pack(grad), depth, eps,
                       h0, active, max_doublings, divergence_threshold)
    u = flat.unpack
    return t._replace(end=(u(t.end[0]), u(t.end[1]), t.end[2], u(t.end[3])),
                      proposal=(u(t.proposal[0]), t.proposal[1], u(t.proposal[2])),
                      momentum_sum=u(t.momentum_sum))


def nuts(logdensity_fn: LogDensityFn, step_size=0.1, max_doublings: int = 8,
         inverse_mass: Any = None,
         divergence_threshold: float = DIVERGENCE_THRESHOLD) -> SamplerKernel:
    """Build a NUTS kernel: at most ``max_doublings`` doublings a step, a
    diagonal (dict) or dense (:class:`~binf_tpu_torch.samplers.hmc.
    DenseMetric`) metric or none, and a step size that is a scalar or one
    per chain."""
    vg = value_and_grad(logdensity_fn)

    def init(position: Position) -> NUTSState:
        ld, grad = vg(position)
        return NUTSState(position, ld, grad)

    def step(generator: torch.Generator, state: NUTSState) -> tuple[NUTSState, NUTSInfo]:
        ld0 = state.logdensity
        bshape, dev = ld0.shape, ld0.device
        flat = _Flat(logdensity_fn, state.position, ld0.dim(), inverse_mass)
        q0, g0 = flat.pack(state.position), flat.pack(state.logdensity_grad)
        p0 = flat.pack(sample_momentum(generator, state.position, inverse_mass))
        h0 = -ld0 + flat.kinetic(p0)
        eps = torch.broadcast_to(torch.as_tensor(step_size, dtype=torch.float32, device=dev),
                                 bshape)

        prop = (q0, ld0, g0)
        lw_total = torch.zeros(bshape, device=dev)
        left = right = (q0, p0, g0)
        rho = p0
        sum_alpha = torch.zeros(bshape, device=dev)
        n_leaves = torch.zeros(bshape, dtype=torch.int32, device=dev)
        depth = torch.zeros(bshape, dtype=torch.int32, device=dev)
        turning = torch.zeros(bshape, dtype=torch.bool, device=dev)
        divergent = torch.zeros_like(turning)
        for d in range(max_doublings):
            active = ~turning & ~divergent
            if not chain_rows.any_row(active):  # the one host sync of a doubling
                break
            go_right = chain_rows.rand(bshape, generator=generator, device=dev) < 0.5
            eps_signed = torch.where(go_right, eps, -eps)
            start = [_where(go_right, r, l) for r, l in zip(right, left)]
            sub = _build_subtree(flat, generator, *start, d, eps_signed, h0, active,
                                 max_doublings, divergence_threshold)
            q_end, p_end, _, g_end = sub.end
            sum_alpha = sum_alpha + torch.where(active, sub.sum_alpha, 0.0)
            n_leaves = n_leaves + torch.where(active, sub.num_leaves, 0)

            # a subtree that turned or diverged is discarded whole
            ok = active & ~sub.turning & ~sub.divergent
            left = tuple(_where(ok & ~go_right, e, x) for e, x in zip((q_end, p_end, g_end), left))
            right = tuple(_where(ok & go_right, e, x) for e, x in zip((q_end, p_end, g_end), right))

            # biased progressive sampling between the trajectory and the subtree
            u = chain_rows.rand(bshape, generator=generator, device=dev)
            take_new = (u < torch.exp(sub.log_weight - lw_total)) & ok
            prop = (_where(take_new, sub.proposal[0], prop[0]),
                    torch.where(take_new, sub.proposal[1], prop[1]),
                    _where(take_new, sub.proposal[2], prop[2]))
            lw_total = torch.where(ok, torch.logaddexp(lw_total, sub.log_weight), lw_total)

            # the whole trajectory's U-turn check
            rho = _where(ok, rho + sub.momentum_sum, rho)
            full_turn = flat.is_turning(rho, left[1], right[1])
            turning = torch.where(active, sub.turning | (ok & full_turn), turning)
            divergent = torch.where(active, sub.divergent, divergent)
            depth = depth + active.to(torch.int32)

        new_state = NUTSState(flat.unpack(prop[0]), prop[1], flat.unpack(prop[2]))
        info = NUTSInfo(acceptance_prob=sum_alpha / torch.clamp_min(n_leaves, 1),
                        is_divergent=divergent, is_turning=turning, num_doublings=depth,
                        num_integration_steps=n_leaves, energy=h0)
        return new_state, info

    return SamplerKernel(init=init, step=step)

