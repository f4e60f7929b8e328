"""Gibbs sampling over posterior blocks (port of ``binf_tpu/samplers/gibbs.py``).

A *block* is a function ``(generator, position) -> (position, info)``
closing over the posterior; its conditional density is the joint
``posterior.log_prob`` with the other blocks' current values bound.  A
sweep runs the blocks in the given dict order.

Blocks move a whole batch of chains at once: the number of leading chain
axes of a position is read from the posterior's variable shapes, and the
conditional density is ``torch.func.vmap``-ed over them, so the kernels
of the blocks (``rwm``, ``hmc``, ``mala``, ``nuts``) draw every chain's
noise in one call and the conjugate blocks (``samplers/conjugate.py``)
draw their Gamma and Gaussian variates batched, outside any ``vmap``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from binf_tpu_torch.samplers.base import Position, SamplerKernel

# a Gibbs block: (generator, full position) -> (full position, info)
BlockFn = Callable[[torch.Generator, Position], tuple[Position, Any]]

__all__ = [
    "BlockFn",
    "GibbsState",
    "direct_block",
    "gibbs",
    "hmc_block",
    "mala_block",
    "mh_block",
    "nuts_block",
]


class GibbsState(NamedTuple):
    position: Position


def gibbs(blocks: dict[str, BlockFn]) -> SamplerKernel:
    """Systematic-scan Gibbs kernel over named blocks, run in the dict's
    order each sweep; the info is a dict of the blocks' infos."""
    names = tuple(blocks)

    def init(position: Position) -> GibbsState:
        return GibbsState(dict(position))

    def step(generator: torch.Generator, state: GibbsState):
        position = dict(state.position)
        infos: dict[str, Any] = {}
        for name in names:
            position, infos[name] = blocks[name](generator, position)
        return GibbsState(position), infos

    return SamplerKernel(init=init, step=step)


def _split_position(position: Position, block_vars: tuple[str, ...]):
    block = {k: position[k] for k in block_vars}
    others = {k: v for k, v in position.items() if k not in block_vars}
    return block, others


def chain_ndim(posterior, position: Position) -> int:
    """Leading chain axes of ``position``: its first variable's dimensions
    beyond the shape the posterior gives that variable."""
    name = sorted(position)[0]
    return position[name].dim() - len(posterior.spec(name).shape)


def _conditional_fn(posterior, others: Position, batch_ndim: int = 0):
    """log p(block | others): the joint with the others bound, vmapped over
    ``batch_ndim`` leading chain axes of both."""

    def joint(block_values: Position, bound: Position) -> torch.Tensor:
        return posterior.log_prob({**block_values, **bound})

    for _ in range(batch_ndim):
        joint = torch.func.vmap(joint)

    def fn(block_values: Position) -> torch.Tensor:
        return joint(block_values, others)

    return fn


def _vars(variables) -> tuple[str, ...]:
    return (variables,) if isinstance(variables, str) else tuple(variables)


def _kernel_block(posterior, variables, build) -> BlockFn:
    """A block that builds ``build(conditional)`` afresh each sweep (the
    others' values change) and takes one step of it from ``init``."""
    block_vars = _vars(variables)

    def block(generator: torch.Generator, position: Position):
        block_pos, others = _split_position(position, block_vars)
        kern = build(_conditional_fn(posterior, others, chain_ndim(posterior, position)))
        state, info = kern.step(generator, kern.init(block_pos))
        return {**position, **state.position}, info

    return block


def mh_block(posterior, variables, step_size, proposal: str = "uniform") -> BlockFn:
    """Random-walk Metropolis block (the reference's RWMC block)."""
    from binf_tpu_torch.samplers.rwm import rwm

    return _kernel_block(posterior, variables, lambda fn: rwm(fn, step_size, proposal))


def hmc_block(posterior, variables, step_size: float = 0.1,
              num_integration_steps: int = 10, inverse_mass: Any = None) -> BlockFn:
    """HMC block: one HMC transition of the block's variables per sweep."""
    from binf_tpu_torch.samplers.hmc import hmc

    return _kernel_block(posterior, variables, lambda fn: hmc(
        fn, step_size=step_size, num_integration_steps=num_integration_steps,
        inverse_mass=inverse_mass))


def mala_block(posterior, variables, step_size: float = 0.1) -> BlockFn:
    """MALA block: one Langevin transition of the block's variables per
    sweep."""
    from binf_tpu_torch.samplers.mala import mala

    return _kernel_block(posterior, variables, lambda fn: mala(fn, step_size))


def nuts_block(posterior, variables, step_size: float = 0.1, max_doublings: int = 8,
               inverse_mass: Any = None) -> BlockFn:
    """NUTS block: one No-U-Turn transition of the block's variables per
    sweep."""
    from binf_tpu_torch.samplers.nuts import nuts

    return _kernel_block(posterior, variables, lambda fn: nuts(
        fn, step_size=step_size, max_doublings=max_doublings, inverse_mass=inverse_mass))


def direct_block(sample_fn: Callable[[torch.Generator, Position], tuple[Position, Any]]) -> BlockFn:
    """Exact-draw block from a direct sampler (conjugate updates):
    ``sample_fn(generator, position) -> (new block values, info)``."""

    def block(generator: torch.Generator, position: Position):
        new_vals, info = sample_fn(generator, position)
        return {**position, **new_vals}, info

    return block
