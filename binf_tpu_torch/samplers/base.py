"""Sampler kernel contract: ``(generator, state) -> (state, info)`` functions
(port of ``binf_tpu/samplers/base.py``).

* a *kernel* is built once from a log-density function and its settings:
  ``kernel = hmc(logdensity_fn, ...)``;
* ``kernel.init(position)`` -> ``State`` (a NamedTuple);
* ``kernel.step(generator, state)`` -> ``(State, Info)``.

Where the JAX package splits a key, a step here draws from one
``torch.Generator`` in sequence, on the device of the state it moves.  A
state may carry leading chain axes: a log density that returns one value
per chain (shape ``B``) makes a kernel step ``B`` independent chains at once
(``parallel/runner.py::run_chains``); a scalar log density is one chain, as
in the JAX package.  Loops run eagerly where JAX scans.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from binf_tpu_torch.ops.tree import tree_map

Position = Any  # dict of named tensors
LogDensityFn = Callable[[Position], torch.Tensor]

__all__ = [
    "LogDensityFn",
    "Position",
    "SamplerKernel",
    "make_logdensity",
    "run_kernel",
    "sample_chain",
]


class SamplerKernel(NamedTuple):
    """A sampling algorithm bound to a target density."""

    init: Callable[[Position], Any]
    step: Callable[[torch.Generator, Any], tuple[Any, Any]]


def make_logdensity(density) -> LogDensityFn:
    """Close a Density (usually a Posterior) over its free variables."""

    def logdensity_fn(position: Position) -> torch.Tensor:
        return density.log_prob(position)

    return logdensity_fn


def _stack_steps(collected: list):
    """Per-step results (trees of the same structure) stacked along a new
    leading step axis."""
    return tree_map(lambda *xs: torch.stack(xs), *collected)


def run_kernel(kernel: SamplerKernel, generator: torch.Generator, initial_state: Any,
               num_steps: int, collect: Callable[[Any, Any], Any] | None = None,
               thin: int = 1):
    """Run ``num_steps`` kernel steps; returns ``(final_state, collected)``.

    ``collect(state, info)`` selects what is stored per kept step (default:
    the position), stacked along a leading step axis.  With ``thin > 1``
    every ``thin``-th step is kept, with the info of that step.
    """
    if collect is None:
        collect = lambda state, info: state.position
    if num_steps % thin:
        raise ValueError("num_steps must be a multiple of thin")
    state, kept = initial_state, []
    for s in range(num_steps):
        state, info = kernel.step(generator, state)
        if (s + 1) % thin == 0:
            kept.append(collect(state, info))
    return state, _stack_steps(kept)


def sample_chain(kernel: SamplerKernel, generator: torch.Generator, initial_position: Position,
                 num_steps: int, collect: Callable[[Any, Any], Any] | None = None,
                 thin: int = 1):
    """init + run; returns ``(final_state, collected)``."""
    state = kernel.init(initial_position)
    return run_kernel(kernel, generator, state, num_steps, collect=collect, thin=thin)
