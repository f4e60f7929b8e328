"""Multi-chain execution (port of ``binf_tpu/parallel/runner.py``).

The JAX package runs ``scan(vmap(kernel.step))``: one key per (sweep,
chain) under ``vmap``.  Here the kernels step a whole batch of chains in
one call: every leaf of the state carries a leading chain axis, the
samplers and Gibbs blocks vectorise over it (``samplers/base.py``,
``samplers/gibbs.py``), and each sweep draws every chain's noise from one
``torch.Generator`` in bulk.  That keeps the Gamma draw of the conjugate
blocks, a loop until every entry is accepted, out of ``vmap``, which
refuses such data-dependent control flow.  Sweeps run as an eager loop.

``warmup_and_run`` and ``per_chain_step_size_kernel`` come with
``window_adaptation`` (ROADMAP section 1, item 4); ``mesh=`` with item 11.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from binf_tpu_torch.samplers.base import Position, SamplerKernel, run_kernel

__all__ = ["init_chains", "run_chains"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharding chains over a mesh: ROADMAP section 1, item 11")


def init_chains(kernel: SamplerKernel, initial_positions: Position, mesh=None) -> Any:
    """The kernel's state for a chain-batched position (leading axis =
    chains)."""
    _no_mesh(mesh)
    return kernel.init(initial_positions)


def run_chains(kernel: SamplerKernel, generator: torch.Generator, states: Any,
               num_steps: int, collect: Callable[[Any, Any], Any] | None = None,
               thin: int = 1, mesh=None):
    """Run ``num_steps`` sweeps of every chain; returns ``(final_states,
    collected)`` with collected leaves of shape ``(num_steps // thin,
    n_chains, ...)``.  ``generator`` lies on the chains' device."""
    _no_mesh(mesh)
    return run_kernel(kernel, generator, states, num_steps, collect=collect, thin=thin)
