"""Multi-chain execution (port of ``binf_tpu/parallel/runner.py``).

The JAX package runs ``scan(vmap(kernel.step))``: one key per (sweep,
chain) under ``vmap``.  Here the kernels step a whole batch of chains in
one call: every leaf of the state carries a leading chain axis, the
samplers and Gibbs blocks vectorise over it (``samplers/base.py``,
``samplers/gibbs.py``), and each sweep draws every chain's noise from one
``torch.Generator`` in bulk.  That keeps the Gamma draw of the conjugate
blocks, a loop until every entry is accepted, out of ``vmap``, which
refuses such data-dependent control flow.  Sweeps run as an eager loop.
:func:`warmup_and_run` adapts with ``samplers/adaptation.py::
window_adaptation`` first.  ``mesh=`` raises until ``parallel/mesh.py`` is
ported (ROADMAP section 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from binf_tpu_torch.samplers.base import Position, SamplerKernel, run_kernel

__all__ = ["init_chains", "per_chain_step_size_kernel", "run_chains", "warmup_and_run"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharding chains over a mesh comes with parallel/mesh.py, "
                                  "not ported yet (ROADMAP section 1)")


def per_chain_step_size_kernel(kernel_builder: Callable[[Any, Any], SamplerKernel],
                               inverse_mass: Any) -> SamplerKernel:
    """A kernel whose state is ``(inner_state, step_size)``: chain ``c``
    integrates with ``step_size[c]`` (the sampling counterpart of
    ``window_adaptation(per_chain=True)``).  ``init`` takes ``(position,
    step_size)``; the step size rides along unchanged."""

    def init(carry):
        position, eps = carry
        return (kernel_builder(eps, inverse_mass).init(position), eps)

    def step(generator, carry):
        inner, eps = carry
        new_inner, info = kernel_builder(eps, inverse_mass).step(generator, inner)
        return (new_inner, eps), info

    return SamplerKernel(init=init, step=step)


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


def warmup_and_run(kernel_builder: Callable[[Any, Any], SamplerKernel],
                   initial_positions: Position, generator: torch.Generator,
                   num_warmup: int = 500, num_samples: int = 1000,
                   initial_step_size: float | None = 0.1, target_accept: float = 0.8,
                   thin: int = 1, collect: Callable[[Any, Any], Any] | None = None,
                   mesh=None, per_chain_step_size: bool = False):
    """Window-adapted warmup, then sampling with the frozen kernel.
    ``kernel_builder(step_size, inverse_mass) -> SamplerKernel``; the
    generator lies on the chains' device and feeds both phases in turn.
    ``per_chain_step_size=True`` adapts and samples with a step size per
    chain; ``initial_step_size=None`` seeds the warmup with
    ``find_reasonable_step_size``.  Returns ``(samples, final_states,
    adaptation_result)``."""
    from binf_tpu_torch.samplers.adaptation import window_adaptation

    _no_mesh(mesh)
    init_kernel = kernel_builder(1.0 if initial_step_size is None else initial_step_size, None)
    states = init_kernel.init(initial_positions)
    adapt = window_adaptation(kernel_builder, states, generator, num_steps=num_warmup,
                              initial_step_size=initial_step_size,
                              target_accept=target_accept, per_chain=per_chain_step_size)
    if not per_chain_step_size:
        final_states, samples = run_chains(kernel_builder(adapt.step_size, adapt.inverse_mass),
                                           generator, adapt.final_states, num_samples,
                                           collect=collect, thin=thin)
        return samples, final_states, adapt
    inner_collect = collect if collect is not None else (lambda state, info: state.position)
    final, samples = run_chains(per_chain_step_size_kernel(kernel_builder, adapt.inverse_mass),
                                generator, (adapt.final_states, adapt.step_size), num_samples,
                                collect=lambda carry, info: inner_collect(carry[0], info),
                                thin=thin)
    return samples, final[0], adapt
