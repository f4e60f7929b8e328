"""Driver for the chain-grid kernel (port of
``binf_tpu/samplers/chain_grid.py``).

:func:`chain_grid_model_hmc` runs the eager Stan-window warmup
(``samplers/adaptation.py::window_adaptation`` over ``samplers/hmc.py``),
then the whole sampling phase in K7 (``ops/kernels/chain_grid.py``), where
each chain's density is evaluated at its natural shapes.  The JAX package
built it for data-heavy densities, the reference's own application class:
chromatin restraint fields (``example/chromatin.py::make_gram_logdensity``);
on the card K7 runs that Gram density or the group form of any density
the density compiler lowers (``ops/kernels/density_compiler.py``).
"""

from __future__ import annotations

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels.chain_grid import (
    _card_refusal,
    chain_grid_hmc_run,
    chain_grid_potential_from_scalar,
)
from binf_tpu_torch.ops.kernels.fused_potential import pack_positions
from binf_tpu_torch.samplers.fused import FusedModelResult, _draw_seed, _generator, eager_density

__all__ = ["chain_grid_model_hmc"]


def chain_grid_model_hmc(logdensity_fn, initial_positions: dict, key, num_warmup: int = 400,
                         num_samples: int = 1000, num_leapfrog: int = 10,
                         initial_step_size: float | None = 0.05, block_chains: int = 8,
                         thin: int = 1, mesh=None, host_noise: bool = False,
                         collect: str = "draws", target_accept: float = 0.8,
                         device=None) -> FusedModelResult:
    """Adaptive HMC with the sampling phase in the chain-grid kernel.

    The contract of ``fused_model_hmc(warmup="xla")``: Stan windows, pooled
    dual averaging and a cross-chain diagonal metric on the eager path, then
    draws in unconstrained space (or Welford moments with
    ``collect="moments"``).  ``logdensity_fn`` is the Gram chromatin density
    (batch-polymorphic) or any per-chain scalar callable, which the warmup
    wraps in ``torch.func.vmap``; on the card the kernel runs the Gram
    density or the group form the density compiler makes of the callable
    (one that it refuses raises ``NotImplementedError`` with its reason,
    before the warmup).  ``key`` is an int seed or a ``torch.Generator``:
    the warmup's generator and the kernel's Philox seed are drawn from it.
    ``block_chains`` must divide the chains.  Returns the scalar step size
    and the packed ``(D,)`` inverse mass.  Runs on the card unless
    ``device="cpu"``.

    ``mesh``: the chains are sharded over it (``parallel/mesh.py``): the
    eager warmup pools over the mesh (one generator on every rank), then
    shard ``r`` runs K7 on its rows with the run seed plus ``r``;
    ``block_chains`` must divide a rank's chains.  The accept rate is
    averaged over the mesh; draws, moments and final positions come back
    as ``DTensor``\\ s."""
    from binf_tpu_torch.samplers.fused import _rank_index

    from binf_tpu_torch.parallel.mesh import local_rows

    dev = resolve_device(device)
    initial_positions = local_rows(initial_positions, mesh)
    positions = {k: torch.as_tensor(v).to(dev, torch.float32)
                 for k, v in initial_positions.items()}
    template = {k: v[0] for k, v in positions.items()}
    if isinstance(logdensity_fn, torch.nn.Module):
        logdensity_fn = logdensity_fn.to(dev)
    potential, consts, spec = chain_grid_potential_from_scalar(logdensity_fn, template)
    if dev.type == "cuda":
        _card_refusal(potential)
    n_chains = next(iter(positions.values())).shape[0]
    if n_chains % block_chains:
        raise ValueError(f"chains {n_chains} not divisible by block_chains={block_chains}")
    if num_samples % thin:
        raise ValueError(f"num_samples={num_samples} must be divisible by thin={thin}")
    spb = min(max(50, thin), num_samples)
    while num_samples % spb or spb % thin:
        spb -= 1

    generator = _generator(key)
    adapt = _warmup(logdensity_fn, potential, spec, positions, generator, dev, mesh,
                    num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                    initial_step_size=initial_step_size, target_accept=target_accept)
    res = chain_grid_hmc_run(
        potential, adapt.final_states.position, _draw_seed(generator) + _rank_index(mesh),
        adapt.step_size, adapt.inverse_mass, consts, num_steps=num_samples,
        num_leapfrog=num_leapfrog, block_chains=block_chains, steps_per_block=spb, thin=thin,
        collect=collect, host_noise=host_noise, device=dev)
    im_vec = pack_positions({k: v[None] for k, v in adapt.inverse_mass.items()}, spec)[0]
    out = FusedModelResult(samples=res.draws, accept_rate=res.accept_rate,
                           step_size=adapt.step_size, inverse_mass=im_vec, mean=res.mean,
                           variance=res.variance, final_positions=res.final_positions)
    if mesh is None:
        return out
    from binf_tpu_torch.samplers.fused import _shard_result

    return _shard_result(out, mesh, per_chain_metric=False, per_chain_step=False)


def _warmup(logdensity_fn, potential, spec, positions: dict, generator: torch.Generator, dev,
            mesh, *, num_warmup: int, num_leapfrog: int, initial_step_size,
            target_accept: float):
    """The eager Stan-window warmup on ``positions`` (this rank's rows,
    pooled over the mesh), from a generator seeded by ``generator``'s next
    kernel seed; K7's run seed is the one after it."""
    from binf_tpu_torch.samplers.adaptation import _window_adaptation
    from binf_tpu_torch.samplers.hmc import hmc

    g_warm = torch.Generator(device=dev).manual_seed(_draw_seed(generator))
    # the Gram density, its own potential, takes a chain axis as it is
    batched = logdensity_fn if potential is logdensity_fn else eager_density(logdensity_fn, spec)

    def builder(step_size, inverse_mass):
        return hmc(batched, step_size, num_leapfrog, inverse_mass)

    states = builder(1.0 if initial_step_size is None else initial_step_size,
                     None).init(positions)
    return _window_adaptation(builder, states, g_warm, num_steps=num_warmup,
                              initial_step_size=initial_step_size, target_accept=target_accept,
                              mesh=mesh)
