"""The production driver: long runs in blocks, with checkpoint and resume,
streaming moments, metrics and divergence accounting (port of
``binf_tpu/parallel/production.py``).

* :func:`run_blocks` steps an eager ``SamplerKernel`` over a chain batch,
  ``block_size`` sweeps at a time; between blocks the host logs,
  checkpoints and stops early.  Moments pool every chain and step into a
  streaming Welford state on the chains' device, so memory is O(state),
  not O(draws); thinned draws can be kept too.  The carry holds the
  generator, so a resumed run continues the same stream.
* :func:`run_fused_blocks` adapts once (the eager warmup, K3, or the eager
  dense warmup), then runs one K4 call a block and merges the blocks'
  moments with Chan's combine.  Every block draws from one run seed at its
  absolute step (``block_offset``), so B blocks end bit for bit where one
  K4 call of ``B * block_size`` steps ends, and a resumed run ends where
  the uninterrupted one does.

Checkpoints are ``io/checkpoint.py``'s; a resume whose checkpoint file does
not exist starts fresh.  Under a mesh (``parallel/mesh.py``) each rank
runs K4 on its rows with the run seed plus its index; a checkpoint is
gathered to rank 0 and written as one file in the same format, which a
run under the same mesh resumes from by taking its rows (and a run with
no mesh loads whole).
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import torch

from binf_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from binf_tpu_torch.io.metrics import MetricsLogger
from binf_tpu_torch.ops.math import WelfordState, welford_init, welford_variance
from binf_tpu_torch.ops.tree import tree_leaves, tree_map
from binf_tpu_torch.samplers.adaptation import welford_batch_update
from binf_tpu_torch.samplers.base import SamplerKernel

__all__ = [
    "FusedBlocksCarry",
    "FusedBlocksResult",
    "InferenceCarry",
    "InferenceResult",
    "run_blocks",
    "run_fused_blocks",
]


class InferenceCarry(NamedTuple):
    states: Any
    generator: torch.Generator
    moments: WelfordState
    n_divergences: torch.Tensor  # (chains,) int32, cumulative
    step: torch.Tensor  # () int32


class InferenceResult(NamedTuple):
    carry: InferenceCarry
    mean: Any
    variance: Any
    draws: Any | None  # (kept, chains, ...) with collect_draws
    divergence_fraction: float
    elapsed: float


def _resume(checkpoint_path, resume: bool, template):
    """The checkpointed carry, or ``None`` when there is nothing to resume
    (no path, no ``resume``, or no file yet: a fresh start)."""
    if not (resume and checkpoint_path is not None and os.path.exists(checkpoint_path)):
        return None
    return load_checkpoint(checkpoint_path, template)


def _checkpoint_due(checkpoint_path, every: int, block: int) -> bool:
    return checkpoint_path is not None and every > 0 and (block + 1) % every == 0


def run_blocks(kernel: SamplerKernel, initial_states: Any, generator: torch.Generator,
               num_steps: int, block_size: int = 100, thin: int = 1,
               collect_draws: bool = False, checkpoint_path: str | None = None,
               checkpoint_every_blocks: int = 0, resume: bool = False,
               logger: MetricsLogger | None = None) -> InferenceResult:
    """Run ``num_steps`` sweeps of a chain batch in ``block_size`` blocks.

    ``initial_states`` carries a leading chain axis and ``generator`` lies
    on its device (the JAX package takes a key).  The kernel's info may
    have ``is_divergent`` (bool per chain); without it divergences count as
    zero.  Returns the streaming moments pooled over chains and steps, and
    with ``collect_draws`` every ``thin``-th position of each block.
    ``resume`` continues from ``checkpoint_path`` when it exists."""
    if num_steps % block_size:
        raise ValueError(f"num_steps={num_steps} must be a multiple of block_size={block_size}")
    if collect_draws and block_size % thin:
        raise ValueError(f"block_size={block_size} must be a multiple of thin={thin}")
    first = tree_leaves(initial_states)[0]
    n_chains, device = first.shape[0], first.device
    position_template = tree_map(lambda x: x[0], initial_states.position)
    carry = InferenceCarry(initial_states, generator, welford_init(position_template),
                           torch.zeros(n_chains, dtype=torch.int32, device=device),
                           torch.zeros((), dtype=torch.int32, device=device))
    resumed = _resume(checkpoint_path, resume, carry)
    carry = carry if resumed is None else resumed

    all_draws = []
    t0 = time.perf_counter()
    n_blocks = num_steps // block_size
    for b in range(int(carry.step) // block_size, n_blocks):
        states, moments, ndiv = carry.states, carry.moments, carry.n_divergences
        kept = []
        for s in range(block_size):
            states, infos = kernel.step(carry.generator, states)
            moments = welford_batch_update(moments, states.position)
            div = getattr(infos, "is_divergent", None)
            if div is not None:
                ndiv = ndiv + div.to(torch.int32)
            if collect_draws and (s + 1) % thin == 0:
                kept.append(states.position)
        if collect_draws:
            all_draws.append(tree_map(lambda *xs: torch.stack(xs), *kept))
        carry = InferenceCarry(states, carry.generator, moments, ndiv, carry.step + block_size)
        if logger is not None:
            logger.log(step=int(carry.step), n_chains=n_chains,
                       divergence_frac=float((carry.n_divergences > 0).float().mean()))
        if _checkpoint_due(checkpoint_path, checkpoint_every_blocks, b):
            save_checkpoint(checkpoint_path, carry)
    divergence_fraction = float((carry.n_divergences > 0).float().mean())  # waits for the card
    elapsed = time.perf_counter() - t0
    draws = None
    if collect_draws and all_draws:
        draws = tree_map(lambda *xs: torch.cat(xs), *all_draws)
    return InferenceResult(carry, carry.moments.mean,
                           welford_variance(carry.moments, regularize=False), draws,
                           divergence_fraction, elapsed)


# -- the fused sampling kernel driven in checkpointable blocks ---------------------


class FusedBlocksCarry(NamedTuple):
    """The resumable state between K4 blocks."""

    positions: torch.Tensor  # (C, D) flat unconstrained
    mean: torch.Tensor  # (C, D) Welford mean over every completed block
    m2: torch.Tensor  # (C, D) Welford M2
    count: torch.Tensor  # () float32, steps accumulated
    block: torch.Tensor  # () int32, blocks completed
    step_size: torch.Tensor  # (C,) frozen after the warmup
    inverse_mass: torch.Tensor  # (D,) "xla", (C, D) "fused", (D, D) "dense"


class FusedBlocksResult(NamedTuple):
    carry: FusedBlocksCarry
    mean: dict  # (C, ...) per variable
    variance: dict
    draws: dict | None
    accept_rate: float
    elapsed: float


def _welford_merge(mean_a, m2_a, n_a, mean_b, m2_b, n_b):
    """Chan et al.'s parallel combine of two Welford accumulators."""
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / n)
    return mean, m2, n


def _inverse_mass_shape(warmup: str, C: int, D: int) -> tuple:
    return {"xla": (D,), "fused": (C, D), "dense": (D, D)}[warmup]


def run_fused_blocks(
    logdensity_fn,
    initial_positions: dict,
    key,
    num_steps: int,
    block_size: int = 1000,
    num_warmup: int = 400,
    num_leapfrog: int = 10,
    initial_step_size: float | None = 0.05,
    block_chains: int = 512,
    thin: int | None = None,
    collect_draws: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every_blocks: int = 0,
    resume: bool = False,
    logger: MetricsLogger | None = None,
    host_noise: bool | None = None,
    interpret: bool | None = None,
    mesh=None,
    warmup: str = "xla",
    device=None,
) -> FusedBlocksResult:
    """Drive the fused sampling kernel K4 in checkpointable blocks.

    The warmup runs once, as ``samplers/fused.py::fused_model_hmc`` runs
    it: ``"xla"`` the eager Stan windows (a pooled step size and diagonal
    metric), ``"fused"`` K3 (per chain, pooled over ``block_chains``
    tiles), ``"dense"`` the eager dense windows (a ``(D, D)`` metric).
    Each block is then one K4 call that returns its final positions and
    its Welford moments (``collect_draws``: its draws, every ``thin``-th
    step, and the moments of those); the driver merges the moments across
    blocks, logs, and checkpoints the carry every
    ``checkpoint_every_blocks`` blocks.  ``resume`` restarts from
    ``checkpoint_path`` when the file exists, without the warmup, which
    the checkpoint already holds.

    ``key`` is an int seed or a ``torch.Generator``: the warmup's seed and
    one run seed are drawn from it.  Block b draws K4's Philox noise at
    absolute steps ``b * block_size`` onward (``block_offset``), so the
    blocks make one uninterrupted stream (the JAX package seeds each block
    with ``fold_in(key, b)``).  ``host_noise`` stages each block's noise
    from a ``torch.Generator`` seeded with the run seed plus b (default
    off: Philox runs on both devices here).  ``interpret`` is the Pallas
    interpreter of the TPU package and has no counterpart: ``True``
    raises, the plain versions run with ``device="cpu"``.  Runs on the card
    unless ``device="cpu"``.

    ``mesh``: the chains are sharded over it; shard ``r`` runs every block
    with the run seed plus ``r`` (the JAX package's ``seed +
    axis_index("chain")``), the eager warmups pool over the mesh, the
    accept rate is averaged over it, and the moments, draws and the
    carry's chain-axis fields come back as ``DTensor``\\ s.  Every rank
    reads the checkpoint file; rank 0 writes it, gathered whole.
    """
    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_run, unpack_draws
    from binf_tpu_torch.parallel.collectives import chain_count, pooled_mean
    from binf_tpu_torch.parallel.mesh import local_rows, shard_rows
    from binf_tpu_torch.samplers.fused import (
        _adapt,
        _block_chains,
        _draw_seed,
        _generator,
        _prepare,
        _rank_index,
        _steps_per_block,
    )

    if interpret:
        raise ValueError("interpret= runs the TPU package's Pallas interpreter; here the "
                         "plain versions run with device='cpu'")
    if warmup not in ("xla", "fused", "dense"):
        raise ValueError(f"unknown warmup={warmup!r}; use 'xla', 'dense', or 'fused'")
    if num_steps % block_size:
        raise ValueError(f"num_steps={num_steps} must be a multiple of block_size={block_size}")
    thin = thin or 1
    host_noise = bool(host_noise)
    dev = resolve_device(device)
    rank = _rank_index(mesh)
    density, spec, q0 = _prepare(logdensity_fn, local_rows(initial_positions, mesh), dev)
    C, D = q0.shape
    n_all = chain_count(C, mesh)
    bc = _block_chains(block_chains, C)
    spb = _steps_per_block(block_size, thin)
    generator = _generator(key)
    seed_w, seed_r = _draw_seed(generator), _draw_seed(generator)

    def zeros_carry(c):
        zeros = torch.zeros((c, D), device=dev)
        return FusedBlocksCarry(zeros, zeros, zeros, torch.zeros((), device=dev),
                                torch.zeros((), dtype=torch.int32, device=dev),
                                torch.zeros(c, device=dev),
                                torch.zeros(_inverse_mass_shape(warmup, c, D), device=dev))

    per_chain = _chain_fields(warmup)
    carry = _resume(checkpoint_path, resume, zeros_carry(n_all))
    if carry is not None:  # the global file: take this rank's rows
        carry = carry._replace(**{f: local_rows(getattr(carry, f), mesh) for f in per_chain})
    if carry is None:
        a = _adapt(warmup, logdensity_fn, density, spec, q0, seed_w, num_warmup=num_warmup,
                   num_leapfrog=num_leapfrog, initial_step_size=initial_step_size,
                   per_chain_step_size=False, block_chains=bc, host_noise=host_noise,
                   trajectory="fixed", max_leapfrog=num_leapfrog, dev=dev, mesh=mesh)
        carry = zeros_carry(C)
        carry = carry._replace(
            positions=a.positions,
            step_size=torch.broadcast_to(a.step_size.reshape(-1).float(), (C,)).contiguous(),
            inverse_mass=a.inverse_mass)

    all_draws = []
    acc_sum = torch.zeros((), device=dev)
    n_blocks = num_steps // block_size
    start_block = int(carry.block)
    t0 = time.perf_counter()
    for b in range(start_block, n_blocks):
        res = fused_potential_hmc_run(
            density, carry.positions, (seed_r + b if host_noise else seed_r) + rank,
            carry.step_size,
            carry.inverse_mass, num_steps=block_size, num_leapfrog=num_leapfrog,
            block_chains=bc, steps_per_block=spb, host_noise=host_noise, thin=thin,
            collect="draws" if collect_draws else "moments", dense_mass=warmup == "dense",
            block_offset=b * block_size // spb, device=dev)
        if collect_draws:
            all_draws.append(res.draws)
            mean_b = res.draws.mean(dim=0)
            m2_b = ((res.draws - mean_b) ** 2).sum(dim=0)
            n_b = float(res.draws.shape[0])
        else:
            mean_b, m2_b, n_b = res.mean, res.variance * float(block_size - 1), float(block_size)
        mean, m2, count = _welford_merge(carry.mean, carry.m2, carry.count, mean_b, m2_b, n_b)
        acc = pooled_mean(res.accept_rate, mesh)  # the JAX package's pmean
        acc_sum = acc_sum + acc
        carry = carry._replace(positions=res.final_positions, mean=mean, m2=m2, count=count,
                               block=carry.block + 1)
        if logger is not None:
            logger.log(step=(b + 1) * block_size, n_chains=n_all, accept_rate=float(acc))
        if _checkpoint_due(checkpoint_path, checkpoint_every_blocks, b):
            _save(checkpoint_path, carry, mesh, per_chain)
    accept_rate = float(acc_sum) / max(n_blocks - start_block, 1)  # waits for the card
    elapsed = time.perf_counter() - t0

    draws = unpack_draws(torch.cat(all_draws), spec) if collect_draws and all_draws else None
    variance = carry.m2 / torch.clamp_min(carry.count - 1.0, 1.0)
    carry = carry._replace(**{f: shard_rows(getattr(carry, f), mesh) for f in per_chain})
    return FusedBlocksResult(carry, shard_rows(unpack_draws(carry.mean, spec), mesh),
                             shard_rows(unpack_draws(variance, spec), mesh),
                             shard_rows(draws, mesh, dim=1), accept_rate, elapsed)


def _chain_fields(warmup: str) -> tuple[str, ...]:
    """The carry's fields with a chain axis (the metric is per chain only
    after K3)."""
    fields = ("positions", "mean", "m2", "step_size")
    return fields + ("inverse_mass",) if warmup == "fused" else fields


def _save(path: str, carry: FusedBlocksCarry, mesh, per_chain: tuple[str, ...]) -> None:
    """Write the carry; under a mesh every rank sends its rows and rank 0
    writes the whole carry, one file in the format a single process
    writes."""
    if mesh is None:
        save_checkpoint(path, carry)
        return
    import torch.distributed as dist

    from binf_tpu_torch.parallel.collectives import all_gather_rows

    whole = carry._replace(**{f: all_gather_rows(getattr(carry, f), mesh) for f in per_chain})
    if dist.get_rank() == int(mesh.mesh.flatten()[0]):
        save_checkpoint(path, whole)
    dist.barrier(group=_group(mesh))


def _group(mesh):
    from binf_tpu_torch.parallel.mesh import mesh_axis

    return mesh_axis(mesh)[0]
