#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``binf_tpu_torch/csrc`` (nvcc, first use), holds
each kernel against its plain PyTorch version on the card, then drives
twenty-one paths at full width, the first nine each once cold and ``REPS``
times timed (the regression path once, the chromatin path ``CHROM_REPS``,
the chain-grid path ``CG_REPS``),
the next four and the five of the families, the hierarchical posterior,
the samplers and SMC timed once, scored as min bulk ESS (or sweeps) over
the end-to-end wall time:

- ``main_path``: the headline composition of ``bench.py`` (16,384 chains,
  500 fused-warmup steps pooled over one tile of all chains, 4,000 fused
  linear-regression sampling steps at L = 10: K3 then K2);
- ``regression_path``: ``fused_regression_hmc``, the user's route to K2,
  at the JAX package's defaults (8,192 chains, 400 eager Stan-window
  warmup steps, 1,000 K2 steps), gated as the main path;
- ``model_path``: ``fused_model_hmc(warmup="fused")`` on the DSL-built
  polynomial posterior at the same sizes (K3 then K4), bench.py's
  "general kernel" phase through the user's entry point;
- ``chees_path``: the same with ``trajectory="chees"``, ``max_leapfrog=128``
  (K3's ChEES branch, then K4 with jittered trajectories), bench.py's
  ChEES phase;
- ``gibbs_path``: K5, the whole-run collapsed Gibbs kernel, on the same
  data from ``initial_positions`` (16,384 chains, 4,000 sweeps);
- ``collapsed_gibbs_path``: the CLI's gibbs route,
  ``make_collapsed_gibbs_kernel`` through ``init_chains``/``run_chains``
  (16,384 chains, 500 sweeps), held to ``gibbs_path``'s moments;
- ``chromatin_path``: ``examples/run_chromatin.py``'s Gibbs alternation of
  HMC over a 2,048-bead structure (gradients through the restraint
  kernels K6a/K6b) and the exact precision draw, 200 sweeps;
- ``chain_grid_path``: the CLI's ``--algorithm chain-grid`` route,
  ``chain_grid_model_hmc`` on the Gram-form chromatin density of the CLI's
  64-bead model, 2,048 chains: the eager Stan-window warmup (200 steps),
  then 200 sampling steps at L = 10 in the chain-grid kernel K7, beside the
  same 200 steps through the eager HMC route; K7 also alone at 256 beads;
  then its traced phase (``chain_grid_traced_path``, ``cgt_cli_route``):
  the CLI's five other models through the density compiler's group form,
  the functor against torch.func, K7 against its plain version, K7 beside
  K4 from K3's adapted state at 2,048 chains, and ``python -m
  binf_tpu_torch --algorithm chain-grid`` on the polynomial model;
- ``quadratic_path``: ``quadratic_hmc`` through ``init_chains``/``run_chains``
  on the JAX package's recorded leapfrog shape (8,192 chains, D = 128, L =
  32, 200 sweeps), every trajectory in the leapfrog kernel K8;
- ``production_path``: ``run_fused_blocks(warmup="fused")`` at the main
  path's shape (K3, then 4,000 steps as 4 K4 blocks of 1,000 with in-kernel
  moments and a checkpoint after each); a run resumed from block 2's
  checkpoint and one K4 call of all 4,000 steps must end where it ends,
  bit for bit; gated on the merged moments;
- ``dense_path``: ``fused_model_hmc(warmup="dense")`` (8,192 chains, 200
  eager dense warmup steps, cut from 400 for time, 1,000 K4 steps with the
  (D, D) metric), also
  gated on the adapted metric's correlations;
- ``chees_xla_path``: ``fused_model_hmc(warmup="xla", trajectory="chees")``
  (4,096 chains, 100 eager ChEES warmup steps, cut from 400 for time,
  1,000 jittered K4 steps);
- ``router_path``: ``adaptive_hmc`` routing the polynomial density to K3 and
  K4 (2,048 chains; the profiler's view of that run is taken in a fresh
  process, ``router_profile``), the plain 6-D Gaussian callable to K3
  and K4 through its generated functor (the decision; ``traced_path``
  runs it), and the same Gaussian through a triangular solve, which the
  density compiler refuses, to the eager path (1,024 chains, 100 + 150
  steps on the card, cut from 400 + 1,000 for time).

Three more paths drive the tenth and eleventh slices' modules, each
printed as one line:

- ``families_path``: ``fused_model_hmc(warmup="fused")`` on the logistic,
  AR(1) and mixture posteriors (``bench_models.py``'s 8,192 chains, 400 +
  500 steps, L = 10; the data at the JAX package's published sizes), K3
  and K4 instantiated with each family's CUDA functor, which is first held
  against its plain version and ``torch.func`` at 1,024 points, at every
  lane-group width it is instantiated for; each run against an eager HMC
  run at 1,024 chains; each branch also timed at one lane and at its
  width, with its registers and CTAs an SM, and the logistic's and
  mixture's MUFU side of their bounds (``scripts/family_lanes.py`` builds
  and sweeps the other widths);
- ``nuts_path``: the measurement behind ``route_trajectory_sampler``:
  eager fixed-L10 HMC and NUTS at ``max_doublings`` 4 and 8 on the
  hierarchical posterior (2,048 chains, after an eager window warmup;
  depths cut, ``NUTS_STEPS``), and HMC against NUTS at 8 on the chromatin
  posterior at 64 beads (2,048 chains) and 2,048 beads (16 chains);
- ``samplers_path``: MALA, elliptical and random-direction slice sampling
  and NUTS on the logistic posterior (4,096 chains), parallel tempering on
  a bimodal target (1,024 chains) and Gibbs sweeps with MALA and NUTS
  blocks on the polynomial posterior.

And two of the twelfth slice:

- ``hierarchical_path``: ``fused_model_hmc(warmup="fused")`` on the CLI's
  hierarchical model (8 groups, D = 21: the first functor past D = 8) at
  the families path's shape and at 2,048 chains, K3 and K4 instantiated
  with its functor (checked as the families' are, at one lane and at its
  width), each run against eager adaptive HMC on the same potential
  (``HIER_EAGER_*``, cut), with ESS/s, the card's idle share, registers,
  spills and the operations, MUFU and issue bounds; the router's
  decisions at 8 and 20 groups (past the 2 to 16 its functor takes);
- ``smc_path``: ``tempered_smc`` on the polynomial posterior (4,096
  particles, RWM moves) and on a conjugate Gaussian target whose
  evidence has a closed form.

And two of the thirteenth:

- ``vi_path``: the Laplace approximation, ADVI (mean-field and
  full-rank), SVGD and pathfinder at the reference CLI's sizes, their
  steps cut for time (``VI_STEPS``, ``VI_HIER_STEPS``), on the
  polynomial and hierarchical posteriors, eager loops that launch none of
  the port's kernels, with their wall times and the card's idle share
  under mean-field ADVI; gated against the exact conditional Gaussian, the
  Laplace mode against it and ``get_map``, the Laplace evidence against
  ``smc_path``'s;
- ``cli_path``: ``python -m binf_tpu_torch`` at its defaults in a
  subprocess, then ``cli.main`` for the routes under it (the hierarchical
  auto route with the fused warmup at 8,192 and 256 chains, fused, HMC
  from pathfinder starts, SMC, the four VI methods, Gibbs, the chromatin
  chain-grid route, NUTS rerouted), each gated as its counterpart in
  ``tests/test_cli.py``, with the kernels each launched.

And one of the density compiler's:

- ``traced_path``: models with no hand-written functor through the
  density compiler (``ops/kernels/density_compiler.py``): a Student-t
  polynomial regression, a Poisson GLM and the router's 6-D Gaussian,
  each through ``adaptive_hmc(algorithm="auto", warmup="fused")`` at the
  families' shape, its functor held against ``torch.func`` at 1,024
  points, its means against an eager run of the same model (or the known
  moments), with the compiler's trace, nodes and float operations and its
  units' nvcc seconds, registers and spills; and the polynomial posterior
  forced through the compiler, its functor and K3/K4 times beside
  ``LinregDensity``'s.

And one of the fourteenth:

- ``mesh_path``: ``parallel/{mesh,collectives,data_parallel}.py`` on the
  one card: a world of one on NCCL in this process (``fused_model_hmc``
  with the fused warmup at the main shape against the run without a mesh,
  bit for bit; ``python -m binf_tpu_torch ... --mesh``'s hierarchical
  route at 8,192 chains), then two ranks spawned on the card over gloo
  (``chip_smoke.py --mesh-rank``): the fused and ``xla`` warmups at the
  main shape, the chain grid, the block driver with its resume, SMC, the
  sharded polynomial likelihood and the sharded restraint loss at 2,048
  beads, each rank's shard held bit for bit to the single-process kernels
  with the seeds plus its index; wall ms a rank beside the unsharded
  run's and each rank's time in collectives (two ranks sharing one card:
  not scaling numbers).

Besides the paths, K3 and K4 are timed at tiles of 512, 2,048 and 16,384
chains (``SWEEP_BC``, fixed and ChEES; K3 fixed also at L = 1): the
``model_path`` line's ``bc_sweep`` and the ``bc_sweep`` key of both kernels
in the ``kernels`` line.  Their ``lanes``, ``ctas``, ``threads``,
``rounds`` and ``barriers_per_step`` keys are what the timed launch of the
main path (K3) and the model path (K4) reported, the barriers counted by
K3's grid barrier word (``LaunchRecord``).

Every row of the ``kernels`` line carries the grid its timed launch
reported (``_build.LaunchRecord``: CTAs and threads; K2-K5 and K7 also
their lanes a chain, K2-K4 and K7 rounds); K1's, K2's, K5's and K7's also the
share of the bound (``bound_share``), their bounds counting the least work
(L evaluations a step; K7 each unordered pair once; K5 the Gamma rounds and
Philox calls this run's noise needs; a Philox call's integer-pipe slots as
the built SASS has them, at sm_90's rate: ``phase_philox``, which prints
beside K1's bound the floors of its own SASS a chain-step).  The previous
designs' times from ``PERF.md`` are printed beside the new ones on stderr
only.

Progress goes to stderr.  Standard output ends with one JSON line per path,
the card's name and power limit, one JSON line of kernels
(``{"kernels": [...]}``) and, last, ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero; so does a host without a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_CHAINS = 16384
N_WARMUP = 500
N_SAMPLES = 4000
N_LEAPFROG = 10
REPS = 3
K2_CHECK_STEPS = 200
K4_CHECK_STEPS = 200
# plain versions of the sampling kernels are timed over this many of the
# 4,000 steps
PLAIN_CUT = 200
CHEES_MAX_LEAP = 128
# fused_regression_hmc's defaults in the JAX package (binf_tpu/samplers/fused.py:91-101)
# the eager warmup cut from the JAX defaults' 400 steps to keep the
# script within its time limit as later slices add phases
REG_CHAINS, REG_WARMUP, REG_SAMPLES = 8192, 200, 1000
REG_WARMUP_PUBLISHED = 400
# tile widths at which K3 and K4 are timed besides the paths' own
# (samplers/fused.py::auto_block_chains picks the widest, 16,384 chains)
SWEEP_BC = (512, 2048, 16384)
# Philox seeds of the six-step K3 comparisons, fixed and ChEES, each at
# both tile widths
K3_SHORT_SEEDS = (9, 10, 11, 12)
# the statistical ChEES check's warmup at the main width: three plain runs
# of the whole warmup (~20 s each on the card's host at 500 steps), cut to
# 250 steps, a whole Stan window schedule still
K3_CHEES_CHECK_WARMUP = 250
# K5: the check's sweeps, the collapsed-Gibbs route's sweeps and burn-in
K5_CHECK_STEPS = 200
N_COLLAPSED = 500
COLLAPSED_BURN = 100
# chromatin: examples/run_chromatin.py's composition at the bead count the
# JAX package measured its restraint kernel at.  Leapfrog is unstable once
# eps 2 sqrt(lambda) / d_min, for the closest restrained pair, passes 2
# (scripts/chromatin_step_size.py); the step is the reference's 3e-3
# (run_chromatin.py:32) or less, so that this number is at most
# CHROM_EPS_OMEGA on the problem at hand
N_BEADS = 2048
BEAD_BLOCK = 256
OBSERVE_FRAC = 0.3
CHROM_SWEEPS = 200
# the chromatin path's cold run (its sweeps are the timed run's, from the
# same start) and its timed runs: each 200-sweep run is ~10 s of host-bound
# sweeps, so one timed run, as the chain-grid path's
CHROM_COLD_SWEEPS = 10
CHROM_REPS = 1
CHROM_HMC_STEPS = 5
CHROM_MAX_STEP = 3e-3
CHROM_EPS_OMEGA = 1.0
# the chromatin run under the profiler: reading a 200-sweep trace back
# (~177,000 device events) took ~100 s of host time, 40 sweeps ~20 s, so 10
CHROM_PROFILED_SWEEPS = 10
K6_CHECK_BEADS = (2048, 4096)
# copies of W and logD that K6's HBM timing cycles through: 134 MB at
# 2,048 beads, against the card's 50 MB L2
K6_COPIES = 4

# chain-grid path: the CLI's chromatin model (binf_tpu/cli.py:75-88: 64
# beads, observe fraction 0.3) at the JAX package's measured shape
# (benchmarks/bench_chain_grid.py:53-71: 2,048 chains from X_true + 0.1
# noise at precision 20, 200 warmup steps from a step of 0.01, 200 sampling
# steps at L = 10)
CG_BEADS = 64
CG_CHAINS = 2048
CG_WARMUP = 200
CG_SAMPLES = 200
CG_LEAP = 10
CG_STEP0 = 0.01
CG_BLOCK = 8
# timed chain-grid runs: each is ~14 s, nearly all the eager warmup (the
# other timed paths take REPS)
CG_REPS = 1
CG_CHECK_STEPS = 10
# K7 alone at the JAX package's second measured shape (docs/performance.md:237)
CG_BIG_BEADS, CG_BIG_CHAINS, CG_BIG_STEPS = 256, 256, 100
# beads whose coordinates the path's ESS covers, besides the precision
CG_ESS_BEADS = (0, 21, 42, 63)
# quadratic path: benchmarks/bench_kernels.py:36-40's target and shape
Q_CHAINS, Q_DIM, Q_LEAP = 8192, 128, 32
Q_STEP = 0.15
Q_SWEEPS = 200
Q_BURN = 50

# this slice's paths, all on the main path's posterior at its published size:
# the block driver at the main path's shape (4,000 steps in 4 K4 blocks);
# fused_model_hmc(warmup="dense") at fused_regression_hmc's default width;
# the eager ChEES warmup; the router's two decisions
PROD_BLOCKS, PROD_BLOCK_STEPS = 4, 1000
# the eager dense warmup cut from fused_regression_hmc's 400 steps to 200
# for time (~40 ms a step of PyTorch calls on the card's host)
DENSE_CHAINS, DENSE_WARMUP, DENSE_SAMPLES = 8192, 200, 1000
DENSE_WARMUP_PUBLISHED = 400
# the eager ChEES warmup runs 400 steps in ~75 s on the card (~80
# leapfrogs a step, each ~2.3 ms of PyTorch calls): cut to 100 to keep
# the script within half its time limit, then to 60 (on the CPU at
# 60 every gate held, acceptance 0.922)
CX_CHAINS, CX_WARMUP, CX_SAMPLES = 4096, 60, 1000
CX_WARMUP_PUBLISHED = 400
ROUTER_FUSED_CHAINS = 2048
# the eager route steps the callable through torch.func.vmap, ~3.4 ms a
# leapfrog on the card: 400 + 1,000 steps took 47 s, cut to 100 + 250, then
# to 100 + 150 (on the CPU its moments 0.023 and 1.2% off, the gate
# 0.25)
ROUTER_XLA_CHAINS, ROUTER_XLA_WARMUP, ROUTER_XLA_SAMPLES = 1024, 100, 150
ROUTER_XLA_PUBLISHED = (400, 1000)
# warmup steps run under the profiler for an eager warmup's idle share
PROFILED_WARMUP = 10

# the previous designs of K2 (one thread a chain, rows from shared memory),
# K7 (one CTA a chain), K8 (float32 FMA from shared memory), K6b (tiles
# and a second pass over partials) and K5 (one thread a chain, all four
# Gamma rounds every sweep) on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6), printed beside the current kernels' times
PREVIOUS_MS = {"K2": 30.60, "K7": 130.39, "K7 256": 154.78, "K8": 0.4798, "K6b": 0.02871,
               "K5": 15.80, "K1": 1.748}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores (132 SMs x 128 lanes x 2 flops at 1.98 GHz), dense TF32
# FLOP/s on them, int32 operations/s (64 of the 128 lanes per SM: 132 x 64 x
# 1.98 GHz)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 494.7e12
PEAK_I32 = 16.73e12
# SM clocks a second over the card (132 SMs at 1.98 GHz)
SM_CLOCKS = PEAK_F32 / 256
# results a clock an SM on sm_90 (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): every instruction takes
# an issue slot, one a clock on each of 4 schedulers; float32 add, multiply
# and FMA 128; 32-bit integer add, logic, shift, compare and select and
# integer multiply-add 64 (the integer pipe, PEAK_I32); MUFU 16;
# conversions 16
SM90_RATE = {"issue": 128, "fp32": 128, "int": 64, "mufu": 16, "cvt": 16}
# one Philox4x32-10 call's slots of the integer pipe, as the SASS has the
# call (set by phase_philox)
PHILOX_CALL = {}

T0 = time.perf_counter()


def progress(msg: str) -> None:
    print(f"# [{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    progress(f"ok: {what}")


def timed(fn, reps: int = 1):
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events),
    and the last result."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def device_ms(fn, reps: int = 20):
    """Mean device time in ms of ``fn`` over ``reps`` back-to-back calls,
    with the host's launch overhead hidden: the card sleeps while the host
    queues the calls, so the events bracket the kernels alone.  Inputs that
    fit the 50 MB L2 stay there from call to call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(fn, groups: dict):
    """Run ``fn`` once under ``torch.profiler`` and sum the device time of
    its kernels: ``{group: (ms, launches)}`` for the kernels whose names
    hold any of ``groups[group]``, ``"busy"`` over all kernels, and
    ``"wall"``, this run's host-clock ms.  Every other value is None when
    the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host's operator events added nothing read
    # here and took most of the trace's read-back (up to ~18 s after one
    # eager NUTS step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {**{g: None for g in (*groups, "busy")}, "wall": wall_ms}
    out = {"busy": (sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)),
           "wall": wall_ms}
    for group, keys in groups.items():
        hits = [e for e in kernels if any(k in e.name for k in keys)]
        out[group] = (sum(e.time_range.elapsed_us() for e in hits) / 1e3, len(hits))
    return out


def eval_flops(n: int, d: int) -> int:
    """Float operations of one linear-regression potential-and-gradient
    evaluation (csrc/linreg_density.cuh): per data point d FMAs for the
    residual, one subtract, one FMA for the sum of squares and d FMAs for
    the gradient; then the prior and the log-precision terms."""
    return n * (4 * d + 3) + 6 * d + 12


def diag_eval_flops(D: int) -> int:
    """Float operations of one diagonal-Gaussian evaluation
    (csrc/diag_gaussian_density.cuh: a subtract, two divisions and an FMA a
    coordinate, and the half)."""
    return 4 * D + 1


def trajectory_flops(ev: int, D: int, L):
    """One HMC step of D coordinates: L + 1 evaluations of ``ev`` flops, L
    drift-and-kick updates (5 flops a coordinate), momentum and kinetic
    terms.  ``L`` may be a tensor of counts."""
    return (L + 1) * ev + L * 5 * D + 8 * D


def least_run_flops(ev: int, D: int, L: int, steps: int) -> int:
    """The least float work of ``steps`` HMC steps of one chain: U and grad U
    of the start once, then L evaluations a step (the current state's are
    carried: a rejected step keeps them, an accepted one takes the
    endpoint's), with the updates, momentum and kinetic terms."""
    return ev + steps * (trajectory_flops(ev, D, L) - ev)


def bound_ms(bytes_moved: float, flops: float, philox_calls: float):
    """The least ms of work that moves ``bytes_moved`` bytes, does ``flops``
    float32 flops and makes ``philox_calls`` Philox calls, and what bounds
    it: the bytes at the HBM rate, or the busier of two pipes, float32 (the
    flops) and the integer pipe (the calls' IMAD.WIDEs and LOP3s, each
    call's slots as PHILOX_CALL has them)."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = flops / PEAK_F32
    if philox_calls:
        t_ops = max(t_ops, philox_calls * PHILOX_CALL["int"] / PEAK_I32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gibbs_flops(n: int, d: int, rounds: float = 1.0) -> float:
    """The least float work of one K5 sweep of one chain on its Philox
    stream (csrc/fused_gibbs.cu): the residual sum of squares, ``rounds``
    Marsaglia-Tsang rounds (14 each with their two logs: 1 plus the share
    of sweeps whose round 0 rejects, as this run's noise needs), the
    precision, P and its right-hand side, the Cholesky factor (d square
    roots, d(d-1)/2 divisions), the forward and two back solves, the
    update, and 1 + d Box-Muller normals at 20 each (round 0's and the
    coefficients'; round 1's normal with the rejected share)."""
    chol = sum(2 * k for i in range(d) for k in range(i + 1)) + d + d * (d - 1) // 2
    return (n * (2 * d + 3) + rounds * 14 + 3 + d * (d + 1) // 2 + d + 3 * d + chol
            + 3 * d * d + d + (d + rounds) * 20)


def gibbs_philox_calls(d: int, both_reject: float = 0.0) -> float:
    """Philox calls of one K5 sweep at the least: slot 0 (round 0's
    normal), slot 2 (the uniforms), ceil(d/2) coefficient slots, and slot 1
    for the share of sweeps whose rounds 0 and 1 both reject."""
    return 2 + (d + 1) // 2 + both_reject


def gamma_rejections(seed: int, shape: float, n_chains: int, num_steps: int, dev,
                     chunk: int = 100) -> tuple[float, float]:
    """Shares of the sweeps of a K5 run on its Philox stream (``seed``,
    chains ``0..C-1``, sweeps ``0..steps-1``) whose Gamma(``shape``, 1)
    draw rejects round 0, and rounds 0 and 1: the extra rounds, and slot
    1's Philox calls, that the run's noise needs (the decisions depend on
    the noise alone)."""
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg
    from binf_tpu_torch.ops.kernels import prng

    d, c = fg.gamma_constants(shape)
    chains = torch.arange(n_chains, dtype=torch.int64, device=dev)
    rej0 = rej01 = 0
    for s0 in range(0, num_steps, chunk):
        sweeps = torch.arange(s0, min(s0 + chunk, num_steps), dtype=torch.int64, device=dev)
        cc, ss = (t.reshape(-1) for t in torch.meshgrid(chains, sweeps, indexing="ij"))
        gz, gu, _ = prng.gibbs_noise(seed, cc, ss, 1)
        acc = [(v > 0.0) & (m < 0.0)
               for v, m in (fg._round_margin(d, c, gz[r], gu[r]) for r in (0, 1))]
        rej0 += int((~acc[0]).sum())
        rej01 += int((~acc[0] & ~acc[1]).sum())
    total = n_chains * num_steps
    return rej0 / total, rej01 / total


def pairwise_flops(n: int, forces: bool) -> int:
    """Float operations of K6a (forces=False) or K6b over n^2 pairs: three
    differences, d2 + eps (6), the log (1) and the residual (2), then
    W r^2 and the sum (3), or W r / d2 (2) and three force FMAs (6)."""
    return n * n * (12 + (8 if forces else 3))


def gram_eval_flops(n: int) -> int:
    """The least float work of one value-and-gradient evaluation of the Gram
    chromatin density, each unordered pair once, however a kernel computes
    it: the dot product (5), d2 (3), its floor, the log and its half (3),
    both residuals (2), both W r^2 with their sums (6), the force
    coefficient (w r + w' r') / d2 (4), the three differences and both
    beads' force updates (3 + 12), 38 in all; per bead |x|^2, the mean, both
    springs and the gradient's sums, about 40; the scalar terms about 20."""
    return 38 * (n * (n - 1) // 2) + 40 * n + 20


def philox_calls(steps: int, chains: int, D: int) -> int:
    """Philox calls of ``steps`` HMC steps of ``chains`` chains: ceil(D/2)
    momentum slots and the accept uniform per chain and step."""
    return steps * chains * ((D + 1) // 2 + 1)


# -- phases ---------------------------------------------------------------------------


def phase_build(build, shapes=(), grids=()):
    """The package's libraries, K3's and K4's for each of ``shapes`` and
    K7's for each traced density of ``grids``, all nvcc processes at once;
    each shape's seconds are in ``build.SHAPE_BUILDS``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    out_dir = build.build_all(shapes=shapes, grids=grids)
    seconds = time.perf_counter() - t
    tags = [build.shape_names(*shape)[0].split(".", 1)[1] for shape in shapes]
    tags += [build.chain_grid_name(t) for t in grids]
    progress(f"kernels and {len(tags)} shapes {tags} built in {seconds:.1f}s into "
             f"{out_dir.name}; a shape's seconds {build.SHAPE_BUILDS}")
    for log in sorted(out_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                progress(f"ptxas {log.stem}: {line.strip()}")
    return seconds


# Probes of the Philox unit's device functions, one kernel each, for their
# SASS: a Philox call on a loaded counter beside the same loads and stores
# alone, and one step's noise at D = 5 in the kernels' form and the
# previous one beside the step's stores alone
PHILOX_PROBE = r"""
#include "philox.cuh"
using namespace binf;
extern "C" __global__ void call(const uint4* in, uint4* out, unsigned k0, unsigned k1) {
  const uint4 c = in[threadIdx.x];
  const Philox4 b = philox4x32_10(Philox4{c.x, c.y, c.z, c.w}, k0, k1);
  out[threadIdx.x] = make_uint4(b.x, b.y, b.z, b.w);
}
extern "C" __global__ void call_empty(const uint4* in, uint4* out, unsigned k0, unsigned k1) {
  out[threadIdx.x] = in[threadIdx.x];
}
template <bool R>
__device__ void step(unsigned long long seed, unsigned s, float* out) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  float z[5], u;
  step_noise<5, R>(seed, kTagSample, c, s, z, u);
  for (int k = 0; k < 5; ++k) out[6 * c + k] = z[k];
  out[6 * c + 5] = u;
}
extern "C" __global__ void step_new(unsigned long long seed, unsigned s, float* out) {
  step<false>(seed, s, out);
}
extern "C" __global__ void step_reference(unsigned long long seed, unsigned s, float* out) {
  step<true>(seed, s, out);
}
extern "C" __global__ void step_empty(unsigned long long seed, unsigned s, float* out) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < 6; ++k) out[6 * c + k] = __uint_as_float(s + k + (unsigned)seed);
}
"""


def sass_listing(path) -> dict:
    """``{function: [(address, opcode, operands)]}`` of a cubin or a
    library's embedded cubins (``cuobjdump -sass``), NOPs left out."""
    import re

    from binf_tpu_torch.ops.kernels._build import _nvcc

    objdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([objdump, "-sass", str(path)], check=True, capture_output=True,
                          text=True).stdout
    line_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name:
            m = line_re.search(line)
            if m and m.group(2) != "NOP":
                out[name].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def compile_probe(name: str, source: str):
    """``source`` compiled for sm_90a into ``<name>.cubin`` in the build
    directory, against the package's headers."""
    from binf_tpu_torch.ops.kernels._build import CSRC, _nvcc, build_dir

    out_dir = build_dir()
    src = out_dir / f"{name}.cu"
    out = out_dir / f"{name}.cubin"
    src.write_text(source)
    subprocess.run([_nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-I", str(CSRC), "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    return out


_PIPES = {
    "fp32": ("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I", "FSWZADD", "HFMA2",
             "HADD2", "HMUL2"),
    "imad": ("IMAD", "IMUL", "IMAD32I", "IMUL32I"),
    "mufu": ("MUFU",),
    "cvt": ("I2F", "F2I", "F2F", "I2I", "FRND"),
    "lsu": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL", "LDC", "SHFL", "ATOM",
            "ATOMS", "ATOMG", "RED", "LDGSTS", "LDSM", "MEMBAR", "CCTL"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "BAR", "CALL", "RET", "BREAK",
                "S2R", "CS2R", "NANOSLEEP", "YIELD", "DEPBAR", "VOTE", "MATCH", "KILL"),
}


def sass_pipe(op: str) -> str:
    """The pipe an sm_90 instruction issues to: ``fp32`` and ``imad`` (the
    FMA pipe), ``mufu``, ``cvt`` (conversions), ``lsu`` (memory and
    shuffles), ``control``, ``uniform`` (the uniform datapath, once a warp),
    else ``alu`` (integer add, logic, shift, compare, select)."""
    base = op.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    for pipe, ops in _PIPES.items():
        if base in ops:
            return pipe
    return "alu"


def sass_counts(instrs) -> dict:
    """Instructions by pipe (``by_pipe``), by opcode, the IMAD.WIDEs among
    them (``wide``) and in all."""
    by_pipe, by_op = {}, {}
    for _, op, _ in instrs:
        pipe = sass_pipe(op)
        by_pipe[pipe] = by_pipe.get(pipe, 0) + 1
        by_op[op] = by_op.get(op, 0) + 1
    return {"total": len(instrs), "by_pipe": by_pipe, "by_op": by_op,
            "wide": sum(n for op, n in by_op.items() if op.startswith("IMAD.WIDE"))}


def int_slots(counts: dict) -> float:
    """Slots of the integer pipe an instruction mix takes: its integer ALU
    instructions and IMADs, one each."""
    return counts["by_pipe"].get("alu", 0) + counts["by_pipe"].get("imad", 0)


def until_exit(instrs):
    """A function's instructions up to its first EXIT: the path every
    thread takes (slow paths lie past it)."""
    for i, (_, op, _) in enumerate(instrs):
        if op == "EXIT":
            return instrs[:i + 1]
    return instrs


def sass_loop(instrs):
    """The body of a function's widest loop: from the target of its widest
    backward branch to the branch, both included; None if it has none."""
    import re

    best = None
    for addr, op, operands in instrs:
        m = re.search(r"0x([0-9a-f]+)", operands)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            target = int(m.group(1), 16)
            if best is None or addr - target > best[1] - best[0]:
                best = (target, addr)
    return None if best is None else [i for i in instrs if best[0] <= i[0] <= best[1]]


def difference(a: dict, b: dict) -> dict:
    """Counts ``a`` less ``b`` (sass_counts), by pipe and in all."""
    pipes = set(a["by_pipe"]) | set(b["by_pipe"])
    return {"total": a["total"] - b["total"], "wide": a["wide"] - b["wide"],
            "by_pipe": {k: a["by_pipe"].get(k, 0) - b["by_pipe"].get(k, 0) for k in pipes}}


def scaled(counts: dict, k: float) -> dict:
    """Counts (sass_counts) divided by ``k``."""
    return {"total": counts["total"] / k, "wide": counts["wide"] / k,
            "by_pipe": {p: n / k for p, n in counts["by_pipe"].items()}}


def pipe_floors_ms(counts: dict, units: float) -> dict:
    """The least ms of ``units`` repetitions of an instruction mix
    (sass_counts, per thread) over the card at SM90_RATE: the issue slots,
    float32, the integer pipe (int_slots), MUFU and conversions."""
    p = counts["by_pipe"]
    per_rep = {"issue": counts["total"] / SM90_RATE["issue"],
               "fp32": p.get("fp32", 0) / SM90_RATE["fp32"],
               "int": int_slots(counts) / SM90_RATE["int"],
               "mufu": p.get("mufu", 0) / SM90_RATE["mufu"],
               "cvt": p.get("cvt", 0) / SM90_RATE["cvt"]}
    return {k: 1e3 * v * units / SM_CLOCKS for k, v in per_rep.items()}


def ptxas_entries(build, stem: str, key) -> dict:
    """Registers, stack frame, spill bytes and cumulative stack (the call
    tree's) of the kernels of one translation unit from its ``-Xptxas -v``
    log, under ``key(mangled name)`` (kernels it maps to None are skipped;
    so are the properties of the device functions a kernel calls, which
    the log prints after it)."""
    import re

    path = build.build_dir() / f"{stem}.log"
    out, name = {}, None
    for line in (path.read_text().splitlines() if path.exists() else []):
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes cumulative stack size", line)
            if m:
                out[name]["cumulative_stack"] = int(m.group(1))
    return out


def philox_sass(build) -> dict:
    """K1's instructions from the SASS: the step loop of the stand-alone
    kernel at D = 5 with full warps (``philox_noise_kernel<5, true>`` in the
    built library), per chain-step (a pass of the loop is a warp's 32
    chains at as many steps as it has MUFU.RSQ over 5, one per normal); a
    Philox call (PHILOX_PROBE's ``call`` less ``call_empty``) and one
    step's noise in the kernels' form and the previous one (``step_new``,
    ``step_reference`` less ``step_empty``), up to their first EXIT."""
    lib = sass_listing(build.build_dir() / "libphilox.so")
    name = next(k for k in lib if "philox_noise_kernelILi5ELb1E" in k)
    loop = sass_loop(lib[name])
    check(loop is not None, f"K1's step loop found in the SASS of {name}")
    step_loop = sass_counts(loop)
    steps_a_pass = step_loop["by_op"].get("MUFU.RSQ", 0) / 5
    probe = {k: sass_counts(until_exit(v))
             for k, v in sass_listing(compile_probe("philox_probe", PHILOX_PROBE)).items()}
    return {"chain_step": scaled(step_loop, steps_a_pass), "steps_a_pass": steps_a_pass,
            "call": difference(probe["call"], probe["call_empty"]),
            "step_new": difference(probe["step_new"], probe["step_empty"]),
            "step_reference": difference(probe["step_reference"], probe["step_empty"]),
            "call_by_op": probe["call"]["by_op"]}


def noise_accuracy(prng, dev) -> dict:
    """The conversions against float64 Box-Muller on the same bits, in the
    kernels' form and the previous one: the radius over every 23-bit value
    of u1, the cosine over every 23-bit value of u2, the normal on 2^24
    drawn pairs (max abs errors); and the kernels' uniforms against the
    plain version's over every 23-bit value (mismatches)."""
    k = torch.arange(1 << 23, dtype=torch.int64, device=dev)
    high = torch.randint(0, 1 << 9, (1 << 23,), generator=torch.Generator(device=dev)
                         .manual_seed(15), device=dev) << 23
    u64 = (2.0 * k.double() + 1.0) / 2.0 ** 24
    ref = {"radius": torch.sqrt(-2.0 * torch.log(u64)), "cosine": torch.cos(2.0 * math.pi * u64)}
    out = {"uniform_mismatches": int((prng.noise_parts("uniform", k | high)
                                      != prng.bits_to_uniform(k | high)).sum())}
    for part, r in ref.items():
        for form, reference in (("new", False), ("reference", True)):
            v = prng.noise_parts(part, k | high, reference=reference)
            out[f"{part}_{form}"] = float((v.double() - r).abs().max())
    del ref, u64, high
    g = torch.Generator(device=dev).manual_seed(16)
    b1, b2 = (torch.randint(0, 1 << 32, (1 << 24,), generator=g, device=dev) for _ in range(2))
    u1, u2 = (((b & 0x7FFFFF).double() * 2.0 + 1.0) / 2.0 ** 24 for b in (b1, b2))
    z64 = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    for form, reference in (("new", False), ("reference", True)):
        v = prng.noise_parts("normal", b1, b2, reference=reference)
        out[f"normal_{form}"] = float((v.double() - z64).abs().max())
    return out


def phase_philox(prng, dev):
    rng = np.random.default_rng(0)
    ctr = torch.tensor(rng.integers(0, 1 << 32, size=(1 << 16, 4), dtype=np.int64),
                       device=dev)
    seed = 0x299F31D0_A4093822
    bits_kernel = prng.philox_bits(ctr, seed)
    bits_plain = prng.philox4x32_10(ctr, prng._key(seed))
    check(torch.equal(bits_kernel, bits_plain), "Philox bits: kernel == plain, bit for bit")

    # the main path's shape, then ragged ones (the last warp part full, the
    # rows as floats) at every D
    err = 0.0
    for C, steps, D, step0 in ((N_CHAINS, 8, 5, 100), (1000, 20, 3, 7), (77, 5, 8, 3),
                               (64, 40, 1, 0), (4096, 33, 6, 9), (33, 17, 7, 1),
                               (96, 3, 2, 5), (160, 2, 4, 11)):
        z_k, u_k = prng.philox_noise(1234, prng.TAG_SAMPLE, C, steps, D, step0=step0,
                                     device=dev)
        z_p, u_p = prng.philox_noise_plain(1234, prng.TAG_SAMPLE, C, steps, D, step0=step0,
                                           device=dev)
        check(torch.equal(u_k, u_p),
              f"Philox uniforms at C={C}, D={D}, {steps} steps: kernel == plain, bit for bit")
        e = float((z_k - z_p).abs().max())
        # conversions within a few ulp of logf/cosf/sqrtf on normals up to ~5.8
        check(e <= 1e-5, f"Philox normals at C={C}, D={D}: max abs err {e:.3g} <= 1e-5")
        if C == N_CHAINS:
            err = e

    acc = noise_accuracy(prng, dev)
    check(acc["uniform_mismatches"] == 0,
          "Philox uniforms: device functions == plain over every 23-bit value, bit for bit")
    for part in ("radius", "cosine", "normal"):
        check(acc[f"{part}_new"] <= acc[f"{part}_reference"],
              f"Philox {part} against float64: max abs err {acc[f'{part}_new']:.4g} <= the "
              f"logf/cosf/sqrtf form's {acc[f'{part}_reference']:.4g}")

    # the noise volume of one main-path run: warmup and sampling steps
    # (device time, so the host's allocation of the 1.8 GB output is not in
    # it), in turns with the library's counterpart: torch.randn and
    # torch.rand from a CUDA generator (Philox4x32-10 too) at the same volume
    # as K1 writes, 5 normals and 1 uniform a chain and step; the same
    # distribution, not the same bits
    steps = N_WARMUP + N_SAMPLES
    n = steps * N_CHAINS
    gen = torch.Generator(device=dev).manual_seed(7)

    def kernel():
        prng.philox_noise(7, prng.TAG_SAMPLE, N_CHAINS, steps, 5, device=dev)

    def library():
        torch.randn(5 * n, generator=gen, device=dev)
        torch.rand(n, generator=gen, device=dev)

    turns = [device_ms(fn, reps=5) for fn in (kernel, library, kernel, library)]
    ms, library_ms = float(np.mean(turns[0::2])), float(np.mean(turns[1::2]))
    launch = grid_keys(prng._build.last_launch["philox"])

    # the plain version over PLAIN_CUT of the steps (host-bound: ~3 ms a step)
    plain_ms, _ = timed(lambda: prng.philox_noise_plain(7, prng.TAG_SAMPLE, N_CHAINS,
                                                        PLAIN_CUT, 5, device=dev))

    # K1's bound: the larger of its bytes and the least work the stream's
    # counters require, four Philox calls a chain-step on the integer pipe
    # (a call's slots from the SASS of PHILOX_PROBE's ``call``) and the
    # conversions' float work (11 uniforms' adds, 5 products of radius and
    # cosine) on the float pipe.  Beside it, not a bound: the floors of the
    # kernel's own SASS a chain-step at sm_90's rates (issue and each pipe)
    sass = philox_sass(prng._build)
    PHILOX_CALL.update(int=int_slots(sass["call"]))
    bms, by = bound_ms(n * 6 * 4, n * 16, 4 * n)
    step = sass["chain_step"]
    floors = {"bytes": 1e3 * n * 6 * 4 / PEAK_BYTES, **pipe_floors_ms(step, n)}
    ptxas = ptxas_entries(prng._build, "philox",
                          lambda m: next((k for k in ("noise_kernelILi5ELb1E", "bits_kernel",
                                                      "parts_kernel", "step_cycles")
                                          if k in m), None))
    cycles = {}
    for form, reference in (("new", False), ("reference", True)):
        for label, C, threads, reps in (("one_warp", 32, 32, 2000),
                                        ("full", N_CHAINS, 128, 400)):
            c = prng.step_noise_cycles(reference, C, threads, reps, device=dev).double() / reps
            cycles.setdefault(form, {})[label] = float(c.median())
    progress(f"philox: {ms:.4f} ms kernel (the previous design {PREVIOUS_MS['K1']} ms), "
             f"{plain_ms:.1f} ms plain ({PLAIN_CUT} steps), {library_ms:.4f} ms torch.randn + "
             f"torch.rand; bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of it; the SASS's "
             f"floors " + ", ".join(f"{k} {v:.4f}" for k, v in floors.items()))
    progress(f"philox SASS a chain-step: {step['total']} instructions {step['by_pipe']}, "
             f"{step['wide']} IMAD.WIDE; a call {sass['call']} ({PHILOX_CALL['int']:.1f} "
             f"integer slots); a step's noise {sass['step_new']['total']} (the logf/cosf/sqrtf "
             f"form {sass['step_reference']['total']}); ptxas {ptxas}")
    progress(f"philox step cycles: {cycles}; against float64 {acc}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                bound_by=by, floors_ms=floors, turns_ms=turns, sass_per_chain_step=step,
                sass_call=sass["call"], philox_call_int_slots=PHILOX_CALL["int"],
                sass_call_by_op=sass["call_by_op"], sass_step_noise=sass["step_new"],
                sass_step_noise_reference=sass["step_reference"], ptxas=ptxas,
                step_cycles=cycles, float64_errors=acc, launch=launch)


def decision_flips(draws_k, q0, plain_draws, margin):
    """The decisions a kernel run took otherwise than its plain version
    (a step was accepted iff the chain moved; the plain version's is the
    sign of log u - (E0 - E1)), ``(steps, C)``, the chains that flipped one,
    and the largest draw error on the others: flip_check holds these, and
    a caller may skip a perturbed plain run where there is no flip and the
    error lies within flip_check's floor (1e-5)."""
    moved = (draws_k != torch.cat([q0[None], draws_k[:-1]])).any(dim=2)
    flips = moved != (margin < 0)
    flipped = flips.any(dim=0)
    err = float((draws_k - plain_draws)[:, ~flipped].abs().max())
    return moved, flips, flipped, err


def flip_check(label, draws_k, accept_k, q0, plain_draws, margin, accepts_p, err_tol=1e-2,
               margin_tol=1e-3, max_flips=None):
    """A whole-run kernel against its plain version on one noise stream.
    An MH decision within rounding of its threshold may flip between two
    float32 implementations; the flips are found from the kernel's draws
    (a step was accepted iff the chain moved) and the plain version's
    decisions (the sign of log u - (E0 - E1)), and each chain's first flip
    is held to its margin.  Returns the largest draw error on the chains
    that took the same decisions throughout.  ``margin_tol`` (a number, or
    a bound per step and chain) and ``max_flips`` (default 1% of the
    chains) hold the flips where a trajectory amplifies rounding beyond
    the defaults' reach (K7)."""
    n_steps, n_chains = margin.shape
    if max_flips is None:
        max_flips = n_chains // 100
    moved, flips, flipped, err = decision_flips(draws_k, q0, plain_draws, margin)
    chains = torch.nonzero(flipped).flatten()
    first = flips.float().argmax(dim=0)[chains]
    n_flips = int(chains.numel())
    at_flip = margin[first, chains].abs()
    worst = float(at_flip.max()) if n_flips else 0.0
    progress(f"{label}: {n_flips} of {n_chains} chains flipped an MH decision "
             f"(largest |log u - (E0 - E1)| at a first flip {worst:.3g})")
    print(f"{label} MH flips: {n_flips} of {n_chains} chains over {n_steps} steps")
    # float32 rounding moves E0 - E1 by ~1e-5 here: a decision flips only
    # that close to its threshold.  A 1e-6 relative change of the start
    # flips ~0.1% of the plain version's chains over these steps, so 1% is
    # ten times that.
    if torch.is_tensor(margin_tol):
        limit = margin_tol[first, chains]
        check(bool((at_flip < limit).all()),
              f"{label}: each chain's first flipped decision lay within its bound of its "
              f"threshold (largest margin / bound "
              f"{float((at_flip / limit).max()) if n_flips else 0.0:.3g})")
    else:
        check(worst < margin_tol, f"{label}: each chain's first flipped decision lay within "
                                  f"{margin_tol:.3g} of its threshold")
    check(n_flips <= max_flips, f"{label}: {n_flips} flipped chains <= {max_flips}")
    # on chains that took the same decisions throughout: the same 1e-6
    # change of the start moves the plain draws by up to 1.3e-3 at L = 10
    # (err_tol 1e-2), 1.9e-2 with ChEES trajectories of up to 40 steps
    check(err <= err_tol,
          f"{label} draws: max abs err {err:.3g} <= {err_tol} on unflipped chains")
    n_dec = n_steps * n_chains
    check(abs(int(moved.sum()) - float(accept_k) * n_dec) < 1.0,
          f"{label} accept rate counts the kernel's own accepted steps")
    acc_p = float(accepts_p.sum()) / n_dec
    # half a decision of slack: the kernel's rate is a float32 quotient
    check(abs(float(accept_k) - acc_p) * n_dec <= int(flips.sum()) + 0.5,
          f"{label} accept rate {float(accept_k):.6f} vs plain {acc_p:.6f}, apart by no "
          f"more than the {int(flips.sum())} flipped decisions")
    return err, flipped


def perturbed_limits(plain, pert, C: int):
    """flip_check's limits from a plain run and the same run from a start
    moved by 1e-6 (``pert``; None: the run was not needed, the floors): ten
    times what the change moves the draws (on chains whose decisions it
    keeps) and the margins by, and at most 1% of the chains, one at least,
    or three times the change's flips.  Also returns the spread and the
    change's flips (None when not run)."""
    if pert is None:
        return dict(err_tol=1e-5, margin_tol=1e-3, max_flips=max(C // 100, 1)), None, None
    same = ((plain.margin < 0) == (pert.margin < 0)).all(dim=0)
    sp = float((flat_or_self(pert.result.draws) - flat_or_self(plain.result.draws))[:, same]
               .abs().max())
    moved = torch.nan_to_num((pert.margin - plain.margin).abs(), nan=0.0)
    n_pert = int((~same).sum())
    return (dict(err_tol=10 * sp + 1e-5, margin_tol=10 * moved + 1e-3,
                 max_flips=max(C // 100, 1, 3 * n_pert)), sp, n_pert)


def flat_or_self(draws):
    return flat_draws(draws) if isinstance(draws, dict) else draws


def phase_k2_check(fh, density, dev):
    """K2 against its plain version at the main width, on one Philox stream
    and on staged noise in the JAX host-noise layout."""
    g = torch.Generator().manual_seed(3)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((N_CHAINS, 5), generator=g)).to(dev)
    eps = torch.tensor([0.2], device=dev)
    im = torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    gn = torch.Generator(device=dev).manual_seed(12)
    staged = (torch.randn((K2_CHECK_STEPS, 8, N_CHAINS), generator=gn, device=dev),
              torch.rand((K2_CHECK_STEPS, 1, N_CHAINS), generator=gn, device=dev))
    errs = []
    for label, noise in (("K2", None), ("K2 staged", staged)):
        draws_k, acc_k = fh.fused_linreg_hmc_run(
            q0, 11, density.V, density.y, density.prior_var, 1.0, 0.2, eps, inverse_mass=im,
            num_steps=K2_CHECK_STEPS, steps_per_block=K2_CHECK_STEPS, block_chains=N_CHAINS,
            noise=noise, device=dev)
        rec = fh._build.last_launch["fused_linreg_hmc"]
        check(rec.rows_in_registers, f"{label}: the launch held the rows in registers "
                                     f"({rec.ctas} CTAs of {rec.threads} threads)")
        plain = fh.linreg_hmc_plain(density, q0, eps, im, num_steps=K2_CHECK_STEPS,
                                    num_leapfrog=N_LEAPFROG, seed=11, noise=noise)
        torch.cuda.synchronize()
        errs.append(flip_check(label, draws_k, acc_k, q0, plain.draws, plain.margin,
                               plain.accepts)[0])
        del draws_k, plain
    return max(errs)


def perturbed_start(q, k):
    """``q`` moved by a relative 1e-6 (normal, seed 6 + k): the spread of
    float32 rounding, as a change of the start."""
    noise = torch.randn(q.shape, generator=torch.Generator().manual_seed(6 + k))
    return q * (1.0 + 1e-6 * noise.to(q.device))


def near_decisions(margins, margins_s):
    """The MH decisions ``(steps, C)`` of a plain warmup that lie within
    reach of float32 rounding, from its ``log u - dE`` per step (``margins``)
    and those of the same run from a start moved by 1e-6 (``margins_s``,
    the same noise): within 1e-4 of the threshold, or within ten times the
    distance the moved start shifted that decision's dE (a long or unstable
    trajectory amplifies rounding as it amplifies the change of the start).
    Also returns that reach."""
    m_p, m_s = torch.stack(margins), torch.stack(margins_s)
    reach = 1e-4 + 10.0 * torch.nan_to_num((m_s - m_p).abs(), nan=0.0)
    return m_p.abs() < reach, reach


def report_parted_tiles(label, parted, q_k, q_p, margins, reach, bc):
    """Progress lines for each tile whose kernel and plain warmups parted:
    its chains parted by > 1e-3, the largest parting, and its decision
    closest to its threshold relative to its reach (below 1: excused)."""
    m_p = torch.stack(margins).abs()
    for tile in torch.nonzero(parted).flatten().tolist()[:8]:
        sl = slice(tile * bc, (tile + 1) * bc)
        diff = (q_k[sl] - q_p[sl]).abs().amax(dim=1)
        ratio = (m_p[:, sl] / reach[:, sl]).min()
        progress(f"{label}: tile {tile} parted: {int((diff > 1e-3).sum())} chains by > 1e-3, "
                 f"largest {float(diff.max()):.3g}; closest decision {float(m_p[:, sl].min()):.3g}"
                 f" from its threshold, {float(ratio):.3g} of its reach")


def phase_k3_check(fp, density, q_init, dev):
    """K3 against its plain version at the main width, with 512-chain tiles
    and with one tile of all chains.  The pooled warmup is chaotic in
    float32 (a 1e-6 change of the start grows to O(1) in the positions), so
    over 500 steps the two agree as two independent adaptations do: the
    tolerances are ten times the spread a 1e-6 perturbation gave the plain
    version at this shape (per 512-chain tile 2% in eps, 3.7% in the
    metric; pooled 0.08% and 0.19%; one tile 0.012% and 0.12%)."""
    errs = []
    plain_ms = None
    # six steps first, before the chaos grows, at each of K3_SHORT_SEEDS.
    # A decision within rounding of its threshold may flip; the flipped
    # chain then moves its tile's pooled acceptance by ~1/bc, which at 512
    # chains shifts the step size and with it every chain of the tile, and
    # at 16,384 chains shifts nothing past the tolerances.  So a tile
    # agrees (<= 1% of its chains parted by > 1e-3, metric within 1e-2)
    # unless one of its decisions lay within reach of rounding
    # (near_decisions), and at most a quarter of the tiles may be excused so.
    for seed in K3_SHORT_SEEDS:
        for bc in (512, N_CHAINS):
            tiles = N_CHAINS // bc
            kw = dict(num_warmup=6, num_leapfrog=N_LEAPFROG, block_chains=bc)
            q_k, eps_k, im_k = fp.fused_warmup_run(density, q_init, seed, 0.1, device=dev, **kw)
            margins, margins_s = [], []
            pk = dict(target_accept=0.8, init_search=False, **kw)
            q_p, eps_p, im_p = fp.fused_warmup_plain(density, q_init, seed, 0.1,
                                                     margins=margins, **pk)
            fp.fused_warmup_plain(density, perturbed_start(q_init, 0), seed, 0.1,
                                  margins=margins_s, **pk)
            near_dec, reach = near_decisions(margins, margins_s)
            near = near_dec.reshape(-1, tiles, bc).any(2).any(0)
            parted = ((q_k - q_p).abs().amax(dim=1) > 1e-3).reshape(tiles, bc).float().mean(1)
            rel_i = ((im_k - im_p).abs() / im_p).reshape(tiles, bc * 5).amax(1)
            agree = (parted <= 0.01) & (rel_i <= 1e-2)
            excused = int((~agree & near).sum())
            report_parted_tiles(f"K3 seed {seed} bc={bc}", ~agree, q_k, q_p, margins, reach, bc)
            check(bool((agree | near).all()) and excused <= tiles // 4,
                  f"K3 seed {seed} bc={bc}, 6 steps: {int(agree.sum())} of {tiles} tiles agree "
                  f"(<= 1% of chains parted by > 1e-3, metric rel err <= 1e-2), {excused} "
                  f"excused for a decision within reach of rounding; worst tile: "
                  f"{float(parted.max()):.2%} parted, metric {float(rel_i.max()):.3g}")
            # six steps leave a one-step final buffer: eps is the reset value
            check(bool(torch.equal(eps_k, eps_p)), f"K3 seed {seed} bc={bc}, 6 steps: eps equal")
    for bc, tile_rtol, pooled_rtol in ((512, (0.2, 0.4), (0.01, 0.02)),
                                       (N_CHAINS, (0.01, 0.02), (0.01, 0.02))):
        kw = dict(num_warmup=N_WARMUP, num_leapfrog=N_LEAPFROG, block_chains=bc)
        q_k, eps_k, im_k = fp.fused_warmup_run(density, q_init, 5, 0.1, device=dev, **kw)
        ms_p, (q_p, eps_p, im_p) = timed(lambda: fp.fused_warmup_plain(
            density, q_init, 5, 0.1, target_accept=0.8, init_search=False, **kw))
        if bc == N_CHAINS:
            plain_ms = ms_p
        tiles = N_CHAINS // bc
        e_k, e_p = eps_k.reshape(tiles, bc)[:, 0], eps_p.reshape(tiles, bc)[:, 0]
        i_k, i_p = im_k.reshape(tiles, bc, 5)[:, 0], im_p.reshape(tiles, bc, 5)[:, 0]
        check(bool(torch.isfinite(q_k).all()), f"K3 bc={bc}: finite positions")
        rel_e = float(((e_k - e_p).abs() / e_p).max())
        rel_i = float(((i_k - i_p).abs() / i_p).max())
        check(rel_e <= tile_rtol[0] and rel_i <= tile_rtol[1],
              f"K3 bc={bc}: per tile eps rel err {rel_e:.3g} <= {tile_rtol[0]}, "
              f"metric {rel_i:.3g} <= {tile_rtol[1]}")
        rel_pe = abs(float(e_k.mean() / e_p.mean()) - 1.0)
        rel_pi = float((i_k.mean(0) / i_p.mean(0) - 1.0).abs().max())
        check(rel_pe <= pooled_rtol[0] and rel_pi <= pooled_rtol[1],
              f"K3 bc={bc}: pooled eps rel err {rel_pe:.3g} <= {pooled_rtol[0]}, "
              f"metric {rel_pi:.3g} <= {pooled_rtol[1]}")
        errs.append(float((eps_k - eps_p).abs().max()))
        progress(f"K3 bc={bc}: eps kernel {float(e_k.mean()):.5f} plain "
                 f"{float(e_p.mean()):.5f}; metric kernel {i_k.mean(0).tolist()}")
    return max(errs), plain_ms


def grid_keys(record):
    """The grid (CTAs, threads a CTA) a launch of K1, K5, K6 or K8 reported
    (``_build.LaunchRecord``)."""
    return dict(ctas=record.ctas, threads=record.threads)


def launch_keys(record):
    """The grid a whole-run kernel's launch reported and the grid barriers
    its run passed a step (``_build.LaunchRecord``)."""
    return dict(lanes=record.lanes, ctas=record.ctas, threads=record.threads,
                rounds=record.rounds, cooperative=record.cooperative,
                barriers_per_step=record.barriers_per_step())


def phase_bc_sweep(fp, density, q_init, dev):
    """K3 and K4 at the main width with tiles of SWEEP_BC chains, fixed and
    ChEES: kernel ms (CUDA events, mean of 2 launches after a warm one) and
    K3's launch; K3 fixed also at L = 1, whose difference from L = 10 is
    the trajectories' share of a step.  K4 samples N_SAMPLES steps from the
    sweep's warmup, so its ChEES trajectories follow that tile width's T."""
    out = {}
    for bc in SWEEP_BC:
        row = {}
        for traj in ("fixed", "chees"):
            kw = dict(num_warmup=N_WARMUP, num_leapfrog=N_LEAPFROG, block_chains=bc,
                      trajectory=traj, max_leapfrog=CHEES_MAX_LEAP, device=dev)
            if traj == "chees":
                kw["target_accept"] = 0.651
            warm = fp.fused_warmup_run(density, q_init, 31, 0.1, **kw)
            ms3, warm = timed(lambda: fp.fused_warmup_run(density, q_init, 31, 0.1, **kw), 2)
            k3 = launch_keys(fp._build.last_launch["fused_warmup"])
            run_kw = dict(num_steps=N_SAMPLES, num_leapfrog=N_LEAPFROG, block_chains=bc,
                          steps_per_block=50, trajectory=traj, max_leapfrog=CHEES_MAX_LEAP,
                          traj_length=warm[3] if traj == "chees" else None, device=dev)
            fp.fused_potential_hmc_run(density, warm[0], 32, warm[1], warm[2], **run_kw)
            ms4, res = timed(lambda: fp.fused_potential_hmc_run(density, warm[0], 32, warm[1],
                                                                warm[2], **run_kw), 2)
            check(bool(torch.isfinite(warm[0]).all()) and bool(torch.isfinite(res.draws).all()),
                  f"bc sweep {bc} {traj}: finite warmup and draws")
            row[traj] = dict(k3_ms=ms3, k4_ms=ms4, accept=float(res.accept_rate),
                             eps=float(warm[1].mean()), k3_launch=k3)
            if traj == "fixed":
                kw1 = dict(kw, num_leapfrog=1)
                fp.fused_warmup_run(density, q_init, 31, 0.1, **kw1)
                row[traj]["k3_l1_ms"], _ = timed(
                    lambda: fp.fused_warmup_run(density, q_init, 31, 0.1, **kw1), 2)
            progress(f"bc sweep {bc} {traj}: K3 {ms3:.3f} ms on {k3['ctas']} CTAs x "
                     f"{k3['rounds']} rounds, {k3['barriers_per_step']} barriers a step"
                     f"{', L = 1: %.3f ms' % row[traj]['k3_l1_ms'] if traj == 'fixed' else ''}"
                     f", K4 {ms4:.3f} ms, eps {row[traj]['eps']:.5f}, "
                     f"accept {row[traj]['accept']:.4f}")
        out[str(bc)] = row
    return out


def leap_flip_check(label, counts_k, counts_p, args):
    """ChEES leapfrog counts of a kernel against its plain version: a count
    is ceil of a float32 argument, and flips between two implementations
    only where the argument lies within rounding of an integer.  Returns
    the flipped (step, tile) mask; each tile's first flip must have had its
    argument within 1e-5 (relative) of an integer."""
    flips = counts_k != counts_p
    tiles = torch.nonzero(flips.any(dim=0)).flatten()
    first = flips.float().argmax(dim=0)[tiles]
    x = args[first, tiles]
    rel = ((x - torch.round(x)).abs() / x) if tiles.numel() else torch.zeros(0)
    worst = float(rel.max()) if tiles.numel() else 0.0
    print(f"{label} leapfrog-count flips: {int(flips.sum())} of {flips.numel()} "
          f"(step, tile) counts, in {int(tiles.numel())} tiles")
    check(worst <= 1e-5, f"{label}: {int(tiles.numel())} tiles flipped a leapfrog count, each "
                         f"first flip within {worst:.3g} (relative) of an integer (<= 1e-5)")
    return flips.any(dim=0)


def phase_k4_check(fp, dens_mod, density, dev):
    """K4 against its plain version at the main width on one Philox stream,
    on both device densities: fixed trajectories with per-chain step sizes
    and a per-chain metric, thinning, moments, a dense metric, the diagonal
    Gaussian, ChEES with a T per 512-chain tile, and bitwise resume."""
    g = torch.Generator().manual_seed(4)
    C, S = N_CHAINS, K4_CHECK_STEPS
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((C, 5), generator=g)).to(dev)
    eps = (0.15 + 0.05 * torch.rand(C, generator=g)).to(dev)
    im = (torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1])
          * (1 + 0.1 * torch.rand((C, 5), generator=g))).to(dev)
    base = dict(num_steps=S, steps_per_block=50, block_chains=512, device=dev)

    def both(density, q0, eps, im, seed=21, **kw):
        res = fp.fused_potential_hmc_run(density, q0, seed, eps, im, **base, **kw)
        plain = fp.fused_potential_hmc_plain(density, q0, seed, eps, im, num_steps=S,
                                             block_chains=512, **kw)
        torch.cuda.synchronize()
        return res, plain

    fixed, plain = both(density, q0, eps, im)
    err, _ = flip_check("K4 fixed", fixed.draws, fixed.accept_rate, q0, plain.result.draws,
                        plain.margin, plain.accepts)

    thin = fp.fused_potential_hmc_run(density, q0, 21, eps, im, thin=2, **base)
    check(torch.equal(thin.draws, fixed.draws[1::2]),
          "K4 thin=2: every second state of the same kernel run, bit for bit")
    mom = fp.fused_potential_hmc_run(density, q0, 21, eps, im, collect="moments", **base)
    ref_mean, ref_var = fixed.draws.mean(0), fixed.draws.var(0)
    m_err = float((mom.mean - ref_mean).abs().max())
    v_err = float(((mom.variance - ref_var).abs() / ref_var.clamp_min(1e-12)).max())
    check(m_err <= 1e-4 and v_err <= 1e-3 and torch.equal(mom.final_positions,
                                                           fixed.final_positions),
          f"K4 moments: the in-kernel Welford mean within {m_err:.3g} (<= 1e-4) and variance "
          f"within {v_err:.3g} relative (<= 1e-3) of the same run's draws")

    M = torch.diag(torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1]))
    M[0, 1] = M[1, 0] = 0.01
    dense, dplain = both(density, q0, eps, M.to(dev), dense_mass=True)
    flip_check("K4 dense", dense.draws, dense.accept_rate, q0, dplain.result.draws,
               dplain.margin, dplain.accepts)

    gauss = dens_mod.DiagGaussianDensity([0.3, -1.0, 0.0, 2.0], [0.5, 1.0, 2.0, 4.0]).to(dev)
    gq0 = (gauss.mean + gauss.scale * torch.randn((C, 4), generator=g).to(dev))
    gres, gplain = both(gauss, gq0, torch.full((C,), 0.9, device=dev), gauss.scale ** 2)
    flip_check("K4 DiagGaussian", gres.draws, gres.accept_rate, gq0, gplain.result.draws,
               gplain.margin, gplain.accepts)

    tiles = C // 512
    T = torch.linspace(0.5, 3.0, tiles).repeat_interleave(512).to(dev)
    counts_k = torch.zeros((S, tiles), dtype=torch.int32, device=dev)
    counts_p = torch.zeros_like(counts_k)
    ch = fp.fused_potential_hmc_run(density, q0, 21, eps, im, trajectory="chees",
                                    traj_length=T, max_leapfrog=CHEES_MAX_LEAP,
                                    leapfrog_counts=counts_k, **base)
    chp = fp.fused_potential_hmc_plain(density, q0, 21, eps, im, num_steps=S,
                                       block_chains=512, trajectory="chees", traj_length=T,
                                       max_leapfrog=CHEES_MAX_LEAP, leapfrog_counts=counts_p)
    torch.cuda.synchronize()
    _, args = fp.chees_leapfrog_counts(T[::512], eps[::512], S, CHEES_MAX_LEAP)
    leap_flip_check("K4 ChEES", counts_k, counts_p, args)
    progress(f"K4 ChEES: mean leapfrog count {float(counts_k.float().mean()):.2f}")
    flip_check("K4 ChEES", ch.draws, ch.accept_rate, q0, chp.result.draws, chp.margin,
               chp.accepts, err_tol=0.2)

    one = fp.fused_potential_hmc_run(density, q0, 23, eps, im, **base)
    half = dict(base, num_steps=S // 2)
    a = fp.fused_potential_hmc_run(density, q0, 23, eps, im, **half)
    b = fp.fused_potential_hmc_run(density, a.final_positions, 23, eps, im,
                                   block_offset=S // 2 // 50, **half)
    check(torch.equal(torch.cat([a.draws, b.draws]), one.draws)
          and torch.equal(b.final_positions, one.final_positions),
          "K4 resume: two chained calls with block_offset advanced == one call, bit for bit")
    return err


def phase_k3_chees_check(fp, density, q_init, dev):
    """K3's ChEES branch against its plain version at the main width.  Six
    steps step for step: ChEES trajectories run up to 128 leapfrog steps at
    step sizes dual averaging is still searching for, so float32 rounding
    grows along them, and a tile agrees when its kernel positions (90th
    percentile over the tile's chains) and metric lie within ten times the
    distance a 1e-6 relative change of the start moves the plain version's
    (plus 1e-4), unless it was excused: by an MH decision within reach of
    rounding (``near_decisions``), or by a leapfrog count that flipped
    with its argument within rounding of an integer (checked count by
    count); at each of K3_SHORT_SEEDS.  Then K3_CHEES_CHECK_WARMUP steps
    statistically: the kernel and the
    plain version must agree on eps, the metric and T per tile and pooled
    within three times the spread that two 1e-6 relative changes of the
    start give the plain version in this same run, plus 2%."""
    kw = dict(num_leapfrog=N_LEAPFROG, trajectory="chees", max_leapfrog=CHEES_MAX_LEAP,
              target_accept=0.651)

    for seed, bc in ((s, b) for s in K3_SHORT_SEEDS for b in (512, N_CHAINS)):
        tiles = N_CHAINS // bc
        counts_k = torch.zeros((6, tiles), dtype=torch.int32, device=dev)
        counts_p = torch.zeros_like(counts_k)
        out_k = fp.fused_warmup_run(density, q_init, seed, 0.1, num_warmup=6,
                                    block_chains=bc, leapfrog_counts=counts_k, device=dev, **kw)
        margins, margins_s, args = [], [], []
        pk = dict(num_warmup=6, block_chains=bc, init_search=False, **kw)
        out_p = fp.fused_warmup_plain(density, q_init, seed, 0.1, margins=margins,
                                      leap_args=args, leapfrog_counts=counts_p, **pk)
        out_s = fp.fused_warmup_plain(density, perturbed_start(q_init, 0), seed, 0.1, margins=margins_s,
                                      **pk)
        torch.cuda.synchronize()
        leap_flipped = leap_flip_check(f"K3 ChEES seed {seed} bc={bc}", counts_k, counts_p,
                                       torch.stack(args))
        near_dec, reach = near_decisions(margins, margins_s)
        near = near_dec.reshape(-1, tiles, bc).any(2).any(0) | leap_flipped

        def dist(a, b):
            # positions: the 90th percentile over a tile's chains (a chain
            # whose decision flipped in the perturbed run does not set it)
            return ((a[0] - b[0]).abs().amax(1).reshape(tiles, bc).quantile(0.9, dim=1),
                    ((a[2] - b[2]).abs() / b[2]).reshape(tiles, bc * 5).amax(1))

        (q_kp, i_kp), (q_sp, i_sp) = dist(out_k, out_p), dist(out_s, out_p)
        agree = (q_kp <= 10 * q_sp + 1e-4) & (i_kp <= 10 * i_sp + 1e-4)
        excused = int((~agree & near).sum())
        report_parted_tiles(f"K3 ChEES seed {seed} bc={bc}", ~agree, out_k[0], out_p[0],
                            margins, reach, bc)
        # a flipped leapfrog count moves every chain of its tile, so one
        # tile may be excused even where there is only one
        check(bool((agree | near).all()) and excused <= max(tiles // 4, 1),
              f"K3 ChEES seed {seed} bc={bc}, 6 steps: {int(agree.sum())} of {tiles} tiles "
              f"agree (positions and metric within 10 x the perturbed plain distance + 1e-4), "
              f"{excused} excused for a flip; worst tile: positions {float(q_kp.max()):.3g} "
              f"(perturbed {float(q_sp.max()):.3g}), metric {float(i_kp.max()):.3g} "
              f"(perturbed {float(i_sp.max()):.3g})")
        # six steps leave a one-step final buffer: eps is the reset value
        # exp(0); T is exp(log T) clamped, within a rounding on agreeing tiles
        eps_k, T_k, eps_p, T_p = out_k[1], out_k[3], out_p[1], out_p[3]
        rel_T = ((T_k - T_p).abs() / T_p).reshape(tiles, bc)[agree]
        worst_T = float(rel_T.max()) if rel_T.numel() else 0.0
        check(bool(torch.equal(eps_k, eps_p)) and worst_T <= 1e-4,
              f"K3 ChEES seed {seed} bc={bc}, 6 steps: eps equal, T within 1e-4 on agreeing "
              f"tiles")
    errs, plain_ms = [], None
    for bc in (N_CHAINS,):
        tiles = N_CHAINS // bc
        W = K3_CHEES_CHECK_WARMUP
        counts = torch.zeros((W, tiles), dtype=torch.int32, device=dev)
        out_k = fp.fused_warmup_run(density, q_init, 5, 0.1, num_warmup=W,
                                    block_chains=bc, leapfrog_counts=counts, device=dev, **kw)
        pk = dict(num_warmup=W, block_chains=bc, init_search=False, **kw)
        ms_p, out_p = timed(lambda: fp.fused_warmup_plain(density, q_init, 5, 0.1, **pk))
        spread_runs = [fp.fused_warmup_plain(density, perturbed_start(q_init, k), 5, 0.1, **pk)
                       for k in range(2)]
        if bc == N_CHAINS:
            plain_ms = ms_p
        check(bool(torch.isfinite(out_k[0]).all()), f"K3 ChEES bc={bc}: finite positions")
        eps_k, T_k = out_k[1], out_k[3]
        check(bool((T_k >= eps_k * (1 - 1e-6)).all())
              and bool((T_k <= CHEES_MAX_LEAP * eps_k * (1 + 1e-6)).all()),
              f"K3 ChEES bc={bc}: T within [eps, {CHEES_MAX_LEAP} eps]")

        def per_tile(out):
            return (out[1].reshape(tiles, bc)[:, 0], out[2].reshape(tiles, bc, 5)[:, 0],
                    out[3].reshape(tiles, bc)[:, 0])

        def rel(a, b):
            return float(((a - b).abs() / b).max()), float((a.mean(0) / b.mean(0) - 1.0).abs().max())

        for i, name in enumerate(("eps", "metric", "T")):
            p = per_tile(out_p)[i]
            tile_k, pool_k = rel(per_tile(out_k)[i], p)
            spread = [rel(per_tile(s)[i], p) for s in spread_runs]
            tile_s, pool_s = max(x[0] for x in spread), max(x[1] for x in spread)
            check(tile_k <= 3 * tile_s + 0.02 and pool_k <= 3 * pool_s + 0.02,
                  f"K3 ChEES bc={bc}, {W} steps: {name} per tile rel err "
                  f"{tile_k:.3g} (perturbed plain {tile_s:.3g}), pooled {pool_k:.3g} "
                  f"(perturbed plain {pool_s:.3g}); bound 3 x perturbed + 0.02")
        errs.append(float((out_k[3] - out_p[3]).abs().max()))
        progress(f"K3 ChEES bc={bc}: eps kernel {float(eps_k.mean()):.5f} plain "
                 f"{float(out_p[1].mean()):.5f}; T kernel {float(T_k.mean()):.4f} plain "
                 f"{float(out_p[3].mean()):.4f}; mean leapfrog count "
                 f"{float(counts.float().mean()):.2f}")
    return max(errs), plain_ms


def gibbs_flip_check(label, draws_k, plain, tol):
    """K5 against its plain version on one noise stream.  A Gamma round's
    accept decision depends on the noise alone and flips between two
    float32 implementations only within rounding of its threshold; a flip
    swaps the chain's precision for another round's, so the draws part by
    far more than rounding.  Each chain's first parting (relative error
    > 1e-3) must fall on a sweep whose plain decision lay within 1e-4 of
    its threshold, at most 1% of the chains may part, and the rest must
    agree within ``tol``.  Returns (largest error on those, flipped)."""
    rel = (draws_k - plain.draws).abs() / plain.draws.abs().clamp_min(1.0)
    parted = (rel > 1e-3).any(dim=2)  # (steps, C)
    flipped = parted.any(dim=0)
    chains = torch.nonzero(flipped).flatten()
    first = parted.float().argmax(dim=0)[chains]
    n_flips = int(chains.numel())
    worst = float(plain.margin[first, chains].max()) if n_flips else 0.0
    print(f"{label} Gamma-round flips: {n_flips} of {flipped.numel()} chains over "
          f"{draws_k.shape[0]} sweeps")
    check(worst < 1e-4, f"{label}: {n_flips} chains parted, each first parting on a sweep "
                        f"whose Gamma decision lay within {worst:.3g} (< 1e-4) of its threshold")
    check(n_flips <= flipped.numel() // 100, f"{label}: {n_flips} flipped chains <= 1%")
    err = float(rel[:, ~flipped].max())
    check(err <= tol, f"{label} draws: max rel err {err:.3g} <= {tol:.3g} on unflipped chains")
    return float((draws_k - plain.draws)[:, ~flipped].abs().max()), flipped


def phase_k5_check(build, fg, density, dev):
    """K5 against its plain version at the main width on one Philox stream,
    the tolerance ten times the spread that a 1e-6 relative change of the
    start gives the plain version (plus 1e-6); neither tiling nor the lanes
    a chain (every G the kernel is built for) change the draws; staged noise
    in the JAX layout gives the plain version's draws."""
    g = torch.Generator().manual_seed(5)
    q0 = torch.cat([1.0 + 0.1 * torch.randn((N_CHAINS, 4), generator=g),
                    torch.ones((N_CHAINS, 1))], 1).to(dev)
    args = (density.V, density.y, density.prior_var, 1.0, 0.2)
    kw = dict(num_steps=K5_CHECK_STEPS, steps_per_block=K5_CHECK_STEPS, device=dev)
    draws_k = fg.fused_linreg_gibbs_run(q0, 31, *args, block_chains=512, **kw)
    plain = fg.fused_linreg_gibbs_plain(density, q0, num_steps=K5_CHECK_STEPS, seed=31)
    q_s = q0 * (1.0 + 1e-6 * torch.randn(q0.shape, generator=g).to(dev))
    spread = fg.fused_linreg_gibbs_plain(density, q_s, num_steps=K5_CHECK_STEPS, seed=31)
    torch.cuda.synchronize()
    sp = float(((spread.draws - plain.draws).abs() / plain.draws.abs().clamp_min(1.0)).max())
    progress(f"K5: a 1e-6 change of the start moves the plain draws by {sp:.3g} (relative)")
    err, _ = gibbs_flip_check("K5", draws_k, plain, 10 * sp + 1e-6)
    one_tile = fg.fused_linreg_gibbs_run(q0, 31, *args, block_chains=N_CHAINS, **kw)
    check(torch.equal(one_tile, draws_k),
          f"K5 block_chains={N_CHAINS} == block_chains=512, bit for bit")
    G = build.last_launch["fused_gibbs"].lanes
    for lanes in fg.LANE_WIDTHS:
        if lanes != G:
            other = fg._gibbs_cuda(density, q0, num_steps=K5_CHECK_STEPS, seed=31, noise=None,
                                   lanes=lanes)
            check(torch.equal(other, draws_k),
                  f"K5 at G = {lanes} lanes a chain == G = {G}, bit for bit")
    steps = 50
    noise = tuple(f((steps, 8, N_CHAINS), generator=g).to(dev)
                  for f in (torch.randn, torch.rand, torch.randn))
    staged_k = fg.fused_linreg_gibbs_run(q0, 0, *args, num_steps=steps, steps_per_block=steps,
                                         block_chains=512, noise=noise, device=dev)
    staged_p = fg.fused_linreg_gibbs_plain(density, q0, num_steps=steps, seed=0, noise=noise)
    torch.cuda.synchronize()
    gibbs_flip_check("K5 staged noise", staged_k, staged_p, 10 * sp + 1e-6)
    return err


def rotating(kernel, X, copies):
    """A call of ``kernel(X, logD, W)`` that takes the next of ``copies``
    of ``(logD, W)`` each time."""
    cycle = itertools.cycle(copies)
    return lambda: kernel(X, *next(cycle))


def phase_k6_check(pw, synthetic_restraints, dev):
    """K6a and K6b against their plain versions on the card: the loss
    within 1e-5 relative (sums of ~N^2/3 positive terms in another order),
    the gradient within 1e-4 of its largest component of the gradient
    torch.autograd takes through the plain loss, two calls bit for bit
    equal.  Returns the errors and times at N = 2,048."""
    out = {}
    for n in K6_CHECK_BEADS:
        g = torch.Generator(device=dev).manual_seed(n)
        X, logD, W = synthetic_restraints(g, n, observe_frac=OBSERVE_FRAC, device=dev)
        X = X + 0.1 * torch.randn(X.shape, generator=g, device=dev)
        x = X.clone().requires_grad_()
        loss = pw.pairwise_restraint_loss(x, logD, W, block=BEAD_BLOCK)
        loss.backward()
        xp = X.clone().requires_grad_()
        loss_p = pw.pairwise_loss_plain(xp, logD, W)
        loss_p.backward()
        lk, lp = float(loss.detach()), float(loss_p.detach())
        rel = abs(lk / lp - 1.0)
        check(rel <= 1e-5, f"K6a N={n}: loss {lk:.6g} vs plain {lp:.6g}, rel err {rel:.3g} "
                           "<= 1e-5")
        g_err = float((x.grad - xp.grad).abs().max())
        scale = float(xp.grad.abs().max())
        check(g_err <= 1e-4 * scale, f"K6b N={n}: gradient max abs err {g_err:.3g} <= 1e-4 x "
                                     f"{scale:.3g} (autograd of the plain loss)")
        x2 = X.clone().requires_grad_()
        loss2 = pw.pairwise_restraint_loss(x2, logD, W, block=BEAD_BLOCK)
        loss2.backward()
        check(torch.equal(loss, loss2) and torch.equal(x.grad, x2.grad),
              f"K6 N={n}: two calls equal bit for bit")
        if n == N_BEADS:
            # cold: consecutive launches read K6_COPIES different copies of
            # W and logD (33.5 MB each pair), so every launch reads its
            # operands from HBM, as the bound assumes; warm: one copy, which
            # stays in the 50 MB L2 as it does inside the chromatin path
            copies = [(logD.clone(), W.clone()) for _ in range(K6_COPIES)]
            fwd_ms = device_ms(rotating(pw.pairwise_loss_cuda, X, copies))
            bwd_ms = device_ms(rotating(pw.pairwise_forces_cuda, X, copies))
            del copies
            fwd_l2 = device_ms(lambda: pw.pairwise_loss_cuda(X, logD, W))
            bwd_l2 = device_ms(lambda: pw.pairwise_forces_cuda(X, logD, W))
            fwd_plain = device_ms(lambda: pw.pairwise_loss_plain(X, logD, W), reps=5)
            bwd_plain = device_ms(lambda: pw.pairwise_forces_plain(X, logD, W), reps=5)
            progress(f"K6 N={n}: device time a launch from HBM K6a {fwd_ms * 1e3:.1f} us, "
                     f"K6b {bwd_ms * 1e3:.1f} us; with W and logD in L2 {fwd_l2 * 1e3:.1f} / "
                     f"{bwd_l2 * 1e3:.1f} us; plain {fwd_plain:.3f} / {bwd_plain:.3f} ms")
            out = dict(fwd_err=abs(lk - lp), bwd_err=g_err,
                       fwd_alone_ms=fwd_ms, bwd_alone_ms=bwd_ms, fwd_l2_ms=fwd_l2,
                       bwd_l2_ms=bwd_l2, fwd_plain_ms=fwd_plain, bwd_plain_ms=bwd_plain)
    return out


# -- paths ----------------------------------------------------------------------------


def main_path(fh, fp, density, V, ys, prior_var, q_init, seed, dev):
    """One complete adaptive run as bench.py scores it: warmup pooled over
    one tile of all chains, eps and metric pooled across chains, sampling."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    qw, eps_c, im_c = fp.fused_warmup_run(density, q_init, seed, 0.1, num_warmup=N_WARMUP,
                                          num_leapfrog=N_LEAPFROG, block_chains=N_CHAINS,
                                          device=dev)
    ev[1].record()
    eps, im = eps_c.mean(), im_c.mean(dim=0)
    draws, acc = fh.fused_linreg_hmc_run(
        qw, seed + 1, V, ys, prior_var, 1.0, 0.2, eps, inverse_mass=im, num_steps=N_SAMPLES,
        num_leapfrog=N_LEAPFROG, block_chains=N_CHAINS, steps_per_block=50, device=dev)
    ev[2].record()
    return draws, acc, eps, im, ev


class KernelSpans:
    """CUDA events around every call of some launch functions of ``module``
    while a path runs: ``names`` maps each function's attribute to the label
    its spans are summed under (the functions are swapped for timed ones)."""

    def __init__(self, module, names: dict):
        self.module, self.names, self.spans = module, names, []

    def _prepare(self, label, args, kw):
        """Hook run before a launch's first event."""

    def _wrap(self, label, fn):
        def launch(*args, **kw):
            self._prepare(label, args, kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            self.spans.append((label, ev))
            return out
        return launch

    def __enter__(self):
        self.saved = {attr: getattr(self.module, attr) for attr in self.names}
        for attr, label in self.names.items():
            setattr(self.module, attr, self._wrap(label, self.saved[attr]))
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.module, attr, fn)

    def ms(self, label):
        return sum(ev[0].elapsed_time(ev[1]) for n, ev in self.spans if n == label)


class LaunchSpans(KernelSpans):
    """The K3 and K4 launches ``fused_model_hmc`` makes, and the ChEES
    leapfrog counts of both."""

    def __init__(self, fp):
        super().__init__(fp, {"_fused_warmup_cuda": "warmup",
                              "_fused_potential_cuda": "sampling"})
        self.counts = {}

    def _prepare(self, label, args, kw):
        if kw.get("trajectory") == "chees":
            steps = kw["num_warmup"] if label == "warmup" else kw["num_steps"]
            q0 = args[1]
            kw["leapfrog_counts"] = self.counts[label] = torch.zeros(
                (steps, q0.shape[0] // kw["block_chains"]), dtype=torch.int32,
                device=q0.device)


def exact_conditional(V, ys, lam: float, dev):
    """The coefficients' exact conditional Gaussian given the precision
    ``lam`` (prior N(0, 5 I)), float64: ``(mean (4,), cov (4, 4))``."""
    Vd, yd = V.double(), ys.double()
    cov = torch.linalg.inv(lam * Vd.T @ Vd + torch.eye(4, device=dev, dtype=torch.float64) / 5.0)
    return cov @ (lam * Vd.T @ yd), cov


def posterior_gates(label, draws, accept, accept_range, V, ys, dev,
                    shape=(N_SAMPLES, N_CHAINS, 5)):
    """The main path's posterior checks on draws ``(steps, C, 5)`` in
    (coefficients, log precision) space, of the expected ``shape``
    (``accept`` None: no acceptance gate); returns min bulk ESS."""
    from binf_tpu_torch.diagnostics import ess

    m_ess = min(float(ess(draws[:, :, :4]).min()), float(ess(torch.exp(draws[:, :, 4]))))
    check(bool(torch.isfinite(draws).all()) and tuple(draws.shape) == tuple(shape),
          f"{label}: finite draws of shape {tuple(shape)}")
    if accept is not None:  # Gibbs draws are exact: no acceptance to gate
        lo, hi = accept_range
        check(lo < accept < hi, f"{label}: acceptance {accept:.4f} in ({lo}, {hi})")
    check(np.isfinite(m_ess) and m_ess > 0, f"{label}: min bulk ESS {m_ess:.1f} > 0")
    kept = draws[draws.shape[0] // 4:].double()
    coeffs = kept[..., :4].reshape(-1, 4)
    prec = torch.exp(kept[..., 4]).reshape(-1)
    Vd, yd = V.double(), ys.double()
    lam = float(prec.mean())
    exact, _ = exact_conditional(V, ys, lam, dev)
    c_err = float((coeffs.mean(0) - exact).abs().max())
    check(c_err < 0.1, f"{label}: coefficient mean within {c_err:.3g} of the exact "
                       "conditional Gaussian at the mean precision (< 0.1)")
    ss = ((yd[:, None] - Vd @ coeffs[::64].T) ** 2).sum(0)
    # the Gamma(1.0, 0.2) prior's conditional: (n / 2 + 1) / (0.2 + ss / 2)
    expected = float(((0.5 * V.shape[0] + 1.0) / (0.2 + ss / 2)).mean())
    check(abs(lam / expected - 1.0) < 0.1,
          f"{label}: precision mean {lam:.4f} vs Gamma self-consistency {expected:.4f} "
          "(rtol 0.1)")
    return m_ess


def regression_path(build, fh, adaptation, fused_regression_hmc, posterior, V, ys, dev):
    """``fused_regression_hmc`` on the card at the JAX package's defaults
    (8,192 chains, 1,000 K2 steps at L = 10, step 0.05) but for the eager
    warmup, REG_WARMUP steps of its 400 (an earlier form of this call
    passed none, so the recorded cut had not applied): a short cold run (20 + 50 steps)
    and one timed run, CUDA events around the warmup and K2; gated as the
    main path."""
    build.reset_launch_counts()
    t = time.perf_counter()
    fused_regression_hmc(posterior, 5, num_warmup=20, num_samples=50, device=dev)
    torch.cuda.synchronize()
    progress(f"regression path cold run: {time.perf_counter() - t:.2f}s")
    with KernelSpans(adaptation, {"window_adaptation": "warmup"}) as warm, \
            KernelSpans(fh, {"_linreg_hmc_cuda": "k2"}) as k2:
        t = time.perf_counter()
        res = fused_regression_hmc(posterior, 6, n_chains=REG_CHAINS, num_warmup=REG_WARMUP,
                                   num_samples=REG_SAMPLES, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = dict(build.LAUNCHES)
    for name in ("philox", "fused_linreg_hmc"):
        check(launches[name] > 0, f"regression path launched {name} {launches[name]} times")
    draws = torch.cat([res.samples["coefficients"],
                       torch.log(res.samples["precision"])[..., None]], -1)
    accept = float(res.accept_rate)
    m_ess = posterior_gates("regression path", draws, accept, (0.6, 0.95), V, ys, dev,
                            shape=(REG_SAMPLES, REG_CHAINS, 5))
    out = {"chains": REG_CHAINS, "warmup": REG_WARMUP, "samples": REG_SAMPLES,
           "cut": {"warmup": [REG_WARMUP_PUBLISHED, REG_WARMUP]},
           "leapfrog": N_LEAPFROG, "e2e_ms": wall * 1e3, "warmup_ms": warm.ms("warmup"),
           "k2_ms": k2.ms("k2"), "accept": accept, "step_size": float(res.step_size),
           "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall, "launches": launches}
    progress(f"regression path: e2e {out['e2e_ms']:.1f} ms, eager warmup "
             f"{out['warmup_ms']:.1f} ms, K2 {out['k2_ms']:.2f} ms, accept {accept:.4f}, eps "
             f"{out['step_size']:.5f}, min bulk ESS {m_ess:.1f}, ESS/s {out['ess_per_s']:.4g}")
    return out


def model_run(fused_model_hmc, logdensity, init, seed, chees, dev, mesh=None):
    return fused_model_hmc(
        logdensity, init, seed, num_warmup=N_WARMUP, num_samples=N_SAMPLES,
        num_leapfrog=N_LEAPFROG, initial_step_size=0.1, block_chains=N_CHAINS,
        warmup="fused", trajectory="chees" if chees else "fixed",
        max_leapfrog=CHEES_MAX_LEAP, device=dev, mesh=mesh)


def model_path(label, build, fp, fused_model_hmc, logdensity, init, V, ys, chees, dev):
    """``fused_model_hmc`` on the DSL posterior: launch counts from 0, one
    cold run, REPS timed runs with CUDA events around K3 and K4."""
    build.reset_launch_counts()
    t = time.perf_counter()
    model_run(fused_model_hmc, logdensity, init, 100, chees, dev)
    torch.cuda.synchronize()
    progress(f"{label} cold run: {time.perf_counter() - t:.2f}s")
    walls, warm_ms, samp_ms = [], [], []
    for rep in range(REPS):
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res = model_run(fused_model_hmc, logdensity, init, 101 + rep, chees, dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        warm_ms.append(spans.ms("warmup"))
        samp_ms.append(spans.ms("sampling"))
    k3_launch = launch_keys(build.last_launch["fused_warmup"])
    k4_launch = launch_keys(build.last_launch["fused_potential_hmc"])
    launches = dict(build.LAUNCHES)
    for name in ("philox", "fused_warmup", "fused_potential_hmc"):
        check(launches[name] > 0, f"{label} launched {name} {launches[name]} times")
    draws = torch.cat([res.samples["coefficients"], res.samples["precision"][..., None]], -1)
    accept = float(res.accept_rate)
    # ChEES adapts eps to 0.651 acceptance over jittered trajectories; the
    # averaged eps it hands the sampler accepts more: 0.92 on this dataset
    # at 512 chains for the JAX package too (scripts/compare_chees_acceptance.py)
    m_ess = posterior_gates(label, draws, accept, (0.45, 0.95) if chees else (0.6, 0.95),
                            V, ys, dev)
    e2e = float(np.mean(walls))
    out = {"chains": N_CHAINS, "warmup": N_WARMUP, "samples": N_SAMPLES,
           "e2e_ms": e2e * 1e3, "e2e_runs_ms": [w * 1e3 for w in walls],
           "warmup_ms": float(np.mean(warm_ms)), "sampling_ms": float(np.mean(samp_ms)),
           "accept": accept, "step_size": float(res.step_size.mean()),
           "min_bulk_ess": m_ess, "ess_per_s": m_ess / e2e, "launches": launches,
           "k3_launch": k3_launch, "k4_launch": k4_launch}
    if chees:
        T, eps = res.trajectory_length, res.step_size
        check(bool((T >= eps * (1 - 1e-6)).all())
              and bool((T <= CHEES_MAX_LEAP * eps * (1 + 1e-6)).all()),
              f"{label}: T {float(T.mean()):.4f} within [eps, {CHEES_MAX_LEAP} eps]")
        out.update(trajectory_length=float(T.mean()),
                   warmup_mean_leapfrog=float(spans.counts["warmup"].float().mean()),
                   sampling_mean_leapfrog=float(spans.counts["sampling"].float().mean()))
    else:
        out["leapfrog"] = N_LEAPFROG
    progress(f"{label}: e2e {out['e2e_ms']:.2f} ms (runs "
             f"{[round(w * 1e3, 2) for w in walls]}), warmup {out['warmup_ms']:.2f} ms, "
             f"sampling {out['sampling_ms']:.2f} ms, accept {accept:.4f}, min bulk ESS "
             f"{m_ess:.1f}, ESS/s {out['ess_per_s']:.4g}")
    return out, res, spans


def gibbs_path(build, fg, V, ys, prior_var, q0, dev):
    """K5 at the main path's data and width: one cold run and REPS timed
    runs of 4,000 sweeps from ``initial_positions``; posterior gates on
    the precision in constrained space, and ESS near the number of draws."""
    from binf_tpu_torch.diagnostics import ess

    def run(seed):
        return fg.fused_linreg_gibbs_run(q0, seed, V, ys, prior_var, 1.0, 0.2,
                                         num_steps=N_SAMPLES, block_chains=512,
                                         steps_per_block=50, device=dev)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(40)
    torch.cuda.synchronize()
    progress(f"gibbs path cold run: {time.perf_counter() - t:.2f}s")
    walls, kern_ms = [], []
    for rep in range(REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        draws = run(41 + rep)
        ev[1].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        kern_ms.append(ev[0].elapsed_time(ev[1]))
    launches = dict(build.LAUNCHES)
    rec = build.last_launch["fused_gibbs"]
    k5_launch = dict(grid_keys(rec), lanes=rec.lanes, rows_in_registers=rec.rows_in_registers)
    check(launches["fused_gibbs"] > 0, f"gibbs path launched fused_gibbs "
                                       f"{launches['fused_gibbs']} times")
    check(bool((draws[..., 4] > 0).all()), "gibbs path: every precision draw positive")
    unc = torch.cat([draws[..., :4], torch.log(draws[..., 4:])], dim=-1)
    m_ess = posterior_gates("gibbs path", unc, None, None, V, ys, dev)
    n_draws = N_SAMPLES * N_CHAINS
    check(m_ess > 0.5 * n_draws, f"gibbs path: min bulk ESS {m_ess:.4g} > half the "
                                 f"{n_draws} draws (collapsed Gibbs draws are nearly iid)")
    e2e = float(np.mean(walls))
    kept = draws[draws.shape[0] // 4:].double()
    moments = dict(coef_mean=kept[..., :4].reshape(-1, 4).mean(0),
                   coef_std=kept[..., :4].reshape(-1, 4).std(0),
                   prec_mean=kept[..., 4].mean(), prec_std=kept[..., 4].std())
    out = {"chains": N_CHAINS, "sweeps": N_SAMPLES, "e2e_ms": e2e * 1e3,
           "e2e_runs_ms": [w * 1e3 for w in walls], "kernel_ms": float(np.mean(kern_ms)),
           "min_bulk_ess": m_ess, "ess_per_draw": m_ess / n_draws, "ess_per_s": m_ess / e2e,
           "launches": launches}
    progress(f"gibbs path: e2e {out['e2e_ms']:.2f} ms (runs "
             f"{[round(w * 1e3, 2) for w in walls]}), kernel {out['kernel_ms']:.2f} ms, min "
             f"bulk ESS {m_ess:.1f} ({m_ess / n_draws:.3f} per draw), ESS/s "
             f"{out['ess_per_s']:.4g}")
    # the kernel's own device time (the profiler; the wrapper's host work
    # and its stream synchronisations are outside it), and the Gamma draws'
    # rejections on the timed runs' streams (the bound's work)
    prof = profile_device(lambda: run(41), {"k5": ("fused_linreg_gibbs",)})
    check(prof["k5"] is not None and prof["k5"][1] == 1,
          f"gibbs path: the profiler saw K5's one launch ({prof['k5']})")
    out["kernel_device_ms"] = prof["k5"][0]
    rej = np.mean([gamma_rejections(41 + rep, 1.0 + 0.5 * V.shape[0], N_CHAINS, N_SAMPLES,
                                    dev) for rep in range(REPS)], axis=0)
    out["round0_rejects"], out["rounds01_reject"] = float(rej[0]), float(rej[1])
    progress(f"gibbs path: K5 device time {out['kernel_device_ms']:.4g} ms; Gamma round 0 "
             f"rejects {out['round0_rejects']:.5f} of the sweeps, rounds 0 and 1 "
             f"{out['rounds01_reject']:.3g}")
    out["k5_launch"] = k5_launch
    return out, moments


def collapsed_gibbs_path(build, poly, init_chains, run_chains, xses, ys, init, moments, dev):
    """The CLI's gibbs route on the card: ``make_collapsed_gibbs_kernel``
    through ``init_chains`` and ``run_chains``, 500 sweeps of 16,384 chains
    (one cold run, REPS timed), held to ``gibbs_path``'s moments: the
    coefficient means within 0.01, their sds within 2%, the precision mean
    within 1% and its sd within 3% (``tests/test_fused_gibbs.py:90-93``
    allow 0.06, 15%, 6% and 25% at 64 chains; at 6.5e6 draws each the
    Monte Carlo error is ~1e-3 of these)."""
    kernel = poly.make_collapsed_gibbs_kernel(poly.make_posterior(xses, ys))

    def run(seed):
        states = init_chains(kernel, init)
        return run_chains(kernel, torch.Generator(device=dev).manual_seed(seed), states,
                          N_COLLAPSED)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(50)
    torch.cuda.synchronize()
    progress(f"collapsed gibbs path cold run: {time.perf_counter() - t:.2f}s")
    walls = []
    for rep in range(REPS):
        t = time.perf_counter()
        _, samples = run(51 + rep)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    launches = dict(build.LAUNCHES)
    c = samples["coefficients"][COLLAPSED_BURN:].double().reshape(-1, 4)
    p = samples["precision"][COLLAPSED_BURN:].double()
    check(bool(torch.isfinite(c).all()) and bool((p > 0).all()),
          "collapsed gibbs path: finite coefficients, positive precisions")
    d_mean = float((c.mean(0) - moments["coef_mean"]).abs().max())
    d_std = float((c.std(0) / moments["coef_std"] - 1.0).abs().max())
    d_pm = abs(float(p.mean() / moments["prec_mean"]) - 1.0)
    d_ps = abs(float(p.std() / moments["prec_std"]) - 1.0)
    check(d_mean <= 0.01 and d_std <= 0.02 and d_pm <= 0.01 and d_ps <= 0.03,
          f"collapsed gibbs path vs gibbs path: coefficient means within {d_mean:.3g} "
          f"(<= 0.01), sds {d_std:.3g} (<= 2%), precision mean {d_pm:.3g} (<= 1%), sd "
          f"{d_ps:.3g} (<= 3%)")
    e2e = float(np.mean(walls))
    out = {"chains": N_CHAINS, "sweeps": N_COLLAPSED, "e2e_ms": e2e * 1e3,
           "e2e_runs_ms": [w * 1e3 for w in walls], "sweeps_per_s": N_COLLAPSED / e2e,
           "coef_mean": c.mean(0).tolist(), "prec_mean": float(p.mean()),
           "moment_diffs": [d_mean, d_std, d_pm, d_ps], "launches": launches}
    progress(f"collapsed gibbs path: e2e {out['e2e_ms']:.2f} ms (runs "
             f"{[round(w * 1e3, 2) for w in walls]}), {out['sweeps_per_s']:.1f} sweeps/s")
    return out


def chromatin_path(build, pw, chrom, gibbs_mod, dev):
    """``examples/run_chromatin.py:49-80`` at 2,048 beads: Gibbs sweeps of
    [HMC over the structure, exact precision draw] from X_true + 0.3 noise
    at precision 5; a cold run of CHROM_COLD_SWEEPS and CHROM_REPS timed
    runs of 200 sweeps, CUDA events around every K6a and K6b launch, then
    one profiled run of CHROM_PROFILED_SWEEPS."""
    # drawn as run_chromatin.py draws it: the problem from seed 0, the
    # start's noise from seed 1, here by generators of the card
    X_true, logD, W = chrom.synthetic_restraints(torch.Generator(device=dev).manual_seed(0),
                                                 N_BEADS, observe_frac=OBSERVE_FRAC, device=dev)
    X0 = X_true + 0.3 * torch.randn(X_true.shape, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(1))
    n_obs = float(W.sum())
    emp_prec = n_obs / float(pw.pairwise_loss_plain(X_true, logD, W))

    def dists(A):
        return torch.cdist(A.double(), A.double())

    mask = W > 0
    d_true = dists(X_true)[mask]
    # the stiffest restraint, near its target at the noise's precision, is a
    # spring of frequency omega = 2 sqrt(lambda) / d_min
    omega = 2 * emp_prec ** 0.5 / float(d_true.min())
    step = min(CHROM_MAX_STEP, CHROM_EPS_OMEGA / omega)
    progress(f"chromatin path: closest restrained pair {float(d_true.min()):.4f}; eps omega "
             f"{CHROM_MAX_STEP * omega:.3f} at the reference's step {CHROM_MAX_STEP}, "
             f"step {step:.4g}")
    post = chrom.make_chromatin_posterior(logD, W, block=BEAD_BLOCK)
    kernel = gibbs_mod.gibbs({
        "structure": gibbs_mod.hmc_block(post, "structure", step_size=step,
                                         num_integration_steps=CHROM_HMC_STEPS),
        "precision": chrom.restraint_precision_block(post)})

    def run(seed, sweeps=CHROM_SWEEPS):
        state = kernel.init({"structure": X0, "precision": torch.tensor(5.0, device=dev)})
        gen = torch.Generator(device=dev).manual_seed(seed)
        precs, accs = [], []
        for _ in range(sweeps):
            state, infos = kernel.step(gen, state)
            precs.append(state.position["precision"])
            accs.append(infos["structure"].acceptance_prob)
        return state, torch.stack(precs), torch.stack(accs)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(1, CHROM_COLD_SWEEPS)
    torch.cuda.synchronize()
    progress(f"chromatin path cold run: {time.perf_counter() - t:.2f}s")
    walls, fwd_ms, bwd_ms, accepts = [], [], [], []
    for rep in range(CHROM_REPS):
        with KernelSpans(pw, {"pairwise_loss_cuda": "k6a",
                              "pairwise_forces_cuda": "k6b"}) as spans:
            t = time.perf_counter()
            state, precs, accs = run(2 + rep)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        fwd_ms.append(spans.ms("k6a"))
        bwd_ms.append(spans.ms("k6b"))
        accepts.append(float(accs.mean()))
    launches = dict(build.LAUNCHES)
    k6_launch = {name: grid_keys(build.last_launch[name])
                 for name in ("pairwise_fwd", "pairwise_bwd")}
    k6_launch["pairwise_bwd"]["loads"] = build.last_launch["pairwise_bwd"].route
    # one more run under the profiler, outside the timed ones: the kernels'
    # device time and the card's busy time over its CHROM_PROFILED_SWEEPS
    prof = profile_device(lambda: run(2 + CHROM_REPS, CHROM_PROFILED_SWEEPS), {
        "k6a": ("pairwise_tile_kernel", "sum_partials"),
        "k6b": ("pairwise_forces_kernel",)})
    per_sweep = (CHROM_HMC_STEPS + 2, CHROM_HMC_STEPS + 1)
    for name, k in zip(("pairwise_fwd", "pairwise_bwd"), per_sweep):
        check(launches[name] == (CHROM_COLD_SWEEPS + CHROM_REPS * CHROM_SWEEPS) * k,
              f"chromatin path launched {name} {launches[name]} times ({k} a sweep)")
    for a in accepts:
        check(0.3 < a < 0.99, f"chromatin path: HMC acceptance {a:.4f} in (0.3, 0.99)")
    accept = accepts[-1]
    X = state.position["structure"]
    check(bool(torch.isfinite(X).all()), "chromatin path: finite structure")
    med = float(((dists(X)[mask] - d_true).abs() / d_true.clamp_min(0.1)).median())
    check(med < 0.15, f"chromatin path: median restrained-distance error {med:.4f} < 0.15")
    prec = float(precs[-50:].mean())
    check(abs(prec / emp_prec - 1.0) < 0.15,
          f"chromatin path: precision {prec:.3f} (mean of the last 50 sweeps) within 15% of "
          f"the noise's empirical precision at the truth, {emp_prec:.3f}")
    e2e = float(np.mean(walls))
    k6 = float(np.mean(fwd_ms)) + float(np.mean(bwd_ms))
    # restraint evaluations as run_chromatin.py:82 counts them
    evals = n_obs * CHROM_SWEEPS * (CHROM_HMC_STEPS + 2)
    out = {"beads": N_BEADS, "restraints": n_obs, "sweeps": CHROM_SWEEPS,
           "hmc_steps": CHROM_HMC_STEPS, "step_size": step,
           "closest_restrained_pair": float(d_true.min()), "eps_omega": step * omega,
           "e2e_ms": e2e * 1e3,
           "e2e_runs_ms": [w * 1e3 for w in walls], "sweeps_per_s": CHROM_SWEEPS / e2e,
           # event spans around each launch: the kernels and any wait of the
           # card for the host's enqueue
           "restraint_evals_per_s": evals / e2e, "k6a_event_ms": float(np.mean(fwd_ms)),
           "k6b_event_ms": float(np.mean(bwd_ms)), "host_gap_ms": e2e * 1e3 - k6,
           "accept": accept, "accept_runs": accepts, "precision": prec, "empirical_precision": emp_prec,
           "median_distance_error": med, "launches": launches}
    if prof["busy"] is not None:
        # the device kernels of a launch: K6a a tile and a sum kernel, K6b one
        out.update(k6a_device_ms=prof["k6a"][0], k6b_device_ms=prof["k6b"][0],
                   k6a_device_launch_ms=2 * prof["k6a"][0] / max(prof["k6a"][1], 1),
                   k6b_device_launch_ms=prof["k6b"][0] / max(prof["k6b"][1], 1),
                   device_busy_ms=prof["busy"][0], device_kernels=prof["busy"][1],
                   profiled_wall_ms=prof["wall"], profiled_sweeps=CHROM_PROFILED_SWEEPS,
                   idle_share=1.0 - prof["busy"][0] / prof["wall"])
    else:
        progress("chromatin path: the profiler trace held no device events: device time "
                 "and idle share not measured")
    progress(f"chromatin path: profiler {prof}")
    progress(f"chromatin path: e2e {out['e2e_ms']:.1f} ms, {out['sweeps_per_s']:.1f} sweeps/s, "
             f"{out['restraint_evals_per_s'] / 1e9:.3f} G restraint evals/s, K6a events "
             f"{out['k6a_event_ms']:.2f} ms, K6b {out['k6b_event_ms']:.2f} ms, "
             f"accept {accept:.4f}, "
             f"precision {prec:.3f} vs {emp_prec:.3f}, median error {med:.4f}")
    out["k6_launch"] = k6_launch
    return out


class Recorded(KernelSpans):
    """KernelSpans that also keep each label's last return value."""

    def __init__(self, module, names: dict):
        super().__init__(module, names)
        self.outputs = {}

    def _wrap(self, label, fn):
        timed_fn = super()._wrap(label, fn)

        def launch(*args, **kw):
            out = self.outputs[label] = timed_fn(*args, **kw)
            return out
        return launch


class BetaSchedule:
    """The tempering schedule of the ``tempered_smc`` runs inside the block:
    each stage's next beta as ``smc/smc.py::_find_next_beta`` returns it."""

    def __enter__(self):
        from binf_tpu_torch.smc import smc as module

        self.module, self.fn, self.betas = module, module._find_next_beta, []

        def find(*args, **kw):
            beta = self.fn(*args, **kw)
            self.betas.append(float(beta))
            return beta

        module._find_next_beta = find
        return self

    def __exit__(self, *exc):
        self.module._find_next_beta = self.fn


def gram_flat(q: dict) -> torch.Tensor:
    """Chain-grid positions ``{"precision": (..., C), "structure": (..., C,
    N, 3)}`` packed flat, log precision first: ``(..., C, 1 + 3 N)``."""
    s = q["structure"]
    return torch.cat([q["precision"][..., None], s.reshape(s.shape[:-2] + (-1,))], dim=-1)


def chromatin_start(chrom, n: int, chains: int, dev):
    """The problem as run_chromatin.py draws it (seed 0, card generator) and
    ``chains`` starts from X_true + 0.1 noise (seed 1) at precision 20."""
    X_true, logD, W = chrom.synthetic_restraints(torch.Generator(device=dev).manual_seed(0), n,
                                                 observe_frac=OBSERVE_FRAC, device=dev)
    noise = torch.randn((chains, n, 3), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    init = {"structure": X_true + 0.1 * noise,
            "precision": torch.full((chains,), float(np.log(20.0)), device=dev)}
    return X_true, logD, W, init


def phase_k7_functor_check(cg, chrom, dev):
    """(a) K7's functor alone against the plain potential_and_grad at 64 and
    256 beads over 2,048 chains.  Both form each pair's d2 as the same
    float, op by op, and differ only in the order of the pair sums: U
    within 1e-5 relative, the gradient within 1e-4 of the plain version's
    largest component.  How far each lies from a float64 evaluation of the
    same formula is reported, not held (the Gram form loses digits for close
    pairs in float32 on both sides alike)."""
    errs = {}
    for n in (CG_BEADS, CG_BIG_BEADS):
        _, logD, W, init = chromatin_start(chrom, n, CG_CHAINS, dev)
        gram = chrom.make_gram_logdensity(logD, W, device=dev)
        flat = gram_flat(init).contiguous()
        U_k, g_k = cg.group_value_and_grad(gram, flat)
        U2, g2 = cg.group_value_and_grad(gram, flat)
        outs = {torch.float32: ([], []), torch.float64: ([], [])}
        for lo in range(0, CG_CHAINS, 256):
            for dt, (us, gs) in outs.items():
                u, g = gram.potential_and_grad({k: v[lo:lo + 256].to(dt) for k, v in init.items()})
                us.append(u)
                gs.append(gram_flat(g))
        (U_p, g_p), (U_d, g_d) = ((torch.cat(us), torch.cat(gs)) for us, gs in outs.values())
        torch.cuda.synchronize()
        rel = float(((U_k - U_p).abs() / U_p.abs()).max())
        check(rel <= 1e-5, f"K7 functor N={n}: U rel err {rel:.3g} <= 1e-5 over {CG_CHAINS} chains")
        err = float((g_k - g_p).abs().max())
        scale = float(g_p.abs().max())
        err_k = float((g_k.double() - g_d).abs().max())
        err_p = float((g_p.double() - g_d).abs().max())
        check(err <= 1e-4 * scale,
              f"K7 functor N={n}: gradient within {err:.3g} of the plain float32 one (<= 1e-4 x "
              f"{scale:.3g}); from float64: kernel {err_k:.3g}, plain {err_p:.3g}")
        check(torch.equal(U_k, U2) and torch.equal(g_k, g2), f"K7 functor N={n}: two calls "
                                                             "equal bit for bit")
        errs[n] = {"grad_err": err, "grad_scale": scale, "kernel_vs_f64": err_k,
                   "plain_vs_f64": err_p}
    return errs


def phase_k7_check(cg, gram, q0, eps, im, dev):
    """(b) K7 against its plain version on one Philox stream, 2,048 chains
    at 64 beads over CG_CHECK_STEPS steps at L = 10 from the chain-grid
    path's warmed-up state, held by flip_check with the tolerance ten times
    the spread a 1e-6 relative change of the start gives the plain version
    (plus 1e-5); (c) moments against the draws of the same stream; (d) two
    chained calls with block_offset against one; (e) two calls."""
    kw = dict(num_steps=CG_CHECK_STEPS, num_leapfrog=CG_LEAP, block_chains=CG_BLOCK,
              steps_per_block=CG_CHECK_STEPS // 2, device=dev)
    res = cg.chain_grid_hmc_run(gram, q0, 41, eps, im, {}, **kw)
    pk = dict(num_steps=CG_CHECK_STEPS, num_leapfrog=CG_LEAP)
    plain_ms, plain = timed(lambda: cg.chain_grid_hmc_plain(gram, q0, 41, eps, im, **pk))
    g = torch.Generator(device=dev).manual_seed(42)
    q_s = {k: v * (1.0 + 1e-6 * torch.randn(v.shape, generator=g, device=dev))
           for k, v in q0.items()}
    pert = cg.chain_grid_hmc_plain(gram, q_s, 41, eps, im, **pk)
    torch.cuda.synchronize()
    draws_k, draws_p = gram_flat(res.draws), gram_flat(plain.result.draws)
    same = ((plain.margin < 0) == (pert.margin < 0)).all(dim=0)
    sp = float((gram_flat(pert.result.draws) - draws_p)[:, same].abs().max())
    # the stiff restraints amplify rounding along a trajectory: a decision
    # may flip where the 1e-6 change moves its margin by a tenth of it
    # (inf - inf, a divergence rejected in both runs, moves nothing)
    moved = torch.nan_to_num((pert.margin - plain.margin).abs(), nan=0.0)
    n_pert = int((~same).sum())
    progress(f"K7: a 1e-6 change of the start moves the plain draws by {sp:.3g} and flips "
             f"{n_pert} chains' decisions")
    err, _ = flip_check("K7", draws_k, res.accept_rate, gram_flat(q0), draws_p, plain.margin,
                        plain.accepts, err_tol=10 * sp + 1e-5, margin_tol=10 * moved + 1e-3,
                        max_flips=max(CG_CHAINS // 100, 3 * n_pert))
    mom = cg.chain_grid_hmc_run(gram, q0, 41, eps, im, {}, collect="moments", **kw)
    m_err = float((gram_flat(mom.mean) - draws_k.mean(0)).abs().max())
    ref_var = draws_k.var(0)
    v_err = float(((gram_flat(mom.variance) - ref_var).abs() / (ref_var + 1e-6)).max())
    check(m_err <= 1e-4 and v_err <= 1e-3
          and torch.equal(gram_flat(mom.final_positions), gram_flat(res.final_positions)),
          f"K7 moments: Welford mean within {m_err:.3g} (<= 1e-4), variance {v_err:.3g} "
          "relative (<= 1e-3) of the same stream's draws, final positions equal")
    half = dict(kw, num_steps=CG_CHECK_STEPS // 2)
    a = cg.chain_grid_hmc_run(gram, q0, 41, eps, im, {}, **half)
    b = cg.chain_grid_hmc_run(gram, a.final_positions, 41, eps, im, {}, block_offset=1, **half)
    check(torch.equal(torch.cat([gram_flat(a.draws), gram_flat(b.draws)]), draws_k)
          and torch.equal(gram_flat(b.final_positions), gram_flat(res.final_positions)),
          "K7 resume: two chained calls with block_offset advanced == one call, bit for bit")
    again = cg.chain_grid_hmc_run(gram, q0, 41, eps, im, {}, **kw)
    check(torch.equal(gram_flat(again.draws), draws_k), "K7: two identical calls equal bit "
                                                        "for bit")
    return err, plain_ms


def addmm_leapfrog(q, p, A, b, eps: float, L: int):
    """The quadratic leapfrog as PyTorch library calls: each kick one
    cuBLAS SGEMM with the kick in its epilogue, p + c (q A - b) =
    addmm(p - c b, q, A, alpha=c); timed as K8's library yardstick."""
    p = torch.addmm(p + 0.5 * eps * b, q, A, alpha=-0.5 * eps)
    for _ in range(L):
        q = q + eps * p
        p = torch.addmm(p + eps * b, q, A, alpha=-eps)
    return q, torch.addmm(p - 0.5 * eps * b, q, A, alpha=0.5 * eps)


def quadratic_target(dev, seed: int = 0, C: int = Q_CHAINS, D: int = Q_DIM):
    """A = M M^T + I with M = 0.05 N(0, 1), b ~ N(0, 1) and q ~ N(0, I),
    drawn on the card (bench_kernels.py:36-40's target)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    M = 0.05 * torch.randn((D, D), generator=g, device=dev)
    A = M @ M.T + torch.eye(D, device=dev)
    b = torch.randn(D, generator=g, device=dev)
    return A, b, torch.randn((C, D), generator=g, device=dev), g


def phase_k8_check(lf, dev):
    """K8 against the plain leapfrog (torch.matmul, TF32 off) at the main
    shape and at ragged shapes, with the potential at the final positions
    the quadratic path takes from it: within 1e-4 of the largest value
    (float32 products of depth D in other orders over L + 1 kicks of a
    stable trajectory), two calls equal bit for bit; device times of K8 as
    the path calls it, the plain version and the addmm yardstick at the main
    shape."""
    errs = []
    for C, D, L in ((Q_CHAINS, Q_DIM, Q_LEAP), (70, 200, Q_LEAP), (70, 8, 8)):
        A, b, q, g = quadratic_target(dev, D, C, D)
        p = torch.randn((C, D), generator=g, device=dev)
        eps = torch.tensor(Q_STEP, device=dev)
        call = lambda: lf.quadratic_leapfrog(q, p, A, b, eps, L, device=dev,
                                             return_potential=True)
        qk, pk, Uk = call()
        qk2, pk2, Uk2 = call()
        qp, pp = lf.quadratic_leapfrog_reference(q, p, A, b, Q_STEP, L)
        Up = lf.quadratic_potential(qp, A, b)
        torch.cuda.synchronize()
        err = max(float((qk - qp).abs().max()), float((pk - pp).abs().max()))
        scale = max(float(qp.abs().max()), float(pp.abs().max()))
        check(err <= 1e-4 * scale, f"K8 C={C} D={D} L={L}: max abs err {err:.3g} <= 1e-4 x "
                                   f"{scale:.3g}")
        u_err, u_scale = float((Uk - Up).abs().max()), float(Up.abs().max())
        check(u_err <= 1e-4 * u_scale, f"K8 C={C} D={D} L={L}: potential within {u_err:.3g} "
                                       f"(<= 1e-4 x {u_scale:.3g})")
        check(torch.equal(qk, qk2) and torch.equal(pk, pk2) and torch.equal(Uk, Uk2),
              f"K8 C={C} D={D}: two calls equal bit for bit")
        errs.append(err)
        if C == Q_CHAINS:
            qa, pa = addmm_leapfrog(q, p, A, b, Q_STEP, L)
            lib_err = float((pa - pp).abs().max())
            check(lib_err <= 1e-4 * scale, f"K8 yardstick (addmm) within {lib_err:.3g} of plain")
            ms = device_ms(call)
            plain_ms = device_ms(lambda: lf.quadratic_leapfrog_reference(q, p, A, b, Q_STEP, L))
            lib_ms = device_ms(lambda: addmm_leapfrog(q, p, A, b, Q_STEP, L))
            progress(f"K8 C={C} D={D} L={L}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain "
                     f"(torch.matmul), {lib_ms:.4f} ms addmm")
            out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
    return dict(out, err=max(errs))


def chain_grid_path(build, cg, cgs, adaptation, chrom, pw, hmc_mod, init_chains, run_chains,
                    dev):
    """The CLI's chain-grid route on the card: ``chain_grid_model_hmc`` on
    the Gram density of the 64-bead chromatin model, one cold run
    (CG_WARMUP // 20 warmup steps, the K7 launch at full size) and CG_REPS
    timed runs, CUDA events around the warmup and the K7 launch; then the
    same sampling steps through the eager HMC route from the same warmed-up
    state, and K7 alone at 256 beads."""
    from binf_tpu_torch.diagnostics import ess

    X_true, logD, W, init = chromatin_start(chrom, CG_BEADS, CG_CHAINS, dev)
    gram = chrom.make_gram_logdensity(logD, W, device=dev)
    n_obs = float(W.sum())
    emp_prec = n_obs / float(pw.pairwise_loss_plain(X_true, logD, W))

    def run(seed, warmup=CG_WARMUP):
        return cgs.chain_grid_model_hmc(
            gram, init, seed, num_warmup=warmup, num_samples=CG_SAMPLES,
            num_leapfrog=CG_LEAP, initial_step_size=CG_STEP0, block_chains=CG_BLOCK, device=dev)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(70, CG_WARMUP // 20)
    torch.cuda.synchronize()
    progress(f"chain-grid path cold run: {time.perf_counter() - t:.2f}s")
    walls, warm_ms, k7_ms = [], [], []
    for rep in range(CG_REPS):
        with Recorded(adaptation, {"_window_adaptation": "warmup"}) as warm, \
                KernelSpans(cg, {"_chain_grid_cuda": "k7"}) as k7:
            t = time.perf_counter()
            res = run(71 + rep)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        warm_ms.append(warm.ms("warmup"))
        k7_ms.append(k7.ms("k7"))
    launches = dict(build.LAUNCHES)
    k7_launch = launch_keys(build.last_launch["chain_grid_hmc"])
    check(launches["chain_grid_hmc"] == CG_REPS + 1,
          f"chain-grid path launched chain_grid_hmc {launches['chain_grid_hmc']} times")
    # the card's busy time over 10 warmup steps, under the profiler (which
    # slows this host-bound loop several times; a short K7 run closes it):
    # how far the host holds the eager warmup
    prof_warmup = CG_WARMUP // 20
    prof = profile_device(lambda: cgs.chain_grid_model_hmc(
        gram, init, 75, num_warmup=prof_warmup, num_samples=10, num_leapfrog=CG_LEAP,
        initial_step_size=CG_STEP0, block_chains=CG_BLOCK, device=dev),
        {"k7": ("chain_grid_kernel",)})
    warm_busy = None if prof["busy"] is None else (prof["busy"][0] - prof["k7"][0]) / prof_warmup
    adapt = warm.outputs["warmup"]
    accept = float(res.accept_rate)
    check(0.6 < accept < 0.95, f"chain-grid path: K7 acceptance {accept:.4f} in (0.6, 0.95)")
    prec_draws = res.samples["precision"]
    structure = res.samples["structure"]
    check(bool(torch.isfinite(prec_draws).all()) and bool(torch.isfinite(structure).all())
          and structure.shape == (CG_SAMPLES, CG_CHAINS, CG_BEADS, 3),
          f"chain-grid path: finite draws of shape ({CG_SAMPLES}, {CG_CHAINS}, {CG_BEADS}, 3)")
    # the density is invariant under rotations of the structure, so its
    # coordinates mix slowly; the precision's ESS is reported beside
    ess_prec = float(ess(prec_draws))
    m_ess = min(ess_prec,
                float(ess(structure[:, :, list(CG_ESS_BEADS)].reshape(CG_SAMPLES, CG_CHAINS,
                                                                      -1)).min()))
    mask = W > 0
    d_true = torch.cdist(X_true.double(), X_true.double())[mask]
    X = res.final_positions["structure"].double()
    d = torch.cdist(X, X)[:, mask]
    med = float(((d - d_true).abs() / d_true.clamp_min(0.1)).median())
    check(med < 0.15, f"chain-grid path: median restrained-distance error {med:.4f} < 0.15")
    kept = torch.exp(prec_draws[CG_SAMPLES // 2:].double())
    prec = float(kept.mean())
    # Given the structure the precision is Gamma(a + K/2, b + loss(X)/2)
    # exactly, so over the same draws its mean must match the conditional
    # means (the main path's self-consistency gate).  The noise's empirical
    # precision at the truth is no gate here: with ~605 independent
    # restraints against ~186 free coordinates the posterior's residual
    # loss is a third below the truth's, and its precision that much above
    # (at 2,048 beads, the chromatin path's, the two agree).
    every = range(CG_SAMPLES // 2, CG_SAMPLES, 10)
    lam = torch.exp(prec_draws[list(every)].double())
    cond = torch.stack([(gram.gamma_shape + 0.5 * n_obs)
                        / (gram.gamma_rate + 0.5 * gram.loss(structure[t]).double())
                        for t in every])
    ratio = float(lam.mean() / cond.mean())
    check(abs(ratio - 1.0) < 0.05,
          f"chain-grid path: precision mean {float(lam.mean()):.3f} vs its Gamma "
          f"self-consistency {float(cond.mean()):.3f} (rtol 0.05); the noise's empirical "
          f"precision at the truth is {emp_prec:.3f}")

    # the same sampling steps through the eager route, from the same state
    kernel = hmc_mod.hmc(gram, adapt.step_size, CG_LEAP, adapt.inverse_mass)
    t = time.perf_counter()
    _, (prec_e, acc_e) = run_chains(
        kernel, torch.Generator(device=dev).manual_seed(9),
        init_chains(kernel, adapt.final_states.position), CG_SAMPLES,
        collect=lambda state, info: (state.position["precision"], info.accepted))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3
    accept_e = float(acc_e.float().mean())
    check(abs(accept_e - accept) < 0.05, f"chain-grid path: eager route accepts {accept_e:.4f}, "
                                         f"K7 {accept:.4f} (within 0.05)")
    cm_k = kept.mean(0)
    cm_e = torch.exp(prec_e[CG_SAMPLES // 2:].double()).mean(0)
    se = float(torch.sqrt(cm_k.var() / CG_CHAINS + cm_e.var() / CG_CHAINS))
    diff = abs(float(cm_e.mean()) - prec)
    check(diff <= 3 * se, f"chain-grid path: eager precision mean {float(cm_e.mean()):.4f} vs "
                          f"K7 {prec:.4f}, apart by {diff:.3g} <= 3 standard errors ({se:.3g})")

    # K7 alone at the JAX package's second measured shape
    _, logD2, W2, init2 = chromatin_start(chrom, CG_BIG_BEADS, CG_BIG_CHAINS, dev)
    gram2 = chrom.make_gram_logdensity(logD2, W2, device=dev)
    im2 = {"structure": torch.ones((CG_BIG_BEADS, 3), device=dev),
           "precision": torch.ones((), device=dev)}
    big = lambda: cg.chain_grid_hmc_run(gram2, init2, 5, 2e-3, im2, {}, num_steps=CG_BIG_STEPS,
                                        num_leapfrog=CG_LEAP, block_chains=CG_BLOCK,
                                        steps_per_block=CG_BIG_STEPS // 2, device=dev)
    big()
    big_ms, big_res = timed(big)
    check(bool(torch.isfinite(big_res.final_positions["structure"]).all()),
          f"K7 at {CG_BIG_BEADS} beads: finite positions (accept "
          f"{float(big_res.accept_rate):.3f})")

    e2e = float(np.mean(walls))
    out = {"beads": CG_BEADS, "chains": CG_CHAINS, "restraints": n_obs, "warmup": CG_WARMUP,
           "samples": CG_SAMPLES, "leapfrog": CG_LEAP, "e2e_ms": e2e * 1e3,
           "e2e_runs_ms": [w * 1e3 for w in walls], "warmup_ms": float(np.mean(warm_ms)),
           "k7_ms": float(np.mean(k7_ms)), "k7_runs_ms": k7_ms, "accept": accept,
           "step_size": float(res.step_size), "min_bulk_ess": m_ess, "ess_per_s": m_ess / e2e,
           "precision_ess": ess_prec,
           "precision": prec, "precision_self_consistency": float(cond.mean()),
           "empirical_precision": emp_prec, "median_distance_error": med,
           "eager_sampling_ms": eager_ms, "eager_accept": accept_e,
           "eager_precision": float(cm_e.mean()), "big_beads": CG_BIG_BEADS,
           "big_chains": CG_BIG_CHAINS, "big_steps": CG_BIG_STEPS, "big_k7_ms": big_ms,
           "big_accept": float(big_res.accept_rate),
           "warmup_ms_per_step": float(np.mean(warm_ms)) / CG_WARMUP,
           "warmup_busy_ms_per_step": warm_busy,
           "warmup_idle_share": (None if warm_busy is None
                                 else 1.0 - warm_busy * CG_WARMUP / float(np.mean(warm_ms))),
           "profiled_warmup_steps": prof_warmup, "profiled_wall_ms": prof["wall"],
           "launches": launches, "k7_launch": k7_launch}
    progress(f"chain-grid path: e2e {out['e2e_ms']:.1f} ms (runs "
             f"{[round(w * 1e3, 1) for w in walls]}), warmup {out['warmup_ms']:.1f} ms, K7 "
             f"{out['k7_ms']:.2f} ms, accept {accept:.4f}, eps {out['step_size']:.5f}, min bulk "
             f"ESS {m_ess:.1f}, ESS/s {out['ess_per_s']:.4g}; eager sampling {eager_ms:.1f} ms "
             f"accept {accept_e:.4f}; K7 at {CG_BIG_BEADS} beads {big_ms:.2f} ms; warmup "
             f"{out['warmup_ms_per_step']:.3f} ms a step, card busy {warm_busy} ms of it "
             f"(profiled), idle share {out['warmup_idle_share']}")
    q_check = adapt.final_states.position
    return out, gram, q_check, adapt.step_size, adapt.inverse_mass


def quadratic_path(build, qh, init_chains, run_chains, dev):
    """``quadratic_hmc`` through ``init_chains``/``run_chains`` at 8,192
    chains, D = 128, L = 32: one cold run and REPS timed runs of 200 sweeps
    (K8 on the card, once at init and once a sweep), CUDA events around
    every K8 launch; one more run under the profiler for the card's busy
    time; one timed run with ``use_pallas=False`` (the plain leapfrog)
    beside it."""
    A, b, q0, _ = quadratic_target(dev)
    cov = torch.linalg.inv(A.double())
    mean_t, var_t = cov @ b.double(), torch.diagonal(cov)

    def run(seed, use_pallas=None):
        kernel = qh.quadratic_hmc(A, b, Q_STEP, Q_LEAP, use_pallas=use_pallas)
        return run_chains(kernel, torch.Generator(device=dev).manual_seed(seed),
                          init_chains(kernel, q0), Q_SWEEPS,
                          collect=lambda state, info: (state.position, info.accepted))

    build.reset_launch_counts()
    t = time.perf_counter()
    run(80)
    torch.cuda.synchronize()
    progress(f"quadratic path cold run: {time.perf_counter() - t:.2f}s")
    walls, k8_ms = [], []
    for rep in range(REPS):
        with KernelSpans(qh, {"quadratic_leapfrog": "k8"}) as spans:
            t = time.perf_counter()
            _, (draws, accepted) = run(81 + rep)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        k8_ms.append(spans.ms("k8"))
    launches = dict(build.LAUNCHES)
    k8_launch = dict(grid_keys(build.last_launch["quadratic_leapfrog"]),
                     kernel_route=build.last_launch["quadratic_leapfrog"].route)
    check(launches["quadratic_leapfrog"] == (REPS + 1) * (Q_SWEEPS + 1),
          f"quadratic path launched quadratic_leapfrog {launches['quadratic_leapfrog']} times "
          f"(one at init and one a sweep)")
    prof = profile_device(lambda: run(81 + REPS), {"k8": ("quadratic_leapfrog_tc_kernel",
                                                              "quadratic_leapfrog_kernel")})
    accept = float(accepted.float().mean())
    check(accept > 0.8, f"quadratic path: acceptance {accept:.4f} > 0.8")
    kept = draws[Q_BURN:]
    m_err = float((kept.double().mean(dim=(0, 1)) - mean_t).abs().max())
    v_err = float((kept.var(dim=(0, 1)).double() / var_t - 1.0).abs().max())
    check(m_err < 0.02, f"quadratic path: draws' mean within {m_err:.4f} of A^-1 b (< 0.02)")
    check(v_err < 0.05, f"quadratic path: variances within {v_err:.4f} of diag(A^-1) (< 5%)")
    del draws, kept
    t = time.perf_counter()
    run(90, use_pallas=False)
    torch.cuda.synchronize()
    plain_route_ms = (time.perf_counter() - t) * 1e3
    e2e = float(np.mean(walls))
    busy = None if prof["busy"] is None else prof["busy"][0]
    out = {"chains": Q_CHAINS, "dim": Q_DIM, "leapfrog": Q_LEAP, "sweeps": Q_SWEEPS,
           "step_size": Q_STEP, "e2e_ms": e2e * 1e3, "e2e_runs_ms": [w * 1e3 for w in walls],
           "ms_per_sweep": e2e * 1e3 / Q_SWEEPS, "k8_event_ms": float(np.mean(k8_ms)),
           "k8_event_ms_per_launch": float(np.mean(k8_ms)) / (Q_SWEEPS + 1), "accept": accept,
           "mean_err": m_err, "var_rel_err": v_err, "plain_route_e2e_ms": plain_route_ms,
           "profiled_busy_ms": busy,
           "profiled_k8_ms": None if prof["k8"] is None else prof["k8"][0],
           "profiled_wall_ms": prof["wall"],
           "idle_share": None if busy is None else 1.0 - busy / (e2e * 1e3),
           "launches": launches}
    progress(f"quadratic path: e2e {out['e2e_ms']:.1f} ms ({out['ms_per_sweep']:.3f} ms a "
             f"sweep), K8 events {out['k8_event_ms_per_launch']:.4f} ms a launch, accept "
             f"{accept:.4f}; card busy {busy} ms of a run (profiled, K8 "
             f"{out['profiled_k8_ms']} ms), idle share of the timed runs {out['idle_share']}; "
             f"use_pallas=False {plain_route_ms:.1f} ms")
    out["k8_launch"] = k8_launch
    return out


def moment_gates(label, mean, variance, accept, accept_range, V, ys, dev):
    """The main path's posterior checks on per-chain Welford moments in
    (coefficients, log precision) space: acceptance in ``accept_range``,
    the pooled coefficient means within 0.1 of the exact conditional at the
    mean precision, and that precision (each chain's E[lambda] taken as
    exp(m + v / 2), log-normal: 0.06% from the Gamma's mean at shape 11)
    within 10% of its Gamma self-consistency point, E[11 / (0.2 + ss(c) /
    2)] over 4,096 coefficients drawn from that conditional."""
    c_mean, lp_mean = mean["coefficients"].double(), mean["precision"].double()
    c_var, lp_var = variance["coefficients"].double(), variance["precision"].double()
    check(all(bool(torch.isfinite(x).all()) for x in (c_mean, lp_mean, c_var, lp_var))
          and bool((c_var >= 0).all()) and bool((lp_var >= 0).all()),
          f"{label}: finite per-chain moments")
    lo, hi = accept_range
    check(lo < accept < hi, f"{label}: acceptance {accept:.4f} in ({lo}, {hi})")
    lam = float(torch.exp(lp_mean + lp_var / 2).mean())
    exact, cov = exact_conditional(V, ys, lam, dev)
    c_err = float((c_mean.mean(0) - exact).abs().max())
    check(c_err < 0.1, f"{label}: coefficient mean within {c_err:.3g} of the exact "
                       "conditional Gaussian at the mean precision (< 0.1)")
    z = torch.randn((4096, 4), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64).to(dev)
    c = exact + z @ torch.linalg.cholesky(cov).T
    ss = ((ys.double()[None, :] - c @ V.double().T) ** 2).sum(1)
    expected = float((11.0 / (0.2 + ss / 2)).mean())
    check(abs(lam / expected - 1.0) < 0.1,
          f"{label}: precision mean {lam:.4f} vs Gamma self-consistency {expected:.4f} "
          "(rtol 0.1)")
    return {"coefficient_err": c_err, "precision": lam, "precision_self_consistency": expected}


def production_path(build, fp, production, checkpoint, logdensity, init, V, ys, dev):
    """``run_fused_blocks(warmup="fused")`` at the main path's shape:
    16,384 chains, K3 over 500 steps, then 4,000 steps as 4 K4 blocks of
    1,000 with in-kernel moments, a checkpoint after every block.  Timed
    once: CUDA events around K3 and each block, the card's gap between
    blocks (the driver's merge and checkpoint), one checkpoint's save and
    load.  A run resumed from block 2's checkpoint, and one K4 call of all
    4,000 steps from the same warmed state, must end where the
    uninterrupted run ends, bit for bit."""
    import os
    import tempfile

    kw = dict(num_steps=PROD_BLOCKS * PROD_BLOCK_STEPS, block_size=PROD_BLOCK_STEPS,
              num_warmup=N_WARMUP, num_leapfrog=N_LEAPFROG, initial_step_size=0.1,
              block_chains=N_CHAINS, warmup="fused", device=dev)
    run = production.run_fused_blocks
    with tempfile.TemporaryDirectory() as tmp:
        path, half = os.path.join(tmp, "run.pt"), os.path.join(tmp, "half.pt")
        build.reset_launch_counts()
        with KernelSpans(fp, {"_fused_warmup_cuda": "k3", "_fused_potential_cuda": "k4"}) as sp:
            t = time.perf_counter()
            full = run(logdensity, init, 11, checkpoint_path=path, checkpoint_every_blocks=1,
                       **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(build.LAUNCHES)
        for name in ("philox", "fused_warmup", "fused_potential_hmc"):
            check(launches[name] > 0, f"production path launched {name} {launches[name]} times")
        check(launches["fused_potential_hmc"] == PROD_BLOCKS,
              f"production path: one K4 launch a block ({launches['fused_potential_hmc']})")
        blocks = [ev for label, ev in sp.spans if label == "k4"]
        k4_ms = [ev[0].elapsed_time(ev[1]) for ev in blocks]
        gaps = [a[1].elapsed_time(b[0]) for a, b in zip(blocks, blocks[1:])]
        nbytes = os.path.getsize(path)
        t = time.perf_counter()
        checkpoint.save_checkpoint(path, full.carry)
        save_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        back = checkpoint.load_checkpoint(path, full.carry)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t) * 1e3
        check(all(torch.equal(a, b) for a, b in zip(back, full.carry)),
              f"production path: a checkpoint of {nbytes} bytes restores the carry bit for bit")

        first = run(logdensity, init, 11, checkpoint_path=half, checkpoint_every_blocks=2,
                    **dict(kw, num_steps=2 * PROD_BLOCK_STEPS))
        check(int(first.carry.block) == 2, "production path: the first call stopped at block 2")
        resumed = run(logdensity, init, 11, checkpoint_path=half, resume=True, **kw)
    check(int(resumed.carry.block) == PROD_BLOCKS
          and all(torch.equal(getattr(full.carry, f), getattr(resumed.carry, f))
                  for f in ("positions", "mean", "m2", "count")),
          "production path: the run resumed from block 2 ends where the uninterrupted run "
          "ends (positions, Welford mean, M2 and count bit for bit)")
    one = run(logdensity, init, 11, **dict(kw, block_size=PROD_BLOCKS * PROD_BLOCK_STEPS))
    check(torch.equal(one.carry.positions, full.carry.positions),
          f"production path: {PROD_BLOCKS} blocks end where one K4 call of "
          f"{PROD_BLOCKS * PROD_BLOCK_STEPS} steps ends, bit for bit")
    gates = moment_gates("production path", full.mean, full.variance, full.accept_rate,
                         (0.6, 0.95), V, ys, dev)
    steps = PROD_BLOCKS * PROD_BLOCK_STEPS
    out = {"chains": N_CHAINS, "warmup": N_WARMUP, "blocks": PROD_BLOCKS,
           "block_steps": PROD_BLOCK_STEPS, "leapfrog": N_LEAPFROG, "e2e_ms": wall * 1e3,
           "k3_ms": sp.ms("k3"), "k4_ms_per_block": float(np.mean(k4_ms)),
           "k4_block_ms": k4_ms, "host_ms_between_blocks": float(np.mean(gaps)),
           "host_gaps_ms": gaps, "checkpoint_bytes": nbytes, "checkpoint_save_ms": save_ms,
           "checkpoint_load_ms": load_ms, "accept": full.accept_rate,
           "chain_steps_per_s": N_CHAINS * steps / wall, "resume_bitwise": True,
           "one_call_bitwise": True, **gates, "launches": launches}
    progress(f"production path: e2e {out['e2e_ms']:.1f} ms, K3 {out['k3_ms']:.2f} ms, K4 "
             f"{out['k4_ms_per_block']:.2f} ms a block, {out['host_ms_between_blocks']:.2f} ms "
             f"between blocks, checkpoint {nbytes} B saved in {save_ms:.1f} ms, loaded in "
             f"{load_ms:.1f} ms, accept {full.accept_rate:.4f}, "
             f"{out['chain_steps_per_s']:.4g} chain-steps/s")
    return out


def k4_dense_bound(C: int, steps: int, D: int = 5, L: int = N_LEAPFROG):
    """K4's dense branch at the dense path's shape: the diagonal count plus
    the (D, D) products, one a leapfrog step (M^-1 p) and one a momentum
    draw (W z), of 2 D^2 flops each; bytes as the model path's plus the two
    (D, D) matrices."""
    flops = trajectory_flops(eval_flops(20, 4), D, L) + (L + 1) * 2 * D * D
    nbytes = C * (2 * D + 1) * 4 + steps * C * D * 4 + C * (D + 1) * 4 + 2 * D * D * 4
    return bound_ms(nbytes, steps * C * flops, philox_calls(steps, C, D))


def eager_warmup_path(label, build, fp, module, name, fused_model_hmc, logdensity, init,
                      chains, warmup_steps, samples, V, ys, dev, accept_range=(0.6, 0.95),
                      **kw):
    """``fused_model_hmc`` with an eager warmup (``module.name``) at
    ``chains`` of the main path's starts: a short cold run, one timed run
    (CUDA events around the warmup and K4), and ``PROFILED_WARMUP`` warmup
    steps under the profiler for the card's idle share; gated as the main
    path."""
    init_c = {k: v[:chains] for k, v in init.items()}

    def run(seed, **extra):
        return fused_model_hmc(logdensity, init_c, seed, num_leapfrog=N_LEAPFROG,
                               initial_step_size=0.1, block_chains=chains, device=dev,
                               **kw, **extra)

    t = time.perf_counter()
    run(30, num_warmup=20, num_samples=50)
    torch.cuda.synchronize()
    progress(f"{label} cold run: {time.perf_counter() - t:.2f}s")
    build.reset_launch_counts()
    with Recorded(module, {name: "warmup"}) as warm, LaunchSpans(fp) as spans:
        t = time.perf_counter()
        res = run(31, num_warmup=warmup_steps, num_samples=samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = dict(build.LAUNCHES)
    for k in ("philox", "fused_potential_hmc"):
        check(launches[k] > 0, f"{label} launched {k} {launches[k]} times")
    check(launches["fused_warmup"] == 0, f"{label}: the warmup ran eagerly, not in K3")
    warm_ms = warm.ms("warmup")
    prof = profile_device(lambda: run(32, num_warmup=PROFILED_WARMUP, num_samples=50),
                          {"k4": ("fused_potential_kernel",)})
    busy = None if prof["busy"] is None else (prof["busy"][0] - prof["k4"][0]) / PROFILED_WARMUP
    draws = torch.cat([res.samples["coefficients"], res.samples["precision"][..., None]], -1)
    accept = float(res.accept_rate)
    m_ess = posterior_gates(label, draws, accept, accept_range, V, ys, dev,
                            shape=(samples, chains, 5))
    out = {"chains": chains, "warmup": warmup_steps, "samples": samples,
           "leapfrog": N_LEAPFROG, "e2e_ms": wall * 1e3, "warmup_ms": warm_ms,
           "warmup_ms_per_step": warm_ms / warmup_steps, "warmup_busy_ms_per_step": busy,
           "warmup_idle_share": None if busy is None else 1.0 - busy * warmup_steps / warm_ms,
           "profiled_warmup_steps": PROFILED_WARMUP, "profiled_wall_ms": prof["wall"],
           "k4_ms": spans.ms("sampling"), "accept": accept,
           "step_size": float(res.step_size), "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall,
           "launches": launches}
    return out, res, draws, spans


def dense_path(build, fp, dense_mod, fused_model_hmc, logdensity, init, V, ys, dev):
    """``fused_model_hmc(warmup="dense")`` at fused_regression_hmc's default
    width (8,192 chains, 1,000 K4 steps with the (D, D) metric) after 200
    eager dense warmup steps (cut from its 400); besides the main path's gates, the adapted metric's
    coefficient correlations within 0.25 of the exact conditional
    covariance's at the mean precision."""
    out, res, draws, _ = eager_warmup_path(
        "dense path", build, fp, dense_mod, "_dense_window_adaptation", fused_model_hmc,
        logdensity, init, DENSE_CHAINS, DENSE_WARMUP, DENSE_SAMPLES, V, ys, dev,
        warmup="dense")
    minv = res.inverse_mass.double()
    check(tuple(minv.shape) == (5, 5), "dense path: a (5, 5) metric")
    lam = float(torch.exp(draws[DENSE_SAMPLES // 4:, :, 4].double()).mean())
    _, cov = exact_conditional(V, ys, lam, dev)

    def corr(m):
        sd = torch.sqrt(torch.diagonal(m))
        return m / (sd[:, None] * sd[None, :])

    c_err = float((corr(minv[:4, :4]) - corr(cov)).abs().max())
    check(c_err < 0.25, f"dense path: the metric's coefficient correlations within {c_err:.3g} "
                        "of the exact conditional covariance's (< 0.25)")
    bound = k4_dense_bound(DENSE_CHAINS, DENSE_SAMPLES)
    out.update(metric_corr_err=c_err, metric_cross_corr_max=float(corr(minv)[:4, 4].abs().max()),
               k4_bound_ms=bound[0], k4_bound_by=bound[1],
               cut={"warmup": [DENSE_WARMUP_PUBLISHED, DENSE_WARMUP]})
    progress(f"dense path: e2e {out['e2e_ms']:.1f} ms, warmup {out['warmup_ms']:.1f} ms (idle "
             f"share {out['warmup_idle_share']}), K4 dense {out['k4_ms']:.2f} ms against a "
             f"{bound[0]:.3f} ms bound, accept {out['accept']:.4f}, min bulk ESS "
             f"{out['min_bulk_ess']:.1f}, ESS/s {out['ess_per_s']:.4g}")
    return out


def chees_xla_path(build, fp, chees_mod, fused_model_hmc, logdensity, init, V, ys, dev):
    """``fused_model_hmc(warmup="xla", trajectory="chees", max_leapfrog=128)``:
    4,096 chains, 100 eager ChEES warmup steps (cut from 400), 1,000 K4 steps jittered
    around the adapted T; gated as the ChEES path, with a finite positive T
    whose mean leapfrog count stays below ``max_leapfrog``."""
    out, res, _, spans = eager_warmup_path(
        "chees xla path", build, fp, chees_mod, "_chees_adaptation", fused_model_hmc, logdensity,
        init, CX_CHAINS, CX_WARMUP, CX_SAMPLES, V, ys, dev, warmup="xla", trajectory="chees",
        max_leapfrog=CHEES_MAX_LEAP, accept_range=(0.45, 0.95))
    T = float(res.trajectory_length)
    mean_L = float(spans.counts["sampling"].float().mean())
    check(np.isfinite(T) and T > 0 and mean_L < CHEES_MAX_LEAP,
          f"chees xla path: T {T:.4f} finite and positive, mean leapfrog count {mean_L:.1f} "
          f"< {CHEES_MAX_LEAP}")
    out.update(trajectory_length=T, sampling_mean_leapfrog=mean_L,
               cut={"warmup": [CX_WARMUP_PUBLISHED, CX_WARMUP]})
    progress(f"chees xla path: e2e {out['e2e_ms']:.1f} ms, warmup {out['warmup_ms']:.1f} ms "
             f"(idle share {out['warmup_idle_share']}), K4 {out['k4_ms']:.2f} ms, T {T:.4f}, "
             f"mean L {mean_L:.1f}, accept {out['accept']:.4f}, ESS/s {out['ess_per_s']:.4g}")
    return out


def fresh_profiles():
    """Print, as one JSON line, router_profile's and hierarchical_profile's
    results (``{"router": ..., "hierarchical": ...}``); run by
    ``router_path`` in a process of its own, whose hierarchical part
    ``hierarchical_path`` reads (one process start for both)."""
    print(json.dumps({"router": router_profile(), "hierarchical": hierarchical_profile()}))


def router_profile():
    """What ``torch.profiler`` sees of ``adaptive_hmc`` routing the
    polynomial density (2,048 of the main path's starts, ``warmup="fused"``)
    to K3 and K4 (fresh_profiles)."""
    from binf_tpu_torch.example.polynomial import make_data, make_posterior
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers import auto

    _build.build_all()
    dev = torch.device("cuda")
    xses, ys = make_data(torch.Generator().manual_seed(1), device=dev)
    logdensity = transform_logdensity(make_posterior(xses, ys).log_prob,
                                      {"precision": LogTransform})
    g = torch.Generator().manual_seed(2)
    q = torch.cat([1.0 + 0.1 * torch.randn((ROUTER_FUSED_CHAINS, 4), generator=g),
                   torch.zeros((ROUTER_FUSED_CHAINS, 1))], dim=1).to(dev)
    init = {"coefficients": q[:, :4], "precision": q[:, 4]}

    def run():
        return auto.adaptive_hmc(logdensity, init, 61, initial_step_size=0.1, warmup="fused",
                                 device=dev)

    run()
    return profile_device(run, {"k3": ("fused_warmup_kernel",),
                                "k4": ("fused_potential_kernel",)})


def router_path(build, auto, logdensity, init, dev):
    """``adaptive_hmc(algorithm="auto")`` twice: the transformed polynomial
    density at 2,048 chains with ``warmup="fused"`` (routed to K3 and K4,
    which the profiler must see), and a callable the density compiler
    refuses, the 6-D Gaussian of correlation 0.95 of the JAX package's
    dense tests written through a triangular solve, at 1,024 chains, 100 +
    150 steps (routed to the eager path, which must stay on the card and
    recover the known moments within 0.25).  The same Gaussian as a plain
    callable routes to K3 and K4 through its generated functor
    (traced_path runs it)."""
    init_f = {k: v[:ROUTER_FUSED_CHAINS] for k, v in init.items()}
    build.reset_launch_counts()
    t = time.perf_counter()
    res_f, dec_f = auto.adaptive_hmc(logdensity, init_f, 60, initial_step_size=0.1,
                                     warmup="fused", device=dev)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t
    launches = dict(build.LAUNCHES)
    check(dec_f.path == "fused" and dec_f.reason.startswith("device density"),
          f"router path: the polynomial density routes to {dec_f.path} ({dec_f.reason})")
    for k in ("philox", "fused_warmup", "fused_potential_hmc"):
        check(launches[k] > 0, f"router path (fused) launched {k} {launches[k]} times")
    # K3 and K4 in a fresh process's trace: late in this one, after the
    # earlier paths' profiler sessions, traces of this run have held no
    # device event, or K4 without K3, where a fresh process traces both;
    # the same process profiles hierarchical_path's runs
    child = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.fresh_profiles()"],
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=900)
    profs = json.loads(child.stdout.strip().splitlines()[-1]) if child.returncode == 0 else {}
    prof = profs.get("router", {})
    check(child.returncode == 0 and prof["k3"] is not None and prof["k3"][1] > 0
          and prof["k4"][1] > 0,
          f"router path: a fresh process's profiler saw K3 and K4 ({prof.get('k3')}, "
          f"{prof.get('k4')}; rc {child.returncode} {child.stderr[-300:]!r})")

    mu, S, _, gaussian = gaussian6(dev)
    d = len(mu)
    mu_t = torch.tensor(mu, dtype=torch.float32, device=dev)
    L = torch.tensor(np.linalg.cholesky(S), dtype=torch.float32, device=dev)

    def solved(pos):
        z = torch.linalg.solve_triangular(L, (pos["x"] - mu_t)[:, None], upper=False)[:, 0]
        return -0.5 * z @ z

    start = {"x": 0.5 * torch.randn((ROUTER_XLA_CHAINS, d), generator=torch.Generator()
                                    .manual_seed(1)).to(dev)}
    dec_g = auto.route_algorithm(gaussian, start)
    check(dec_g.path == "fused" and "TracedDensity" in dec_g.reason,
          f"router path: the plain Gaussian routes to {dec_g.path} ({dec_g.reason})")
    build.reset_launch_counts()
    t = time.perf_counter()
    res_x, dec_x = auto.adaptive_hmc(solved, start, torch.Generator(device=dev).manual_seed(2),
                                     num_warmup=ROUTER_XLA_WARMUP,
                                     num_samples=ROUTER_XLA_SAMPLES, device=dev)
    torch.cuda.synchronize()
    wall_x = time.perf_counter() - t
    check(dec_x.path == "xla" and dec_x.reason.startswith("not tile-compilable")
          and "solve_triangular" in dec_x.reason,
          f"router path: the refused callable routes to {dec_x.path} ({dec_x.reason})")
    check(sum(build.LAUNCHES.values()) == 0, "router path: the eager route launched no kernel")
    tensors = (res_x.samples["x"], res_x.accept_rate, res_x.step_size, res_x.inverse_mass,
               res_x.final_positions["x"])
    check(all(x.device.type == "cuda" for x in tensors),
          "router path: every tensor of the eager result lies on the card")
    from binf_tpu_torch.diagnostics import ess

    ess_x = float(ess(res_x.samples["x"]).min())
    X = res_x.samples["x"][ROUTER_XLA_SAMPLES // 4:].reshape(-1, d).double().cpu().numpy()
    mean_err = float(np.abs(X.mean(0) - mu).max())
    sd_err = float(np.abs(X.std(0) / np.sqrt(np.diag(S)) - 1).max())
    check(mean_err < 0.25 and sd_err < 0.25,
          f"router path: eager moments, means within {mean_err:.3g} and standard deviations "
          f"within {100 * sd_err:.1f}% of the target's (< 0.25)")
    out = {"fused": {"chains": ROUTER_FUSED_CHAINS, "reason": dec_f.reason,
                     "wall_ms": wall_f * 1e3, "block_chains": dec_f.block_chains,
                     "accept": float(res_f.accept_rate),
                     "profiled_k3": prof["k3"], "profiled_k4": prof["k4"]},
           "gaussian_route": dec_g.reason,
           "xla": {"chains": ROUTER_XLA_CHAINS, "warmup": ROUTER_XLA_WARMUP,
                   "samples": ROUTER_XLA_SAMPLES, "reason": dec_x.reason,
                   "wall_ms": wall_x * 1e3, "accept": float(res_x.accept_rate),
                   "min_bulk_ess": ess_x, "ess_per_s": ess_x / wall_x,
                   "mean_err": mean_err, "sd_rel_err": sd_err,
                   "cut": {"warmup": [ROUTER_XLA_PUBLISHED[0], ROUTER_XLA_WARMUP],
                           "samples": [ROUTER_XLA_PUBLISHED[1], ROUTER_XLA_SAMPLES]}},
           "hierarchical_profiles": profs.get("hierarchical", {}), "launches": launches}
    progress(f"router path: fused ({dec_f.reason}) {wall_f * 1e3:.1f} ms; eager "
             f"({dec_x.reason}) {wall_x * 1e3:.1f} ms")
    return out


# -- this slice: the example families, the NUTS rule, the other samplers ----------------

# benchmarks/bench_models.py's shape for the families with device densities
# (8,192 chains, 400 warmup and 500 sampling steps at L = 10), their data
# at the JAX package's published sizes (logistic n = 200, d = 5; AR(1)
# T = 64; mixture n = 240, K = 3)
FAM_CHAINS, FAM_WARMUP, FAM_SAMPLES = 8192, 400, 500
# each functor against its plain version and torch.func at this many
# points; K3 (6 steps) and K4 (FAM_CHECK_STEPS) against their plain
# versions at FAM_CHECK_CHAINS chains, one tile
FAM_EVAL_POINTS, FAM_CHECK_CHAINS, FAM_CHECK_STEPS = 1024, 1024, 30
# phase_family_check(calm_steps=...): K4 to CALM_ERR on the chains whose
# plain draws three 1e-6 changes of the start move by at most CALM_SPREAD
# (ten times below the error held), at least CALM_SHARE of them; the card
# tests' bounds for the hierarchical posterior (tests/test_torch_cuda.py)
CALM_ERR, CALM_SPREAD, CALM_SHARE = 2e-3, 2e-4, 0.7
# the eager reference of each family: warmup_and_run HMC at 1,024 chains
# (6.6-15.0 s each at 100 + 150 steps on the card; at 75 samples the AR(1)
# reference's standard deviations missed K4's by more than 50% + 0.05)
FAM_REF_CHAINS, FAM_REF_WARMUP, FAM_REF_SAMPLES = 1024, 100, 150
# nuts path: benchmarks/bench_nuts_depth.py's shape (the CLI's
# hierarchical model, 8 groups, 2,048 chains, 300 eager warmup steps of
# fixed-L10 HMC, then 200 steps of each sampler).  Each leapfrog of the
# eager route is ~15-25 ms of PyTorch calls on the card's host, so the
# depths are cut to keep the script within half its time limit
NUTS_GROUPS, NUTS_CHAINS = 8, 2048
# the hierarchical posterior past the density compiler's MAX_D_WIDE
# coordinates (2,046 groups, D = 4,097; 2 to 16 groups have a hand-written
# functor, 17 to 2,045 the wide form): a density with no functor, for the
# router's and the NUTS rule's other side
NO_FUNCTOR_GROUPS = 2046
NUTS_WARMUP, NUTS_WARMUP_PUBLISHED = 50, 300
# (cut for the wide phase: NUTS 10 -> 5 and 6 -> 3 steps; the gates,
# acceptance in (0.6, 0.99) and mu within 0.35, read 0.94 and 0.004)
NUTS_STEPS = {"hmc_L10": 10, "nuts_D4": 5, "nuts_D8": 3}
NUTS_STEPS_PUBLISHED = 200
# the chromatin posterior in its joint (Gram) form, eager NUTS at 8
# doublings against eager fixed-L10 HMC after one window warmup, at two
# sizes: the CLI's chain-grid model (64 beads, binf_tpu/cli.py:75-88) at
# the chain-grid path's 2,048 chains, and examples/run_chromatin.py's
# 2,048 beads at the chains one batched gradient's (C, N, N) intermediates
# leave room for in time.  Warmup and steps cut for time (the warmup 100 ->
# 50: on the CPU at 64 beads HMC then accepted 0.72 and NUTS 0.56, the gate
# (0.3, 1))
CHROM_NUTS = {64: {"chains": 2048}, 2048: {"chains": 16}}
CHROM_NUTS_WARMUP = 50
# (cut for the wide phase: NUTS 4 -> 2 steps; the gates are finite
# draws and the acceptance)
CHROM_NUTS_STEPS = {"hmc_L10": 20, "nuts_D8": 2}
CHROM_NUTS_STEP0 = 1e-3
# eager steps under the profiler for an idle share: its events take ~0.5 s
# of host time a leapfrog to read back (110 leapfrogs of two NUTS D = 8
# steps took ~58 s), so one step
NUTS_PROFILED = 1
# hierarchical path: the CLI's hierarchical model (8 groups, D = 21, the
# first functor past D = 8) through fused_model_hmc(warmup="fused") at the
# families path's shape (8,192 chains, 400 + 500 steps, L = 10) and at
# nuts_path's 2,048 chains; beside each, adaptive_hmc(algorithm="xla"),
# the eager route the router took for it before its functor, over the
# same closed-form potential, cut for time (40 warmup steps and 20
# samples of fixed-L10 HMC, of the published 400 + 500; cut from 100
# warmup steps after a CPU run found mu's means at 40 within 0.002 of
# those at 200)
HIER_CHAINS = (8192, 2048)
HIER_EAGER_WARMUP, HIER_EAGER_SAMPLES = 40, 20
# smc path: tempered_smc on the polynomial posterior (RWM moves, 10 a
# stage, tests/test_smc.py's settings at twice its particles), and on the
# conjugate Gaussian target whose evidence has a closed form
SMC_PARTICLES, SMC_MUTATION_STEPS = 4096, 10
SMC_GAUSS_PARTICLES, SMC_GAUSS_STEPS = 2048, 5
SMC_PROFILED_STAGES = 3
# vi path: the VI modules at the reference CLI's sizes (binf_tpu/cli.py:
# 229-312 and the functions' defaults) but for the steps: ADVI 16 ELBO
# samples, SVGD 256 particles, pathfinder 8 paths, 1,000 draws; on the
# polynomial posterior and on the hierarchical one (8 groups, D = 21);
# 4,000 draws of each fitted family.  On the polynomial posterior Laplace
# runs 500 of its 2,000 steps, ADVI 300 and SVGD 250 of its 1,000, for
# time (ADVI ~16 ms a step on the card's host; on the CPU its means moved
# by less than 1e-3 between 500 and 300 steps), and pathfinder 30 of its
# 60 iterations (PF_ITERS_PUBLISHED; on the CPU its means 0.010 from the
# exact conditional at 30, 0.029 at 60, the gate 0.2).  SVGD from the
# prior, which no gate reads (svgd_from_laplace holds SVGD to the
# posterior), 250 -> 100 steps
VI_STEPS = {"laplace": 500, "advi": 300, "svgd": 100}
VI_STEPS_PUBLISHED = {"laplace": 2000, "advi": 2000, "svgd": 1000}
# ADVI and SVGD cut on the hierarchical posterior for time (the
# reference's 2,000 and 1,000): their eager steps take 15-25 ms each on
# the card's host; Laplace keeps its 2,000 steps (at 500, 800 and 1,000 its
# Hessian there was not positive definite and its draws not finite, on the
# CPU too).  Only finiteness is gated here: ADVI 150 -> 100, SVGD 75 -> 50
VI_HIER_STEPS = {"laplace": 2000, "advi": 100, "svgd": 50}
# SVGD from prior draws settles slowly on the polynomial posterior (the
# JAX package's own run at 1,000 steps ends ~1.1 off in coefficient 1;
# tests/test_svgd.py runs 3,000 at twice the rate): its gate is a second
# run, SVGD_GATE_STEPS from SVGD_PARTICLES of the Laplace fit's draws, held
# to the posterior's moments, the run from the prior timed beside it
SVGD_GATE_STEPS = 200
VI_ELBO_SAMPLES, SVGD_PARTICLES = 16, 256
PF_PATHS, PF_ITERS, PF_DRAWS = 8, 30, 1000
PF_ITERS_PUBLISHED = 60
VI_DRAWS = 4000
VI_PROFILED_STEPS = 20
# cli path: python -m binf_tpu_torch once at its defaults in a subprocess,
# then cli.main in process; each run's gates are its counterpart's in
# tests/test_cli.py, its sizes too but where the eager steps are cut for
# time (fused 100 + 100 of 200 + 200; hmc from pathfinder starts 50 + 100
# of 100 + 200; advi and laplace 400 steps of the CLI's 1,600 and 2,000;
# svgd 200 of 2,000; logistic nuts 150 + 150 of 300 + 300); the
# hierarchical auto runs at bench_models.py's 8,192 chains and 400 + 500
# steps, and at the CLI's defaults
CLI_TIMEOUT_S = 240
# samplers path: the eager samplers on the logistic posterior from K4's
# final positions; parallel tempering on tests/test_tempering.py's bimodal
# target (K = 6, beta_min 0.02); Gibbs sweeps with MALA and NUTS blocks
SAMP_CHAINS = 4096
# NUTS 40 -> 20 steps and the Gibbs blocks 20 -> 12 sweeps (on the
# CPU NUTS's weight means 0.0024 from a long HMC run's, the gate 0.15; the
# blocks' coefficients within 0.0044 and 0.0025 of the collapsed sampler's,
# the gate 0.12)
SAMP_STEPS = {"mala": 200, "elliptical_slice": 60, "slice": 60, "nuts": 20}
PT_CHAINS, PT_K, PT_BETA_MIN, PT_STEPS, PT_BURN = 1024, 6, 0.02, 600, 200
GIBBS_CHAINS, GIBBS_SWEEPS = 1024, 12


def logistic_eval_flops(n: int, d: int) -> int:
    """Float operations of one logistic evaluation
    (csrc/logistic_density.cuh), a transcendental counted as one: a row's
    d FMAs for x . w, the softplus and sigmoid from one expf and one
    log1pf (12 with the division and the sums), d FMAs of the gradient;
    then the prior."""
    return n * (4 * d + 12) + 4 * d + 4


def ar1_eval_flops(T: int) -> int:
    """One AR(1) evaluation (csrc/ar1_density.cuh): a step's residual, four
    sums and four tangent and state updates (16), then the closed form."""
    return 16 * T + 30


def mixture_eval_flops(n: int, K: int = 3) -> int:
    """One mixture evaluation (csrc/mixture_density.cuh), transcendentals
    counted as one: a point's K distances and components, the log-sum-exp
    (K expf, one logf) and the responsibilities' 2 K + 2 sums (15 K + 2: 47
    at K = 3); then the sort, the weights and the prior (26 K + 2)."""
    return (15 * K + 2) * n + 26 * K + 2


def hierarchical_eval_flops(n: int, groups: int = 8) -> int:
    """One hierarchical evaluation (csrc/hierarchical_density.cuh), a
    transcendental and a division counted as one: a row's sigmoid (one
    expf, one division), its mock value, residual and three sums (16); a
    group's amplitude, Poisson rate and terms and its two gradients (12);
    the pooled prior's terms of each group coordinate (8 each); then the
    hyperparameters, t and U."""
    return 16 * groups * n + 12 * groups + 16 * groups + 40


def hierarchical_family(dev):
    """The hierarchical posterior as a family: (logdensity, start(C, seed),
    flops an evaluation), its data and start those of hierarchical_problem
    (the CLI's model, 8 groups, 15 points a group)."""
    logdensity, _, _ = hierarchical_problem(dev, 1)

    def start(C, seed):
        return hierarchical_problem(dev, C, seed)[2]

    return logdensity, start, hierarchical_eval_flops(15, NUTS_GROUPS)


def family_problems(dev):
    """The families with device densities at the JAX package's published
    sizes, their data drawn on the card from fixed seeds: name ->
    (logdensity, start(C, seed), flops an evaluation, the names whose draws
    are gated)."""
    from binf_tpu_torch.example import logistic, mixture, statespace
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    X, y = logistic.synthetic_logistic_data(gen(20), device=dev)
    y_ar = statespace.synthetic_ar1_data(gen(21), device=dev)
    y_mx = mixture.synthetic_mixture_data(gen(22), device=dev)

    def ar1_start(C, seed):
        p = statespace.initial_positions(C, torch.Generator().manual_seed(seed), device=dev)
        return {"dynamics": p["dynamics"], "precision": torch.log(p["precision"])}

    return {
        "logistic": (logistic.make_logistic_posterior(X, y, device=dev).log_prob,
                     lambda C, s: logistic.initial_positions(
                         C, torch.Generator().manual_seed(s), device=dev),
                     logistic_eval_flops(logistic.N_DATA_POINTS, 5)),
        "ar1": (transform_logdensity(statespace.make_ar1_posterior(y_ar, device=dev).log_prob,
                                     {"precision": LogTransform}),
                ar1_start, ar1_eval_flops(statespace.N_TIMESTEPS)),
        "mixture": (mixture.make_mixture_posterior(y_mx, device=dev).log_prob,
                    lambda C, s: mixture.initial_positions(
                        C, generator=torch.Generator().manual_seed(s), device=dev),
                    mixture_eval_flops(mixture.N_DATA_POINTS)),
    }


def gated_draws(name, samples: dict) -> dict:
    """Draws whose moments are gated: the mixture's means sorted (the
    density sorts them; raw means switch labels between chains)."""
    if name != "mixture":
        return dict(samples)
    return {**samples, "means": torch.sort(samples["means"], dim=-1).values}


class forced_lanes:
    """K3 and K4 (and density_eval's default) at the lane width ``G`` while
    the block runs: ``fp.lanes_for`` answers ``G``.  A width the kernels
    were not instantiated for raises at the launch."""

    def __init__(self, fp, G: int):
        self.fp, self.G = fp, G

    def __enter__(self):
        self.saved = self.fp.lanes_for
        self.fp.lanes_for = lambda density: self.G

    def __exit__(self, *exc):
        self.fp.lanes_for = self.saved


def phase_family_check(label, fp, dens_mod, density, logdensity, start, dev, widths=None,
                       calm_steps=None):
    """A family's functor at FAM_EVAL_POINTS points (density_eval) against
    its plain potential_and_grad and torch.func of the posterior, at 1e-4
    relative to the largest |U| and |grad U|; then K3 (6 steps) and K4
    (FAM_CHECK_STEPS steps, flip checks) against their plain versions at
    FAM_CHECK_CHAINS chains, one tile; each at each of ``widths`` (default:
    those the family's functor is instantiated for, ``fp.FAMILY_WIDTHS``:
    one lane and the chosen width), and K4's draws at
    each width against those at the width ``lanes_for`` picks, on the
    chains whose decisions matched the plain version's at both.  A width
    nobody instantiated raises.  The plain K4's own spread (how far a 1e-6
    relative change of the start moves its draws) is printed and returned.
    ``calm_steps``: where a density's trajectories amplify rounding past
    flip_check's reach (the mixture of more components than its data's
    clusters, the hierarchical funnel), K4 is held over ``calm_steps``
    steps instead, as the card tests hold the hierarchical posterior: to
    CALM_ERR on the chains whose plain decisions all lay past 1e-3 of their
    thresholds and whose plain draws three such changes moved by at most
    CALM_SPREAD, which must be at least CALM_SHARE of the chains.
    Returns the errors, the largest over the widths, and each width's."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions, pack_template

    C = FAM_CHECK_CHAINS
    widths = widths or fp.FAMILY_WIDTHS[density.functor]
    chosen = fp.lanes_for(density)
    template = {k: v[0] for k, v in start.items()}
    q = pack_positions(start)[:FAM_EVAL_POINTS]
    q = q + 0.3 * torch.randn(q.shape, generator=torch.Generator().manual_seed(23)).to(dev)
    U_p, g_p = density.potential_and_grad(q)
    # a device density's forward is its potential
    spec = pack_template(template)
    reference = ((lambda p: -logdensity(pack_positions(p, spec)[0]))
                 if dens_mod.is_device_density(logdensity) else logdensity)
    U_f, g_f = dens_mod.CallableDensity(reference, template).potential_and_grad(q)
    if isinstance(density, dens_mod.LinregDensity):
        # its potential drops the posterior's constants: one offset at every point
        offset = (U_f - U_p).mean()
        check(float((U_f - U_p - offset).abs().max() / U_f.abs().max()) <= 1e-4,
              f"{label}: the posterior's potential and the density's differ by one constant")
        U_f = U_f - offset
    q0 = pack_positions(start)[:C].contiguous()
    kw = dict(num_warmup=6, num_leapfrog=N_LEAPFROG, block_chains=C)
    margins, margins_s = [], []
    pk = dict(target_accept=0.8, init_search=False, **kw)
    q_p, eps_p, im_p = fp.fused_warmup_plain(density, q0, 9, 0.1, margins=margins, **pk)
    fp.fused_warmup_plain(density, perturbed_start(q0, 0), 9, 0.1, margins=margins_s, **pk)
    near = bool(near_decisions(margins, margins_s)[0].any())
    # K4 from a warmed state: 200 K3 steps on the kernel at the chosen width
    qw, eps_w, im_w = fp.fused_warmup_run(density, q0, 10, 0.1, num_warmup=200,
                                          num_leapfrog=N_LEAPFROG, block_chains=C, device=dev)
    S = calm_steps or FAM_CHECK_STEPS
    plain = fp.fused_potential_hmc_plain(density, qw, 24, eps_w, im_w, num_steps=S,
                                         block_chains=C)
    spread = torch.zeros(C, device=dev)  # per chain; inf where a decision flipped
    for k in range(3 if calm_steps else 1):
        moved = fp.fused_potential_hmc_plain(density, perturbed_start(qw, k), 24, eps_w, im_w,
                                             num_steps=S, block_chains=C)
        same = ((plain.margin < 0) == (moved.margin < 0)).all(dim=0)
        d = (moved.result.draws - plain.result.draws).abs().amax(dim=(0, 2))
        spread = torch.maximum(spread, torch.where(same, d, torch.full_like(d, math.inf)))
    finite = spread[torch.isfinite(spread)]
    k4_spread = {"steps": S, "max": float(finite.max()), "median": float(finite.median()),
                 "flipped_chains": int((~torch.isfinite(spread)).sum())}
    progress(f"{label}: a 1e-6 change of the start moves the plain K4 draws over {S} steps "
             f"by up to {k4_spread['max']:.3g} (median {k4_spread['median']:.3g}) and flips "
             f"{k4_spread['flipped_chains']} chains' decisions")
    held = None
    if calm_steps:
        held = (plain.margin.abs() > 1e-3).all(dim=0) & (spread <= CALM_SPREAD)
        k4_spread.update(held_share=float(held.float().mean()), err_tol=CALM_ERR)
        check(k4_spread["held_share"] >= CALM_SHARE,
              f"{label} K4: {k4_spread['held_share']:.1%} of chains calm over {S} steps "
              f"(decisions past 1e-3, spread <= {CALM_SPREAD}) >= {CALM_SHARE:.0%}")
    else:
        k4_spread.update(err_tol=1e-2)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    per_width, k4 = {}, {}
    for G in (chosen, *(w for w in widths if w != chosen)):
        at = f"{label} G={G}"
        U_k, g_k = dens_mod.density_eval(density, q, device=dev, lanes=G)
        check(dens_mod._build.last_launch["density_eval"].lanes == G,
              f"{at}: density_eval ran {G} lanes a point")
        errs = {"U_vs_plain": rel(U_k, U_p), "grad_vs_plain": rel(g_k, g_p),
                "U_vs_func": rel(U_k, U_f), "grad_vs_func": rel(g_k, g_f)}
        check(all(e <= 1e-4 for e in errs.values()),
              f"{at} functor at {FAM_EVAL_POINTS} points: U and grad U within 1e-4 relative "
              f"of the plain version and of torch.func "
              f"({ {k: f'{v:.3g}' for k, v in errs.items()} })")
        with forced_lanes(fp, G):
            q_k, eps_k, im_k = fp.fused_warmup_run(density, q0, 9, 0.1, device=dev, **kw)
            res = fp.fused_potential_hmc_run(density, qw, 24, eps_w, im_w, num_steps=S,
                                             steps_per_block=S, block_chains=C, device=dev)
            torch.cuda.synchronize()
        check(fp._build.last_launch["fused_warmup"].lanes == G
              and fp._build.last_launch["fused_potential_hmc"].lanes == G,
              f"{at}: K3 and K4 launched {G} lanes a chain")
        parted = float(((q_k - q_p).abs().amax(dim=1) > 1e-3).float().mean())
        rel_i = float(((im_k - im_p).abs() / im_p).max())
        check((parted <= 0.01 and rel_i <= 1e-2) or near,
              f"{at} K3, 6 steps: {parted:.2%} of chains parted by > 1e-3, metric rel err "
              f"{rel_i:.3g} (<= 1% and 1e-2, or a decision within reach of rounding: {near})")
        check(bool(torch.equal(eps_k, eps_p)), f"{at} K3, 6 steps: eps equal")
        if held is None:
            err, flipped = flip_check(f"{at} K4", res.draws, res.accept_rate, qw,
                                      plain.result.draws, plain.margin, plain.accepts)
        else:
            err = float((res.draws - plain.result.draws)[:, held].abs().max())
            check(err <= CALM_ERR, f"{at} K4, {S} steps: max abs err {err:.3g} <= {CALM_ERR} "
                                   f"on the {int(held.sum())} calm chains")
            flipped = ~held
        k4[G] = (res.draws, flipped)
        errs.update(k3_eps=float((eps_k - eps_p).abs().max()), k4_draws=err)
        per_width[G] = errs
    # the draws at each width against those at the chosen one: chains that
    # took the plain version's decisions at both agree as kernel and plain do
    for G in widths:
        if G == chosen:
            continue
        both = ~(k4[G][1] | k4[chosen][1])
        err = float((k4[G][0] - k4[chosen][0])[:, both].abs().max())
        check(err <= 1e-2, f"{label} K4 draws at G={G} and G={chosen}: max abs err "
                           f"{err:.3g} <= 1e-2 on {int(both.sum())} chains")
        per_width[G]["k4_draws_vs_chosen"] = err
    out = {k: max(e[k] for e in per_width.values()) for k in per_width[chosen]}
    out.update(chosen_lanes=chosen, widths=per_width, k4_spread=k4_spread)
    return out


# MUFU (the multi-function unit: ex2, lg2, rcp, rsqrt, sin, cos) results a
# clock an SM on sm_90 (CUDA C++ Programming Guide, arithmetic instruction
# throughput) against 128 float32 FMA lanes (256 flops a clock): the card's
# MUFU rate is PEAK_F32 / 16
MUFU_PER_SM_CLOCK = 16
PEAK_MUFU = PEAK_F32 * MUFU_PER_SM_CLOCK / 256

# One row's (one point's) evaluation, and the mixture's per-evaluation
# prologue, alone in a kernel each: their SASS counts the MUFU
# instructions a row issues (lanes.cuh evaluates rows through these)
MUFU_PROBE = r"""
#include "hierarchical_density.cuh"
#include "logistic_density.cuh"
#include "mixture_density.cuh"
using namespace binf;
extern "C" __global__ void logistic_value(const float* in, float* out) {
  float t, r;
  LogisticDensity<5>::row<true>(in[threadIdx.x], in[threadIdx.x + 32], t, r);
  out[threadIdx.x] = t + r;
}
extern "C" __global__ void logistic_grad(const float* in, float* out) {
  float t = 0.0f, r;
  LogisticDensity<5>::row<false>(in[threadIdx.x], in[threadIdx.x + 32], t, r);
  out[threadIdx.x] = r;
}
__device__ MixtureDensity<3>::Prologue pro(const float* in) {
  float q[7];
  for (int k = 0; k < 7; ++k) q[k] = in[k];
  return MixtureDensity<3>::prologue(q);
}
// every field of the prologue, so that none of its work is dead code
__device__ float used(const MixtureDensity<3>::Prologue& pr) {
  return pr.m[0] + pr.m[1] + pr.m[2] + pr.l[0] + pr.l[1] + pr.l[2] + pr.w[0] + pr.w[1]
         + pr.w[2] + pr.iv + pr.s + (float)(pr.perm[0] + pr.perm[1]);
}
extern "C" __global__ void mixture_value(const float* in, float* out) {
  const MixtureDensity<3>::Prologue pr = pro(in);
  const MixtureDensity<3>::Point p = MixtureDensity<3>::point<true>(in[8 + threadIdx.x], pr);
  out[threadIdx.x] = p.lse + p.r[0] + p.r[1] + p.r[2] + p.d[0] + used(pr);
}
extern "C" __global__ void mixture_grad(const float* in, float* out) {
  const MixtureDensity<3>::Prologue pr = pro(in);
  const MixtureDensity<3>::Point p = MixtureDensity<3>::point<false>(in[8 + threadIdx.x], pr);
  out[threadIdx.x] = p.r[0] + p.r[1] + p.r[2] + p.d[0] + used(pr);
}
extern "C" __global__ void mixture_prologue(const float* in, float* out) {
  out[threadIdx.x] = used(pro(in)) + in[8 + threadIdx.x];
}
// a hierarchical row (its sigmoid and three sums), and what an
// evaluation adds to its rows: each group's amplitude, Poisson rate and
// terms, then the closed form
extern "C" __global__ void hierarchical_row(const float* in, float* out) {
  float S = 0.0f, Ga = 0.0f, Gr = 0.0f;
  HierarchicalDensity<8>::row(in[0], in[1], in[threadIdx.x], in[threadIdx.x + 32], S, Ga, Gr);
  out[threadIdx.x] = S + Ga + Gr;
}
// a gradient's (the lesser work: no U), the groups' rows left out (n = 0)
extern "C" __global__ void hierarchical_prologue(const float* in, float* out) {
  const HierarchicalDensity<8> d{in, in, in + 160, in + 192, 0};
  float q[21], g[21];
  for (int k = 0; k < 21; ++k) q[k] = in[k + threadIdx.x];
  const float lam = expf(q[20]);
  float S = 0.0f;
  for (int j = 0; j < 8; ++j) {
    const HierarchicalDensity<8>::Group s = d.group<false>(j, q[2 * j], q[2 * j + 1]);
    S += s.sumsq;
    g[2 * j] = fmaf(lam, s.ga, s.dpois);
    g[2 * j + 1] = lam * s.gr;
  }
  d.close<false>(q, lam, S, 0.0f, g);
  float u = 0.0f;
  for (int k = 0; k < 21; ++k) u += g[k];
  out[threadIdx.x] = u;
}
// the logistic probes' loads and store alone
extern "C" __global__ void empty(const float* in, float* out) {
  out[threadIdx.x] = in[threadIdx.x] + in[threadIdx.x + 32];
}
"""


def mufu_counts(build) -> dict:
    """MUFU instructions, and all instructions issued, in each probe of
    MUFU_PROBE (nvcc -cubin for sm_90a, cuobjdump -sass), counted up to the
    kernel's first EXIT: the path every row takes (IEEE division's slow
    path lies past it).  Per family: a row's (point's) counts with U
    (``value``) and for a gradient alone (``grad``), net of the probe's
    loads and store (the logistic's) or of the prologue (the mixture's,
    whose per-evaluation counts are ``prologue``); instruction counts
    under ``instr``."""
    counts = {}
    for name, instrs in sass_listing(compile_probe("mufu_probe", MUFU_PROBE)).items():
        path = until_exit(instrs)
        mufu = {}
        for _, op, _ in path:
            if op.startswith("MUFU."):
                mufu[op[5:]] = mufu.get(op[5:], 0) + 1
        counts[name] = {"mufu": mufu, "instr": len(path)}

    def n(fn, key):
        c = counts[fn]
        return sum(c["mufu"].values()) if key == "mufu" else c["instr"]

    out = {"by_op": {k: v["mufu"] for k, v in counts.items()}}
    for key, suffix in (("mufu", ""), ("instr", "_instr")):
        out.setdefault("logistic", {}).update({
            "value" + suffix: n("logistic_value", key) - n("empty", key),
            "grad" + suffix: n("logistic_grad", key) - n("empty", key),
            "prologue" + suffix: 0})
        out.setdefault("mixture", {}).update({
            "value" + suffix: n("mixture_value", key) - n("mixture_prologue", key),
            "grad" + suffix: n("mixture_grad", key) - n("mixture_prologue", key),
            "prologue" + suffix: n("mixture_prologue", key) - n("empty", key)})
        # a hierarchical row is the same with U or without
        row = n("hierarchical_row", key) - n("empty", key)
        out.setdefault("hierarchical", {}).update({
            "value" + suffix: row, "grad" + suffix: row,
            "prologue" + suffix: n("hierarchical_prologue", key) - n("empty", key)})
    return out


# what a row adds beyond its probe: the logistic's x . w and gradient FMAs
# and its sum (2 D + 1 at D = 5), the mixture's eight sums (seven for a
# gradient alone); loads and loop control left out (the hierarchical
# probe makes its three sums itself)
ROW_ACCUMULATE = {"logistic": (11, 11), "mixture": (8, 7), "hierarchical": (0, 0)}


def mufu_bound_ms(mufu: dict, rows: int, steps: int, chains: int, L: int = N_LEAPFROG,
                  suffix: str = "", extra=(0, 0)):
    """The least time of ``steps`` HMC steps of ``chains`` chains on the MUFU
    pipe: a step's two evaluations with U and L - 1 gradients alone
    (lane_trajectory), each ``rows`` rows of MUFU work plus the
    prologue's, at PEAK_MUFU (the noise's and the accept test's few MUFU
    results a step are left out).  Also the MUFU results a step.  With
    ``suffix="_instr"`` and a row's ``extra`` instructions: the least time
    to issue the rows' instructions, one a clock on each of an SM's four
    schedulers (PEAK_F32 / 2 thread instructions a second: 128 lanes at two
    flops an FMA), the issue-slot floor of accurate expf, logf, log1pf and
    IEEE division."""
    per_step = (rows * (2 * (mufu["value" + suffix] + extra[0])
                        + (L - 1) * (mufu["grad" + suffix] + extra[1]))
                + (L + 1) * mufu["prologue" + suffix])
    rate = PEAK_MUFU if suffix == "" else PEAK_F32 / 2
    return 1e3 * steps * chains * per_step / rate, per_step


# the unit stems of csrc's K3/K4 branches, by functor
FAMILY_UNITS = {"LogisticDensity": "logistic", "AR1Density": "ar1", "MixtureDensity": "mixture",
                "HierarchicalDensity": "hierarchical"}


def unit_stems(fp, density, G: int) -> tuple[str, str]:
    """The translation units (their log stems) of K3's and K4's branch for
    this density at width G: a shape's own libraries, built at first use,
    or the units of csrc."""
    # an earlier checkout's package (scripts/kernel_cycles.py --package) has
    # only the units of csrc
    libs = (fp._libraries(density, G) if hasattr(fp, "_libraries")
            else ("fused_warmup", "fused_potential"))
    if libs != ("fused_warmup", "fused_potential"):
        return libs
    suffix = "" if G == 1 else f".g{G}"
    return tuple(f"{k}.{FAMILY_UNITS[density.functor]}{suffix}" for k in libs)


def ptxas_report(build, stem: str) -> dict:
    """Registers a thread, spill stores and loads and stack frame bytes of
    each kernel of one translation unit of K3/K4, from its ``-Xptxas -v``
    log (``<stem>.log`` in the build directory): ``{"k3" | "k4" |
    "k4_dense" | "eval": {...}}``; empty when the unit has no log."""
    import re

    def key(mangled):
        return ("k3" if "fused_warmup_kernel" in mangled
                else "eval" if "density_eval_kernel" in mangled
                else "k4_dense" if re.search(r"fused_potential_kernel.*Lb1E", mangled)
                else "k4" if "fused_potential_kernel" in mangled else None)

    return ptxas_entries(build, stem, key)


def family_width_sweep(fp, density, q0, dev, reps: int = 1, widths=None):
    """K3 (FAM_WARMUP steps) then K4 (FAM_SAMPLES steps) at FAM_CHAINS
    chains, one tile, at each of ``widths`` (default: those the family's
    functor is instantiated for, one lane and the chosen width;
    scripts/family_lanes.py builds and passes the others): CUDA events
    around each launch after one untimed run at that width; with each
    width's registers a thread, CTAs an SM and K3's geometry.  The K4
    start is K3's end at that width."""
    dev = q0.device  # with its index, as the density's operands are
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for G in widths or fp.FAMILY_WIDTHS[density.functor]:
        with forced_lanes(fp, G):
            def run(seed):
                q, eps, im = fp.fused_warmup_run(density, q0, seed, 0.1, num_warmup=FAM_WARMUP,
                                                 num_leapfrog=N_LEAPFROG,
                                                 block_chains=FAM_CHAINS, device=dev)
                mid = torch.cuda.Event(enable_timing=True)
                mid.record()
                res = fp.fused_potential_hmc_run(density, q, seed, eps, im,
                                                 num_steps=FAM_SAMPLES,
                                                 steps_per_block=FAM_SAMPLES,
                                                 block_chains=FAM_CHAINS, device=dev)
                return mid, res

            run(50)
            k3, k4 = [], []
            for rep in range(reps):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                mid, res = run(51 + rep)
                ev[1].record()
                torch.cuda.synchronize()
                k3.append(ev[0].elapsed_time(mid))
                k4.append(mid.elapsed_time(ev[1]))
            geo = fp.fused_warmup_geometry(density, FAM_CHAINS, FAM_CHAINS, device=dev)
            k3_max, _, k3_regs = fp._occupancy(density, density.D, G, dev)
            k4_per_sm, k4_regs = fp.k4_occupancy(density, G, device=dev)
            k4_rec = fp._build.last_launch["fused_potential_hmc"]
        ptxas = {k: ptxas_report(fp._build, stem)
                 for k, stem in zip(("fused_warmup", "fused_potential"),
                                    unit_stems(fp, density, G))}
        out[G] = {"k3_ms": float(np.mean(k3)), "k4_ms": float(np.mean(k4)),
                  "accept": float(res.accept_rate),
                  "k3_ptxas": ptxas["fused_warmup"].get("k3"),
                  "k4_ptxas": {k: v for k, v in ptxas["fused_potential"].items() if k != "k3"},
                  "k3_registers": k3_regs, "k3_ctas_per_sm": k3_max / sms,
                  "k3_geometry": geo._asdict(),
                  "k4_registers": k4_regs, "k4_ctas_per_sm": k4_per_sm,
                  "k4_ctas": k4_rec.ctas, "k4_threads": k4_rec.threads}
        progress(f"width sweep {density.functor} G={G}: K3 {out[G]['k3_ms']:.3f} ms "
                 f"({k3_regs} registers, {k3_max / sms:g} CTAs an SM, {geo.ctas} CTAs x "
                 f"{geo.rounds} rounds), K4 {out[G]['k4_ms']:.3f} ms ({k4_regs} registers, "
                 f"{k4_per_sm} CTAs an SM, {k4_rec.ctas} CTAs), accept {out[G]['accept']:.3f}")
    return out


def family_run(fused_model_hmc, logdensity, start, seed, dev):
    return fused_model_hmc(logdensity, start, seed, num_warmup=FAM_WARMUP,
                           num_samples=FAM_SAMPLES, num_leapfrog=N_LEAPFROG,
                           initial_step_size=0.1, warmup="fused", device=dev)


def families_path(build, fp, dens_mod, auto, fused_model_hmc, problems, dev):
    """``fused_model_hmc(warmup="fused")`` on the logistic, AR(1) and mixture
    posteriors at FAM_CHAINS chains: per family the functor, K3 and K4
    checks at every instantiated width (phase_family_check), then launch
    counts from 0, one cold and one timed run (CUDA events around K3 and
    K4) at the width ``lanes_for`` picks, the acceptance gate, the moments
    against an eager warmup_and_run HMC run at FAM_REF_CHAINS chains
    (adaptive_hmc(algorithm="xla")), and the router's decision, which must
    be "fused" for these and "xla" for the hierarchical posterior (checked
    in nuts_path).  Each family's K3 and K4 also at every instantiated
    width (family_width_sweep), and for the logistic and the mixture the
    MUFU side of their bounds (mufu_counts)."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    mufu = mufu_counts(build)
    progress(f"families path: MUFU and all instructions a row (value, gradient alone, "
             f"prologue): { {k: v for k, v in mufu.items() if k != 'by_op'} }")
    out, results = {}, {}
    for name, (logdensity, start_fn, ev) in problems.items():
        label = f"families path {name}"
        start = start_fn(FAM_CHAINS, 40)
        template = {k: v[0] for k, v in start.items()}
        density = dens_mod.device_density(logdensity, template).to(dev)
        D = density.D
        checks = phase_family_check(label, fp, dens_mod, density, logdensity, start, dev)
        dec = auto.route_algorithm(logdensity, start)
        check(dec.path == "fused" and type(density).__name__ in dec.reason,
              f"{label}: the router sends it to {dec.path} ({dec.reason})")

        build.reset_launch_counts()
        t = time.perf_counter()
        family_run(fused_model_hmc, logdensity, start, 41, dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res = family_run(fused_model_hmc, logdensity, start, 42, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(build.LAUNCHES)
        for k in ("philox", "fused_warmup", "fused_potential_hmc"):
            check(launches[k] > 0, f"{label} launched {k} {launches[k]} times")
        accept = float(res.accept_rate)
        check(0.6 < accept < 0.95, f"{label}: acceptance {accept:.4f} in (0.6, 0.95)")
        draws = gated_draws(name, res.samples)
        flat = pack_positions({k: v.reshape((-1,) + v.shape[2:]) for k, v in draws.items()})
        check(bool(torch.isfinite(flat).all())
              and tuple(flat.shape) == (FAM_SAMPLES * FAM_CHAINS, D),
              f"{label}: finite draws of shape ({FAM_SAMPLES}, {FAM_CHAINS}, {D})")
        m_ess = float(ess(flat.reshape(FAM_SAMPLES, FAM_CHAINS, D)).min())

        ref_start = {k: v[:FAM_REF_CHAINS] for k, v in start_fn(FAM_REF_CHAINS, 43).items()}
        t = time.perf_counter()
        ref, ref_dec = auto.adaptive_hmc(logdensity, ref_start,
                                         torch.Generator(device=dev).manual_seed(44),
                                         num_warmup=FAM_REF_WARMUP, num_samples=FAM_REF_SAMPLES,
                                         initial_step_size=0.1, algorithm="xla", device=dev)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t
        check(sum(build.LAUNCHES[k] for k in ("fused_warmup", "fused_potential_hmc"))
              == launches["fused_warmup"] + launches["fused_potential_hmc"],
              f"{label}: the eager reference launched no whole-run kernel")
        rdraws = gated_draws(name, ref.samples)
        kept = FAM_SAMPLES // 4
        moments = {}
        for k in draws:
            a = draws[k][kept:].reshape((-1,) + draws[k].shape[2:]).double()
            b = rdraws[k][FAM_REF_SAMPLES // 4:].reshape((-1,) + rdraws[k].shape[2:]).double()
            mean_err = float((a.mean(0) - b.mean(0)).abs().max())
            sd_a, sd_b = a.std(0), b.std(0)
            sd_ok = bool(((sd_a - sd_b).abs() <= 0.5 * sd_b + 0.05).all())
            # tests/test_fused_models.py: means within 0.15 (the mixture's
            # sorted means 0.25), standard deviations within 50% + 0.05;
            # tests/test_logistic.py:87-104: weight means within 0.15
            tol = 0.25 if (name, k) == ("mixture", "means") else 0.15
            check(mean_err < tol and sd_ok,
                  f"{label}: {k} means within {mean_err:.3g} (< {tol}) and standard "
                  f"deviations within 50% + 0.05 of the eager HMC reference")
            moments[k] = {"mean": a.mean(0).reshape(-1).tolist(),
                          "sd": sd_a.reshape(-1).tolist(), "ref_mean_err": mean_err}
        k4_ms, k3_ms = spans.ms("sampling"), spans.ms("warmup")
        k4_bound = bound_ms(FAM_CHAINS * (2 * D + 1) * 4 + FAM_SAMPLES * FAM_CHAINS * D * 4
                            + FAM_CHAINS * (D + 1) * 4,
                            FAM_SAMPLES * FAM_CHAINS * trajectory_flops(ev, D, N_LEAPFROG),
                            philox_calls(FAM_SAMPLES, FAM_CHAINS, D))
        k3_bound = bound_ms(FAM_CHAINS * (3 * D + 1) * 4,
                            FAM_WARMUP * FAM_CHAINS * trajectory_flops(ev, D, N_LEAPFROG),
                            philox_calls(FAM_WARMUP, FAM_CHAINS, D))
        lanes = {"k3": build.last_launch["fused_warmup"].lanes,
                 "k4": build.last_launch["fused_potential_hmc"].lanes}
        sweep = family_width_sweep(fp, density, pack_positions(start).contiguous(), dev)
        branch = {"width_sweep": sweep}
        if name in mufu:
            k3_mufu, per_step = mufu_bound_ms(mufu[name], density.n, FAM_WARMUP, FAM_CHAINS)
            k4_mufu, _ = mufu_bound_ms(mufu[name], density.n, FAM_SAMPLES, FAM_CHAINS)
            issue = {k: mufu_bound_ms(mufu[name], density.n, steps, FAM_CHAINS,
                                      suffix="_instr", extra=ROW_ACCUMULATE[name])[0]
                     for k, steps in (("k3", FAM_WARMUP), ("k4", FAM_SAMPLES))}
            branch.update(mufu_per_row=mufu[name], mufu_per_step=per_step,
                          k3_mufu_bound_ms=k3_mufu, k4_mufu_bound_ms=k4_mufu,
                          k3_issue_bound_ms=issue["k3"], k4_issue_bound_ms=issue["k4"])
            progress(f"{label}: MUFU bound K3 {k3_mufu:.3f} ms, K4 {k4_mufu:.3f} ms; "
                     f"operations bound K3 {k3_bound[0]:.3f}, K4 {k4_bound[0]:.3f}; the rows' "
                     f"instruction issue alone K3 {issue['k3']:.3f}, K4 {issue['k4']:.3f}")
        chosen = sweep[lanes["k4"]]
        progress(f"{label}: G = {lanes['k4']}; the one-lane branch K3 {sweep[1]['k3_ms']:.3f}, "
                 f"K4 {sweep[1]['k4_ms']:.3f} ms in the sweep, G = {lanes['k4']} "
                 f"{chosen['k3_ms']:.3f}, {chosen['k4_ms']:.3f}")
        out[name] = {
            "chains": FAM_CHAINS, "warmup": FAM_WARMUP, "samples": FAM_SAMPLES,
            "leapfrog": N_LEAPFROG, "D": D, "functor": type(density).__name__,
            "eval_flops": ev, "cold_ms": cold * 1e3, "e2e_ms": wall * 1e3, "k3_ms": k3_ms,
            "k4_ms": k4_ms, "k3_bound_ms": k3_bound[0], "k4_bound_ms": k4_bound[0],
            "k4_bound_by": k4_bound[1], "k4_bound_share": k4_bound[0] / k4_ms,
            "accept": accept, "step_size": float(res.step_size.mean()),
            "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall, "moments": moments,
            "reference": {"chains": FAM_REF_CHAINS, "warmup": FAM_REF_WARMUP,
                          "samples": FAM_REF_SAMPLES, "wall_ms": ref_wall * 1e3,
                          "accept": float(ref.accept_rate), "path": ref_dec.path},
            "route": dec.reason, "checks": checks,
            "k3_launch": launch_keys(build.last_launch["fused_warmup"]),
            "k4_launch": launch_keys(build.last_launch["fused_potential_hmc"]),
            "lanes": lanes, **branch, "launches": launches}
        results[name] = res
        progress(f"{label}: e2e {wall * 1e3:.2f} ms, K3 {k3_ms:.3f} ms, K4 {k4_ms:.3f} ms "
                 f"(bound {k4_bound[0]:.3f}), accept {accept:.4f}, min bulk ESS {m_ess:.1f}, "
                 f"ESS/s {m_ess / wall:.4g}; eager reference {ref_wall:.1f} s")
    # the paths' total counts one launches dict
    merged = {k: sum(o["launches"][k] for o in out.values()) for k in build.LAUNCHES}
    return {"families": out, "launches": merged, "mufu": mufu}, results


def family_branch(f: dict, k: str) -> dict:
    """One family's branch of K3 (``k = "k3"``) or K4 for the ``kernels``
    line: its width, launches on the path, ms, the operations bound and,
    for the logistic and the mixture, the MUFU side (transcendentals at
    the MUFU rate), the larger of the two (``bound_pipe`` says which pipe),
    its share, the least time to issue the rows' instructions
    (``issue_bound_ms``, beside the bound: the floor the accurate library
    functions set), and each instantiated width's ms from the sweep."""
    name = {"k3": "fused_warmup", "k4": "fused_potential_hmc"}[k]
    ops = f[f"{k}_bound_ms"]
    row = {"lanes": f["lanes"][k], "launches": f["launches"][name], "ms": f[f"{k}_ms"],
           "bound_ms": ops, "bound_by": "operations"}
    if f"{k}_mufu_bound_ms" in f:
        mufu = f[f"{k}_mufu_bound_ms"]
        row.update(ops_bound_ms=ops, mufu_bound_ms=mufu, bound_ms=max(ops, mufu),
                   bound_pipe="fp32" if ops >= mufu else "mufu",
                   issue_bound_ms=f[f"{k}_issue_bound_ms"])
    row["width_ms"] = {G: r[f"{k}_ms"] for G, r in f["width_sweep"].items()}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def hierarchical_ess(samples: dict):
    """Min bulk ESS of a hierarchical run's draws (each ``(steps, C, ...)``)
    over every coordinate, and over the hyperparameters (mu, log_tau and
    the log precision) alone."""
    from binf_tpu_torch.diagnostics import ess

    steps, C = samples["mu"].shape[:2]
    hyper = torch.cat([samples["mu"], samples["log_tau"], samples["precision"][..., None]], -1)
    every = torch.cat([samples["group_params"].reshape(steps, C, -1), hyper], -1)
    return float(ess(every).min()), float(ess(hyper).min())


def hierarchical_path(build, fp, dens_mod, auto, fused_model_hmc, mufu, dev, profiles):
    """``fused_model_hmc(warmup="fused")`` on the CLI's hierarchical model
    (8 groups, D = 21): the functor at every instantiated width against its
    plain version and torch.func, K3 and K4 against their plain versions
    (phase_family_check, flip checks); the router's decisions at 8 groups
    ("fused", device density) and at 4 ("xla"; the fused route raises on
    the card there, and runs nothing); launch counts from 0, one cold and
    one timed run (CUDA events around K3 and K4) at each of HIER_CHAINS,
    and one profiled in a fresh process (``profiles``: hierarchical_profile,
    which router_path's fresh process ran; the card's idle share), gated on
    acceptance, the
    hyperparameters against the truth (tests/test_hierarchical.py's
    bounds) and split R-hat; ESS/s of the whole run against eager
    adaptive HMC on the same closed-form potential at the same chains;
    each branch timed at every instantiated width with its registers,
    spills and CTAs an SM; the operations, MUFU and issue bounds."""
    from binf_tpu_torch.diagnostics import split_rhat
    from binf_tpu_torch.example import hierarchical
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    label = "hierarchical path"
    logdensity, start_fn, ev = hierarchical_family(dev)
    start = start_fn(FAM_CHAINS, 40)
    template = {k: v[0] for k, v in start.items()}
    density = dens_mod.device_density(logdensity, template).to(dev)
    D = density.D
    check(type(density).__name__ == "HierarchicalDensity" and D == 21,
          f"{label}: the posterior of 8 groups has its device density, D = {D}")
    checks = phase_family_check(label, fp, dens_mod, density, logdensity, start, dev)
    dec = auto.route_algorithm(logdensity, start)
    check(dec.path == "fused" and dec.reason.startswith("device density"),
          f"{label}: the router sends it to {dec.path} ({dec.reason})")
    ld4, _, start4 = hierarchical_problem(dev, 64, groups=NO_FUNCTOR_GROUPS)
    dec4 = auto.route_algorithm(ld4, start4)
    check(dec4.path == "xla", f"{label}: at {NO_FUNCTOR_GROUPS} groups the router sends it to "
                              f"{dec4.path}")
    build.reset_launch_counts()
    try:
        fused_model_hmc(ld4, start4, 0, num_warmup=10, num_samples=10, warmup="fused",
                        device=dev)
        raised = False
    except NotImplementedError:
        raised = True
    check(raised and sum(build.LAUNCHES.values()) == 0,
          f"{label}: at {NO_FUNCTOR_GROUPS} groups the fused route raises on the card and "
          "launches nothing")
    _, _, _, gp_true = hierarchical.synthetic_hierarchical_data(
        torch.Generator(device=dev).manual_seed(30), NUTS_GROUPS, device=dev)
    true_mu = torch.tensor(hierarchical.TRUE_MU, device=dev)

    runs, launches = {}, {k: 0 for k in build.LAUNCHES}
    for C in HIER_CHAINS:
        at = f"{label} C={C}"
        st = start if C == FAM_CHAINS else start_fn(C, 40)
        build.reset_launch_counts()
        t = time.perf_counter()
        family_run(fused_model_hmc, logdensity, st, 41, dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res = family_run(fused_model_hmc, logdensity, st, 42, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = dict(build.LAUNCHES)
        for k in ("philox", "fused_warmup", "fused_potential_hmc"):
            check(counts[k] > 0, f"{at} launched {k} {counts[k]} times")
        accept = float(res.accept_rate)
        check(0.6 < accept < 0.95, f"{at}: acceptance {accept:.4f} in (0.6, 0.95)")
        flat = pack_positions({k: v.reshape((-1,) + v.shape[2:]) for k, v in res.samples.items()})
        check(bool(torch.isfinite(flat).all()) and tuple(flat.shape) == (FAM_SAMPLES * C, D),
              f"{at}: finite draws of shape ({FAM_SAMPLES}, {C}, {D})")
        kept = {k: v[FAM_SAMPLES // 4:] for k, v in res.samples.items()}
        mu = kept["mu"].reshape(-1, 2).mean(0)
        prec = float(torch.exp(kept["precision"]).mean())
        gp = kept["group_params"].reshape(-1, NUTS_GROUPS, 2).mean(0)
        mu_err = float((mu - true_mu).abs().max())
        gp_err = float((gp - gp_true).abs().max())
        check(mu_err < 0.35 and 10.0 < prec < 45.0 and gp_err < 0.5,
              f"{at}: mu within {mu_err:.3g} of the truth (< 0.35), precision mean "
              f"{prec:.2f} in (10, 45), group params within {gp_err:.3g} (< 0.5)")
        hyper = torch.cat([kept["mu"], kept["log_tau"], kept["precision"][..., None]], -1)
        rhat = float(split_rhat(hyper).max())
        check(rhat < 1.2, f"{at}: split R-hat of the hyperparameters {rhat:.4f} < 1.2")
        ess_all, ess_hyper = hierarchical_ess(res.samples)
        # the eager route over the same potential (the device density's
        # closed form), cut as nuts_path cuts its eager runs
        ref_start = start_fn(C, 44)
        before = sum(build.LAUNCHES.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref, ref_dec = auto.adaptive_hmc(logdensity, ref_start,
                                         torch.Generator(device=dev).manual_seed(45),
                                         num_warmup=HIER_EAGER_WARMUP,
                                         num_samples=HIER_EAGER_SAMPLES, initial_step_size=0.1,
                                         algorithm="xla", device=dev)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t
        check(sum(build.LAUNCHES.values()) == before and ref_dec.path == "xla",
              f"{at}: the eager reference launched no kernel of the port")
        ref_all, ref_hyper = hierarchical_ess(ref.samples)
        ref_mu = ref.samples["mu"][HIER_EAGER_SAMPLES // 4:].reshape(-1, 2).mean(0)
        mu_vs_eager = float((mu - ref_mu).abs().max())
        check(mu_vs_eager < 0.35, f"{at}: mu means within {mu_vs_eager:.3g} of the eager "
                                  "run's (< 0.35)")
        runs[C] = {
            "chains": C, "cold_ms": cold * 1e3, "e2e_ms": wall * 1e3,
            "k3_ms": spans.ms("warmup"), "k4_ms": spans.ms("sampling"), "accept": accept,
            "step_size": float(res.step_size.mean()), "min_bulk_ess": ess_all,
            "min_bulk_ess_hyper": ess_hyper, "ess_per_s": ess_all / wall,
            "ess_per_s_hyper": ess_hyper / wall, "mu": mu.tolist(), "precision_mean": prec, "rhat_hyper": rhat,
            "eager": {"warmup": HIER_EAGER_WARMUP, "samples": HIER_EAGER_SAMPLES,
                      "wall_ms": ref_wall * 1e3, "accept": float(ref.accept_rate),
                      "min_bulk_ess": ref_all, "min_bulk_ess_hyper": ref_hyper,
                      "ess_per_s": ref_all / ref_wall, "ess_per_s_hyper": ref_hyper / ref_wall,
                      "mu_vs_fused": mu_vs_eager},
            "fused_ahead": ess_hyper / wall > ref_hyper / ref_wall
                           and ess_all / wall > ref_all / ref_wall,
            "k3_launch": launch_keys(build.last_launch["fused_warmup"]),
            "k4_launch": launch_keys(build.last_launch["fused_potential_hmc"]),
            "launches": counts}
        for k, v in counts.items():
            launches[k] += v
        progress(f"{at}: e2e {wall * 1e3:.2f} ms, K3 {runs[C]['k3_ms']:.3f} ms, K4 "
                 f"{runs[C]['k4_ms']:.3f} ms, accept {accept:.4f}, min bulk ESS {ess_all:.1f} "
                 f"(hyper {ess_hyper:.1f}), ESS/s {ess_all / wall:.4g} (hyper "
                 f"{ess_hyper / wall:.4g}); eager {ref_wall * 1e3:.1f} ms for "
                 f"{HIER_EAGER_WARMUP} + {HIER_EAGER_SAMPLES} steps, ESS/s "
                 f"{ref_all / ref_wall:.4g} (hyper {ref_hyper / ref_wall:.4g})")
    # the card's idle share of each run, in a fresh process's trace (late
    # in this one the profiler has lost every device event: router_path,
    # whose process made these too)
    for C in HIER_CHAINS:
        prof = profiles.get(str(C), {})
        check(prof.get("k3") is not None and prof["k3"][1] > 0 and prof["k4"][1] > 0,
              f"{label} C={C}: a fresh process's profiler saw K3 and K4 ({prof.get('k3')}, "
              f"{prof.get('k4')})")
        runs[C].update(idle_share=1.0 - prof["busy"][0] / prof["wall"], profiled=prof)
        progress(f"{label} C={C}: the card idle {runs[C]['idle_share']:.3f} of a profiled run "
                 f"({prof['wall']:.1f} ms, K3 {prof['k3'][0]:.3f} ms, K4 {prof['k4'][0]:.3f} ms "
                 f"device time)")
    main = runs[FAM_CHAINS]
    k4_bound = bound_ms(FAM_CHAINS * (2 * D + 1) * 4 + FAM_SAMPLES * FAM_CHAINS * D * 4
                        + FAM_CHAINS * (D + 1) * 4,
                        FAM_SAMPLES * FAM_CHAINS * trajectory_flops(ev, D, N_LEAPFROG),
                        philox_calls(FAM_SAMPLES, FAM_CHAINS, D))
    k3_bound = bound_ms(FAM_CHAINS * (3 * D + 1) * 4,
                        FAM_WARMUP * FAM_CHAINS * trajectory_flops(ev, D, N_LEAPFROG),
                        philox_calls(FAM_WARMUP, FAM_CHAINS, D))
    rows = density.n_groups * density.n
    k3_mufu, per_step = mufu_bound_ms(mufu["hierarchical"], rows, FAM_WARMUP, FAM_CHAINS)
    k4_mufu, _ = mufu_bound_ms(mufu["hierarchical"], rows, FAM_SAMPLES, FAM_CHAINS)
    issue = {k: mufu_bound_ms(mufu["hierarchical"], rows, steps, FAM_CHAINS, suffix="_instr",
                              extra=ROW_ACCUMULATE["hierarchical"])[0]
             for k, steps in (("k3", FAM_WARMUP), ("k4", FAM_SAMPLES))}
    sweep = family_width_sweep(fp, density, pack_positions(start).contiguous(), dev)
    # the plain versions at the path's inputs: K3 over a quarter of
    # PLAIN_CUT steps, K4 from a warmed state over PLAIN_CUT
    k3_plain_ms, _ = timed(lambda: fp.fused_warmup_plain(
        density, pack_positions(start).contiguous(), 46, 0.1, num_warmup=PLAIN_CUT // 4,
        num_leapfrog=N_LEAPFROG, block_chains=FAM_CHAINS, target_accept=0.8,
        init_search=False))
    warm = fp.fused_warmup_run(density, pack_positions(start).contiguous(), 47, 0.1,
                               num_warmup=FAM_WARMUP, num_leapfrog=N_LEAPFROG,
                               block_chains=FAM_CHAINS, device=dev)
    k4_plain_ms, _ = timed(lambda: fp.fused_potential_hmc_plain(
        density, warm[0], 48, warm[1], warm[2], num_steps=PLAIN_CUT, block_chains=FAM_CHAINS))
    progress(f"{label}: operations bound K3 {k3_bound[0]:.3f}, K4 {k4_bound[0]:.3f} ms; MUFU "
             f"bound K3 {k3_mufu:.3f}, K4 {k4_mufu:.3f} ms; the rows' instruction issue K3 "
             f"{issue['k3']:.3f}, K4 {issue['k4']:.3f} ms; plain K3 {k3_plain_ms:.1f} ms for "
             f"{PLAIN_CUT // 4} steps, plain K4 {k4_plain_ms:.1f} ms for {PLAIN_CUT} steps")
    lanes = {"k3": main["k3_launch"]["lanes"], "k4": main["k4_launch"]["lanes"]}
    out = {
        "chains": FAM_CHAINS, "warmup": FAM_WARMUP, "samples": FAM_SAMPLES,
        "leapfrog": N_LEAPFROG, "D": D, "groups": NUTS_GROUPS, "rows": rows,
        "functor": type(density).__name__, "eval_flops": ev, "route": dec.reason,
        "route_4_groups": dec4.reason, "runs": runs,
        "k3_ms": main["k3_ms"], "k4_ms": main["k4_ms"], "e2e_ms": main["e2e_ms"],
        "k3_bound_ms": k3_bound[0], "k4_bound_ms": k4_bound[0], "k4_bound_by": k4_bound[1],
        "k3_mufu_bound_ms": k3_mufu, "k4_mufu_bound_ms": k4_mufu, "mufu_per_step": per_step,
        "mufu_per_row": mufu["hierarchical"], "k3_issue_bound_ms": issue["k3"],
        "k4_issue_bound_ms": issue["k4"], "k3_plain_ms": k3_plain_ms,
        "k3_plain_steps": PLAIN_CUT // 4, "k4_plain_ms": k4_plain_ms,
        "k4_plain_steps": PLAIN_CUT, "checks": checks, "lanes": lanes, "width_sweep": sweep,
        "eager_cut": {"warmup": [FAM_WARMUP, HIER_EAGER_WARMUP],
                      "samples": [FAM_SAMPLES, HIER_EAGER_SAMPLES]},
        "launches": launches}
    return out


def hierarchical_profile():
    """What ``torch.profiler`` sees of one hierarchical path run at each of
    HIER_CHAINS (after one untraced run): ``{C: profile_device(...)}``
    (fresh_profiles)."""
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    _build.build_all()
    dev = torch.device("cuda")
    logdensity, start_fn, _ = hierarchical_family(dev)
    out = {}
    for C in HIER_CHAINS:
        start = start_fn(C, 40)
        family_run(fused_model_hmc, logdensity, start, 43, dev)
        out[C] = profile_device(lambda: family_run(fused_model_hmc, logdensity, start, 43, dev),
                                {"k3": ("fused_warmup_kernel",),
                                 "k4": ("fused_potential_kernel",)})
    return out


def smc_path(build, poly, xses, ys, V, dev):
    """``tempered_smc`` on the polynomial posterior: SMC_PARTICLES particles
    on the card, RWM moves (SMC_MUTATION_STEPS a stage); one cold and one
    timed run (wall ms, stages, acceptance) and its first
    SMC_PROFILED_STAGES stages under the profiler (the card's idle share);
    gated on reaching beta = 1, the coefficient
    means within 0.1 of the exact conditional at the mean precision, and,
    on the conjugate Gaussian target of tests/test_smc.py:51, the posterior
    moments and the log evidence against their closed forms (0.05, 0.03,
    0.25).  The eager samplers launch none of the port's kernels."""
    from binf_tpu_torch.core.density import VariableSpec
    from binf_tpu_torch.model import GaussianErrorModel
    from binf_tpu_torch.model.forward import ParametricCurveModel
    from binf_tpu_torch.pdf import GaussianPrior, Likelihood, Posterior
    from binf_tpu_torch.smc import tempered_smc

    label = "smc path"
    posterior = poly.make_posterior(xses, ys)

    def run(seed, max_stages=100):
        return tempered_smc(posterior, torch.Generator(device=dev).manual_seed(seed),
                            num_particles=SMC_PARTICLES, mutation="rwm",
                            num_mutation_steps=SMC_MUTATION_STEPS, max_stages=max_stages)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(60)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    t = time.perf_counter()
    with BetaSchedule() as schedule:
        res = run(61)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    # the profiler's events of a whole run (~65,000 launches) take ~40 s to
    # read back: the idle share is taken over the first SMC_PROFILED_STAGES
    prof = profile_device(lambda: run(62, SMC_PROFILED_STAGES), {})
    idle = None if prof["busy"] is None else 1.0 - prof["busy"][0] / prof["wall"]
    check(float(res.final_beta) == 1.0 and int(res.num_stages) < 50,
          f"{label}: beta 1 reached in {int(res.num_stages)} stages (< 50)")
    coeffs = res.particles["coefficients"].double()
    lam = float(res.particles["precision"].double().mean())
    exact, _ = exact_conditional(V, ys, lam, dev)
    c_err = float((coeffs.mean(0) - exact).abs().max())
    check(c_err < 0.1, f"{label}: coefficient means within {c_err:.3g} of the exact "
                       "conditional Gaussian at the mean precision (< 0.1)")
    # the conjugate Gaussian target: x_i ~ N(mu, 1), mu ~ N(0, 1)
    n = 10
    data = torch.randn(n, generator=torch.Generator().manual_seed(63)) + 1.5
    fwm = ParametricCurveModel(x=torch.zeros(n, device=dev),
                               fn=lambda x, v: torch.broadcast_to(v["mu"], (n,)),
                               specs=(VariableSpec("mu", ()),))
    em = GaussianErrorModel.create(data.to(dev), full_normalization=True).fix(
        precision=torch.tensor(1.0, device=dev))
    gauss = Posterior.create({"obs": Likelihood.create("obs", fwm, em)},
                             {"mu_prior": GaussianPrior.create(torch.zeros((), device=dev),
                                                               torch.ones((), device=dev),
                                                               variable="mu")})
    g = tempered_smc(gauss, torch.Generator(device=dev).manual_seed(64),
                     num_particles=SMC_GAUSS_PARTICLES, num_mutation_steps=SMC_GAUSS_STEPS)
    d = data.double().numpy()
    post_mean, post_var = n * d.mean() / (n + 1), 1.0 / (n + 1)
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    log_z = -0.5 * (n * np.log(2 * np.pi) + logdet + d @ np.linalg.solve(cov, d))
    mu = g.particles["mu"].double()
    errs = {"mean_err": abs(float(mu.mean()) - post_mean),
            "var_err": abs(float(mu.var()) - post_var),
            "log_evidence_err": abs(float(g.log_evidence) - log_z)}
    check(errs["mean_err"] < 0.05 and errs["var_err"] < 0.03 and errs["log_evidence_err"] < 0.25
          and float(g.final_beta) == 1.0,
          f"{label}: the Gaussian target's mean, variance and log evidence within "
          f"{errs['mean_err']:.3g}, {errs['var_err']:.3g}, {errs['log_evidence_err']:.3g} of "
          "their closed forms (< 0.05, 0.03, 0.25)")
    check(sum(build.LAUNCHES.values()) == 0, f"{label}: the eager samplers launched no kernel")
    out = {"particles": SMC_PARTICLES, "mutation": "rwm",
           "mutation_steps": SMC_MUTATION_STEPS, "cold_ms": cold * 1e3, "wall_ms": wall * 1e3,
           "stages": int(res.num_stages), "accept": float(res.mean_acceptance),
           "final_step_size": float(res.final_step_size),
           "log_evidence": float(res.log_evidence), "betas": schedule.betas,
           "idle_share": idle,
           "profiled": {k: prof[k] for k in ("busy", "wall")},
           "profiled_stages": SMC_PROFILED_STAGES,
           "coefficient_err": c_err, "precision_mean": lam,
           "gaussian": {"particles": SMC_GAUSS_PARTICLES, "log_evidence": float(g.log_evidence),
                        "closed_form": float(log_z), "stages": int(g.num_stages), **errs},
           "launches": dict(build.LAUNCHES)}
    progress(f"{label}: {wall * 1e3:.1f} ms, {out['stages']} stages, accept {out['accept']:.3f}, "
             f"idle {idle}; Gaussian log evidence {float(g.log_evidence):.4f} vs {log_z:.4f}")
    return out


def polynomial_log_evidence(V, ys, prior_var: float = 5.0, shape: float = 1.0,
                            rate: float = 0.2, points: int = 20001) -> float:
    """The polynomial posterior's log evidence (the port's unnormalised
    Gaussian error model, without its -(n/2) log 2 pi), float64: the
    coefficients integrated in closed form, y | lam ~ N(0, I / lam + 5 V
    V^T), and the Gamma(1, 0.2) precision by the trapezoid rule on (0, 20]."""
    Vd, yd = V.double().cpu(), ys.double().cpu()
    n = yd.shape[0]
    lam = torch.linspace(1e-3, 20.0, points, dtype=torch.float64)
    C = torch.eye(n, dtype=torch.float64) / lam[:, None, None] + prior_var * Vd @ Vd.T
    _, logdet = torch.linalg.slogdet(C)
    quad = (yd * torch.linalg.solve(C, yd.expand(points, n))).sum(-1)
    log_prior = (shape * math.log(rate) - math.lgamma(shape) + (shape - 1) * torch.log(lam)
                 - rate * lam)
    lp = -0.5 * (logdet + quad) + log_prior
    top = float(lp.max())
    return top + math.log(float(torch.trapezoid(torch.exp(lp - top), lam)))


def vi_path(build, vi, poly, xses, ys, V, smc_out, dev):
    """The VI modules on the card, eager loops over the DSL's log density:
    each method once, timed (wall ms, synchronised), on the polynomial
    posterior (VI_STEPS) and the hierarchical one (VI_HIER_STEPS), and the
    card's idle share over VI_PROFILED_STEPS steps of mean-field ADVI on
    the hierarchical posterior.  Gated on the polynomial posterior: every
    method's coefficient means within 0.1 of the exact conditional
    Gaussian at its mean precision (pathfinder's within 0.2, its Pareto k
    finite; SVGD's from the Laplace draws); the Laplace mode's coefficients within 1e-3 of the exact
    conditional mode at the mode's precision, and no draw of any method
    (``example/polynomial.py::get_map`` over all of them) above the mode's
    log density by more than 1e-3; the Laplace log evidence within 1.5
    nats (tests/test_laplace_waic.py:69-88's tolerance) of the evidence by
    quadrature, the smc path's recorded beside it; on the
    hierarchical posterior, finite fits and draws of the expected shapes.
    The VI loops launch none of the port's kernels."""
    from binf_tpu_torch.example import hierarchical
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    label = "vi path"
    transforms = {"precision": LogTransform}
    targets = {"polynomial": poly.make_posterior(xses, ys)}
    x, y, counts, _ = hierarchical.synthetic_hierarchical_data(
        torch.Generator(device=dev).manual_seed(30), NUTS_GROUPS, device=dev)
    targets["hierarchical"] = hierarchical.make_hierarchical_posterior(x, y, counts, NUTS_GROUPS,
                                                                       device=dev)

    def seeds_of(post, n, seed):
        """``n`` overdispersed unconstrained starts (prior draws)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        draws = [post.sample_prior(g) for _ in range(n)]
        u = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
        u["precision"] = torch.log(u["precision"])
        return u

    def timed_wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    build.reset_launch_counts()
    out, draws = {}, {}
    for name, post in targets.items():
        steps = VI_STEPS if name == "polynomial" else VI_HIER_STEPS
        ld = transform_logdensity(post.log_prob, transforms)
        res, ms = {}, {}
        res["laplace"], ms["laplace"] = timed_wall(lambda: vi.laplace_approximation(
            post, 0, num_steps=steps["laplace"], transforms=transforms, device=dev))
        for method in ("meanfield", "fullrank"):
            res[method], ms[method] = timed_wall(lambda: vi.advi(
                post, torch.Generator(device=dev).manual_seed(81), num_steps=steps["advi"],
                num_elbo_samples=VI_ELBO_SAMPLES, method=method, transforms=transforms,
                device=dev))
        res["svgd"], ms["svgd"] = timed_wall(lambda: vi.svgd(
            post, torch.Generator(device=dev).manual_seed(82), num_particles=SVGD_PARTICLES,
            num_steps=steps["svgd"], transforms=transforms, device=dev))
        if name == "polynomial":
            start = vi.laplace_sample(post, res["laplace"], 87, SVGD_PARTICLES, transforms)
            res["svgd_gate"], ms["svgd_from_laplace"] = timed_wall(lambda: vi.svgd(
                post, 0, num_steps=SVGD_GATE_STEPS, transforms=transforms,
                initial_particles=start, device=dev))
        res["pathfinder"], ms["pathfinder"] = timed_wall(lambda: vi.pathfinder(
            ld, seeds_of(post, PF_PATHS, 83), torch.Generator(device=dev).manual_seed(84),
            num_draws=PF_DRAWS, max_iters=PF_ITERS, device=dev))
        g = torch.Generator(device=dev).manual_seed(85)
        d = {"laplace": vi.laplace_sample(post, res["laplace"], g, VI_DRAWS, transforms),
             "meanfield": vi.variational_sample(post, res["meanfield"], g, VI_DRAWS, transforms),
             "fullrank": vi.variational_sample(post, res["fullrank"], g, VI_DRAWS, transforms),
             "svgd": res["svgd_gate" if "svgd_gate" in res else "svgd"].particles,
             "pathfinder": {k: torch.exp(v) if k == "precision" else v
                            for k, v in res["pathfinder"].samples.items()}}
        for method, dm in d.items():
            check(all(bool(torch.isfinite(v).all()) for v in dm.values())
                  and all(v.shape[1:] == post.spec(k).shape for k, v in dm.items()),
                  f"{label}: {name} {method}: finite draws of the variables' shapes")
        lap = res["laplace"]
        check(bool(torch.isfinite(lap.cov).all())
              and bool(torch.isfinite(lap.log_evidence_laplace)),
              f"{label}: {name} laplace: finite covariance and log evidence")
        for method in ("meanfield", "fullrank"):
            check(bool(torch.isfinite(res[method].elbo_trace).all()),
                  f"{label}: {name} advi {method}: finite ELBO trace")
        check(bool(torch.isfinite(res["pathfinder"].elbo).any()),
              f"{label}: {name} pathfinder: a path with a finite ELBO")
        out[name] = {"steps": steps, "wall_ms": ms,
                     "steps_published": VI_STEPS_PUBLISHED,
                     "laplace": {"converged": bool(lap.converged),
                                 "log_evidence": float(lap.log_evidence_laplace),
                                 "log_prob_at_mode": float(lap.log_prob_at_mode)},
                     "advi_final_elbo": {m: float(res[m].final_elbo)
                                         for m in ("meanfield", "fullrank")},
                     "svgd_final_grad_norm": float(res["svgd"].grad_norm_trace[-1]),
                     "pathfinder": {"best_elbo": float(res["pathfinder"].elbo.max()),
                                    "pareto_k": float(res["pathfinder"].pareto_k)}}
        draws[name] = (d, res)
        progress(f"{label}: {name}: " + ", ".join(f"{m} {v:.1f} ms" for m, v in ms.items()))

    # the polynomial posterior's gates
    d, res = draws["polynomial"]
    errs = {}
    for method, dm in d.items():
        lam = float(dm["precision"].double().mean())
        exact, _ = exact_conditional(V, ys, lam, dev)
        errs[method] = float((dm["coefficients"].double().mean(0) - exact).abs().max())
        bound = 0.2 if method == "pathfinder" else 0.1
        check(errs[method] < bound,
              f"{label}: {method}: coefficient means within {errs[method]:.3g} of the exact "
              f"conditional Gaussian at the mean precision (< {bound})")
    check(bool(torch.isfinite(res["pathfinder"].pareto_k)),
          f"{label}: pathfinder Pareto k {float(res['pathfinder'].pareto_k):.3f} finite")
    lap = res["laplace"]
    lam_mode = float(lap.mode["precision"])
    exact_mode, _ = exact_conditional(V, ys, lam_mode, dev)
    mode_err = float((lap.mode["coefficients"].double() - exact_mode).abs().max())
    check(bool(lap.converged) and mode_err < 1e-3,
          f"{label}: laplace converged, its mode's coefficients within {mode_err:.3g} of the "
          "exact conditional mode at its precision (< 1e-3)")
    # get_map over every method's draws, on the density Laplace maximises
    post = targets["polynomial"]
    ld = transform_logdensity(post.log_prob, transforms)
    pooled = {k: torch.cat([dm[k] for dm in d.values()]) for k in ("coefficients", "precision")}
    u_pooled = {"coefficients": pooled["coefficients"], "precision": torch.log(pooled["precision"])}
    best = poly.get_map(pooled, torch.func.vmap(ld)(u_pooled))
    excess = float(best.log_prob) - float(lap.log_prob_at_mode)
    check(excess < 1e-3,
          f"{label}: get_map over {pooled['precision'].shape[0]} draws finds none above the "
          f"Laplace mode's log density by 1e-3 (best {excess:+.3g})")
    # the evidence by quadrature: the smc path's SMC with RWM moves sits 1-2
    # nats under it on these data in both packages (cli_path holds Laplace
    # to SMC with HMC moves, the CLI's, on the CLI's data)
    exact_ev = polynomial_log_evidence(V, ys)
    ev_err = abs(float(lap.log_evidence_laplace) - exact_ev)
    check(ev_err < 1.5, f"{label}: the Laplace log evidence {float(lap.log_evidence_laplace):.4f} "
                        f"within {ev_err:.3g} nats of the quadrature's {exact_ev:.4f} (< 1.5); "
                        f"the smc path's {smc_out['log_evidence']:.4f}")
    hpost = targets["hierarchical"]
    prof = profile_device(lambda: vi.advi(hpost, 86, num_steps=VI_PROFILED_STEPS,
                                          num_elbo_samples=VI_ELBO_SAMPLES,
                                          transforms=transforms, device=dev), {})
    idle = None if prof["busy"] is None else 1.0 - prof["busy"][0] / prof["wall"]
    check(sum(build.LAUNCHES.values()) == 0,
          f"{label}: the VI loops launched none of the port's kernels")
    out.update(coefficient_err=errs, laplace_mode_err=mode_err, get_map_excess=excess,
               laplace_evidence_err=ev_err,
               log_evidence={"laplace": float(lap.log_evidence_laplace),
                             "quadrature": exact_ev, "smc_path_rwm": smc_out["log_evidence"]},
               profiled={"method": "advi meanfield, hierarchical", "steps": VI_PROFILED_STEPS,
                         "busy": prof["busy"], "wall": prof["wall"], "idle_share": idle},
               elbo_samples=VI_ELBO_SAMPLES, svgd_particles=SVGD_PARTICLES,
               pathfinder={"paths": PF_PATHS, "iters": PF_ITERS,
                           "iters_published": PF_ITERS_PUBLISHED, "draws": PF_DRAWS},
               launches=dict(build.LAUNCHES))
    progress(f"{label}: idle {idle} over {VI_PROFILED_STEPS} ADVI steps on the hierarchical "
             "posterior")
    return out


def cli_path(build, cli):
    """The command line on the card: ``python -m binf_tpu_torch`` at its
    defaults (polynomial, auto, 256 chains, 300 + 500 steps) once in a
    subprocess, then ``cli.main`` in process for the routes under it; each
    run gated as its counterpart in tests/test_cli.py, its wall ms and
    ``elapsed_sec`` recorded, and the kernels it launched read from
    ``_build.LAUNCHES`` and ``_build.last_launch`` (the LaunchRecords its
    launches left), both cleared before it."""
    label = "cli path"

    def coeff_gate(name, out, tol, mean_key="summary"):
        c = (out["summary"]["coefficients"]["mean"] if mean_key == "summary"
             else out["posterior_means"]["coefficients"])
        check(abs(c[1] + 4.0) < tol, f"{label}: {name}: coefficient 1 at {c[1]:.4f}, within "
                                     f"{tol} of its truth -4")

    def accept_gate(name, out, lo=0.3):
        check(lo < out["accept_rate"] <= 1.0,
              f"{label}: {name}: acceptance {out['accept_rate']} in ({lo}, 1]")

    runs = {}
    # the defaults, as a user starts it
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "binf_tpu_torch"], cwd=root,
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                          env={**os.environ, "PYTHONPATH": root})
    wall = (time.perf_counter() - t) * 1e3
    check(proc.returncode == 0, f"{label}: python -m binf_tpu_torch exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    check(out["algorithm"] == "auto" and out["routed_to"] == "fused" and "routing_reason" in out,
          f"{label}: defaults: routed to {out['routed_to']} ({out['routing_reason']})")
    coeff_gate("defaults", out, 0.8)
    runs["defaults (subprocess)"] = {"argv": [], "wall_ms": wall,
                                     "elapsed_sec": out["elapsed_sec"],
                                     "accept_rate": out["accept_rate"],
                                     "routed_to": out["routed_to"]}

    def run(name, argv, gates, kernels=()):
        build.reset_launch_counts()
        build.last_launch.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        records = {k: launch_keys(r) for k, r in build.last_launch.items()}
        gates(name, out)
        for k in kernels:
            check(launched.get(k, 0) > 0 and k in records,
                  f"{label}: {name}: launched {k} {launched.get(k, 0)} times, its LaunchRecord "
                  "read")
        runs[name] = {"argv": argv, "wall_ms": wall, "elapsed_sec": out["elapsed_sec"],
                      "launches": launched, "launch_records": records,
                      **{k: out[k] for k in ("accept_rate", "routed_to", "sampler",
                                             "reroute_reason", "pareto_k", "num_stages",
                                             "converged", "log_evidence_laplace")
                         if k in out}}
        progress(f"{label}: {name}: {wall:.1f} ms (elapsed_sec {out['elapsed_sec']}), "
                 f"launched {launched}")
        return out

    def hier_gates(name, out):
        check(out["routed_to"] == "fused"
              and out["routing_reason"].startswith("device density: HierarchicalDensity"),
              f"{label}: {name}: routed to the fused kernels ({out['routing_reason']})")
        accept_gate(name, out)
        check(out["summary"]["mu"]["rhat"][0] < 1.3,
              f"{label}: {name}: mu R-hat {out['summary']['mu']['rhat'][0]:.4f} < 1.3")

    hier = ["--model", "hierarchical", "--algorithm", "auto", "--warmup-mode", "fused"]
    run("hierarchical auto fused 8192", [*hier, "--chains", "8192", "--warmup", "400",
                                         "--samples", "500"], hier_gates,
        ("fused_warmup", "fused_potential_hmc"))
    run("hierarchical auto fused 256", hier, hier_gates, ("fused_warmup", "fused_potential_hmc"))

    def fused_gates(name, out):
        coeff_gate(name, out, 0.6)
        check(out["summary"]["precision"]["mean"] > 0, f"{label}: {name}: precision > 0")
        accept_gate(name, out)

    # its eager warmup 100 -> 50 steps (on the CPU coefficient 1 at
    # -3.79, the gate 0.6 from -4)
    run("polynomial fused", ["--model", "polynomial", "--algorithm", "fused", "--chains", "64",
                             "--warmup", "50", "--samples", "100"], fused_gates,
        ("fused_potential_hmc",))
    run("polynomial hmc --init pathfinder",
        ["--model", "polynomial", "--algorithm", "hmc", "--init", "pathfinder", "--chains", "64",
         "--warmup", "50", "--samples", "40"], lambda n, o: coeff_gate(n, o, 0.8))

    def smc_gates(name, out):
        check(out["num_stages"] > 2, f"{label}: {name}: {out['num_stages']} stages > 2")
        coeff_gate(name, out, 0.6, "means")

    # 512 -> 256 particles (on the CPU 10 stages, coefficient 1 at -3.80 and the
    # log evidence 0.20 nats from Laplace's, the gates 0.6 and 1.5)
    smc = run("polynomial smc", ["--model", "polynomial", "--algorithm", "smc", "--chains", "256"],
              smc_gates)
    run("polynomial advi", ["--model", "polynomial", "--algorithm", "advi", "--samples", "100"],
        lambda n, o: coeff_gate(n, o, 0.6, "means"))

    def laplace_gates(name, out):
        check(out["converged"], f"{label}: {name}: converged")
        coeff_gate(name, out, 0.6, "means")
        # tests/test_laplace_waic.py:69-88's tolerance, against the SMC run above
        # (HMC moves) on the same data
        err = abs(out["log_evidence_laplace"] - smc["log_evidence"])
        check(err < 1.5, f"{label}: {name}: log evidence {out['log_evidence_laplace']:.4f} "
                         f"within {err:.3g} nats of the smc run's {smc['log_evidence']:.4f} (< 1.5)")

    run("polynomial laplace", ["--model", "polynomial", "--algorithm", "laplace", "--samples",
                               "100"], laplace_gates)

    def svgd_gates(name, out):
        # tests/test_cli.py has no svgd case; from the prior SVGD settles
        # slowly (vi_path holds it to the posterior from the Laplace draws)
        means = out["posterior_means"]
        check(all(np.isfinite(v).all() for v in map(np.asarray, means.values()))
              and means["precision"] > 0, f"{label}: {name}: finite means, precision > 0")

    run("polynomial svgd", ["--model", "polynomial", "--algorithm", "svgd", "--samples", "50"],
        svgd_gates)

    def pathfinder_gates(name, out):
        check(out["pareto_k"] < 0.7, f"{label}: {name}: Pareto k {out['pareto_k']} < 0.7")
        coeff_gate(name, out, 1.0, "means")

    run("polynomial pathfinder", ["--model", "polynomial", "--algorithm", "pathfinder",
                                  "--chains", "8"], pathfinder_gates)

    def gibbs_gates(name, out):
        stats = out["summary"]["precision"]
        check(abs(stats["mean"] - 2.5) < 1.5 and stats["rhat"] < 1.1,
              f"{label}: {name}: precision mean {stats['mean']:.4f} within 1.5 of 2.5, R-hat "
              f"{stats['rhat']:.4f} < 1.1")

    run("polynomial gibbs", ["--model", "polynomial", "--algorithm", "gibbs", "--chains", "64",
                             "--samples", "200"], gibbs_gates)
    # 100 + 100 steps cut to 50 + 50 (on the CPU acceptance 0.899)
    run("chromatin chain-grid 64 beads", ["--model", "chromatin", "--algorithm", "chain-grid",
                                          "--chains", "256", "--warmup", "50", "--samples",
                                          "50"],
        lambda n, o: accept_gate(n, o, 0.5), ("chain_grid_hmc",))

    def nuts_gates(name, out):
        check(out.get("sampler") == "hmc"
              and out["reroute_reason"].startswith("nuts rerouted to fixed-L HMC"),
              f"{label}: {name}: rerouted to {out.get('sampler')} ({out.get('reroute_reason')})")
        w = out["summary"]["weights"]
        check(abs(w["mean"][1] + 2.0) < 0.7 and w["rhat"][0] < 1.2,
              f"{label}: {name}: weight 1 at {w['mean'][1]:.4f} within 0.7 of -2, R-hat "
              f"{w['rhat'][0]:.4f} < 1.2")

    run("logistic nuts (rerouted)", ["--model", "logistic", "--algorithm", "nuts", "--chains",
                                     "16", "--warmup", "100", "--samples", "100"], nuts_gates)
    total = {k: sum(r.get("launches", {}).get(k, 0) for r in runs.values())
             for k in build.LAUNCHES}
    return {"runs": runs, "launches": total}


def hierarchical_problem(dev, chains: int, seed: int = 31, groups: int = NUTS_GROUPS):
    """The CLI's hierarchical model (binf_tpu/cli.py:43-62): 8 groups (or
    ``groups``), data drawn on the card, the precision under LogTransform;
    its start (group params 0.1 z with z from ``seed``, mu 0, log_tau -1,
    precision 5) and the eager density mapped over the chains."""
    from binf_tpu_torch.example import hierarchical
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    x, y, counts, _ = hierarchical.synthetic_hierarchical_data(
        torch.Generator(device=dev).manual_seed(30), groups, device=dev)
    post = hierarchical.make_hierarchical_posterior(x, y, counts, groups, device=dev)
    logdensity = transform_logdensity(post.log_prob, {"precision": LogTransform})
    z = torch.randn((chains, groups, 2), generator=torch.Generator().manual_seed(seed))
    start = {"group_params": 0.1 * z.to(dev), "mu": torch.zeros((chains, 2), device=dev),
             "log_tau": torch.full((chains, 2), -1.0, device=dev),
             "precision": torch.full((chains,), float(np.log(5.0)), device=dev)}
    return logdensity, torch.func.vmap(logdensity), start


def run_eager(kernel, states, generator, steps, collect):
    """``steps`` steps of an eager kernel: the last states, the collected
    values stacked over steps, and the wall seconds (synchronised)."""
    kept = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        states, info = kernel.step(generator, states)
        kept.append(collect(states, info))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return states, {k: torch.stack([c[k] for c in kept]) for k in kept[0]}, wall


def idle_share(fn, steps: int):
    """The card's busy ms a step and idle share of ``steps`` eager steps
    under the profiler (whose wall it lengthens on a host-bound path)."""
    prof = profile_device(fn, {})
    if prof["busy"] is None:
        return None, None, prof["wall"]
    return prof["busy"][0] / steps, 1.0 - prof["busy"][0] / prof["wall"], prof["wall"]


def nuts_path(build, auto, adaptation, hmc_mod, nuts_mod, logistic_logdensity, chrom, dev):
    """The card's measurement behind route_trajectory_sampler's rule, at
    benchmarks/bench_nuts_depth.py's shape (depths cut, NUTS_STEPS): the
    hierarchical posterior (D = 21) stepped on the eager samplers through
    torch.func, as a density with no CUDA functor is stepped (at 8 groups
    the router now sends it to K3/K4: hierarchical_path), the basis of the
    rule for such densities, 2,048 chains, an eager window warmup of fixed-L10 HMC,
    then fixed-L10 HMC, NUTS at max_doublings 4 and at 8 from the warmed
    states with the adapted step and metric.  Per sampler: ms a step,
    ESS/s (min bulk ESS of mu, log_tau and the log precision), leapfrogs a
    step (per chain and in lockstep), the doubling depth's mean, q50 and
    q90, acceptance, and the card's idle share over NUTS_PROFILED steps.
    Gates: the hyperparameters' means agree between NUTS and HMC within
    tests/test_hierarchical.py's bounds, NUTS accepts in (0.6, 0.99).
    Then the same comparison, NUTS at 8 doublings, on the chromatin
    posterior at two sizes (chromatin_nuts), where a gradient reads O(N^2)
    data a chain: the measurement behind the rule's gradient-scarce
    branch."""
    from binf_tpu_torch.diagnostics import ess

    logdensity, batched, start = hierarchical_problem(dev, NUTS_CHAINS)
    dec = auto.route_algorithm(logdensity, start)
    check(dec.path == "fused" and dec.reason.startswith("device density"),
          f"nuts path: the hierarchical posterior routes to {dec.path} ({dec.reason}); the "
          "samplers below step it eagerly through torch.func all the same")
    rule_8 = auto.route_trajectory_sampler("nuts", logdensity, start)
    check(rule_8[0] == "hmc" and "device density" in rule_8[1],
          f"nuts path: NUTS on the hierarchical posterior of 8 groups is rerouted ({rule_8[1]})")
    # the rule for densities with no functor, which this measurement is the
    # basis of: the hierarchical posterior past the groups its functor takes
    ld4, _, start4 = hierarchical_problem(dev, 8, groups=NO_FUNCTOR_GROUPS)
    rule_h = auto.route_trajectory_sampler("nuts", ld4, start4)
    rule_l = auto.route_trajectory_sampler("nuts", logistic_logdensity,
                                           {"weights": torch.zeros((4, 5), device=dev)})
    check(auto.route_trajectory_sampler("hmc", logdensity, start)[0] == "hmc",
          "nuts path: a request other than NUTS passes the rule unchanged")
    check(rule_l[0] == "hmc", f"nuts path: NUTS on the logistic posterior is rerouted "
                              f"({rule_l[1]})")
    generator = torch.Generator(device=dev).manual_seed(32)
    build.reset_launch_counts()

    def builder(step_size, inverse_mass):
        return hmc_mod.hmc(batched, step_size, N_LEAPFROG, inverse_mass)

    torch.cuda.synchronize()
    t = time.perf_counter()
    warm = adaptation.window_adaptation(builder, builder(0.05, None).init(start), generator,
                                        num_steps=NUTS_WARMUP, initial_step_size=0.05)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    eps, im = float(warm.step_size), warm.inverse_mass
    q0 = warm.final_states.position
    kernels = {"hmc_L10": hmc_mod.hmc(batched, eps, N_LEAPFROG, im),
               "nuts_D4": nuts_mod.nuts(batched, eps, 4, im),
               "nuts_D8": nuts_mod.nuts(batched, eps, 8, im)}

    def collect(st, info):
        out = {"mu": st.position["mu"], "log_tau": st.position["log_tau"],
               "precision": st.position["precision"], "accept": info.acceptance_prob}
        if hasattr(info, "num_doublings"):
            out.update(depth=info.num_doublings, leaves=info.num_integration_steps)
        return out

    rows, draws = {}, {}
    for name, kernel in kernels.items():
        steps = NUTS_STEPS[name]
        _, kept, wall = run_eager(kernel, kernel.init(q0), generator, steps, collect)
        x = torch.cat([kept["mu"], kept["log_tau"], kept["precision"][..., None]], -1)
        m_ess = float(ess(x).min())
        busy, idle, prof_wall = idle_share(
            lambda: run_eager(kernel, kernel.init(q0), generator, NUTS_PROFILED, collect),
            NUTS_PROFILED)
        row = {"steps": steps, "ms_per_step": wall * 1e3 / steps, "wall_ms": wall * 1e3,
               "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall,
               "accept": float(kept["accept"].float().mean()),
               "busy_ms_per_step": busy, "idle_share": idle, "profiled_steps": NUTS_PROFILED,
               "profiled_wall_ms": prof_wall}
        if "depth" in kept:
            depth = kept["depth"].float()
            row.update(depth_mean=float(depth.mean()),
                       depth_q50=float(torch.quantile(depth.flatten(), 0.5)),
                       depth_q90=float(torch.quantile(depth.flatten(), 0.9)),
                       depth_max=int(depth.max()),
                       leapfrogs_per_chain=float(kept["leaves"].float().mean()),
                       leapfrogs_lockstep=float(np.mean([2 ** int(d.max()) - 1
                                                         for d in kept["depth"]])))
        else:
            row.update(leapfrogs_per_chain=N_LEAPFROG, leapfrogs_lockstep=N_LEAPFROG)
        rows[name], draws[name] = row, kept
        progress(f"nuts path {name}: {row['ms_per_step']:.1f} ms a step, ESS/s "
                 f"{row['ess_per_s']:.4g}, accept {row['accept']:.3f}, leapfrogs "
                 f"{row['leapfrogs_per_chain']:.1f} a chain / {row['leapfrogs_lockstep']:.1f} "
                 f"lockstep, idle {idle}")
    check(sum(build.LAUNCHES.values()) == 0, "nuts path: the eager samplers launched no kernel")
    h = draws["hmc_L10"]
    for name in ("nuts_D4", "nuts_D8"):
        acc = rows[name]["accept"]
        check(0.6 < acc < 0.99, f"nuts path {name}: acceptance {acc:.3f} in (0.6, 0.99)")
        d = draws[name]
        mu_err = float((d["mu"].mean((0, 1)) - h["mu"].mean((0, 1))).abs().max())
        prec = float(torch.exp(d["precision"]).mean())
        check(mu_err < 0.35 and 10.0 < prec < 45.0,
              f"nuts path {name}: mu means within {mu_err:.3g} of fixed-L HMC's (< 0.35), "
              f"precision mean {prec:.2f} in (10, 45)")
    prec_h = float(torch.exp(h["precision"]).mean())
    check(10.0 < prec_h < 45.0, f"nuts path hmc_L10: precision mean {prec_h:.2f} in (10, 45)")
    # the rule rests on a recorded measurement; say whether this run agrees
    agrees = (rows["hmc_L10"]["ess_per_s"] > rows["nuts_D8"]["ess_per_s"]) == (
        rule_h[0] == "hmc")
    progress(f"nuts path: this run's measurement {'agrees' if agrees else 'disagrees'} with "
             f"the rule's decision for a density with no functor (the hierarchical posterior "
             f"at {NO_FUNCTOR_GROUPS} groups: {rule_h[0]})")
    chromatin = {n: chromatin_nuts(build, adaptation, hmc_mod, nuts_mod, chrom, n, dev)
                 for n in CHROM_NUTS}
    for n, row in chromatin.items():
        agrees_c = row["nuts_ahead"] == (row["rule"][0] == "nuts")
        progress(f"nuts path: the chromatin posterior at {n} beads: this run's measurement "
                 f"{'agrees' if agrees_c else 'disagrees'} with the rule ({row['rule'][0]})")
    check(sum(build.LAUNCHES.values()) == 0,
          "nuts path: the eager samplers launched no kernel on the chromatin posterior")
    out = {"chains": NUTS_CHAINS, "groups": NUTS_GROUPS, "D": 21, "warmup": NUTS_WARMUP,
           "rule_agrees_with_this_run": agrees,
           "chromatin": chromatin,
           "chromatin_cut": {"warmup": [NUTS_WARMUP_PUBLISHED, CHROM_NUTS_WARMUP],
                             "steps": {k: [NUTS_STEPS_PUBLISHED, v]
                                       for k, v in CHROM_NUTS_STEPS.items()}},
           "warmup_ms": warm_s * 1e3, "step_size": eps, "samplers": rows,
           "cut": {"warmup": [NUTS_WARMUP_PUBLISHED, NUTS_WARMUP],
                   "steps": {k: [NUTS_STEPS_PUBLISHED, v] for k, v in NUTS_STEPS.items()}},
           "rule": {"hierarchical": list(rule_8),
                    f"hierarchical_{NO_FUNCTOR_GROUPS}_groups": list(rule_h),
                    "logistic": list(rule_l)},
           "route": dec.reason, "launches": dict(build.LAUNCHES)}
    progress(f"nuts path: warmup {warm_s:.1f} s; rule: hierarchical {rule_8}; at "
             f"{NO_FUNCTOR_GROUPS} groups "
             f"{rule_h}; logistic {rule_l}")
    return out


def chromatin_nuts(build, adaptation, hmc_mod, nuts_mod, chrom, n_beads: int, dev):
    """Eager NUTS (8 doublings) against eager fixed-L10 HMC on the Gram-form
    chromatin posterior of ``n_beads`` beads (``chromatin_start``'s problem
    and starts, CHROM_NUTS's chains), both after one eager window warmup of
    fixed-L10 HMC and from its states, step and metric.  Per sampler: ms a
    step, min bulk ESS of the log precision and beads 0, N/3, 2N/3 and N - 1
    over the run, ESS/s, gradients a chain and step and in lockstep, ESS
    per gradient both ways, acceptance, and the doubling depths."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.samplers import auto

    chains = CHROM_NUTS[n_beads]["chains"]
    _, logD, W, init = chromatin_start(chrom, n_beads, chains, dev)
    gram = chrom.make_gram_logdensity(logD, W, device=dev)
    beads = sorted({0, n_beads // 3, 2 * n_beads // 3, n_beads - 1})
    generator = torch.Generator(device=dev).manual_seed(33)

    def builder(step_size, inverse_mass):
        return hmc_mod.hmc(gram, step_size, N_LEAPFROG, inverse_mass)

    torch.cuda.synchronize()
    t = time.perf_counter()
    warm = adaptation.window_adaptation(builder, builder(CHROM_NUTS_STEP0, None).init(init),
                                        generator, num_steps=CHROM_NUTS_WARMUP,
                                        initial_step_size=CHROM_NUTS_STEP0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    eps, im = float(warm.step_size), warm.inverse_mass
    q0 = warm.final_states.position
    kernels = {"hmc_L10": hmc_mod.hmc(gram, eps, N_LEAPFROG, im),
               "nuts_D8": nuts_mod.nuts(gram, eps, 8, im)}

    def collect(st, info):
        out = {"x": torch.cat([st.position["precision"][:, None],
                               st.position["structure"][:, beads].reshape(chains, -1)], 1),
               "accept": info.acceptance_prob}
        if hasattr(info, "num_doublings"):
            out.update(depth=info.num_doublings, leaves=info.num_integration_steps)
        return out

    rows = {}
    for name, kernel in kernels.items():
        steps = CHROM_NUTS_STEPS[name]
        _, kept, wall = run_eager(kernel, kernel.init(q0), generator, steps, collect)
        check(bool(torch.isfinite(kept["x"]).all()),
              f"nuts path chromatin {n_beads} beads {name}: finite draws")
        m_ess = float(ess(kept["x"]).min())
        if "depth" in kept:
            per_chain = float(kept["leaves"].float().mean())
            lockstep = float(np.mean([2 ** int(d.max()) - 1 for d in kept["depth"]]))
            depth = kept["depth"].float()
            extra = dict(depth_mean=float(depth.mean()), depth_max=int(depth.max()),
                         depth_q90=float(torch.quantile(depth.flatten(), 0.9)))
        else:
            per_chain = lockstep = float(N_LEAPFROG)
            extra = {}
        grads = steps * chains * per_chain
        rows[name] = {"steps": steps, "ms_per_step": wall * 1e3 / steps, "wall_ms": wall * 1e3,
                      "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall,
                      "accept": float(kept["accept"].float().mean()),
                      "grads_per_chain_step": per_chain, "grads_lockstep_step": lockstep,
                      "ess_per_grad": m_ess / grads,
                      "ess_per_lockstep_grad": m_ess / (steps * chains * lockstep), **extra}
        progress(f"nuts path chromatin {n_beads} beads {name}: {rows[name]['ms_per_step']:.1f} "
                 f"ms a step, ESS {m_ess:.1f}, ESS/s {m_ess / wall:.4g}, ESS per gradient "
                 f"{m_ess / grads:.3g} ({rows[name]['ess_per_lockstep_grad']:.3g} in lockstep),"
                 f" accept {rows[name]['accept']:.3f}, gradients {per_chain:.1f} a chain / "
                 f"{lockstep:.1f} lockstep")
    for name, row in rows.items():
        check(0.3 < row["accept"] < 1.0,
              f"nuts path chromatin {n_beads} beads {name}: acceptance {row['accept']:.3f} in "
              f"(0.3, 1)")
    return {"beads": n_beads, "restraints": float(W.sum()), "chains": chains,
            "warmup": CHROM_NUTS_WARMUP, "warmup_ms": warm_s * 1e3, "step_size": eps,
            "samplers": rows,
            "nuts_ahead": rows["nuts_D8"]["ess_per_s"] > rows["hmc_L10"]["ess_per_s"],
            "rule": list(auto.route_trajectory_sampler("nuts", gram, init))}


def bimodal(pos):
    """tests/test_tempering.py's target: modes at -4 and +4, scale 0.5."""
    x = pos["x"]
    return torch.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2, -0.5 * ((x - 4.0) / 0.5) ** 2)


def samplers_path(build, fp, modules, problems, fam_results, fam_out, poly_posterior, dev):
    """The other eager samplers on the card.  On the logistic posterior at
    SAMP_CHAINS chains from K4's final positions: MALA, elliptical slice
    (the Gaussian prior times the Bernoulli likelihood), the
    random-direction slice sampler and NUTS (K4's step and metric; its
    ESS/s against the fused route's is the ratio route_trajectory_sampler
    cites); each one's weight means within 0.15 of the families path's K4
    means.  Parallel tempering on the bimodal target (K = 6, beta_min
    0.02, PT_CHAINS chains from the left mode): the cold chain spends
    0.25-0.75 of its time in the right mode.  A Gibbs sweep with
    mala_block and with nuts_block (and the conjugate precision block) on
    the polynomial posterior, from the collapsed sampler's draws, whose
    moments they must keep (tests/test_gibbs.py's bounds).  Per sampler: ms
    a step and acceptance (or shrink and step-out counts), the slice
    sampler's and NUTS's idle share."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.ops.kernels.fused_potential import pack_template

    mala_mod, nuts_mod, slice_mod, tempering, gibbs_mod, conjugate = modules
    from binf_tpu_torch.example import polynomial as poly
    from binf_tpu_torch.samplers.fused import eager_density

    logdensity = problems["logistic"][0]
    post = logdensity.__self__
    batched = eager_density(logdensity, pack_template({"weights": torch.zeros(5)}))
    lik = post.likelihoods["labels"]
    loglik = torch.func.vmap(lambda p: lik.log_prob(p))
    res = fam_results["logistic"]
    start = {"weights": res.final_positions["weights"][:SAMP_CHAINS].contiguous()}
    k4_means = torch.tensor(fam_out["families"]["logistic"]["moments"]["weights"]["mean"],
                            device=dev)
    eps = float(res.step_size.mean())
    im = {"weights": res.inverse_mass.mean(0)}
    generator = torch.Generator(device=dev).manual_seed(50)
    build.reset_launch_counts()
    rows = {}
    kernels = {
        "mala": (mala_mod.mala(batched, 0.15),
                 lambda st, info: {"w": st.position["weights"], "acc": info.acceptance_prob}),
        "elliptical_slice": (slice_mod.elliptical_slice(loglik, {"weights": torch.zeros(5, device=dev)},
                                                        {"weights": 2.0}),
                             lambda st, info: {"w": st.position["weights"],
                                               "shrinks": info.num_shrinks}),
        "slice": (slice_mod.slice_sampler(batched, width=1.0),
                  lambda st, info: {"w": st.position["weights"], "shrinks": info.num_shrinks,
                                    "stepout": info.num_stepout}),
        "nuts": (nuts_mod.nuts(batched, eps, 8, im),
                 lambda st, info: {"w": st.position["weights"], "acc": info.acceptance_prob,
                                   "depth": info.num_doublings}),
    }
    for name, (kernel, collect) in kernels.items():
        steps = SAMP_STEPS[name]
        _, kept, wall = run_eager(kernel, kernel.init(start), generator, steps, collect)
        w = kept["w"]
        err = float((w.mean((0, 1)) - k4_means).abs().max())
        check(bool(torch.isfinite(w).all()) and err < 0.15,
              f"samplers path {name}: weight means within {err:.3g} of K4's (< 0.15)")
        row = {"chains": SAMP_CHAINS, "steps": steps, "ms_per_step": wall * 1e3 / steps,
               "mean_err_vs_k4": err, "min_bulk_ess": float(ess(w).min())}
        row["ess_per_s"] = row["min_bulk_ess"] / wall
        for k in ("acc", "shrinks", "stepout", "depth"):
            if k in kept:
                row[{"acc": "accept"}.get(k, k + "_mean")] = float(kept[k].float().mean())
        if name in ("slice", "nuts"):
            busy, idle, _ = idle_share(
                lambda: run_eager(kernel, kernel.init(start), generator, NUTS_PROFILED, collect),
                NUTS_PROFILED)
            row.update(busy_ms_per_step=busy, idle_share=idle)
        rows[name] = row
        progress(f"samplers path {name}: {row['ms_per_step']:.2f} ms a step, {row}")
    fused_ess_s = fam_out["families"]["logistic"]["ess_per_s"]
    rows["nuts"]["fused_ess_per_s_ratio"] = fused_ess_s / rows["nuts"]["ess_per_s"]

    betas = tempering.geometric_betas(PT_K, beta_min=PT_BETA_MIN)
    pt = tempering.parallel_tempering(bimodal, betas, step_size=0.8)
    pt_start = {"x": torch.full((PT_CHAINS, PT_K), -4.0, device=dev)}
    _, kept, wall = run_eager(pt, pt.init(pt_start), generator, PT_STEPS,
                              lambda st, info: {"x": st.positions["x"][:, 0],
                                                "swap": info.swap_accepted})
    xs = kept["x"][PT_BURN:]
    right = float((xs > 0).float().mean())
    check(0.25 < right < 0.75 and abs(float(xs.abs().mean()) - 4.0) < 0.3,
          f"samplers path PT: the cold chain spends {right:.3f} of its time in the right "
          f"mode (0.25-0.75), |x| mean {float(xs.abs().mean()):.3f} within 0.3 of 4")
    rows["parallel_tempering"] = {"chains": PT_CHAINS, "K": PT_K, "beta_min": PT_BETA_MIN,
                                  "steps": PT_STEPS, "ms_per_step": wall * 1e3 / PT_STEPS,
                                  "right_mode_share": right,
                                  "swap_rate": 2.0 * float(kept["swap"].float().mean())}

    # the blocks start from the collapsed sampler's draws (its 100th sweep):
    # the coefficients' conditional is ill-conditioned (the cubic column),
    # so MALA's step is small and would take thousands of sweeps to get
    # there; a block that did not keep the posterior drifts from it
    collapsed = poly.make_collapsed_gibbs_kernel(poly_posterior)
    ones = {"coefficients": torch.ones((GIBBS_CHAINS, 4), device=dev),
            "precision": torch.ones(GIBBS_CHAINS, device=dev)}
    start_g, ref = run_eager(collapsed, collapsed.init(ones), generator, 100,
                             lambda st, info: {"c": st.position["coefficients"],
                                               "p": st.position["precision"]})[:2]
    ref_c, ref_p = ref["c"][50:].mean((0, 1)), float(ref["p"][50:].mean())
    for name, block in (("gibbs_mala_block", gibbs_mod.mala_block(poly_posterior,
                                                                   "coefficients", 0.03)),
                        ("gibbs_nuts_block", gibbs_mod.nuts_block(poly_posterior, "coefficients",
                                                                   0.05, max_doublings=6))):
        kernel = gibbs_mod.gibbs({"coefficients": block, "precision":
                                  conjugate.gamma_precision_block(poly_posterior, "precision")})
        _, kept, wall = run_eager(kernel, kernel.init(start_g.position), generator,
                                  GIBBS_SWEEPS,
                                  lambda st, info: {"c": st.position["coefficients"],
                                                    "p": st.position["precision"],
                                                    "acc": info["coefficients"].acceptance_prob})
        c = kept["c"][GIBBS_SWEEPS // 4:]
        c_err = float((c.mean((0, 1)) - ref_c).abs().max())
        p_err = abs(float(kept["p"][GIBBS_SWEEPS // 4:].mean()) / ref_p - 1.0)
        # tests/test_gibbs.py::test_rwm_gibbs_agrees_with_collapsed's bounds
        check(bool(torch.isfinite(c).all()) and c_err < 0.12 and p_err < 0.12,
              f"samplers path {name}: coefficient means within {c_err:.3g} (< 0.12) and the "
              f"precision's within {100 * p_err:.2f}% (< 12%) of the collapsed sampler's")
        rows[name] = {"chains": GIBBS_CHAINS, "sweeps": GIBBS_SWEEPS,
                      "ms_per_sweep": wall * 1e3 / GIBBS_SWEEPS,
                      "accept": float(kept["acc"].float().mean()),
                      "coefficient_means": c.mean((0, 1)).tolist(),
                      "coefficient_err_vs_collapsed": c_err, "precision_rel_err": p_err}
        progress(f"samplers path {name}: {rows[name]}")
    check(sum(build.LAUNCHES.values()) == 0, "samplers path: the eager samplers launched no kernel")
    return {"samplers": rows, "launches": dict(build.LAUNCHES)}


# -- the fourteenth slice: chains, particles and data sharded over a mesh ------------

MESH_RANKS = 2
# the pooled eager warmups of the two-rank phase, cut from N_WARMUP and
# CG_WARMUP for time (each runs twice a rank: the entry point, and again
# for the single-process reference's start)
# (cut for the wide phase: 100 -> 50 and 50 -> 25, for the wider one to 25
# and 12; the phase's gates are bitwise equalities, which hold at any
# depth)
MESH_XLA_WARMUP = 25
MESH_CG_WARMUP = 12
MESH_DATA_CHAINS = 4096
MESH_TIMEOUT_S = 420


def mps_state() -> dict:
    """The card's compute mode and whether an MPS control daemon runs: two
    processes on one card time-slice it unless MPS shares it, so a
    cooperative K3 launch has the whole card either way."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    daemon = False
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/comm") as f:
                daemon |= f.read().startswith("nvidia-cuda-mps")
        except OSError:
            pass
    return {"compute_mode": mode, "mps_daemon": daemon}


class CollectiveClock:
    """Counts and host-times a rank's c10d calls by the section running
    them; the card is synchronised before and after each call, so a call's
    time is the collective's alone (the pending kernels are not in it)."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_gather", "broadcast", "barrier")

    def __init__(self):
        self.label, self.stats = None, {}

    def __enter__(self):
        import torch.distributed as dist

        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(dist, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if self.label is None:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            row = self.stats.setdefault(self.label, {}).setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += (time.perf_counter() - t) * 1e3
            return out
        return call

    def section(self, label):
        clock = self

        class Section:
            def __enter__(self):
                clock.label = label

            def __exit__(self, *exc):
                clock.label = None
        return Section()

    def totals(self, label) -> dict:
        rows = self.stats.get(label, {})
        return {"calls": {n: c for n, (c, _) in rows.items()},
                "ms": sum(ms for _, ms in rows.values()),
                "count": sum(c for c, _ in rows.values())}


def gather_probe(dev) -> dict:
    """Which gathers a gloo group of CUDA tensors takes: the tensor form and
    the list form of c10d's all-gather; True, or the refusal.  A
    ``DTensor``'s ``full_tensor()`` is not tried: on such a group it
    crashed both ranks (SIGSEGV in the functional collectives' wait,
    torch 2.11.0+cu128 on the card), so the port gathers with c10d
    (``parallel/mesh.py::gather_chains``)."""
    import torch.distributed as dist

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
    want = torch.cat([torch.arange(4, dtype=torch.float32) + 10 * k for k in range(w)])

    def tensor_form():
        out = torch.empty(4 * w, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out

    def list_form():
        parts = [torch.empty(4, device=dev) for _ in range(w)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    res = {}
    for name, fn in (("all_gather_into_tensor", tensor_form), ("all_gather_list", list_form)):
        try:
            res[name] = bool(torch.equal(fn().cpu(), want))
        except Exception as e:  # a refusal is recorded, not fatal: both ranks refuse alike
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return res


def packed(samples: dict) -> torch.Tensor:
    """Polynomial draws ``{"coefficients", "precision"}`` packed (..., 5)."""
    return torch.cat([samples["coefficients"], samples["precision"][..., None]], -1)


def mesh_rank(argv) -> int:
    """One rank of the two-rank phase of ``mesh_path`` (``chip_smoke.py
    --mesh-rank R WORLD DIR``): every route of the slice with the chains
    sharded over a gloo group on ``cuda:0``, each rank's shard held bit for
    bit to the single-process kernel run on its rows with the seeds plus
    its index (that run made twice first, to show it repeats), and
    ``tempered_smc``'s log evidence and betas to the smc path's unsharded
    run with the same seed (``DIR/smc_ref.json``), bit for bit.  Writes
    ``DIR/rank<R>.json``."""
    import torch.distributed as dist
    from binf_tpu_torch.example import chromatin as chrom
    from binf_tpu_torch.example import polynomial as poly
    from binf_tpu_torch.io.checkpoint import load_checkpoint
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import chain_grid as cg
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels import pairwise as pw
    from binf_tpu_torch.ops.math import vandermonde
    from binf_tpu_torch.parallel.data_parallel import DataShardedLikelihood
    from binf_tpu_torch.parallel.mesh import (
        gather_chains,
        initialize_distributed,
        local_rows,
        make_chain_mesh,
        make_data_mesh,
        to_local,
    )
    from binf_tpu_torch.parallel.production import _welford_merge, run_fused_blocks
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers import chain_grid as cgs
    from binf_tpu_torch.samplers import fused as sf
    from binf_tpu_torch.smc import tempered_smc

    import faulthandler

    faulthandler.enable()  # a crash in a collective leaves its traceback in the rank's log
    rank, world, tmp = int(argv[0]), int(argv[1]), argv[2]
    dev = torch.device("cuda")
    # NCCL refuses two ranks on one card: this phase names gloo, which
    # moves the CUDA tensors itself; the kernels run on cuda:0 in both ranks
    initialize_distributed(init_method="file://" + os.path.join(tmp, "store"),
                           world_size=world, rank=rank, backend="gloo", timeout=MESH_TIMEOUT_S)
    mesh = make_chain_mesh()
    out = {"rank": rank, "gathers": gather_probe(dev), "routes": {}}
    launches = {k: 0 for k in _build.LAUNCHES}
    clock = CollectiveClock()
    m = N_CHAINS // world

    def entry(name, fn, cold=False):
        """Drive an entry point: launch counts from 0 read just after, its
        wall time and its collectives; with ``cold``, after one untimed
        run (the rank's first kernel loads and collectives), whose wall is
        kept apart."""
        progress(f"mesh rank {rank}: {name}")
        cold_ms = None
        if cold:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t) * 1e3
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        with clock, clock.section(name):
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        for k, v in _build.LAUNCHES.items():
            launches[k] += v
        out["routes"][name] = {"wall_ms": wall, "launches": dict(_build.LAUNCHES),
                               "collectives": clock.totals(name)}
        if cold:
            out["routes"][name]["cold_ms"] = cold_ms
        return res

    def twice(label, fn):
        a, b = fn(), fn()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"mesh rank {rank}: {label}: the single-process run repeats, bit for bit")
        return a

    xses, ys = poly.make_data(torch.Generator().manual_seed(1), device=dev)
    V = vandermonde(torch.linspace(-2.0, 2.0, 20, device=dev), 4)
    posterior = poly.make_posterior(xses, ys)
    logdensity = transform_logdensity(posterior.log_prob, {"precision": LogTransform})
    g = torch.Generator().manual_seed(2)
    q_init = torch.cat([1.0 + 0.1 * torch.randn((N_CHAINS, 4), generator=g),
                        torch.zeros((N_CHAINS, 1))], dim=1).to(dev)
    init = {"coefficients": q_init[:, :4], "precision": q_init[:, 4]}
    rows = local_rows(init, mesh)
    density, spec, q0 = sf._prepare(logdensity, rows, dev)
    spb = sf._steps_per_block(N_SAMPLES, 1)

    def seeds(key):
        gen = sf._generator(key)
        return sf._draw_seed(gen), sf._draw_seed(gen)

    def k4(a, seed, steps=N_SAMPLES, **kw):
        return fp.fused_potential_hmc_run(
            density, a.positions, seed, a.step_size, a.inverse_mass, num_steps=steps,
            num_leapfrog=N_LEAPFROG, block_chains=m, steps_per_block=min(spb, steps),
            device=dev, **kw)

    def adapt(warmup, seed_w, num_warmup, mesh_=None, max_leapfrog=CHEES_MAX_LEAP):
        # the settings of fused_model_hmc's (and run_fused_blocks') warmup
        return sf._adapt(warmup, logdensity, density, spec, q0, seed_w, num_warmup=num_warmup,
                         num_leapfrog=N_LEAPFROG, initial_step_size=0.1,
                         per_chain_step_size=False, block_chains=m, host_noise=False,
                         trajectory="fixed", max_leapfrog=max_leapfrog, dev=dev, mesh=mesh_)

    try:
        # -- fused_model_hmc, the fused warmup: K3 and K4 on each shard --------------
        res = to_local(entry("fused", lambda: model_run(sf.fused_model_hmc, logdensity, init,
                                                        101, False, dev, mesh=mesh), cold=True))
        sw, sr = seeds(101)

        def single_fused():
            a = adapt("fused", sw + rank, N_WARMUP)
            return k4(a, sr + rank, max_leapfrog=CHEES_MAX_LEAP).draws, a.step_size, a.inverse_mass

        ref = twice("fused warmup", single_fused)
        check(torch.equal(packed(res.samples), ref[0]) and torch.equal(res.step_size, ref[1])
              and torch.equal(res.inverse_mass, ref[2]),
              f"mesh rank {rank}: fused warmup: the shard's draws, step sizes and metric are "
              f"K3 and K4 on its {m} chains with the seeds plus {rank}, bit for bit")
        out["routes"]["fused"]["accept"] = float(res.accept_rate)
        del res, ref

        # -- fused_model_hmc, the xla warmup: pooled over the mesh, then K4 ------------
        res = to_local(entry("xla", lambda: sf.fused_model_hmc(
            logdensity, init, 102, num_warmup=MESH_XLA_WARMUP, num_samples=N_SAMPLES,
            num_leapfrog=N_LEAPFROG, initial_step_size=0.1, block_chains=N_CHAINS,
            warmup="xla", mesh=mesh, device=dev)))
        sw, sr = seeds(102)
        warm = adapt("xla", sw, MESH_XLA_WARMUP, mesh, max_leapfrog=256)
        check(torch.equal(warm.step_size, res.step_size),
              f"mesh rank {rank}: xla warmup: the pooled warmup repeats ({float(warm.step_size)})")
        ref = twice("xla warmup", lambda: (k4(warm, sr + rank).draws,))
        check(torch.equal(packed(res.samples), ref[0]),
              f"mesh rank {rank}: xla warmup: the shard's draws are K4 from the pooled warmup "
              f"with the run seed plus {rank}, bit for bit")
        out["routes"]["xla"].update(accept=float(res.accept_rate),
                                    step_size=float(res.step_size),
                                    warmup_steps=MESH_XLA_WARMUP)
        del res, ref

        # -- chain_grid_model_hmc: the pooled warmup, then K7 on each shard ------------
        _, logD, W, cinit = chromatin_start(chrom, CG_BEADS, CG_CHAINS, dev)
        gram = chrom.make_gram_logdensity(logD, W, device=dev)
        res = to_local(entry("chain_grid", lambda: cgs.chain_grid_model_hmc(
            gram, cinit, 103, num_warmup=MESH_CG_WARMUP, num_samples=CG_SAMPLES,
            num_leapfrog=CG_LEAP, initial_step_size=CG_STEP0, block_chains=CG_BLOCK, mesh=mesh,
            device=dev)))
        crow = local_rows(cinit, mesh)
        potential, consts, cspec = cg.chain_grid_potential_from_scalar(
            gram, {k: v[0] for k, v in crow.items()})
        gen = sf._generator(103)
        cw = cgs._warmup(gram, potential, cspec, crow, gen, dev, mesh,
                         num_warmup=MESH_CG_WARMUP, num_leapfrog=CG_LEAP,
                         initial_step_size=CG_STEP0, target_accept=0.8)
        seed7 = sf._draw_seed(gen) + rank
        cspb = min(50, CG_SAMPLES)
        while CG_SAMPLES % cspb:
            cspb -= 1
        ref = twice("chain grid", lambda: tuple(cg.chain_grid_hmc_run(
            potential, cw.final_states.position, seed7, cw.step_size, cw.inverse_mass, consts,
            num_steps=CG_SAMPLES, num_leapfrog=CG_LEAP, block_chains=CG_BLOCK,
            steps_per_block=cspb, device=dev).draws.values()))
        check(all(torch.equal(res.samples[k], v) for k, v in zip(res.samples, ref)),
              f"mesh rank {rank}: chain grid: the shard's draws are K7 on its "
              f"{CG_CHAINS // world} chains from the pooled warmup with the run seed plus "
              f"{rank}, bit for bit")
        out["routes"]["chain_grid"].update(accept=float(res.accept_rate),
                                           warmup_steps=MESH_CG_WARMUP)
        del res, ref

        # -- run_fused_blocks: K3, four K4 blocks, a checkpoint at block 2, resume -----
        kw = dict(num_steps=PROD_BLOCKS * PROD_BLOCK_STEPS, block_size=PROD_BLOCK_STEPS,
                  num_warmup=N_WARMUP, num_leapfrog=N_LEAPFROG, initial_step_size=0.1,
                  block_chains=N_CHAINS, warmup="fused", mesh=mesh, device=dev)
        full = entry("blocks", lambda: run_fused_blocks(logdensity, init, 11, **kw))
        half = os.path.join(tmp, "half.pt")
        run_fused_blocks(logdensity, init, 11, checkpoint_path=half, checkpoint_every_blocks=2,
                         **dict(kw, num_steps=2 * PROD_BLOCK_STEPS))
        saved = load_checkpoint(half, gather_chains(full.carry))
        check(int(saved.block) == 2 and saved.positions.shape == (N_CHAINS, 5),
              f"mesh rank {rank}: blocks: block 2's checkpoint is one file of all "
              f"{N_CHAINS} chains, loaded in one process")
        resumed = run_fused_blocks(logdensity, init, 11, checkpoint_path=half, resume=True, **kw)
        fc, rc = to_local(full.carry), to_local(resumed.carry)
        check(all(torch.equal(getattr(fc, f), getattr(rc, f))
                  for f in ("positions", "mean", "m2", "count")),
              f"mesh rank {rank}: blocks: the run resumed from block 2 ends where the "
              "uninterrupted one ends, bit for bit")
        sw, sr = seeds(11)

        def single_blocks():
            a = adapt("fused", sw + rank, N_WARMUP, max_leapfrog=N_LEAPFROG)
            q, n = a.positions, torch.zeros((), device=dev)
            mean, m2 = torch.zeros_like(q), torch.zeros_like(q)
            for b in range(PROD_BLOCKS):
                r = k4(a._replace(positions=q), sr + rank, PROD_BLOCK_STEPS, collect="moments",
                       block_offset=b * PROD_BLOCK_STEPS // min(spb, PROD_BLOCK_STEPS))
                mean, m2, n = _welford_merge(mean, m2, n, r.mean,
                                             r.variance * float(PROD_BLOCK_STEPS - 1),
                                             float(PROD_BLOCK_STEPS))
                q = r.final_positions
            return q, mean, m2

        ref = twice("blocks", single_blocks)
        check(torch.equal(fc.positions, ref[0]) and torch.equal(fc.mean, ref[1])
              and torch.equal(fc.m2, ref[2]),
              f"mesh rank {rank}: blocks: the shard's positions and moments are K3 and "
              f"{PROD_BLOCKS} K4 blocks on its chains with the seeds plus {rank}, bit for bit")
        out["routes"]["blocks"].update(accept=full.accept_rate)
        del full, resumed, saved, ref

        # -- tempered_smc: one gather of the log-likelihoods a stage -----------------
        with BetaSchedule() as schedule:
            res = entry("smc", lambda: tempered_smc(
                posterior, torch.Generator(device=dev).manual_seed(61),
                num_particles=SMC_PARTICLES, mutation="rwm",
                num_mutation_steps=SMC_MUTATION_STEPS, mesh=mesh))
        check(float(res.final_beta) == 1.0 and int(res.num_stages) < 50,
              f"mesh rank {rank}: smc: beta 1 reached in {int(res.num_stages)} stages (< 50)")
        # every stage is the unsharded run's arithmetic (the scales and the
        # acceptance over the gathered particles, every particle's noise on
        # every rank): the smc path's run with the same seed, bit for bit
        with open(os.path.join(tmp, "smc_ref.json")) as f:
            smc_ref = json.load(f)
        check(float(res.log_evidence) == smc_ref["log_evidence"]
              and schedule.betas == smc_ref["betas"],
              f"mesh rank {rank}: smc: log evidence {float(res.log_evidence):.6f} and the "
              f"{len(schedule.betas)} stages' betas equal the unsharded run's "
              f"({smc_ref['log_evidence']:.6f}, {len(smc_ref['betas'])} stages), bit for bit")
        parts = gather_chains(res.particles)
        lam = float(parts["precision"].double().mean())
        exact, _ = exact_conditional(V, ys, lam, dev)
        c_err = float((parts["coefficients"].double().mean(0) - exact).abs().max())
        check(c_err < 0.1, f"mesh rank {rank}: smc: coefficient means within {c_err:.3g} of "
                           "the exact conditional Gaussian at the mean precision (< 0.1)")
        out["routes"]["smc"].update(stages=int(res.num_stages),
                                    log_evidence=float(res.log_evidence),
                                    accept=float(res.mean_acceptance), coefficient_err=c_err)

        # -- the data axis: the polynomial likelihood, the 2,048-bead restraints -------
        dmesh = make_data_mesh()
        lik = poly.make_likelihood(xses, ys)
        sharded = DataShardedLikelihood.create(lik, dmesh, fwm_data_fields=("vandermonde",))
        chains = {"coefficients": q_init[:MESH_DATA_CHAINS, :4],
                  "precision": torch.exp(q_init[:MESH_DATA_CHAINS, 4])}

        def lp_and_grad(f):
            return (torch.func.vmap(f.log_prob)(chains),
                    torch.func.vmap(torch.func.grad(f.log_prob))(chains))

        lp_s, g_s = entry("data", lambda: lp_and_grad(sharded))
        lp, gr = lp_and_grad(lik)

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        errs = {"log_prob": rel(lp_s, lp),
                **{f"grad_{k}": rel(g_s[k], gr[k]) for k in gr}}
        check(max(errs.values()) < 1e-5,
              f"mesh rank {rank}: data: the sharded likelihood's log prob and gradient on "
              f"{MESH_DATA_CHAINS} chains within {max(errs.values()):.3g} of the whole one's, "
              "relative to their largest (< 1e-5)")
        out["routes"]["data"]["errors"] = errs

        X, logD, W = chrom.synthetic_restraints(torch.Generator(device=dev).manual_seed(0),
                                                N_BEADS, observe_frac=OBSERVE_FRAC, device=dev)
        loss_fn = chrom.make_sharded_restraint_loss(dmesh)
        loss, grad = entry("restraints", lambda: (loss_fn(X, logD, W),
                                                  torch.func.grad(loss_fn)(X, logD, W)))
        ref_loss = pw.pairwise_restraint_loss(X, logD, W, block=BEAD_BLOCK)
        ref_grad = torch.func.grad(
            lambda x: pw.pairwise_restraint_loss(x, logD, W, block=BEAD_BLOCK))(X)
        l_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        f_err = rel(grad, ref_grad)
        # the row block floors d2 with max(d2, eps) where K6a adds eps, and
        # sums in another order: the loss within 1e-4 relative, the forces
        # within 1e-4 of their largest
        check(l_err < 1e-4 and f_err < 1e-4,
              f"mesh rank {rank}: restraints: the row-sharded loss and its all-gathered "
              f"forces at {N_BEADS} beads within {l_err:.3g} and {f_err:.3g} of K6a's and "
              "K6b's (< 1e-4)")
        out["routes"]["restraints"].update(loss_err=l_err, forces_err=f_err)
    except CheckFailed as e:
        print(f"chip_smoke: mesh rank {rank}: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        out["launches"] = launches
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
    return 0


def spawn_mesh_ranks(tmp: str) -> list[dict]:
    """Run ``mesh_rank`` in MESH_RANKS processes on the one card; every
    child is killed at MESH_TIMEOUT_S.  A failed rank fails the phase with
    the end of its log."""
    procs, logs = [], []
    for r in range(MESH_RANKS):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
             str(MESH_RANKS), tmp], stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}))
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("# [") and "ok: " in line:
                progress(f"rank {r}: {line.split('ok: ', 1)[1]}")
        check(p.returncode == 0, f"mesh path: rank {r} exited {p.returncode}"
              + ("" if p.returncode == 0 else f": {text[-3000:]}"))
    results = []
    for r in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def mesh_path(build, cli, fused_model_hmc, logdensity, init, production, cgs, chrom,
              smc_out, dev):
    """``parallel/{mesh,collectives,data_parallel}.py`` on the one card.

    (1) A world of one on NCCL, in this process: ``fused_model_hmc(warmup=
    "fused", mesh=...)`` at the main shape against the run without a mesh,
    bit for bit, and ``cli.main([... "--mesh"])`` on the hierarchical auto
    route with the fused warmup at 8,192 chains.  (2) Two ranks spawned on
    the card over gloo (``mesh_rank``): the fused and ``xla`` warmups at
    the main shape (8,192 chains a rank), ``chain_grid_model_hmc`` (64
    beads, 2,048 chains), ``run_fused_blocks`` with its resume from block 2,
    ``tempered_smc`` (4,096 particles), ``DataShardedLikelihood`` on the
    polynomial posterior and ``make_sharded_restraint_loss`` at 2,048 beads;
    the SMC run's evidence and betas equal ``smc_out``'s, bit for bit.
    Each route's wall ms a rank stands beside the unsharded run's; both
    ranks share one card, so these are not scaling numbers.  The time in
    collectives is each rank's c10d calls, by route."""
    import contextlib
    import tempfile

    import torch.distributed as dist
    from binf_tpu_torch.parallel.mesh import gather_chains, initialize_distributed, make_chain_mesh

    label = "mesh path"
    out = {"mps": mps_state()}
    build.reset_launch_counts()
    initialize_distributed()
    try:
        out["world_of_one_backend"] = str(dist.get_backend())
        mesh = make_chain_mesh()
        walls = []
        for _ in range(2):  # the first run starts NCCL's communicator
            t = time.perf_counter()
            res = gather_chains(model_run(fused_model_hmc, logdensity, init, 101, False, dev,
                                          mesh=mesh))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        cold, wall = walls
        one = dict(build.LAUNCHES)
        t = time.perf_counter()
        ref = model_run(fused_model_hmc, logdensity, init, 101, False, dev)
        torch.cuda.synchronize()
        ref_wall = (time.perf_counter() - t) * 1e3
        check(torch.equal(packed(res.samples), packed(ref.samples))
              and torch.equal(res.step_size, ref.step_size)
              and torch.equal(res.inverse_mass, ref.inverse_mass)
              and float(res.accept_rate) == float(ref.accept_rate),
              f"{label}: a world of one on {out['world_of_one_backend']}: fused_model_hmc "
              f"with the mesh equals the run without it at {N_CHAINS} chains, bit for bit")
        del res, ref
        build.reset_launch_counts()
        argv = ["--model", "hierarchical", "--algorithm", "auto", "--warmup-mode", "fused",
                "--chains", "8192", "--warmup", "400", "--samples", "500", "--mesh"]
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            cli_out = cli.main(argv)
        torch.cuda.synchronize()
        cli_wall = (time.perf_counter() - t) * 1e3
        cli_launches = dict(build.LAUNCHES)
        check(cli_out["routed_to"] == "fused" and cli_out["chains"] == 8192
              and cli_out["summary"]["mu"]["rhat"][0] < 1.3
              and cli_launches["fused_warmup"] > 0 and cli_launches["fused_potential_hmc"] > 0,
              f"{label}: python -m binf_tpu_torch --mesh, hierarchical auto fused at 8,192 "
              f"chains: routed to {cli_out['routed_to']}, mu R-hat "
              f"{cli_out['summary']['mu']['rhat'][0]:.4f}, launched {cli_launches}")
    finally:
        dist.destroy_process_group()
    out["world_of_one"] = {"fused_wall_ms": wall, "fused_cold_ms": cold,
                           "unsharded_wall_ms": ref_wall,
                           "cli_argv": argv, "cli_wall_ms": cli_wall,
                           "cli_accept_rate": cli_out["accept_rate"]}

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "smc_ref.json"), "w") as f:
            json.dump({k: smc_out[k] for k in ("log_evidence", "betas")}, f)
        t = time.perf_counter()
        ranks = spawn_mesh_ranks(tmp)
        out["ranks_wall_s"] = time.perf_counter() - t
    launches = {k: one.get(k, 0) + cli_launches.get(k, 0)
                + sum(r["launches"].get(k, 0) for r in ranks) for k in build.LAUNCHES}
    for name in ("fused_warmup", "fused_potential_hmc", "chain_grid_hmc"):
        check(launches[name] > 0, f"{label} launched {name} {launches[name]} times")

    # the unsharded runs at the two-rank phase's sizes, where no earlier path has them
    X_true, logD, W, cinit = chromatin_start(chrom, CG_BEADS, CG_CHAINS, dev)
    gram = chrom.make_gram_logdensity(logD, W, device=dev)
    unsharded = {}
    for name, fn in (
            ("xla", lambda: fused_model_hmc(
                logdensity, init, 102, num_warmup=MESH_XLA_WARMUP, num_samples=N_SAMPLES,
                num_leapfrog=N_LEAPFROG, initial_step_size=0.1, block_chains=N_CHAINS,
                warmup="xla", device=dev)),
            ("chain_grid", lambda: cgs.chain_grid_model_hmc(
                gram, cinit, 103, num_warmup=MESH_CG_WARMUP, num_samples=CG_SAMPLES,
                num_leapfrog=CG_LEAP, initial_step_size=CG_STEP0, block_chains=CG_BLOCK,
                device=dev)),
            ("blocks", lambda: production.run_fused_blocks(
                logdensity, init, 11, num_steps=PROD_BLOCKS * PROD_BLOCK_STEPS,
                block_size=PROD_BLOCK_STEPS, num_warmup=N_WARMUP, num_leapfrog=N_LEAPFROG,
                initial_step_size=0.1, block_chains=N_CHAINS, warmup="fused", device=dev))):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        unsharded[name] = (time.perf_counter() - t) * 1e3
    unsharded["fused"] = ref_wall
    unsharded["smc"] = smc_out["wall_ms"]
    routes = {}
    for name in ranks[0]["routes"]:
        per = [r["routes"][name] for r in ranks]
        routes[name] = {"wall_ms_per_rank": [p["wall_ms"] for p in per],
                        "cold_ms_per_rank": [p.get("cold_ms") for p in per],
                        "unsharded_wall_ms": unsharded.get(name),
                        "collective_calls_per_rank": [p["collectives"]["count"] for p in per],
                        "collective_ms_per_rank": [p["collectives"]["ms"] for p in per],
                        "collective_calls_by_kind": per[0]["collectives"]["calls"],
                        **{k: v for k, v in per[0].items()
                           if k not in ("wall_ms", "collectives", "launches")}}
    # the pooled warmup's all-reduces a step, SMC's gathers a stage
    xla = routes["xla"]
    xla["collective_calls_per_warmup_step"] = xla["collective_calls_per_rank"][0] / MESH_XLA_WARMUP
    xla["collective_ms_per_warmup_step"] = (float(np.mean(xla["collective_ms_per_rank"]))
                                            / MESH_XLA_WARMUP)
    cgr = routes["chain_grid"]
    cgr["collective_ms_per_warmup_step"] = (float(np.mean(cgr["collective_ms_per_rank"]))
                                            / MESH_CG_WARMUP)
    smc = routes["smc"]
    smc["collective_calls_per_stage"] = smc["collective_calls_per_rank"][0] / smc["stages"]
    smc["collective_ms_per_stage"] = (float(np.mean(smc["collective_ms_per_rank"]))
                                      / smc["stages"])
    smc["unsharded_log_evidence"] = smc_out["log_evidence"]
    out.update(ranks=MESH_RANKS, backend="gloo", shared_card=True, chains=N_CHAINS,
               gathers=ranks[0]["gathers"], routes=routes, launches=launches,
               note="two ranks time-slice one card: wall times are not scaling numbers")
    progress(f"{label}: world of one {wall:.1f} ms (cold {cold:.1f}) vs {ref_wall:.1f} ms "
             f"unsharded; two ranks "
             f"in {out['ranks_wall_s']:.1f} s; gathers {out['gathers']}; mps {out['mps']}")
    for name, r in routes.items():
        progress(f"{label}: {name}: {[round(w, 1) for w in r['wall_ms_per_rank']]} ms a rank "
                 f"(unsharded {r['unsharded_wall_ms']}), collectives "
                 f"{r['collective_calls_per_rank']} calls, "
                 f"{[round(w, 1) for w in r['collective_ms_per_rank']]} ms")
    return out


# -- this slice: the router's shared-memory rule, K3/K4 at other family
# dimensions, the port's example scripts --------------------------------------------

# router_smem: the polynomial posterior at 256 chains, 60 + 40 steps, past
# the kernels' shared memory (5,000 points: K3 needs 25,008 floats of the
# 12,288 they take) and just under it (2,394 points: K4's operands, Halton
# table and dense metric take 12,284, at 2,395 points 12,289)
SMEM_CHAINS, SMEM_WARMUP, SMEM_SAMPLES = 256, 60, 40
SMEM_POINTS = {"over": 5000, "under": 2394}
# the eager run's acceptance: its window warmup's 60 steps leave the
# averaged step short of the 0.8 target (0.9455 on the card at 100 steps)
SMEM_ACCEPT = (0.6, 0.99)


def router_smem_path(build, fp, dens_mod, auto, fused_model_hmc, init, dev):
    """The router's shared-memory rule on the card: the polynomial posterior
    past the kernels' shared memory routes to the eager path
    (``kernel_refusal``'s reason), launches no K3 or K4 and meets the main
    path's moment gates; ``fused_model_hmc`` on it raises with the same
    reason before any launch; just under the limit it routes to K3 and K4,
    which run it."""
    from binf_tpu_torch.example import polynomial as poly
    from binf_tpu_torch.ops.math import vandermonde
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    start = {k: v[:SMEM_CHAINS] for k, v in init.items()}
    template = {k: v[0] for k, v in start.items()}
    out = {}
    for case, n in SMEM_POINTS.items():
        label = f"router_smem {case} ({n} points)"
        xses, ys = poly.make_data(torch.Generator().manual_seed(1), n_points=n, device=dev)
        V = vandermonde(xses, 4)
        ld = transform_logdensity(poly.make_posterior(xses, ys).log_prob,
                                  {"precision": LogTransform})
        density = dens_mod.device_density(ld, template)
        refusal = fp.kernel_refusal(density)
        dec = auto.route_algorithm(ld, start)
        need = {k: fp._shared_need(density, k) for k in ("K3", "K4")}
        kwargs = {}
        if case == "over":
            check(dec.path == "xla" and refusal is not None
                  and dec.reason.startswith(refusal),
                  f"{label}: routes to {dec.path} ({dec.reason})")
            build.reset_launch_counts()
            try:
                fused_model_hmc(ld, start, 0, num_warmup=10, num_samples=10, warmup="fused",
                                device=dev)
                raised = None
            except ValueError as e:
                raised = str(e)
            check(raised == refusal and sum(build.LAUNCHES.values()) == 0,
                  f"{label}: fused_model_hmc raises with the router's reason before any "
                  f"launch ({raised!r})")
        else:
            check(dec.path == "fused" and refusal is None,
                  f"{label}: routes to {dec.path} ({dec.reason})")
            kwargs = {"warmup": "fused"}
        build.reset_launch_counts()
        t = time.perf_counter()
        res, _ = auto.adaptive_hmc(ld, start, torch.Generator(device=dev).manual_seed(61),
                                   num_warmup=SMEM_WARMUP, num_samples=SMEM_SAMPLES,
                                   initial_step_size=0.1, device=dev, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(build.LAUNCHES)
        ran = launches["fused_warmup"] + launches["fused_potential_hmc"]
        if case == "over":
            check(ran == 0, f"{label}: the eager route launched no K3 or K4 ({launches})")
        else:
            check(launches["fused_warmup"] > 0 and launches["fused_potential_hmc"] > 0,
                  f"{label}: the fused route launched K3 and K4 ({launches})")
        draws = torch.cat([res.samples["coefficients"], res.samples["precision"][..., None]], -1)
        m_ess = posterior_gates(label, draws, float(res.accept_rate), SMEM_ACCEPT, V, ys, dev,
                                shape=(SMEM_SAMPLES, SMEM_CHAINS, 5))
        out[case] = {"points": n, "shared_floats": need, "kernels_take": fp._SMEM_FLOATS,
                     "path": dec.path, "reason": dec.reason, "wall_ms": wall * 1e3,
                     "accept": float(res.accept_rate), "min_bulk_ess": m_ess,
                     "ess_per_s": m_ess / wall, "launches": launches}
        progress(f"{label}: {dec.path}, {wall * 1e3:.1f} ms for {SMEM_WARMUP} + "
                 f"{SMEM_SAMPLES} steps at {SMEM_CHAINS} chains, accept "
                 f"{float(res.accept_rate):.4f}, min bulk ESS {m_ess:.1f}")
    merged = {k: sum(o["launches"][k] for o in out.values()) for k in build.LAUNCHES}
    return {"chains": SMEM_CHAINS, "warmup": SMEM_WARMUP, "samples": SMEM_SAMPLES,
            "accept_gate": list(SMEM_ACCEPT), **out, "launches": merged}


# family_dims: K3 and K4 at family dimensions the reference's constructors
# take and csrc's units do not instantiate, each built with the package
# (phase_build, _build.build_all's shapes) at the families path's shape
# (FAM_CHAINS, 400 + 500 steps): six shapes the reference's constructors
# take, and the top of the logistic, diagonal Gaussian and
# linear-regression ranges
# (densities.KERNEL_DIMS); the hierarchical posterior of 16 groups at 4 and 8
# lanes
FAMILY_DIMS_SHAPES = (("mixture K=4", "mixture", 4), ("mixture K=5", "mixture", 5),
                      ("hierarchical NG=4", "hierarchical", 4),
                      ("hierarchical NG=16", "hierarchical", 16),
                      ("logistic d=12", "logistic", 12), ("logistic d=32", "logistic", 32),
                      ("linreg 12 coefficients", "linreg", 12),
                      ("linreg 16 coefficients", "linreg", 16),
                      ("diag Gaussian D=32", "diag", 32))
FAMILY_DIMS_EXTRA_LANES = {"hierarchical NG=16": 8}
# the shapes whose plain K4 parts from itself under a 1e-6 change of the
# start past flip_check's reach (on the CPU over 30 steps by 0.98, 1.3 and
# 1.3 at most, a share of chains calm over 10 steps of 95%, 91% and 77%):
# K4 held on calm chains over FAMILY_DIMS_CALM_STEPS (phase_family_check)
FAMILY_DIMS_CHAOTIC = ("mixture K=4", "mixture K=5", "hierarchical NG=4")
FAMILY_DIMS_CALM_STEPS = 10


def family_dims_problems(dev):
    """label -> (logdensity, start(C, seed), flops an evaluation, gated
    name) for FAMILY_DIMS_SHAPES: the mixture posterior of K components on
    the families path's 240 points; the hierarchical posterior of NG groups
    (hierarchical_problem's data); the logistic posterior of a standardised
    design of d columns (the first the intercept) and 200 Bernoulli labels
    of weights 0.5 z; linear regression of 12 coefficients on such a design
    of 200 rows, N(0, 5 I) and Gamma(1.0, 0.2) priors, the precision under
    LogTransform; the diagonal Gaussian of D coordinates, means N(0, 1) and
    scales exp(N(0, 1/4)), as the density itself (its forward is U)."""
    from binf_tpu_torch.example import hierarchical, logistic, mixture
    from binf_tpu_torch.model import GaussianErrorModel, LinearForwardModel
    from binf_tpu_torch.ops.kernels import densities as dens_mod
    from binf_tpu_torch.example.polynomial import make_priors
    from binf_tpu_torch.pdf import Likelihood, Posterior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def design(seed, n, d):
        X = torch.randn((n, d - 1), generator=gen(seed))
        return torch.cat([torch.ones((n, 1)), X], 1).to(dev)

    out = {}
    y_mx = mixture.synthetic_mixture_data(torch.Generator(device=dev).manual_seed(22), device=dev)
    for label, family, k in FAMILY_DIMS_SHAPES:
        if family == "diag":
            mean = torch.randn(k, generator=gen(76))
            scale = torch.exp(0.5 * torch.randn(k, generator=gen(77)))
            out[label] = (dens_mod.DiagGaussianDensity(mean, scale).to(dev),
                          lambda C, s, k=k: {"x": torch.randn((C, k), generator=gen(s)).to(dev)},
                          diag_eval_flops(k), "x")
        elif family == "mixture":
            out[label] = (mixture.make_mixture_posterior(y_mx, k, device=dev).log_prob,
                          lambda C, s, k=k: mixture.initial_positions(
                              C, k, generator=gen(s), device=dev),
                          mixture_eval_flops(mixture.N_DATA_POINTS, k), "means")
        elif family == "hierarchical":
            ld = hierarchical_problem(dev, 1, groups=k)[0]
            out[label] = (ld, lambda C, s, k=k: hierarchical_problem(dev, C, s, groups=k)[2],
                          hierarchical_eval_flops(15, k), "mu")
        elif family == "logistic":
            X = design(70, 200, k)
            w = 0.5 * torch.randn(k, generator=gen(71)).to(dev)
            u = torch.rand(200, generator=gen(72)).to(dev)
            y = (u < torch.sigmoid(X @ w)).float()
            out[label] = (logistic.make_logistic_posterior(X, y, device=dev).log_prob,
                          lambda C, s, k=k: logistic.initial_positions(C, gen(s), d=k,
                                                                       device=dev),
                          logistic_eval_flops(200, k), "weights")
        else:
            X = design(73, 200, k)
            c = torch.randn(k, generator=gen(74)).to(dev)
            y = X @ c + torch.randn(200, generator=gen(75)).to(dev) / 2.5 ** 0.5
            lik = Likelihood.create("points", LinearForwardModel(design=X,
                                                                 variable="coefficients"),
                                    GaussianErrorModel.create(y))
            post = Posterior.create({"points": lik}, make_priors(k, device=dev))

            def start(C, s, k=k):
                g = gen(s)
                return {"coefficients": 0.1 * torch.randn((C, k), generator=g).to(dev),
                        "precision": torch.zeros(C, device=dev)}

            out[label] = (transform_logdensity(post.log_prob, {"precision": LogTransform}),
                          start, eval_flops(200, k), "coefficients")
    return out


def family_dims_shapes(problems, fp, dens_mod, dev):
    """The shapes ``(family code, D, G)`` FAMILY_DIMS_SHAPES runs: each at
    the width ``lanes_for`` picks, and FAMILY_DIMS_EXTRA_LANES."""
    shapes = []
    for label, (ld, start_fn, _, _) in problems.items():
        density = dens_mod.device_density(ld, {k: v[0] for k, v in start_fn(1, 0).items()})
        family = dens_mod.FAMILIES[density.functor]
        for G in (fp.lanes_for(density), FAMILY_DIMS_EXTRA_LANES.get(label)):
            if G is not None:
                shapes.append((family, density.D, G))
    return shapes


def family_dims_path(build, fp, dens_mod, auto, fused_model_hmc, problems, dev):
    """``fused_model_hmc(warmup="fused")`` at each FAMILY_DIMS_SHAPES shape,
    at FAM_CHAINS chains: the router's decision, the functor, K3 and K4
    against their plain versions (phase_family_check), launch counts from
    0, one cold and one timed run (CUDA events around K3 and K4), the
    acceptance gate and finite draws; K3 and K4 at each width
    (family_width_sweep: ms, registers, spills, CTAs an SM) and each
    shape's nvcc seconds; for the hierarchical posterior of 16 groups both
    widths, and whether the one ``lanes_for`` picks was the faster."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    out = {}
    for label, (logdensity, start_fn, ev, gated) in problems.items():
        start = start_fn(FAM_CHAINS, 40)
        template = {k: v[0] for k, v in start.items()}
        density = dens_mod.device_density(logdensity, template).to(dev)
        D, G = density.D, fp.lanes_for(density)
        widths = (G, *filter(None, [FAMILY_DIMS_EXTRA_LANES.get(label)]))
        tag = fp._build.shape_names(dens_mod.FAMILIES[density.functor], D, G)[0].split(".", 1)[1]
        check(fp._libraries(density, G)[0].startswith("fused_warmup_shape."),
              f"family_dims {label}: D = {D}, G = {G} runs a shape's own unit")
        dec = auto.route_algorithm(logdensity, start)
        check(dec.path == "fused" and type(density).__name__ in dec.reason,
              f"family_dims {label}: the router sends it to {dec.path} ({dec.reason})")
        calm = FAMILY_DIMS_CALM_STEPS if label in FAMILY_DIMS_CHAOTIC else None
        checks = phase_family_check(f"family_dims {label}", fp, dens_mod, density, logdensity,
                                    start, dev, widths=widths, calm_steps=calm)
        build.reset_launch_counts()
        t = time.perf_counter()
        family_run(fused_model_hmc, logdensity, start, 41, dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res = family_run(fused_model_hmc, logdensity, start, 42, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(build.LAUNCHES)
        lanes = {"k3": build.last_launch["fused_warmup"].lanes,
                 "k4": build.last_launch["fused_potential_hmc"].lanes}
        for k in ("philox", "fused_warmup", "fused_potential_hmc"):
            check(launches[k] > 0, f"family_dims {label} launched {k} {launches[k]} times")
        accept = float(res.accept_rate)
        check(0.6 < accept < 0.95, f"family_dims {label}: acceptance {accept:.4f} in (0.6, 0.95)")
        draws = gated_draws("mixture" if gated == "means" else label, res.samples)
        flat = pack_positions({k: v.reshape((-1,) + v.shape[2:]) for k, v in draws.items()})
        check(bool(torch.isfinite(flat).all())
              and tuple(flat.shape) == (FAM_SAMPLES * FAM_CHAINS, D),
              f"family_dims {label}: finite draws of shape ({FAM_SAMPLES}, {FAM_CHAINS}, {D})")
        m_ess = float(ess(flat.reshape(FAM_SAMPLES, FAM_CHAINS, D)).min())
        k3_ms, k4_ms = spans.ms("warmup"), spans.ms("sampling")
        k4_bound = bound_ms(FAM_CHAINS * (2 * D + 1) * 4 + FAM_SAMPLES * FAM_CHAINS * D * 4
                            + FAM_CHAINS * (D + 1) * 4,
                            FAM_SAMPLES * FAM_CHAINS * trajectory_flops(ev, D, N_LEAPFROG),
                            philox_calls(FAM_SAMPLES, FAM_CHAINS, D))
        k3_bound = bound_ms(FAM_CHAINS * (3 * D + 1) * 4,
                            FAM_WARMUP * FAM_CHAINS * trajectory_flops(ev, D, N_LEAPFROG),
                            philox_calls(FAM_WARMUP, FAM_CHAINS, D))
        sweep = family_width_sweep(fp, density, pack_positions(start).contiguous(), dev,
                                   widths=widths)
        builds = {w: fp._build.SHAPE_BUILDS.get(
            fp._build.shape_names(dens_mod.FAMILIES[density.functor], D, w)[0].split(".", 1)[1])
            for w in widths}
        out[label] = {
            "functor": density.functor, "D": D, "lanes": lanes, "shape": tag,
            "chains": FAM_CHAINS, "warmup": FAM_WARMUP, "samples": FAM_SAMPLES,
            "leapfrog": N_LEAPFROG, "eval_flops": ev, "nvcc_s": builds,
            "cold_ms": cold * 1e3, "e2e_ms": wall * 1e3, "k3_ms": k3_ms, "k4_ms": k4_ms,
            "k3_bound_ms": k3_bound[0], "k3_bound_by": k3_bound[1], "k4_bound_ms": k4_bound[0],
            "k4_bound_by": k4_bound[1], "accept": accept, "min_bulk_ess": m_ess,
            "ess_per_s": m_ess / wall, "route": dec.reason, "checks": checks,
            "width_sweep": sweep, "launches": launches}
        if len(widths) > 1:
            times = {w: sweep[w]["k3_ms"] + sweep[w]["k4_ms"] for w in widths}
            out[label]["faster_lanes"] = min(times, key=times.get)
        progress(f"family_dims {label}: D = {D}, G = {G}, nvcc {builds} s; e2e "
                 f"{wall * 1e3:.2f} ms, K3 {k3_ms:.3f} ms (bound {k3_bound[0]:.3f}), K4 "
                 f"{k4_ms:.3f} ms (bound {k4_bound[0]:.3f}), accept {accept:.4f}, min bulk "
                 f"ESS {m_ess:.1f}; widths "
                 f"{ {w: (round(r['k3_ms'], 3), round(r['k4_ms'], 3)) for w, r in sweep.items()} }")
    merged = {k: sum(o["launches"][k] for o in out.values()) for k in build.LAUNCHES}
    return {"shapes": out, "launches": merged}


# scripts: the port's six example scripts on the card, in this process
# (stdout captured), at their defaults but for these cuts: the eager NUTS
# runs of the hierarchical (400 + 400 steps) and statespace (300 + 300)
# scripts and the hierarchical ADVI (2,500 steps) are host-bound
SCRIPT_RUNS = {
    "polynomial": ([], {}),
    "mixture": ([], {}),
    "logistic": ([], {"LAPLACE_STEPS": 500}),
    "statespace": ([], {"NUTS_WARMUP": 20, "NUTS_SAMPLES": 20}),
    "hierarchical": (["--warmup", "25", "--samples", "20"], {"ADVI_STEPS": 150}),
    "chromatin": ([], {}),
}
SCRIPT_CUTS = {"logistic": "Laplace 1,500 -> 500 steps (on the CPU the same gap, converged)",
               "statespace": "NUTS cross-check 300 + 300 -> 20 + 20 steps (on the CPU max "
                             "|delta| 0.128 at 20 + 20, 0.018 at 30 + 30, 0.324 at 15 + 15; "
                             "the gate 0.25)",
               "hierarchical": "NUTS 400 + 400 -> 25 + 20 steps, ADVI 2,500 -> 150 steps "
                               "(on the CPU mu within 0.12 of the truth, ADVI's mu "
                               "within 0.04 of NUTS's)"}


def script_numbers(line: str) -> list[float]:
    import re

    return [float(x.replace(",", "")) for x in
            re.findall(r"[-+]?\d[\d,]*\.?\d*(?:e[-+]?\d+)?", line)]


def script_gates(name: str, lines: list[str]) -> dict:
    """The script's summary lines against the truth: raises CheckFailed
    where a number misses its tolerance (stated in each check); returns
    the numbers checked."""
    first = {ln.split()[0]: script_numbers(ln) for ln in lines if ln.split()}
    got = {}
    if name == "polynomial":
        from binf_tpu_torch.example.polynomial import TRUE_COEFFICIENTS, TRUE_PRECISION

        rows = [ln for ln in lines if ln.startswith(("coefficients[", "precision "))]
        truth = list(TRUE_COEFFICIENTS) + [TRUE_PRECISION]
        for ln, tr in zip(rows, truth):
            nums = script_numbers(ln.split(None, 1)[1])
            mean, std, rhat = nums[0], nums[1], nums[2]
            check(abs(mean - tr) <= 3 * std and rhat < 1.05,
                  f"scripts polynomial {ln.split()[0]}: mean {mean} within 3 sd ({std}) of "
                  f"{tr}, rhat {rhat} < 1.05")
        got["rows"] = len(rows)
        check(len(rows) == 5, "scripts polynomial: five summary rows")
    elif name == "mixture":
        means = script_numbers(lines[2].split("truth")[0])
        weights = script_numbers(lines[3].split("truth")[0])
        sigma = script_numbers(lines[4].split("truth")[0])[0]
        agree = script_numbers(lines[5])[-1]
        from binf_tpu_torch.example.mixture import TRUE_MEANS, TRUE_SIGMA, TRUE_WEIGHTS

        check(max(abs(a - b) for a, b in zip(means, sorted(TRUE_MEANS))) < 0.25
              and max(abs(a - b) for a, b in zip(weights, TRUE_WEIGHTS)) < 0.1
              and abs(sigma - TRUE_SIGMA) < 0.1 and agree >= 90,
              f"scripts mixture: means {means} within 0.25, weights {weights} within 0.1, "
              f"sigma {sigma} within 0.1 of the truth, held-out agreement {agree}% >= 90%")
        got = {"means": means, "weights": weights, "sigma": sigma, "agreement": agree}
    elif name == "logistic":
        from binf_tpu_torch.example.logistic import TRUE_WEIGHTS

        rows = [script_numbers(ln) for ln in lines if ln.startswith("weight[")]
        for j, (_, tr, mean, sd, rhat) in enumerate(rows):
            check(abs(mean - tr) <= 3 * sd and rhat < 1.1,
                  f"scripts logistic weight[{j}]: mean {mean} within 3 sd ({sd}) of {tr}, "
                  f"rhat {rhat} < 1.1")
        acc = first["held-out"][-1]
        gap = script_numbers(lines[-1])[0]
        check(len(rows) == len(TRUE_WEIGHTS) and acc > 0.75 and gap < 0.2
              and "converged=True" in lines[-1],
              f"scripts logistic: held-out accuracy {acc} > 0.75, Laplace gap {gap} < 0.2, "
              "converged")
        got = {"accuracy": acc, "laplace_gap": gap}
    elif name == "statespace":
        from binf_tpu_torch.example.statespace import TRUE_DYNAMICS, TRUE_PRECISION

        dyn = script_numbers(lines[2].split("truth")[0])
        prec = first["precision"][0]
        delta = script_numbers(lines[4])[-1]
        check(max(abs(a - b) for a, b in zip(dyn[:2], TRUE_DYNAMICS[:2])) < 0.15
              and abs(dyn[2] - TRUE_DYNAMICS[2]) < 0.5
              and abs(prec / TRUE_PRECISION - 1) < 0.4 and delta < 0.25,
              f"scripts statespace: phi and drift {dyn[:2]} within 0.15, x0 {dyn[2]} within "
              f"0.5 of the truth, precision {prec} within 40%, NUTS max |delta| {delta} < 0.25")
        got = {"dynamics": dyn, "precision": prec, "nuts_delta": delta}
    elif name == "hierarchical":
        from binf_tpu_torch.example.hierarchical import TRUE_MU, TRUE_TAU

        mu = script_numbers(lines[2].split("truth")[0])
        tau = script_numbers(lines[3].split("truth")[0])
        prec = script_numbers(lines[4])[0]
        vi_mu = script_numbers(lines[5].split("mu =")[1].split("ELBO")[0])
        check(max(abs(a - b) for a, b in zip(mu, TRUE_MU)) < 0.2
              and all(0.4 * t < v < 2.5 * t for v, t in zip(tau, TRUE_TAU))
              and abs(prec / 25.0 - 1) < 0.4
              and max(abs(a - b) for a, b in zip(vi_mu, mu)) < 0.15,
              f"scripts hierarchical: mu {mu} within 0.2 of the truth, tau {tau} within 0.4-2.5x"
              f", precision {prec} within 40% of 25, ADVI mu {vi_mu} within 0.15 of NUTS's")
        got = {"mu": mu, "tau": tau, "precision": prec, "advi_mu": vi_mu}
    else:
        acc, prec = first["HMC"][0], first["HMC"][1]
        err = script_numbers(lines[-1])[-1]
        # the symmetrised noise doubles the restraints' precision (~50, not
        # the printed 25; ROADMAP section 3)
        check(0.3 < acc <= 1.0 and 15 < prec < 100 and err < 0.2,
              f"scripts chromatin: HMC acceptance {acc} in (0.3, 1], precision {prec} in "
              f"(15, 100), median restrained-distance error {err} < 0.2")
        got = {"accept": acc, "precision": prec, "median_error": err}
    return got


def scripts_path(build, dev):
    """Each of ``examples/run_*_torch.py`` on the card through its ``main``,
    its module's cut constants set (SCRIPT_RUNS), stdout captured: its
    summary lines checked against the truth (script_gates), its wall
    seconds and the kernels it launched."""
    import contextlib
    import importlib.util
    import io

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, (argv, consts) in SCRIPT_RUNS.items():
        path = os.path.join(root, "examples", f"run_{name}_torch.py")
        spec = importlib.util.spec_from_file_location(f"run_{name}_torch", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        for k, v in consts.items():
            check(hasattr(module, k), f"scripts {name}: the script defines {k}")
            setattr(module, k, v)
        build.reset_launch_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            module.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        lines = buf.getvalue().splitlines()
        progress(f"scripts {name} ({wall:.1f} s):\n" + "\n".join("    " + ln for ln in lines))
        got = script_gates(name, [ln for ln in lines if ln.strip()])
        out[name] = {"argv": argv, "cut": SCRIPT_CUTS.get(name), "wall_s": wall,
                     "lines": lines, "checked": got,
                     "launches": {k: v for k, v in build.LAUNCHES.items() if v}}
    merged = {k: sum(o["launches"].get(k, 0) for o in out.values()) for k in build.LAUNCHES}
    return {"scripts": out, "launches": merged}


# -- this slice: the density compiler's functors in K3 and K4 ------------------------

# traced path: models with no hand-written functor through the density
# compiler (ops/kernels/density_compiler.py) and adaptive_hmc(algorithm=
# "auto") at the families' shape (8,192 chains, 400 + 500 steps, L = 10),
# each beside an eager run of the same model at TRACED_REF_CHAINS chains,
# TRACED_REF_WARMUP + TRACED_REF_SAMPLES steps; its means held to
# TRACED_SE Monte-Carlo standard errors of the two runs' difference
TRACED_CHAINS, TRACED_WARMUP, TRACED_SAMPLES = 8192, 400, 500
TRACED_REF_CHAINS, TRACED_REF_WARMUP, TRACED_REF_SAMPLES = 512, 100, 50
# (cut for the wide phase: the eager references' samples 100 -> 50; their
# standard errors take the shorter run, which only widens the gate's reach)
TRACED_REF_SAMPLES_PUBLISHED = 100
# the robust regression's eager reference, the costliest, at 60 + 40 (on the
# CPU its means lay within 1.05 SE of a 400 + 200 run's at 2,048 chains)
TRACED_REF_DEPTH = {"robust": (60, 40)}
TRACED_SE = 4.0
TRACED_EVAL_POINTS = 1024
# the router's 6-D Gaussian (correlation 0.95 of the JAX package's dense
# tests): its known moments within this
GAUSS_TOL = 0.1


def gaussian6(dev):
    """The 6-D Gaussian of correlation 0.95 (scales exp(linspace(-1, 1.5)),
    means N(0, 1) from numpy seed 0): ``(mu, S, P, logdensity)``."""
    rng = np.random.default_rng(0)
    d, rho = 6, 0.95
    scales = np.exp(np.linspace(-1.0, 1.5, d))
    S = np.diag(scales) @ (np.full((d, d), rho) + (1 - rho) * np.eye(d)) @ np.diag(scales)
    mu = rng.normal(size=d)
    P = torch.tensor(np.linalg.inv(S), dtype=torch.float32, device=dev)
    mu_t = torch.tensor(mu, dtype=torch.float32, device=dev)

    def gaussian(pos):
        x = pos["x"] - mu_t
        return -0.5 * x @ (P @ x)

    return mu, S, P, gaussian


def robust_eval_flops(n: int, d: int) -> int:
    """The least float operations of one evaluation of the robust
    regression's U and grad U (Student-t errors of fixed df, the scale under
    its log transform), a transcendental and a division counted as one: a
    row's d FMAs for the mean, the residual, z = r^2 / (df s^2) (2), 1 + z,
    its log and its sum, the row's weight r k / (1 + z) (2), d FMAs of the
    coefficients' gradient and the scale's sum of z / (1 + z) (2); then
    exp of the log scale, s^2 and k (4), the coefficients' Gaussian prior (3
    a coordinate), the (df + 1) factors of the coefficients' gradient (d),
    the scale's gradient (2), the half-normal prior and its Jacobian (4)
    and the value's sums (3)."""
    return n * (4 * d + 10) + 4 * d + 15


def poisson_eval_flops(n: int, d: int) -> int:
    """The least float operations of one evaluation of the Poisson GLM's U
    and grad U (log link; the data's lgamma(y + 1) a constant), a
    transcendental counted as one: a row's d FMAs for eta, exp(eta), the
    FMA y eta - exp(eta) and its sum, exp(eta) - y, d FMAs of the gradient;
    then the Gaussian prior (3 a coordinate), the constant and the sums."""
    return n * (4 * d + 5) + 3 * d + 3


def gaussian_eval_flops(D: int) -> int:
    """The least float operations of one evaluation of a dense Gaussian's U
    and grad U: z = x - mu (D), grad = P z (D^2 FMAs), U = z . grad / 2 (D
    FMAs and the half)."""
    return 2 * D * D + 3 * D + 1


def traced_problems(dev):
    """label -> (logdensity, start(C, seed), the least float operations of
    one evaluation of its U and grad U) of the traced path's models:
    (a) ``robust``, the polynomial regression on example/polynomial.py's 20
    points with a Student-t error model (df 4) in place of the Gaussian,
    N(0, 5 I) on the 4 coefficients and a half-normal prior (scale 1) on
    the error scale under LogTransform; (b) ``poisson``, a Poisson GLM with
    log link on example/logistic.py's design shape (200 x 5, standardised,
    the first column the intercept), counts drawn at weights (0.5, 0.3,
    -0.2, 0.1, 0.2), N(0, 4 I) on the weights; (c) ``gauss6``, the router's
    6-D Gaussian as a plain callable."""
    from binf_tpu_torch.example.polynomial import make_data
    from binf_tpu_torch.model import (LinearForwardModel, PoissonErrorModel,
                                      PolynomialForwardModel, StudentTErrorModel)
    from binf_tpu_torch.pdf import Likelihood, Posterior
    from binf_tpu_torch.pdf.priors import GaussianPrior, HalfNormalPrior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    xses, ys = make_data(gen(1), device=dev)
    lik = Likelihood.create("points", PolynomialForwardModel.create(xses, 4),
                            StudentTErrorModel.create(ys, df=4.0))
    priors = {"coefficients_prior": GaussianPrior.create(
                  torch.zeros(4, device=dev), torch.full((4,), 5.0, device=dev),
                  variable="coefficients"),
              "scale_prior": HalfNormalPrior.create(torch.tensor(1.0, device=dev),
                                                    variable="scale")}
    robust = transform_logdensity(Posterior.create({"points": lik}, priors).log_prob,
                                  {"scale": LogTransform})

    def robust_start(C, seed):
        g = gen(seed)
        return {"coefficients": (1.0 + 0.1 * torch.randn((C, 4), generator=g)).to(dev),
                "scale": (-0.5 + 0.1 * torch.randn(C, generator=g)).to(dev)}

    g = gen(80)
    X = torch.cat([torch.ones((200, 1)), torch.randn((200, 4), generator=g)], 1).to(dev)
    w_true = torch.tensor([0.5, 0.3, -0.2, 0.1, 0.2], device=dev)
    counts = torch.poisson(torch.exp(X @ w_true).cpu(), generator=g).to(dev)
    lik = Likelihood.create("counts", LinearForwardModel(design=X, variable="weights"),
                            PoissonErrorModel.create(counts, log_link=True))
    prior = GaussianPrior.create(torch.zeros(5, device=dev), torch.full((5,), 4.0, device=dev),
                                 variable="weights")
    poisson = Posterior.create({"counts": lik}, {"weights_prior": prior}).log_prob

    def poisson_start(C, seed):
        return {"weights": (0.1 * torch.randn((C, 5), generator=gen(seed))).to(dev)}

    def gauss_start(C, seed):
        return {"x": (0.5 * torch.randn((C, 6), generator=gen(seed))).to(dev)}

    return {"robust": (robust, robust_start, robust_eval_flops(20, 4)),
            "poisson": (poisson, poisson_start, poisson_eval_flops(200, 5)),
            "gauss6": (gaussian6(dev)[3], gauss_start, gaussian_eval_flops(6))}


def polynomial_traced(dens_mod, dev):
    """(d): the transformed polynomial posterior (the main path's data) and
    its TracedDensity, forced through the density compiler beside the
    LinregDensity the recogniser gives it."""
    from binf_tpu_torch.example.polynomial import make_data, make_posterior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    xses, ys = make_data(torch.Generator().manual_seed(1), device=dev)
    ld = transform_logdensity(make_posterior(xses, ys).log_prob, {"precision": LogTransform})
    template = {"coefficients": torch.zeros(4, device=dev), "precision": torch.zeros((), device=dev)}
    return ld, template, dens_mod.TracedDensity(ld, template).to(dev)


def traced_shapes(dens_mod, problems, poly):
    """The shapes ``(6, D, 1, compiled)`` of the traced path's densities,
    for phase_build's one nvcc batch."""
    poly_traced = poly[2]
    out = []
    for ld, start_fn, _ in problems.values():
        density = dens_mod.device_density(ld, {k: v[0] for k, v in start_fn(1, 0).items()})
        out.append((dens_mod.FAMILIES["TracedDensity"], density.D, 1, density.compiled))
    out.append((dens_mod.FAMILIES["TracedDensity"], poly_traced.D, 1, poly_traced.compiled))
    return out


def traced_functor_check(label, dens_mod, density, reference, start, dev, against=None):
    """The traced functor at TRACED_EVAL_POINTS points (one density_eval
    launch) against torch.func of ``reference`` on the card: U within 1e-4
    of the largest |U|, grad U within 1e-4 of the largest |grad U|
    (``against``: a device density whose gradient it must match too, and
    whose U it must match up to one constant offset).  Returns the errors."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    template = {k: v[0] for k, v in start.items()}
    q = pack_positions(start)[:TRACED_EVAL_POINTS]
    q = q + 0.3 * torch.randn(q.shape, generator=torch.Generator().manual_seed(23)).to(dev)
    U_k, g_k = dens_mod.density_eval(density, q, device=dev)
    U_f, g_f = dens_mod.CallableDensity(reference, template).potential_and_grad(q)
    u_err = float((U_k - U_f).abs().max() / U_f.abs().max())
    g_err = float((g_k - g_f).abs().max() / g_f.abs().max())
    check(u_err <= 1e-4 and g_err <= 1e-4 and bool(torch.isfinite(U_k).all()),
          f"traced {label}: the functor at {TRACED_EVAL_POINTS} points against torch.func: U "
          f"{u_err:.3g}, grad {g_err:.3g} of the largest (<= 1e-4)")
    out = {"points": TRACED_EVAL_POINTS, "u_rel_err": u_err, "grad_rel_err": g_err,
           "max_abs_err": float(max((U_k - U_f).abs().max(), (g_k - g_f).abs().max()))}
    if against is not None:
        U_h, g_h = against.potential_and_grad(q)
        off = (U_k - U_h).mean()
        hu = float((U_k - U_h - off).abs().max() / U_h.abs().max())
        hg = float((g_k - g_h).abs().max() / g_h.abs().max())
        check(hu <= 1e-4 and hg <= 1e-4,
              f"traced {label}: the functor against {type(against).__name__}: U up to one "
              f"constant {hu:.3g}, grad {hg:.3g} (<= 1e-4)")
        out.update(hand_u_rel_err=hu, hand_grad_rel_err=hg, hand_offset=float(off))
    progress(f"traced {label}: functor U {u_err:.3g}, grad {g_err:.3g} of the largest")
    return out


def traced_bounds(flops: int, D: int, C: int, warmup: int, samples: int,
                  moments: bool = False, leapfrog: int = N_LEAPFROG):
    """K3's and K4's bounds for a traced model whose U and grad U need at
    least ``flops`` float operations an evaluation (counted by hand from the
    function, not from the emitted code), as family_dims_path counts
    them, at L = ``leapfrog``; K4 writes the draws, or with ``moments``
    two (C, D) moments."""
    out = samples * C * D * 4 if not moments else 2 * C * D * 4
    k4 = bound_ms(C * (2 * D + 1) * 4 + out + C * (D + 1) * 4,
                  samples * C * trajectory_flops(flops, D, leapfrog),
                  philox_calls(samples, C, D))
    k3 = bound_ms(C * (3 * D + 1) * 4, warmup * C * trajectory_flops(flops, D, leapfrog),
                  philox_calls(warmup, C, D))
    return k3, k4


def traced_usage(build, density) -> dict:
    """nvcc seconds, registers and spills of a traced density's K3 and K4
    units (their ptxas logs)."""
    from binf_tpu_torch.ops.kernels.densities import FAMILIES

    names = build.shape_names(FAMILIES[density.functor], density.D, 1, density.compiled)
    tag = names[0].split(".", 1)[1]
    usage = {}
    for stem, k in zip(names, ("k3", "k4")):
        kernels = ptxas_entries(build, stem, lambda m: m if "kernel" in m else None)
        usage[k] = {"registers": max((v.get("registers", 0) for v in kernels.values()),
                                     default=None),
                    "spill_stores": max((v.get("spill_stores", 0) for v in kernels.values()),
                                        default=None),
                    "stack": max((v.get("stack", 0) for v in kernels.values()), default=None)}
    return {"nvcc_s": build.SHAPE_BUILDS.get(tag), "ptxas": usage}


def traced_run(auto, ld, start, seed, dev, algorithm="auto", warmup=TRACED_WARMUP,
               samples=TRACED_SAMPLES):
    kw = dict(warmup="fused") if algorithm != "xla" else {}
    return auto.adaptive_hmc(ld, start, seed, num_warmup=warmup, num_samples=samples,
                             num_leapfrog=N_LEAPFROG, initial_step_size=0.1,
                             algorithm=algorithm, device=dev, **kw)


def flat_draws(samples: dict) -> torch.Tensor:
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    steps, C = next(iter(samples.values())).shape[:2]
    flat = {k: v.reshape((steps * C,) + v.shape[2:]) for k, v in samples.items()}
    return pack_positions(flat).reshape(steps, C, -1)


def traced_path(build, fp, dens_mod, auto, problems, poly, dev, gauss_eager=None):
    """Models with no hand-written functor through the density compiler, at
    TRACED_CHAINS chains: per model the router's decision (fused, naming
    the traced density), the functor against torch.func, launch counts from
    0, one cold and one timed ``adaptive_hmc(algorithm="auto",
    warmup="fused")`` (CUDA events around K3 and K4), acceptance in (0.6,
    0.95), finite draws; an eager run of the same model (TRACED_REF_*)
    whose means the fused ones match within TRACED_SE standard errors
    (robust, poisson) or the known moments within GAUSS_TOL (gauss6);
    nvcc seconds, registers and spills; then (d), the polynomial
    posterior's generated functor against LinregDensity: functors, and K3
    and K4 of both on the same start.  The Gaussian's eager side is
    router_path's eager run of the same target (``gauss_eager``, its
    ``xla`` record), which it does not repeat."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    out = {}
    for label, (ld, start_fn, least_flops) in problems.items():
        start = start_fn(TRACED_CHAINS, 90)
        template = {k: v[0] for k, v in start.items()}
        density = dens_mod.device_density(ld, template).to(dev)
        D = density.D
        check(isinstance(density, dens_mod.TracedDensity),
              f"traced {label}: device_density compiles it ({type(density).__name__})")
        dec = auto.route_algorithm(ld, start)
        check(dec.path == "fused" and "TracedDensity" in dec.reason,
              f"traced {label}: the router sends it to {dec.path} ({dec.reason})")
        checks = traced_functor_check(label, dens_mod, density, ld, start, dev)
        build.reset_launch_counts()
        t = time.perf_counter()
        traced_run(auto, ld, start, 91, dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res, dec_run = traced_run(auto, ld, start, 92, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(build.LAUNCHES)
        for k in ("philox", "fused_warmup", "fused_potential_hmc"):
            check(launches[k] > 0, f"traced {label} launched {k} {launches[k]} times")
        check(dec_run.path == "fused", f"traced {label}: adaptive_hmc ran {dec_run.path}")
        accept = float(res.accept_rate)
        check(0.6 < accept < 0.95, f"traced {label}: acceptance {accept:.4f} in (0.6, 0.95)")
        flat = flat_draws(res.samples)
        check(bool(torch.isfinite(flat).all())
              and tuple(flat.shape) == (TRACED_SAMPLES, TRACED_CHAINS, D),
              f"traced {label}: finite draws of shape ({TRACED_SAMPLES}, {TRACED_CHAINS}, {D})")
        ess_f = ess(flat).double()
        m_ess = float(ess_f.min())
        fm = flat.double().mean((0, 1))
        moments = {"fused_mean": fm.tolist()}
        if label != "gauss6":
            # the eager run of the same model
            ref_start = start_fn(TRACED_REF_CHAINS, 93)
            t = time.perf_counter()
            ref_w, ref_n = TRACED_REF_DEPTH.get(label, (TRACED_REF_WARMUP, TRACED_REF_SAMPLES))
            ref, dec_ref = traced_run(auto, ld, ref_start, 94, dev, algorithm="xla",
                                      warmup=ref_w, samples=ref_n)
            torch.cuda.synchronize()
            ref_wall = time.perf_counter() - t
            ref_flat = flat_draws(ref.samples)
            ess_e = ess(ref_flat).double()
            em, ev = ref_flat.double().mean((0, 1)), ref_flat.double().var((0, 1))
            se = torch.sqrt(flat.double().var((0, 1)) / ess_f + ev / ess_e)
            z = float(((fm - em).abs() / se).max())
            moments.update(eager_mean=em.tolist(), max_z=z)
            ref_ess = float(ess_e.min())
            eager = {"chains": TRACED_REF_CHAINS, "warmup": ref_w, "samples": ref_n,
                     "cut_from": [TRACED_REF_WARMUP, TRACED_REF_SAMPLES_PUBLISHED],
                     "reason": dec_ref.reason,
                     "e2e_ms": ref_wall * 1e3, "accept": float(ref.accept_rate),
                     "min_bulk_ess": ref_ess, "ess_per_s": ref_ess / ref_wall}
        else:
            eager = None if gauss_eager is None else {
                "chains": gauss_eager["chains"], "warmup": gauss_eager["warmup"],
                "samples": gauss_eager["samples"], "reason": gauss_eager["reason"],
                "e2e_ms": gauss_eager["wall_ms"], "accept": gauss_eager["accept"],
                "min_bulk_ess": gauss_eager["min_bulk_ess"],
                "ess_per_s": gauss_eager["ess_per_s"], "from": "router_path"}
        if label == "gauss6":
            mu, S = gaussian6(dev)[:2]
            X = flat[TRACED_SAMPLES // 4:].reshape(-1, D).double().cpu().numpy()
            mean_err = float(np.abs(X.mean(0) - mu).max())
            sd_err = float(np.abs(X.std(0) / np.sqrt(np.diag(S)) - 1).max())
            check(mean_err < GAUSS_TOL and sd_err < GAUSS_TOL,
                  f"traced {label}: means within {mean_err:.3g} and standard deviations within "
                  f"{100 * sd_err:.1f}% of the known ones (< {GAUSS_TOL})")
            moments.update(mean_err=mean_err, sd_rel_err=sd_err)
        else:
            check(z <= TRACED_SE, f"traced {label}: fused means within {z:.2f} standard errors "
                                  f"of the eager run's (<= {TRACED_SE})")
        k3_ms, k4_ms = spans.ms("warmup"), spans.ms("sampling")
        k3_b, k4_b = traced_bounds(least_flops, D, TRACED_CHAINS, TRACED_WARMUP, TRACED_SAMPLES)
        out[label] = {
            "functor": density.compiled.name, "D": D, "nodes": density.compiled.nodes,
            "lines": density.compiled.lines, "trace_ms": density.compiled.trace_ms,
            "operand_floats": density.shared_floats(), "eval_flops": least_flops,
            "emitted_flops": density.flops,
            "route": dec.reason, "chains": TRACED_CHAINS, "warmup": TRACED_WARMUP,
            "samples": TRACED_SAMPLES, "leapfrog": N_LEAPFROG, "cold_ms": cold * 1e3,
            "e2e_ms": wall * 1e3, "k3_ms": k3_ms, "k4_ms": k4_ms, "k3_bound_ms": k3_b[0],
            "k3_bound_by": k3_b[1], "k4_bound_ms": k4_b[0], "k4_bound_by": k4_b[1],
            "accept": accept, "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall,
            "eager": eager, "moments": moments, "checks": checks, **traced_usage(build, density),
            "lanes": {"k3": build.last_launch["fused_warmup"].lanes,
                      "k4": build.last_launch["fused_potential_hmc"].lanes},
            "launches": launches}
        progress(f"traced {label}: D = {D}, {density.compiled.nodes} nodes, {least_flops} "
                 f"flops an evaluation at least ({density.flops} emitted), nvcc {out[label]['nvcc_s']} s, ptxas "
                 f"{out[label]['ptxas']}; e2e {wall * 1e3:.2f} ms, K3 {k3_ms:.3f} ms (bound "
                 f"{k3_b[0]:.3f}), K4 {k4_ms:.3f} ms (bound {k4_b[0]:.3f}), accept "
                 f"{accept:.4f}, min bulk ESS {m_ess:.1f}, ESS/s {m_ess / wall:.4g}; eager "
                 f"{eager and round(eager['e2e_ms'], 1)} ms, ESS/s "
                 f"{eager and round(eager['ess_per_s'], 1)}; moments {moments}")
    # (d): the polynomial posterior's generated functor beside LinregDensity
    ld, template, traced = poly
    hand = dens_mod.device_density(ld, template).to(dev)
    check(isinstance(hand, dens_mod.LinregDensity), "traced polynomial: the recogniser's "
          f"density is {type(hand).__name__}")
    g = torch.Generator().manual_seed(2)
    q = torch.cat([1.0 + 0.1 * torch.randn((TRACED_CHAINS, 4), generator=g),
                   torch.zeros((TRACED_CHAINS, 1))], dim=1).to(dev)
    start = {"coefficients": q[:, :4], "precision": q[:, 4]}
    checks = traced_functor_check("polynomial", dens_mod, traced, ld, start, dev, against=hand)
    times, counts = {}, {}
    for name, fn in (("traced", traced), ("hand", ld), ("traced_again", traced),
                     ("hand_again", ld)):
        build.reset_launch_counts()
        with LaunchSpans(fp) as spans:
            res = fused_model_hmc(fn, start, 95, num_warmup=TRACED_WARMUP,
                                  num_samples=TRACED_SAMPLES, num_leapfrog=N_LEAPFROG,
                                  initial_step_size=0.1, warmup="fused", device=dev)
            torch.cuda.synchronize()
        counts[name] = dict(build.LAUNCHES)
        check(counts[name]["fused_warmup"] > 0 and counts[name]["fused_potential_hmc"] > 0,
              f"traced polynomial ({name}) launched K3 and K4")
        times[name] = (spans.ms("warmup"), spans.ms("sampling"), float(res.accept_rate))

    def summed(names):
        return {k: sum(counts[n][k] for n in names) for k in build.LAUNCHES}

    least = eval_flops(20, 4)
    k3_b, k4_b = traced_bounds(least, 5, TRACED_CHAINS, TRACED_WARMUP, TRACED_SAMPLES)
    out["polynomial"] = {
        "functor": traced.compiled.name, "D": 5, "nodes": traced.compiled.nodes,
        "lines": traced.compiled.lines, "eval_flops": least, "emitted_flops": traced.flops,
        "operand_floats": traced.shared_floats(), "checks": checks,
        "k3_ms": min(times["traced"][0], times["traced_again"][0]),
        "k4_ms": min(times["traced"][1], times["traced_again"][1]),
        "hand_k3_ms": min(times["hand"][0], times["hand_again"][0]),
        "hand_k4_ms": min(times["hand"][1], times["hand_again"][1]),
        "runs": times, "k3_bound_ms": k3_b[0], "k3_bound_by": k3_b[1], "k4_bound_ms": k4_b[0],
        "k4_bound_by": k4_b[1], **traced_usage(build, traced),
        "launches": summed(("traced", "traced_again")),
        "hand_launches": summed(("hand", "hand_again"))}
    progress(f"traced polynomial: generated K3 {out['polynomial']['k3_ms']:.3f} ms, K4 "
             f"{out['polynomial']['k4_ms']:.3f} ms against LinregDensity's "
             f"{out['polynomial']['hand_k3_ms']:.3f} and {out['polynomial']['hand_k4_ms']:.3f} "
             f"(runs {times}); nvcc {out['polynomial']['nvcc_s']} s, ptxas "
             f"{out['polynomial']['ptxas']}")
    merged = {k: sum(o["launches"].get(k, 0) + o.get("hand_launches", {}).get(k, 0)
                     for o in out.values()) for k in build.LAUNCHES}
    return {"models": out, "launches": merged}


def traced_branch(t: dict, k: str) -> dict:
    """A traced functor's branch of K3 (``k = "k3"``) or K4 for the
    ``kernels`` line: its launches on the path, ms, the bound from the
    least operations of the model's function (the compiler's count of the
    emitted code beside it), its share, the functor's error against
    torch.func; for (d) the hand-written functor's ms beside it."""
    name = {"k3": "fused_warmup", "k4": "fused_potential_hmc"}[k]
    row = {"functor": t["functor"], "lanes": 1, "launches": t["launches"][name],
           "ms": t[f"{k}_ms"], "bound_ms": t[f"{k}_bound_ms"], "bound_by": t[f"{k}_bound_by"],
           "bound_share": t[f"{k}_bound_ms"] / t[f"{k}_ms"], "eval_flops": t["eval_flops"],
           "emitted_flops": t["emitted_flops"],
           "max_abs_err": t["checks"]["max_abs_err"], "nvcc_s": t["nvcc_s"],
           "ptxas": t["ptxas"][k]}
    if f"hand_{k}_ms" in t:
        row["hand_written_ms"] = t[f"hand_{k}_ms"]
    return row


# -- this slice: K7 on the group form of the density compiler's functors -------------

# the chain-grid path's traced phase: the CLI's five models K7 had no
# functor for, each through chain_grid_potential_from_scalar (the density
# compiler's group form, csrc/chain_grid_shape.cu) at its published size:
# (i) the group form alone at TRACED_EVAL_POINTS positions at CGT_WARPS
# warps against torch.func (with the two densities of
# tests/test_chain_grid.py), within CGT_EVAL_TOL of the largest |U| and
# |grad U|; (iii) K3's fixed warmup (CGT_WARMUP steps, one tile of
# CG_CHAINS chains), then CGT_SAMPLES steps at L = N_LEAPFROG in K7 and in
# K4 from its adapted state; (ii) K7 against its plain version from that
# state, on every model at the timed geometry (CG_CHAINS chains on the
# kernel's own Philox stream, CG_CHECK_STEPS steps) and on
# CGT_STAGED_MODELS on staged noise (CGT_STAGED_CHAINS chains,
# CGT_STAGED_STEPS steps: more warps a chain); (iv) the CLI's chain-grid
# route on the polynomial model at its defaults
CGT_MODELS = ("polynomial", "hierarchical", "logistic", "statespace", "mixture")
CGT_WARMUP, CGT_SAMPLES = 400, 500
CGT_STAGED_MODELS, CGT_STAGED_CHAINS, CGT_STAGED_STEPS = ("polynomial", "hierarchical"), 64, 20
CGT_WARPS = (1, 8)
# the CLI's chain-grid route: its eager warmup cut from the CLI's 300 steps
# (to 150 for the wide phase, to 75 for the wider one; on the CPU the
# route accepted 0.82 and 0.81 with its means within 1.06 and 2.37 SE of
# the fused route's, the gate TRACED_SE)
CGT_CLI_WARMUP, CGT_CLI_WARMUP_PUBLISHED = 75, 300
CGT_EVAL_TOL = 1e-5


def cgt_least_flops(name: str) -> int:
    """The least float operations of one evaluation of a CLI model's U and
    grad U, counted from the function (the hand-written functors' counts)."""
    from binf_tpu_torch.example import logistic, mixture, statespace

    return {"polynomial": eval_flops(20, 4), "hierarchical": hierarchical_eval_flops(15, 8),
            "logistic": logistic_eval_flops(logistic.N_DATA_POINTS, 5),
            "statespace": ar1_eval_flops(statespace.N_TIMESTEPS),
            "mixture": mixture_eval_flops(mixture.N_DATA_POINTS)}[name]


def chain_grid_traced_problems(cli, cg, dev):
    """label -> (log density, start(C, seed), TracedPotential): the CLI's five
    models (``cli.build_model``, data from a card generator seeded 1,
    unconstrained starts from the model's init_fn) and, for the functor
    check, tests/test_chain_grid.py's mixed-rank Gaussian and sequential
    matvec density (its data y drawn here from a seeded generator).  The
    potentials are compiled now, for phase_build's one nvcc batch."""
    from binf_tpu_torch.pdf.transforms import unconstrain

    out = {}
    for name in CGT_MODELS:
        model = cli.build_model(name, torch.Generator(device=dev).manual_seed(1), device=dev)

        def start(C, seed, model=model):
            g = torch.Generator(device=dev).manual_seed(seed)
            return unconstrain(model.transforms, model.init_fn(C, generator=g))

        out[name] = (cli._logdensity(model), start)
    M = torch.arange(6.0, device=dev).reshape(3, 2)
    A = torch.tensor([[0.6, 0.2], [0.0, 0.5]], device=dev)
    Y = 0.3 * torch.randn((12, 2), generator=torch.Generator(device=dev).manual_seed(9),
                          device=dev)

    def gaussian(p):
        return -0.5 * torch.sum((p["x"] - M) ** 2 / 0.25) - 0.5 * p["y"] ** 2

    def sequential(p):
        x, sq = p["x0"], []
        for t in range(Y.shape[0]):
            x = A @ x
            sq.append(torch.sum((Y[t] - x) ** 2))
        return -0.5 * torch.sum(torch.stack(sq)) - 0.5 * torch.sum(p["x0"] ** 2)

    def normal_start(shapes):
        def start(C, seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            return {k: torch.randn((C,) + s, generator=g, device=dev) for k, s in shapes.items()}
        return start

    out["jax gaussian"] = (gaussian, normal_start({"x": (3, 2), "y": ()}))
    out["jax sequential"] = (sequential, normal_start({"x0": (2,)}))
    problems = {}
    for label, (ld, start) in out.items():
        template = {k: v[0] for k, v in start(1, 0).items()}
        pot = cg.chain_grid_potential_from_scalar(ld, template)[0]
        check(isinstance(pot, cg.TracedPotential),
              f"chain-grid traced {label}: the compiler lowers it ({type(pot).__name__}, "
              f"{getattr(pot, 'refusal', None)})")
        problems[label] = (ld, start, pot)
    return problems


def cgt_functor_check(build, cg, label, ld, start, pot, dev):
    """(i) The group form alone (``group_value_and_grad``) at
    TRACED_EVAL_POINTS positions, at each of CGT_WARPS warps a position,
    against torch.func of the callable on the card: U and grad U within
    CGT_EVAL_TOL of the largest |U| and |grad U|; two calls at one width
    equal bit for bit.  Returns the errors."""
    from binf_tpu_torch.ops.kernels.densities import CallableDensity
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    first = start(TRACED_EVAL_POINTS, 70)
    template = {k: v[0] for k, v in first.items()}
    q = pack_positions(first)
    q = (q + 0.3 * torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(71),
                               device=dev)).contiguous()
    U_f, g_f = CallableDensity(ld, template).potential_and_grad(q)
    out = {"points": TRACED_EVAL_POINTS}
    for w in CGT_WARPS:
        U_k, g_k = cg.group_value_and_grad(pot, q, warps=w)
        U_2, g_2 = cg.group_value_and_grad(pot, q, warps=w)
        rec = build.last_launch["group_eval"]
        torch.cuda.synchronize()
        u_err = float((U_k - U_f).abs().max() / U_f.abs().max())
        g_err = float((g_k - g_f).abs().max() / g_f.abs().max())
        check(rec.lanes == 32 * w and u_err <= CGT_EVAL_TOL and g_err <= CGT_EVAL_TOL
              and bool(torch.isfinite(U_k).all()) and bool(torch.isfinite(g_k).all()),
              f"chain-grid traced {label}: the group form at {w} warps ({rec.lanes} lanes) "
              f"against torch.func at {TRACED_EVAL_POINTS} points: U {u_err:.3g}, grad "
              f"{g_err:.3g} of the largest (<= {CGT_EVAL_TOL})")
        check(torch.equal(U_k, U_2) and torch.equal(g_k, g_2),
              f"chain-grid traced {label}: two calls at {w} warps equal bit for bit")
        out[w] = {"u_rel_err": u_err, "grad_rel_err": g_err,
                  "max_abs_err": float(max((U_k - U_f).abs().max(), (g_k - g_f).abs().max()))}
    return out


def cgt_k7_check(build, cg, label, pot, q0: dict, eps, im: dict, dev, C: int, S: int,
                 staged: bool):
    """(ii) K7 on a traced density against its plain version on the card,
    from one state, the first C chains over S steps at L = N_LEAPFROG, on
    the kernel's own Philox stream (the same seed for both) or on staged
    noise; held by flip_check with the tolerances of phase_k7_check (ten
    times what a 1e-6 relative change of the start moves the plain draws
    and margins by; at most 1% of the chains, one at least, or three times
    the change's flips; the changed run is made only where the run does
    not already pass at the floors, ``decision_flips``).  The kernel's
    time over the same steps is taken beside the plain version's."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    q0 = {k: v[:C].contiguous() for k, v in q0.items()}
    eps = eps[:C].contiguous()
    noise = None
    if staged:
        g = torch.Generator(device=dev).manual_seed(51)
        noise = ([torch.randn((S, C) + cg._noise_shape(shape), generator=g, device=dev)
                  for _, shape, _ in pot.spec], torch.rand((S, C, 1), generator=g, device=dev))
    ms, res = timed(lambda: cg.chain_grid_hmc_run(
        pot, q0, 52, eps, im, {}, num_steps=S, num_leapfrog=N_LEAPFROG, block_chains=CG_BLOCK,
        steps_per_block=S, noise=noise, device=dev))
    rec = build.last_launch["chain_grid_hmc"]
    pk = dict(num_steps=S, num_leapfrog=N_LEAPFROG, noise=noise)
    plain_ms, plain = timed(lambda: cg.chain_grid_hmc_plain(pot, q0, 52, eps, im, **pk))
    torch.cuda.synchronize()
    draws_k, draws_p = flat_draws(res.draws), flat_draws(plain.result.draws)
    _, _, flipped, e = decision_flips(draws_k, pack_positions(q0), draws_p, plain.margin)
    n_flips = int(flipped.sum())
    pert = None
    if n_flips or e > 1e-5:
        gp = torch.Generator(device=dev).manual_seed(53)
        q_s = {k: v * (1.0 + 1e-6 * torch.randn(v.shape, generator=gp, device=dev))
               for k, v in q0.items()}
        pert = cg.chain_grid_hmc_plain(pot, q_s, 52, eps, im, **pk)
    limits, sp, n_pert = perturbed_limits(plain, pert, C)
    noise_name = "staged" if staged else "philox"
    err, _ = flip_check(f"K7 traced {label} ({noise_name}, {C} chains)", draws_k,
                        res.accept_rate, pack_positions(q0), draws_p, plain.margin,
                        plain.accepts, **limits)
    return {"noise": noise_name, "chains": C, "steps": S, "max_abs_err": err,
            "perturbed_spread": sp, "perturbed_flips": n_pert, "ms": ms, "plain_ms": plain_ms,
            "operands": rec.route, "launch": launch_keys(rec)}


def cgt_usage(build, compiled) -> dict:
    """nvcc seconds, registers, stack and spills of a traced density's K7
    unit (its ptxas log)."""
    name = build.chain_grid_name(compiled)
    kernels = ptxas_entries(build, name, lambda m: m if "chain_grid_kernel" in m else None)
    pick = lambda k: max((v.get(k, 0) for v in kernels.values()), default=None)  # noqa: E731
    return {"nvcc_s": build.SHAPE_BUILDS.get(name), "registers": pick("registers"),
            "spill_stores": pick("spill_stores"), "stack": pick("stack")}


def chain_grid_traced_path(build, cg, fp, dens_mod, problems, dev):
    """The traced phase of the chain-grid path, (i)-(iii) above: per model
    the group form against torch.func, launch counts from 0, K3's warmup,
    one cold and one timed K7 run and K4 run of the same steps from its
    adapted state (CUDA events), K7's acceptance in (0.6, 0.95), finite
    draws, its means within TRACED_SE standard errors of K4's (the
    mixture's means sorted), its ms beside its bound and K4's, its grid,
    nvcc seconds, registers and spills; K7 against its plain version at
    the timed geometry, and on staged noise on CGT_STAGED_MODELS."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions, unpack_draws

    out, launches = {}, {k: 0 for k in build.LAUNCHES}
    for label, (ld, start, pot) in problems.items():
        functor = cgt_functor_check(build, cg, label, ld, start, pot, dev)
        if label not in CGT_MODELS:
            out[label] = {"functor": pot.compiled.group_name, "D": pot.compiled.D,
                          "rows": pot.compiled.group_rows, "checks": functor}
            continue
        first = start(CG_CHAINS, 60)
        template = {k: v[0] for k, v in first.items()}
        density = dens_mod.device_density(ld, template).to(dev)
        spec, D = pot.spec, pot.compiled.D
        build.reset_launch_counts()
        qw, eps_c, im_c = fp.fused_warmup_run(density, pack_positions(first), 61, 0.1,
                                              num_warmup=CGT_WARMUP, block_chains=CG_CHAINS,
                                              device=dev)
        q_dict = unpack_draws(qw, spec)
        im_dict = {k: v[0] for k, v in unpack_draws(im_c[:1], spec).items()}

        def k7():
            return cg.chain_grid_hmc_run(pot, q_dict, 62, eps_c, im_dict, {},
                                         num_steps=CGT_SAMPLES, num_leapfrog=N_LEAPFROG,
                                         block_chains=CG_BLOCK, steps_per_block=CGT_SAMPLES,
                                         device=dev)

        def k4():
            return fp.fused_potential_hmc_run(density, qw, 62, eps_c, im_c,
                                              num_steps=CGT_SAMPLES, num_leapfrog=N_LEAPFROG,
                                              block_chains=CG_CHAINS,
                                              steps_per_block=CGT_SAMPLES, device=dev)

        t = time.perf_counter()
        k7()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        k7_ms, res7 = timed(k7)
        operands = build.last_launch["chain_grid_hmc"].route
        rec = launch_keys(build.last_launch["chain_grid_hmc"])
        k4()
        k4_ms, res4 = timed(k4)
        counts = dict(build.LAUNCHES)
        for k in ("fused_warmup", "chain_grid_hmc", "fused_potential_hmc"):
            check(counts[k] > 0, f"chain-grid traced {label} launched {k} {counts[k]} times")
        accept = float(res7.accept_rate)
        check(0.6 < accept < 0.95, f"chain-grid traced {label}: K7 acceptance {accept:.4f} in "
                                   f"(0.6, 0.95)")
        f7 = flat_draws(gated_draws(label, res7.draws))
        f4 = flat_draws(gated_draws(label, unpack_draws(res4.draws, spec)))
        check(bool(torch.isfinite(f7).all()) and tuple(f7.shape) == (CGT_SAMPLES, CG_CHAINS, D),
              f"chain-grid traced {label}: finite K7 draws of shape ({CGT_SAMPLES}, "
              f"{CG_CHAINS}, {D})")
        e7, e4 = ess(f7).double(), ess(f4).double()
        m7, m4 = f7.double().mean((0, 1)), f4.double().mean((0, 1))
        se = torch.sqrt(f7.double().var((0, 1)) / e7 + f4.double().var((0, 1)) / e4)
        z = float(((m7 - m4).abs() / se).max())
        check(z <= TRACED_SE, f"chain-grid traced {label}: K7 means within {z:.2f} standard "
                              f"errors of K4's from the same state (<= {TRACED_SE})")
        ev = cgt_least_flops(label)
        nf = pot.compiled.operands.numel()
        bound = bound_ms(CGT_SAMPLES * CG_CHAINS * D * 4 + CG_CHAINS * (2 * D + 2) * 4
                         + D * 4 + nf * 4,
                         CG_CHAINS * least_run_flops(ev, D, N_LEAPFROG, CGT_SAMPLES),
                         philox_calls(CGT_SAMPLES, CG_CHAINS, D))
        for k in launches:
            launches[k] += counts[k]
        out[label] = {
            "functor": pot.compiled.group_name, "D": D, "rows": pot.compiled.group_rows,
            "nodes": pot.compiled.nodes, "operand_floats": nf, "eval_flops": ev,
            "emitted_flops": pot.compiled.flops, "chains": CG_CHAINS, "warmup": CGT_WARMUP,
            "samples": CGT_SAMPLES, "leapfrog": N_LEAPFROG, "k7_cold_ms": cold * 1e3,
            "k7_ms": k7_ms, "k4_ms": k4_ms, "k4_functor": type(density).__name__,
            "bound_ms": bound[0], "bound_by": bound[1], "bound_share": bound[0] / k7_ms,
            "accept": accept, "k4_accept": float(res4.accept_rate), "max_z": z,
            "min_bulk_ess": float(e7.min()), "k4_min_bulk_ess": float(e4.min()),
            "k7_launch": rec, "operands": operands, **cgt_usage(build, pot.compiled),
            "checks": functor, "launches": counts,
            "k7_vs_plain": [cgt_k7_check(build, cg, label, pot, q_dict, eps_c, im_dict, dev,
                                         CG_CHAINS, CG_CHECK_STEPS, staged=False)]}
        if label in CGT_STAGED_MODELS:
            out[label]["k7_vs_plain"].append(cgt_k7_check(
                build, cg, label, pot, q_dict, eps_c, im_dict, dev, CGT_STAGED_CHAINS,
                CGT_STAGED_STEPS, staged=True))
        progress(f"chain-grid traced {label}: D = {D}, rows {pot.compiled.group_rows}, K7 "
                 f"{k7_ms:.3f} ms ({rec['lanes']} lanes, {rec['ctas']} CTAs; bound "
                 f"{bound[0]:.3f}, {100 * bound[0] / k7_ms:.1f}%) against K4's {k4_ms:.3f} "
                 f"({type(density).__name__}); accept {accept:.4f} (K4 "
                 f"{float(res4.accept_rate):.4f}), means within {z:.2f} SE; usage "
                 f"{cgt_usage(build, pot.compiled)}")
    return {"models": out, "launches": launches}


def cgt_cli_route(build, cli):
    """(iv) The CLI's chain-grid route, ``cli.main(["--model", "polynomial",
    "--algorithm", "chain-grid"])`` at its defaults (256 chains, 500 K7
    steps) but for its eager warmup (CGT_CLI_WARMUP steps), in this process
    (cli_path runs ``python -m binf_tpu_torch`` in a process of its own),
    beside ``cli.main`` of the fused route at its defaults
    (``--warmup-mode fused``): each variable's means within TRACED_SE
    standard errors (std / sqrt(bulk ESS) of both summaries)."""
    argv = ["--model", "polynomial", "--algorithm", "chain-grid", "--warmup",
            str(CGT_CLI_WARMUP)]
    build.reset_launch_counts()
    t = time.perf_counter()
    cg_out = cli.main(argv)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    check(build.LAUNCHES["chain_grid_hmc"] == 1,
          f"chain-grid traced CLI: {' '.join(argv)} launched K7 "
          f"{build.LAUNCHES['chain_grid_hmc']} times")
    fused = cli.main(["--model", "polynomial", "--algorithm", "fused", "--warmup-mode", "fused"])
    torch.cuda.synchronize()
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    z = {}
    for name, s in cg_out["summary"].items():
        f = fused["summary"][name]
        for j, (a, b) in enumerate(zip(np.atleast_1d(s["mean"]), np.atleast_1d(f["mean"]))):
            se = np.sqrt(np.atleast_1d(s["std"])[j] ** 2 / np.atleast_1d(s["ess"])[j]
                         + np.atleast_1d(f["std"])[j] ** 2 / np.atleast_1d(f["ess"])[j])
            z[f"{name}[{j}]"] = float(abs(a - b) / se)
    worst = max(z.values())
    check(cg_out["algorithm"] == "chain-grid" and 0.6 < cg_out["accept_rate"] < 0.95
          and worst <= TRACED_SE,
          f"chain-grid traced CLI: acceptance {cg_out['accept_rate']} in (0.6, 0.95), means "
          f"within {worst:.2f} standard errors of the fused route's (<= {TRACED_SE})")
    progress(f"chain-grid traced CLI: {wall:.0f} ms (elapsed_sec {cg_out['elapsed_sec']}), "
             f"accept {cg_out['accept_rate']}, z {z}")
    return {"argv": argv, "warmup_cut": [CGT_CLI_WARMUP_PUBLISHED, CGT_CLI_WARMUP],
            "wall_ms": wall, "elapsed_sec": cg_out["elapsed_sec"],
            "accept_rate": cg_out["accept_rate"], "max_z": worst, "z": z,
            "fused_elapsed_sec": fused["elapsed_sec"], "launches": launched}


def cgt_branch(t: dict) -> dict:
    """A traced density's K7 row for the ``kernels`` line: its launches on
    the path, ms beside its bound (the function's least operations) and
    K4's ms on the same steps, the group form's error against torch.func
    and K7's against its plain version, the plain version's ms and K7's
    over the check's steps (at the timed geometry), its grid, whether its
    operands were staged, nvcc seconds, registers and spills."""
    row = {"functor": t["functor"], "rows": t["rows"], "launches":
           t["launches"]["chain_grid_hmc"], "ms": t["k7_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "bound_share": t["bound_share"], "k4_ms": t["k4_ms"],
           "k4_functor": t["k4_functor"], "eval_flops": t["eval_flops"],
           "emitted_flops": t["emitted_flops"],
           "max_abs_err": max(v["max_abs_err"] for w, v in t["checks"].items()
                              if w != "points"),
           "nvcc_s": t["nvcc_s"], "registers": t["registers"],
           "spill_stores": t["spill_stores"], **t["k7_launch"]}
    timed_check = t["k7_vs_plain"][0]
    row.update(operands=t["operands"],
               k7_vs_plain_max_abs_err=max(c["max_abs_err"] for c in t["k7_vs_plain"]),
               plain_ms=timed_check["plain_ms"], plain_steps=timed_check["steps"],
               check_ms=timed_check["ms"])
    return row


# -- this slice: traced densities past 32 coordinates, the wide branches -------------

# the wide phase: (a) the hierarchical posterior of WIDE_GROUPS groups (D =
# 69: example/hierarchical.py's data at synthetic_hierarchical_data(gen,
# 32), 15 points a group, the precision under LogTransform), which only the
# density compiler's wide form takes, through adaptive_hmc(algorithm="auto",
# warmup="fused") at each of WIDE_CHAINS (WIDE_WARMUP + WIDE_SAMPLES steps,
# L = N_LEAPFROG) beside an eager run (WIDE_REF_*), one ChEES run, and
# run_fused_blocks resumed from block 2 of WIDE_BLOCKS; (b) a 256-D
# Gaussian callable (means N(0, 1) from seed 0, scales log-spaced 0.1 to
# 10) through fused_model_hmc(warmup="fused") at WIDE_GAUSS_CHAINS chains;
# (c) on both: the wide functor at TRACED_EVAL_POINTS points against
# torch.func; K3 (fixed, ChEES), K4 (diagonal, dense, ChEES; moments,
# thinning and resume bit for bit) and K7 against their plain versions on
# staged noise (WIDE_STAGED) and on the kernels' Philox streams (WIDE_PHILOX)
# with the traced K7 check's flip limits, K3 one step at a time over
# WIDE_K3_STEPS (its own limits); K3 fixed over WIDE_WARMUP steps
# at WIDE_CG_CHAINS chains, then WIDE_SAMPLES steps in K7 and in K4 from
# that state, timed (chain_grid_model_hmc on a wide form: the wider phase's,
# at 128 groups)
WIDE_GROUPS = 32
WIDE_CHAINS = (1024, 8192)
WIDE_WARMUP, WIDE_SAMPLES = 400, 500
WIDE_REF_CHAINS, WIDE_REF_WARMUP, WIDE_REF_SAMPLES = 512, 100, 100
WIDE_SE = 5.0
WIDE_GAUSS_D, WIDE_GAUSS_CHAINS, WIDE_GAUSS_SD_TOL = 256, 2048, 0.1
WIDE_STAGED, WIDE_PHILOX = (64, 20), (2048, 10)
# K3's checks, one step at a time on both streams: 20 steps, the fewest
# whose final buffer (two steps) follows the last window boundary; each
# step's state within WIDE_K3_STEP_TOL (on the CPU a 1e-6 relative change
# of the state moves one plain step's by at most 5e-5), the outputs within
# WIDE_K3_OUT_TOL of the state's, rounding's reach WIDE_K3_REACH
WIDE_K3_STEPS = 20
WIDE_K3_STEP_TOL, WIDE_K3_OUT_TOL, WIDE_K3_REACH = 1e-4, 1e-5, 1e-3
WIDE_BLOCKS = 4
WIDE_CG_CHAINS = 2048
WIDE_CHEES_LEAP = 64
WIDE_K3_CHEES_LEAP = 16  # K3's ChEES checks: shorter plain trajectories


def wide_problems(dens_mod, cg, dev):
    """label -> (log density, start(C, seed), least flops an evaluation,
    TracedDensity, TracedPotential) of the wide phase's two models,
    compiled now, for phase_build's one nvcc batch."""
    ld_h = hierarchical_problem(dev, 1, groups=WIDE_GROUPS)[0]

    def start_h(C, seed):
        return hierarchical_problem(dev, C, seed, groups=WIDE_GROUPS)[2]

    mean, scale = wide_gauss_truth(dev)

    def ld_g(p):
        return -0.5 * torch.sum(((p["x"] - mean) / scale) ** 2)

    def start_g(C, seed):
        g = torch.Generator().manual_seed(seed)
        return {"x": (0.5 * torch.randn((C, WIDE_GAUSS_D), generator=g)).to(dev)}

    out = {}
    for label, ld, start, flops in (
            ("hierarchical32", ld_h, start_h, hierarchical_eval_flops(15, WIDE_GROUPS)),
            ("gauss256", ld_g, start_g, diag_eval_flops(WIDE_GAUSS_D))):
        template = {k: v[0] for k, v in start(1, 0).items()}
        density = dens_mod.device_density(ld, template).to(dev)
        pot = cg.chain_grid_potential_from_scalar(ld, template)[0]
        check(isinstance(density, dens_mod.TracedDensity) and density.wide
              and isinstance(pot, cg.TracedPotential) and pot.compiled.key == density.key,
              f"wide {label}: the density compiler's wide form ({type(density).__name__}, "
              f"D = {density.D})")
        out[label] = (ld, start, flops, density, pot)
    return out


def wide_gauss_truth(dev, D=WIDE_GAUSS_D):
    """The D-dimensional Gaussian's means (N(0, 1), seed 0) and scales
    (log-spaced 0.1 to 10): the 256-D one, or the wider phase's 1,024-D."""
    mean = torch.randn(D, generator=torch.Generator().manual_seed(0))
    return mean.to(dev), torch.logspace(-1, 1, D).to(dev)


def wide_shapes(problems, fp):
    """K3's and K4's wide units (at the lanes a chain K3 and K4 take, 32
    W) and K7's unit of each model."""
    shapes = [(6, d.D, fp.lanes_for(d), d.compiled) for _, _, _, d, _ in problems.values()]
    return shapes, [p.compiled for *_, p in problems.values()]


def wide_usage(build, fp, density) -> dict:
    """nvcc seconds, registers, stack and spills of a wide density's K3,
    K4 and K7 units (their ptxas logs), each kernel apart."""
    names = build.shape_names(6, density.D, fp.lanes_for(density), density.compiled)
    out = {"nvcc_s": build.SHAPE_BUILDS.get(names[0].split(".", 1)[1]),
           "k7_nvcc_s": build.SHAPE_BUILDS.get(build.chain_grid_name(density.compiled))}
    for stem, k, pick in ((names[0], "k3", "wide_warmup_kernel"),
                          (names[1], "k4", "wide_potential_kernel"),
                          (names[1], "eval", "wide_eval_kernel"),
                          (build.chain_grid_name(density.compiled), "k7", "chain_grid_kernel")):
        entries = ptxas_entries(build, stem, lambda m, p=pick: m if p in m else None)
        out[k] = {m[-60:]: v for m, v in entries.items()}
    return out


def wide_run(auto, ld, start, seed, dev, algorithm="auto", warmup=WIDE_WARMUP,
             samples=WIDE_SAMPLES, **kw):
    if algorithm != "xla":
        kw.setdefault("warmup", "fused")
    return auto.adaptive_hmc(ld, start, seed, num_warmup=warmup, num_samples=samples,
                             num_leapfrog=N_LEAPFROG, initial_step_size=0.1,
                             algorithm=algorithm, device=dev, **kw)


def wide_z(flat, ess_f, ref_flat, ess_r, cols):
    """The largest distance of two runs' means over columns ``cols`` in
    Monte Carlo standard errors (each std / sqrt(bulk ESS))."""
    a, b = flat[..., cols].double(), ref_flat[..., cols].double()
    se = torch.sqrt(a.var((0, 1)) / ess_f[cols] + b.var((0, 1)) / ess_r[cols])
    return float(((a.mean((0, 1)) - b.mean((0, 1))).abs() / se).max())


# the hierarchical runs of the wide phase (PR 19) and of the wider one:
# groups, adaptive_hmc's chain counts, the eager reference's chains, warmup
# and samples, the means' bound in standard errors, and the dense eager
# warmup's steps (None: no dense run)
WIDE_HIER = dict(groups=WIDE_GROUPS, chains=WIDE_CHAINS,
                 ref=(WIDE_REF_CHAINS, WIDE_REF_WARMUP, WIDE_REF_SAMPLES), se=WIDE_SE,
                 dense_warmup=None)


def wide_hierarchical(build, fp, auto, production, prob, dev, cfg=WIDE_HIER,
                      fused_model_hmc=None):
    """(a): the router's decision and adaptive_hmc at each of the chain
    counts, each against one eager run; a ChEES run; with a dense warmup,
    fused_model_hmc(warmup="dense"); run_fused_blocks resumed."""
    import os
    import tempfile

    from binf_tpu_torch.diagnostics import ess

    ld, start_fn, flops, density, _ = prob
    D = density.D
    G, se_max = cfg["groups"], cfg["se"]
    label = f"wide hierarchical{G}"
    W = fp.wide_warps(D)
    hyper = list(range(2 * G, D))  # log_tau, mu, precision (sorted names)
    ref_chains, ref_warmup, ref_samples = cfg["ref"]
    ref_start = start_fn(ref_chains, 103)
    t = time.perf_counter()
    ref, dec_ref = wide_run(auto, ld, ref_start, 104, dev, algorithm="xla",
                            warmup=ref_warmup, samples=ref_samples)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t
    ref_flat = flat_draws(ref.samples)
    ess_r = ess(ref_flat).double()
    eager = {"chains": ref_chains, "warmup": ref_warmup, "samples": ref_samples,
             "reason": dec_ref.reason, "e2e_ms": ref_wall * 1e3,
             "accept": float(ref.accept_rate), "min_bulk_ess": float(ess_r.min()),
             "ess_per_s": float(ess_r.min()) / ref_wall}
    progress(f"{label} eager ({ref_chains} chains, {ref_warmup} + {ref_samples}): "
             f"{ref_wall * 1e3:.0f} ms, accept {eager['accept']:.4f}, "
             f"ESS/s {eager['ess_per_s']:.4g}")
    out, launches = {}, {k: 0 for k in build.LAUNCHES}
    for C in cfg["chains"]:
        start = start_fn(C, 100)
        dec = auto.route_algorithm(ld, start)
        check(dec.path == "fused" and "TracedDensity" in dec.reason and dec.d == D,
              f"{label} at {C} chains: the router sends it to {dec.path} "
              f"({dec.reason}, D = {dec.d})")
        build.reset_launch_counts()
        t = time.perf_counter()
        wide_run(auto, ld, start, 101, dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res, dec_run = wide_run(auto, ld, start, 102, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = dict(build.LAUNCHES)
        for k in ("philox", "fused_warmup", "fused_potential_hmc"):
            check(counts[k] > 0, f"{label} at {C} chains launched {k} {counts[k]} times")
        warps = (build.last_launch["fused_warmup"].warps,
                 build.last_launch["fused_potential_hmc"].warps)
        check(dec_run.path == "fused" and warps == (W, W),
              f"{label} at {C} chains: adaptive_hmc ran {dec_run.path}, K3 and K4 at {warps} "
              f"warps a chain (W = {W})")
        accept = float(res.accept_rate)
        check(0.6 < accept < 0.95, f"{label} at {C} chains: acceptance "
                                   f"{accept:.4f} in (0.6, 0.95)")
        flat = flat_draws(res.samples)
        check(bool(torch.isfinite(flat).all()) and tuple(flat.shape) == (WIDE_SAMPLES, C, D),
              f"{label} at {C} chains: finite draws of shape ({WIDE_SAMPLES}, {C}, "
              f"{D})")
        ess_f = ess(flat).double()
        z = wide_z(flat, ess_f, ref_flat, ess_r, hyper)
        check(z <= se_max, f"{label} at {C} chains: mu, log_tau and precision means within "
                           f"{z:.2f} standard errors of the eager run's (<= {se_max})")
        m_ess = float(ess_f.min())
        k3_b, k4_b = traced_bounds(flops, D, C, WIDE_WARMUP, WIDE_SAMPLES)
        for k in launches:
            launches[k] += counts[k]
        out[C] = {"route": dec.reason, "chains": C, "warmup": WIDE_WARMUP,
                  "samples": WIDE_SAMPLES, "leapfrog": N_LEAPFROG, "cold_ms": cold * 1e3,
                  "e2e_ms": wall * 1e3, "k3_ms": spans.ms("warmup"),
                  "k4_ms": spans.ms("sampling"), "k3_bound_ms": k3_b[0],
                  "k3_bound_by": k3_b[1], "k4_bound_ms": k4_b[0], "k4_bound_by": k4_b[1],
                  "accept": accept, "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall,
                  "max_z": z, "k3_launch": launch_keys(build.last_launch["fused_warmup"]),
                  "k4_launch": launch_keys(build.last_launch["fused_potential_hmc"]),
                  "launches": counts}
        progress(f"{label} at {C} chains: e2e {wall * 1e3:.1f} ms (cold "
                 f"{cold * 1e3:.0f}), K3 {out[C]['k3_ms']:.2f} ms (bound {k3_b[0]:.3f}), K4 "
                 f"{out[C]['k4_ms']:.2f} ms (bound {k4_b[0]:.3f}), accept {accept:.4f}, "
                 f"min bulk ESS {m_ess:.1f}, ESS/s {m_ess / wall:.4g} against the eager run's "
                 f"{eager['ess_per_s']:.4g}; hyperparameter means within {z:.2f} SE")
    # one ChEES run at the first chain count
    C = cfg["chains"][0]
    start = start_fn(C, 100)
    build.reset_launch_counts()
    with LaunchSpans(fp) as spans:
        t = time.perf_counter()
        res, _ = wide_run(auto, ld, start, 105, dev, trajectory="chees",
                          max_leapfrog=WIDE_CHEES_LEAP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = dict(build.LAUNCHES)
    check(counts["fused_warmup"] > 0 and counts["fused_potential_hmc"] > 0,
          f"{label} ChEES launched K3 and K4")
    accept = float(res.accept_rate)
    flat = flat_draws(res.samples)
    ess_c = ess(flat).double()
    z = wide_z(flat, ess_c, ref_flat, ess_r, hyper)
    check(0.45 < accept < 0.95 and bool(torch.isfinite(flat).all()) and z <= se_max,
          f"{label} ChEES at {C} chains: acceptance {accept:.4f} in (0.45, 0.95), "
          f"finite draws, hyperparameter means within {z:.2f} SE of the eager run's")
    for k in launches:
        launches[k] += counts[k]
    chees = {"chains": C, "e2e_ms": wall * 1e3, "k3_ms": spans.ms("warmup"),
             "k4_ms": spans.ms("sampling"), "accept": accept, "max_z": z,
             "min_bulk_ess": float(ess_c.min()),
             "mean_leapfrog": {k: float(v.float().mean()) for k, v in spans.counts.items()},
             "launches": counts}
    progress(f"{label} ChEES: e2e {wall * 1e3:.1f} ms, K3 {chees['k3_ms']:.2f} ms, "
             f"K4 {chees['k4_ms']:.2f} ms, accept {accept:.4f}, mean leapfrog counts "
             f"{chees['mean_leapfrog']}")
    dense = None
    if cfg["dense_warmup"] is not None:
        # fused_model_hmc with the dense eager warmup, then K4's dense metric
        # (read from device memory) at W warps a chain
        build.reset_launch_counts()
        t = time.perf_counter()
        res = fused_model_hmc(ld, start, 106, num_warmup=cfg["dense_warmup"],
                              num_samples=WIDE_SAMPLES, num_leapfrog=N_LEAPFROG,
                              initial_step_size=0.1, warmup="dense", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(build.LAUNCHES)
        rec = build.last_launch["fused_potential_hmc"]
        accept = float(res.accept_rate)
        flat = flat_draws(res.samples)
        z = wide_z(flat, ess(flat).double(), ref_flat, ess_r, hyper)
        # the short warmup leaves the step size below its target (acceptance
        # 0.99 at 60 steps), so the gate is the draws' agreement
        check(counts["fused_potential_hmc"] == 1 and rec.warps == W
              and tuple(res.inverse_mass.shape) == (D, D) and 0.3 < accept < 1.0
              and bool(torch.isfinite(flat).all()) and z <= se_max,
              f"{label} dense at {C} chains ({cfg['dense_warmup']} eager warmup steps): K4 "
              f"launched {counts['fused_potential_hmc']} time(s) at {rec.warps} warps a chain "
              f"with a ({D}, {D}) metric, acceptance {accept:.4f} in (0.3, 1), finite draws, "
              f"hyperparameter means within {z:.2f} SE of the eager run's (<= {se_max})")
        for k in launches:
            launches[k] += counts[k]
        dense = {"chains": C, "warmup": cfg["dense_warmup"], "e2e_ms": wall * 1e3,
                 "accept": accept, "max_z": z, "launch": launch_keys(rec), "launches": counts}
        progress(f"{label} dense: e2e {wall * 1e3:.1f} ms, accept {accept:.4f}, hyperparameter "
                 f"means {z:.2f} SE from the eager run's")
    # run_fused_blocks: WIDE_BLOCKS K4 blocks, resumed from block 2 bit for bit
    block = WIDE_SAMPLES // WIDE_BLOCKS
    kw = dict(num_steps=WIDE_BLOCKS * block, block_size=block, num_warmup=WIDE_WARMUP,
              num_leapfrog=N_LEAPFROG, initial_step_size=0.1, block_chains=C, warmup="fused",
              device=dev)
    run = production.run_fused_blocks
    build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path, half = os.path.join(tmp, "run.pt"), os.path.join(tmp, "half.pt")
        full = run(ld, start, 11, checkpoint_path=path, checkpoint_every_blocks=1, **kw)
        first = run(ld, start, 11, checkpoint_path=half, checkpoint_every_blocks=2,
                    **dict(kw, num_steps=2 * block))
        resumed = run(ld, start, 11, checkpoint_path=half, resume=True, **kw)
    counts = dict(build.LAUNCHES)
    check(int(first.carry.block) == 2 and int(resumed.carry.block) == WIDE_BLOCKS
          and all(torch.equal(getattr(full.carry, f), getattr(resumed.carry, f))
                  for f in ("positions", "mean", "m2", "count"))
          and counts["fused_potential_hmc"] == 2 * WIDE_BLOCKS,
          f"{label} run_fused_blocks: resumed from block 2 of {WIDE_BLOCKS}, it "
          f"ends where the uninterrupted run ends (positions, Welford mean, M2 and count bit "
          f"for bit; {counts['fused_potential_hmc']} K4 launches)")
    for k in launches:
        launches[k] += counts[k]
    return {"runs": out, "eager": eager, "chees": chees, "dense": dense,
            "blocks": {"chains": C, "blocks": WIDE_BLOCKS, "block_steps": block,
                       "accept": float(full.accept_rate), "resume_bitwise": True,
                       "launches": counts},
            "launches": launches}


def wide_gauss(build, fp, fused_model_hmc, prob, dev):
    """(b): the 256-D Gaussian through fused_model_hmc(warmup="fused"): its
    means within WIDE_SE standard errors of the truth, its standard
    deviations within WIDE_GAUSS_SD_TOL; K3 and K4 timed."""
    from binf_tpu_torch.diagnostics import ess

    ld, start_fn, flops, density, _ = prob
    C, D = WIDE_GAUSS_CHAINS, WIDE_GAUSS_D
    start = start_fn(C, 110)
    kw = dict(num_warmup=WIDE_WARMUP, num_samples=WIDE_SAMPLES, num_leapfrog=N_LEAPFROG,
              initial_step_size=0.1, warmup="fused", device=dev)
    build.reset_launch_counts()
    t = time.perf_counter()
    fused_model_hmc(ld, start, 111, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    with LaunchSpans(fp) as spans:
        t = time.perf_counter()
        res = fused_model_hmc(ld, start, 112, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = dict(build.LAUNCHES)
    check(counts["fused_warmup"] > 0 and counts["fused_potential_hmc"] > 0
          and build.last_launch["fused_potential_hmc"].lanes == 32,
          f"wide gauss256 launched K3 {counts['fused_warmup']} and K4 "
          f"{counts['fused_potential_hmc']} times, a warp a chain")
    x = res.samples["x"]
    check(bool(torch.isfinite(x).all()) and tuple(x.shape) == (WIDE_SAMPLES, C, D),
          f"wide gauss256: finite draws of shape ({WIDE_SAMPLES}, {C}, {D})")
    mean, scale = wide_gauss_truth(dev)
    e = ess(x).double()
    xd = x.double()
    z = float(((xd.mean((0, 1)) - mean.double()).abs() / (xd.std((0, 1)) / e.sqrt())).max())
    sd_err = float((xd.std((0, 1)) / scale.double() - 1.0).abs().max())
    accept = float(res.accept_rate)
    check(z <= WIDE_SE and sd_err <= WIDE_GAUSS_SD_TOL and 0.6 < accept < 0.95,
          f"wide gauss256: means within {z:.2f} standard errors of the truth (<= {WIDE_SE}), "
          f"standard deviations within {100 * sd_err:.1f}% (<= {100 * WIDE_GAUSS_SD_TOL:.0f}%), "
          f"acceptance {accept:.4f} in (0.6, 0.95)")
    k3_b, k4_b = traced_bounds(flops, D, C, WIDE_WARMUP, WIDE_SAMPLES)
    out = {"chains": C, "warmup": WIDE_WARMUP, "samples": WIDE_SAMPLES, "leapfrog": N_LEAPFROG,
           "cold_ms": cold * 1e3, "e2e_ms": wall * 1e3, "k3_ms": spans.ms("warmup"),
           "k4_ms": spans.ms("sampling"), "k3_bound_ms": k3_b[0], "k3_bound_by": k3_b[1],
           "k4_bound_ms": k4_b[0], "k4_bound_by": k4_b[1], "accept": accept, "max_z": z,
           "sd_rel_err": sd_err, "min_bulk_ess": float(e.min()),
           "ess_per_s": float(e.min()) / wall, "step_size": float(res.step_size.mean()),
           "k3_launch": launch_keys(build.last_launch["fused_warmup"]),
           "k4_launch": launch_keys(build.last_launch["fused_potential_hmc"]),
           "launches": counts}
    progress(f"wide gauss256 at {C} chains: e2e {wall * 1e3:.1f} ms (cold {cold * 1e3:.0f}), K3 "
             f"{out['k3_ms']:.2f} ms (bound {k3_b[0]:.3f}), K4 {out['k4_ms']:.2f} ms (bound "
             f"{k4_b[0]:.3f}), accept {accept:.4f}, means within {z:.2f} SE, sds within "
             f"{100 * sd_err:.2f}%, min bulk ESS {float(e.min()):.1f}")
    return out


def wide_perturbed(q, seed):
    """``q`` moved by a relative 1e-6 (normal from ``seed``)."""
    g = torch.Generator(device=q.device).manual_seed(seed)
    return q * (1.0 + 1e-6 * torch.randn(q.shape, generator=g, device=q.device))


def wide_noise(C, S, D, dev, seed):
    """Staged noise in the JAX host-noise layout: (S, d_pad, C), (S, 1, C)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d_pad = (D + 7) // 8 * 8
    return (torch.randn((S, d_pad, C), generator=g, device=dev),
            torch.rand((S, 1, C), generator=g, device=dev))


def wide_k4_check(build, label, fp, density, q0, eps, im, dev, C, S, staged, variant):
    """K4's wide branch against its plain version from one state, the first
    C chains over S steps at L = N_LEAPFROG, on staged noise or the kernel's
    Philox stream (the same seed for both): ``variant`` "diag" (per-chain
    step sizes and metric), "dense" (a (D, D) metric of the pooled diagonal
    with correlation 0.1, read from device memory) or "chees" (a T per
    32-chain tile, the leapfrog counts held by leap_flip_check); held by
    flip_check with cgt_k7_check's limits (ten times what a 1e-6 relative change
    of the start moves the plain draws and margins by; at most 1% of the
    chains, one at least, or three times the change's flips; the changed
    run only where the run does not pass at the floors).  On the
    Philox stream the diagonal run also holds thinning, the in-kernel
    moments and resume bit for bit against itself."""
    q0, eps, im = q0[:C].contiguous(), eps[:C].contiguous(), im[:C].contiguous()
    D = q0.shape[1]
    bc = 32
    kw = dict(num_steps=S, num_leapfrog=N_LEAPFROG, block_chains=bc)
    metric = im
    if variant == "dense":
        v = im.mean(0).sqrt()
        R = 0.9 * torch.eye(D, device=dev) + 0.1 * torch.ones((D, D), device=dev)
        metric = (v[:, None] * R * v[None, :]).contiguous()
        kw.update(dense_mass=True)
    counts = None
    if variant == "chees":
        tiles = C // bc
        T = (eps[::bc] * torch.linspace(4.0, 12.0, tiles, device=dev)).repeat_interleave(bc)
        counts = [torch.zeros((S, tiles), dtype=torch.int32, device=dev) for _ in range(2)]
        kw.update(trajectory="chees", traj_length=T, max_leapfrog=WIDE_CHEES_LEAP)
    noise = wide_noise(C, S, D, dev, 41) if staged else None
    ms, res = timed(lambda: fp.fused_potential_hmc_run(
        density, q0, 42, eps, metric, steps_per_block=S, noise=noise,
        leapfrog_counts=None if counts is None else counts[0], device=dev, **kw))
    rec = launch_keys(build.last_launch["fused_potential_hmc"])
    pk = dict(kw, noise=noise)
    plain_ms, plain = timed(lambda: fp.fused_potential_hmc_plain(
        density, q0, 42, eps, metric, leapfrog_counts=None if counts is None else counts[1],
        **pk))
    torch.cuda.synchronize()
    if counts is not None:
        _, args = fp.chees_leapfrog_counts(kw["traj_length"][::bc], eps[::bc], S,
                                           WIDE_CHEES_LEAP)
        leap_flip_check(f"wide K4 {label} ChEES", counts[0], counts[1], args)
    _, _, flipped, e = decision_flips(res.draws, q0, plain.result.draws, plain.margin)
    n_flips = int(flipped.sum())
    pert = None
    if n_flips or e > 1e-5:
        pert = fp.fused_potential_hmc_plain(density, wide_perturbed(q0, 43), 42, eps, metric,
                                            **pk)
    limits, sp, n_pert = perturbed_limits(plain, pert, C)
    noise_name = "staged" if staged else "philox"
    err, _ = flip_check(f"wide K4 {label} {variant} ({noise_name}, {C} chains)", res.draws,
                        res.accept_rate, q0, plain.result.draws, plain.margin, plain.accepts,
                        **limits)
    out = {"variant": variant, "noise": noise_name, "chains": C, "steps": S,
           "max_abs_err": err, "perturbed_spread": sp, "perturbed_flips": n_pert, "ms": ms,
           "plain_ms": plain_ms, "launch": rec}
    if variant == "diag" and not staged:
        base = dict(kw, steps_per_block=S, device=dev)
        thin = fp.fused_potential_hmc_run(density, q0, 42, eps, im, thin=2, **base)
        mom = fp.fused_potential_hmc_run(density, q0, 42, eps, im, collect="moments", **base)
        half = dict(base, num_steps=S // 2, steps_per_block=S // 2)
        a = fp.fused_potential_hmc_run(density, q0, 42, eps, im, **half)
        b = fp.fused_potential_hmc_run(density, a.final_positions, 42, eps, im, block_offset=1,
                                       **half)
        torch.cuda.synchronize()
        m_err = float((mom.mean - res.draws.mean(0)).abs().max())
        v_ref = res.draws.var(0)
        v_err = float(((mom.variance - v_ref).abs() / v_ref.clamp_min(1e-12)).max())
        check(torch.equal(thin.draws, res.draws[1::2])
              and torch.equal(torch.cat([a.draws, b.draws]), res.draws)
              and torch.equal(b.final_positions, res.final_positions)
              and torch.equal(mom.final_positions, res.final_positions)
              and m_err <= 1e-4 * float(res.draws.abs().max()) and v_err <= 1e-3,
              f"wide K4 {label}: thin=2 every second state, resume with block_offset one "
              f"call, bit for bit; in-kernel moments within {m_err:.3g} and {v_err:.3g} "
              f"relative of the run's draws")
        out.update(thin_bitwise=True, resume_bitwise=True, moments_mean_err=m_err,
                   moments_var_rel_err=v_err)
    return out


def wide_k3_check(build, label, fp, density, q0, dev, C, S, staged, chees):
    """K3's wide branch against its plain version from the start q0, the
    first C chains over S warmup steps in two tiles of C // 2 chains (no
    search: the step size from 0.1), on staged noise or the kernel's
    Philox stream, one step at a time (fused_potential.wide_warmup_stepwise):
    before each step the plain version restarts from the kernel's state
    (positions, dual averaging, Welford sums, metric, ChEES's T and Adam),
    so the pooled warmup's float32 chaos cannot grow between them, and
    after it every part of the state agrees within WIDE_K3_STEP_TOL (the
    positions and the Welford mean over their scale, M2, the metric and
    the adaptation's scalars relative; the counts exactly; the scalars
    within WIDE_K3_STEP_TOL x max(1, D / 1,024): they follow the chains'
    acceptance from E0 - E1, a difference of energies ~D / 2 whose float32
    spacing grows with D, amplified by dual averaging's sqrt(t) / 0.05).  A decision or
    a ChEES leapfrog count within WIDE_K3_REACH of rounding is followed
    the kernel's way; a count that differs beyond it fails.  At S =
    WIDE_K3_STEPS the last window boundary comes two steps before the end,
    so the final buffer re-adapts the step size under the final metric."""
    q0 = q0[:C].contiguous()
    D = q0.shape[1]
    bc = C // 2
    kw = dict(num_warmup=S, num_leapfrog=N_LEAPFROG, block_chains=bc)
    if chees:
        kw.update(trajectory="chees", max_leapfrog=WIDE_K3_CHEES_LEAP, target_accept=0.651)
    noise = wide_noise(C, S, D, dev, 44) if staged else None
    ms, out_k = timed(lambda: fp.fused_warmup_run(density, q0, 45, 0.1, noise=noise,
                                                  device=dev, **kw))
    rec = launch_keys(build.last_launch["fused_warmup"])
    plain_ms, out_p = timed(lambda: fp.fused_warmup_plain(
        density, q0, 45, 0.1, init_search=False, noise=noise,
        **dict(kw, target_accept=kw.get("target_accept", 0.8))))
    steps = fp.wide_warmup_stepwise(density, q0, 45, 0.1, noise=noise, reach=WIDE_K3_REACH,
                                    **kw)
    torch.cuda.synchronize()
    parts = ("q", "mean", "m2", "im", "scalars")
    worst = {k: max(r[k] for r in steps) for k in parts}
    out = steps[-1]["out"]
    followed = sum(r["followed"] for r in steps)
    off = sum(r["counts_off"] for r in steps)
    name = f"wide K3 {label} {'ChEES' if chees else 'fixed'} ({'staged' if staged else 'philox'}" \
           f", {C} chains, {S} steps)"
    tol = {k: WIDE_K3_STEP_TOL * (max(1.0, D / 1024) if k == "scalars" else 1.0) for k in parts}
    check(all(worst[k] <= tol[k] for k in parts) and off == 0
          and all(v <= WIDE_K3_OUT_TOL for v in out.values()),
          f"{name}: one step at a time from the kernel's state, the plain version's state "
          f"within {WIDE_K3_STEP_TOL:g} at every step (the scalars {tol['scalars']:g}; "
          f"{', '.join(f'{k} {v:.3g}' for k, v in worst.items())}; "
          f"{followed} decisions or counts within {WIDE_K3_REACH:g} of rounding followed, "
          f"{off} counts apart beyond it); the outputs within {WIDE_K3_OUT_TOL:g} of its ending "
          f"on the kernel's state ({out})")
    # the whole runs for the record: apart by the chaos the steps above exclude
    err = max(r["q_abs"] for r in steps)
    progress(f"{name}: eps kernel {out_k[1][::bc].tolist()}, the plain version's whole run "
             f"{out_p[1][::bc].tolist()}")
    return {"trajectory": "chees" if chees else "fixed", "noise": "staged" if staged else
            "philox", "chains": C, "steps": S, "max_abs_err": err, "step_worst": worst,
            "out": out, "followed": followed, "ms": ms, "plain_ms": plain_ms, "launch": rec}


# the checks against the plain versions, in order: (kernel, variant,
# (chains, steps), staged noise); K3's steps are WIDE_K3_STEPS
WIDE_PLAN = tuple(
    check for shape, staged in ((WIDE_STAGED, True), (WIDE_PHILOX, False))
    for check in ([("k4", v, shape, staged) for v in ("diag", "dense", "chees")]
                  + [("k3", t, (shape[0], WIDE_K3_STEPS), staged) for t in ("fixed", "chees")]
                  + [("k7", None, shape, staged)]))


def moment_stats(mean, var):
    """A run's per-chain Welford moments (C, D) pooled over its chains: the
    grand means, their standard errors (the chains' means' spread over
    sqrt(C): independent chains), and the pooled standard deviations."""
    m, v = mean.double(), var.double()
    grand = m.mean(0)
    se = m.std(0) / math.sqrt(m.shape[0])
    sd = torch.sqrt(v.mean(0) + m.var(0, unbiased=False))
    return grand, se, sd


def wide_kernels(build, fp, dens_mod, cg, label, prob, dev, chains=WIDE_CG_CHAINS,
                 plan=WIDE_PLAN, truth=None, tile=None, samples=WIDE_SAMPLES,
                 leapfrog=N_LEAPFROG):
    """(c) on one model: the functor; K3 fixed over WIDE_WARMUP steps at
    ``chains`` chains (in tiles of ``tile``, all of them by default), then
    ``samples`` steps in K7 and in K4 from its adapted state (the first
    chain's metric), each timed, all at L = ``leapfrog`` (K7's means within
    WIDE_SE standard errors of K4's); K3, K4 and K7 against their plain
    versions at L = N_LEAPFROG as ``plan`` lists them.  With ``truth`` (a
    Gaussian's means and scales) K7 and K4 keep in-kernel moments instead
    of draws, their means are held to the truth by truth_gate (and K7's to
    K4's) with the chains' means' spread as the standard error, and their
    standard deviations within WIDER_GAUSS_SD_TOL."""
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions, unpack_draws

    ld, start_fn, flops, density, pot = prob
    D, C = density.D, chains
    moments = truth is not None
    collect = "moments" if moments else "draws"
    first = start_fn(C, 60)
    build.reset_launch_counts()
    functor = traced_functor_check(f"wide {label}", dens_mod, density, ld, first, dev)
    q_start = pack_positions(first).contiguous()

    def k3():
        return fp.fused_warmup_run(density, q_start, 61, 0.1, num_warmup=WIDE_WARMUP,
                                   num_leapfrog=leapfrog, block_chains=tile or C, device=dev)

    k3()
    k3_ms, (qw, eps_c, im_c) = timed(k3)
    k3_rec = launch_keys(build.last_launch["fused_warmup"])
    spec = pot.spec
    q_dict = unpack_draws(qw, spec)
    im_dict = {k: v[0] for k, v in unpack_draws(im_c[:1], spec).items()}

    def k7():
        return cg.chain_grid_hmc_run(pot, q_dict, 62, eps_c, im_dict, {}, num_steps=samples,
                                     num_leapfrog=leapfrog, block_chains=CG_BLOCK,
                                     steps_per_block=samples, collect=collect, device=dev)

    def k4():
        # K4 with the pooled metric K7 takes, the same state and steps
        return fp.fused_potential_hmc_run(density, qw, 62, eps_c, im_c[:1].expand(C, D),
                                          num_steps=samples, num_leapfrog=leapfrog,
                                          block_chains=C, steps_per_block=samples,
                                          collect=collect, device=dev)

    k7()
    k7_ms, res7 = timed(k7)
    k7_rec = launch_keys(build.last_launch["chain_grid_hmc"])
    k7_route = build.last_launch["chain_grid_hmc"].route
    k4()
    k4_ms, res4 = timed(k4)
    counts = dict(build.LAUNCHES)
    for k in ("fused_warmup", "chain_grid_hmc", "fused_potential_hmc", "density_eval"):
        check(counts[k] > 0, f"wide {label} launched {k} {counts[k]} times")
    extra = {}
    if moments:
        m7, v7 = pack_positions(res7.mean), pack_positions(res7.variance)
        finite = all(bool(torch.isfinite(t).all()) for t in (m7, v7, res4.mean, res4.variance))
        check(finite and tuple(m7.shape) == (C, D) and 0.6 < float(res7.accept_rate) < 0.95,
              f"wide {label}: finite K7 moments of shape ({C}, {D}), acceptance "
              f"{float(res7.accept_rate):.4f} in (0.6, 0.95)")
        g7, se7, sd7 = moment_stats(m7, v7)
        g4, se4, sd4 = moment_stats(res4.mean, res4.variance)
        z = float(((g7 - g4).abs() / torch.sqrt(se7 ** 2 + se4 ** 2)).max())
        mean_t, scale_t = (t.double() for t in truth)
        zt = {k: truth_gate(f"wide {label} {k.upper()}", (g - mean_t).abs() / se)
              for k, g, se in (("k7", g7, se7), ("k4", g4, se4))}
        sd_err = {k: float((sd / scale_t - 1.0).abs().max()) for k, sd in (("k7", sd7),
                                                                             ("k4", sd4))}
        check(max(sd_err.values()) <= WIDER_GAUSS_SD_TOL,
              f"wide {label}: K7's and K4's standard deviations within "
              f"{100 * sd_err['k7']:.2f}% and {100 * sd_err['k4']:.2f}% of the truth "
              f"(<= {100 * WIDER_GAUSS_SD_TOL:.0f}%)")
        extra = {"truth_z": zt, "sd_rel_err": sd_err}
    else:
        f7 = flat_draws(res7.draws)
        f4 = res4.draws
        check(bool(torch.isfinite(f7).all()) and tuple(f7.shape) == (WIDE_SAMPLES, C, D)
              and 0.6 < float(res7.accept_rate) < 0.95,
              f"wide {label}: finite K7 draws of shape ({WIDE_SAMPLES}, {C}, {D}), acceptance "
              f"{float(res7.accept_rate):.4f} in (0.6, 0.95)")
        e7, e4 = ess(f7).double(), ess(f4).double()
        z = wide_z(f7, e7, f4, e4, list(range(D)))
    check(z <= WIDE_SE, f"wide {label}: K7 means within {z:.2f} standard errors of K4's from "
                        f"the same state (<= {WIDE_SE})")
    nf = density.shared_floats()
    k7_bytes = (C * D * 4 * (2 if moments else samples) + C * (2 * D + 2) * 4 + D * 4
                + nf * 4)
    k7_bound = bound_ms(k7_bytes, C * least_run_flops(flops, D, leapfrog, samples),
                        philox_calls(samples, C, D))
    k3_bound, k4_bound = traced_bounds(flops, D, C, WIDE_WARMUP, samples, moments=moments,
                                       leapfrog=leapfrog)
    progress(f"wide {label}: K3 {k3_ms:.2f} ms ({k3_rec['lanes']} lanes; bound "
             f"{k3_bound[0]:.3f}), K7 {k7_ms:.2f} ms ({k7_rec['lanes']} lanes, {k7_route}; bound "
             f"{k7_bound[0]:.3f}) against K4's {k4_ms:.2f} (bound {k4_bound[0]:.3f}), "
             f"K7 accept {float(res7.accept_rate):.4f}, K4 {float(res4.accept_rate):.4f}, "
             f"means within {z:.2f} SE")
    # against the plain versions
    checks = {"k4": [], "k3": [], "k7": []}
    for kernel, variant, (Cc, S), staged in plan:
        if kernel == "k4":
            checks["k4"].append(wide_k4_check(build, label, fp, density, qw, eps_c, im_c, dev,
                                              Cc, S, staged, variant))
        elif kernel == "k3":
            checks["k3"].append(wide_k3_check(build, label, fp, density, q_start, dev, Cc, S,
                                              staged, variant == "chees"))
        else:
            checks["k7"].append(cgt_k7_check(build, cg, f"wide {label}", pot, q_dict, eps_c,
                                             im_dict, dev, Cc, S, staged))
    # the path's launches: the functor's, K3's warmup and the timed K7 and K4
    # runs; the checks against the plain versions are not the path's
    return {"launches": counts, "D": D, "functor": density.compiled.group_name,
            "nodes": density.compiled.nodes,
            "lines": density.compiled.lines, "trace_ms": density.compiled.trace_ms,
            "rows": density.compiled.group_rows, "operand_floats": nf, "eval_flops": flops,
            "emitted_flops": density.flops, "chains": C, "collect": collect,
            "samples": samples, "leapfrog": leapfrog,
            "k3_tile": tile or C, "k3_ms": k3_ms, "k3_bound_ms": k3_bound[0],
            "k3_bound_by": k3_bound[1], "k3_launch": k3_rec, "k7_ms": k7_ms,
            "k4_ms": k4_ms, "k7_bound_ms": k7_bound[0], "k7_bound_by": k7_bound[1],
            "k4_bound_ms": k4_bound[0], "k4_bound_by": k4_bound[1],
            "k7_accept": float(res7.accept_rate), "k4_accept": float(res4.accept_rate),
            "max_z": z, "k7_launch": k7_rec, "k7_operands": k7_route, "functor_check": functor,
            "checks": checks, **extra, **wide_usage(build, fp, density)}


def wider_chain_grid_model(build, cgs, prob, dev):
    """chain_grid_model_hmc on the hierarchical posterior at
    WIDER_CHAINS[0] chains, WIDER_CGM_WARMUP + WIDER_CGM_SAMPLES (its eager
    warmup, then K7 on the wide form): K7 launched, finite draws,
    acceptance in (0.5, 0.99)."""
    chains, warmup = WIDER_CHAINS[0], WIDER_CGM_WARMUP
    ld, start_fn, _, density, _ = prob
    label = f"wide hierarchical{(density.D - 5) // 2}"
    start = start_fn(chains, 120)
    build.reset_launch_counts()
    t = time.perf_counter()
    res = cgs.chain_grid_model_hmc(ld, start, 121, num_warmup=warmup,
                                   num_samples=WIDER_CGM_SAMPLES, initial_step_size=0.1,
                                   device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(build.LAUNCHES)
    flat = flat_draws(res.samples)
    accept = float(res.accept_rate)
    check(counts["chain_grid_hmc"] > 0 and bool(torch.isfinite(flat).all())
          and tuple(flat.shape) == (WIDER_CGM_SAMPLES, chains, density.D)
          and 0.5 < accept < 0.99,
          f"{label} chain_grid_model_hmc ({chains} chains, "
          f"{warmup} + {WIDER_CGM_SAMPLES}): K7 launched {counts['chain_grid_hmc']} "
          f"times, finite draws, acceptance {accept:.4f} in (0.5, 0.99)")
    progress(f"{label} chain_grid_model_hmc: {wall * 1e3:.0f} ms, accept {accept:.4f}")
    return {"chains": chains, "warmup": warmup,
            "samples": WIDER_CGM_SAMPLES, "e2e_ms": wall * 1e3,
            "accept": accept, "launches": counts}


def wide_path(build, fp, dens_mod, cg, cgs, auto, production, fused_model_hmc, problems, dev):
    """The wide phase, (a)-(c) above."""
    out = {"hierarchical32": wide_hierarchical(build, fp, auto, production,
                                               problems["hierarchical32"], dev),
           "gauss256": {"run": wide_gauss(build, fp, fused_model_hmc, problems["gauss256"],
                                          dev)}}
    for label in ("hierarchical32", "gauss256"):
        out[label]["kernels"] = wide_kernels(build, fp, dens_mod, cg, label, problems[label],
                                             dev)
    launches = {k: out["hierarchical32"]["launches"][k]
                + out["gauss256"]["run"]["launches"][k]
                + sum(out[m]["kernels"]["launches"][k] for m in out) for k in build.LAUNCHES}
    return {"models": out, "launches": launches}


def wide_branch(w: dict, k: str) -> dict:
    """The wide branches' rows of K3 (``k = "k3"``), K4 or K7 for the
    ``kernels`` line: each model's ms beside its bound (the function's least
    operations), the checks' largest errors against the plain version, the
    plain version's ms in one check (``check_chains``, ``plain_steps``)
    beside the kernel's in the same check, registers, spills and nvcc
    seconds."""
    rows = {}
    h = w["hierarchical32"]
    for label, m in w.items():
        kern = m["kernels"]
        if k == "k7":
            row = {"ms": kern["k7_ms"], "bound_ms": kern["k7_bound_ms"],
                   "bound_by": kern["k7_bound_by"], "k4_ms": kern["k4_ms"],
                   "chains": kern["chains"], "steps": WIDE_SAMPLES, **kern["k7_launch"],
                   "operands": kern["k7_operands"], "nvcc_s": kern["k7_nvcc_s"],
                   "ptxas": kern["k7"]}
        else:
            run = m["run"] if label == "gauss256" else h["runs"][WIDE_CHAINS[0]]
            row = {"ms": run[f"{k}_ms"], "bound_ms": run[f"{k}_bound_ms"],
                   "bound_by": run[f"{k}_bound_by"], "chains": run["chains"],
                   "steps": WIDE_WARMUP if k == "k3" else WIDE_SAMPLES,
                   **run[f"{k}_launch"], "nvcc_s": kern["nvcc_s"], "ptxas": kern[k]}
            if label == "hierarchical32":
                row["at_8192"] = {"ms": h["runs"][8192][f"{k}_ms"],
                                  "bound_ms": h["runs"][8192][f"{k}_bound_ms"]}
                row["chees_ms"] = h["chees"][f"{k}_ms"]
        checks = kern["checks"][k]
        name = {"k3": "fused_warmup", "k4": "fused_potential_hmc", "k7": "chain_grid_hmc"}[k]
        parts = ([m["launches"]] if label != "gauss256"
                 else [m["run"]["launches"]]) + [kern["launches"]]
        row.update(launches=sum(p[name] for p in parts), functor=kern["functor"], D=kern["D"],
                   eval_flops=kern["eval_flops"],
                   emitted_flops=kern["emitted_flops"],
                   bound_share=row["bound_ms"] / row["ms"],
                   max_abs_err=max(c["max_abs_err"] for c in checks))
        # the plain version's time from one check, named by its chains and
        # steps: on the Philox stream, the diagonal metric (K4) or the fixed
        # trajectory (K3)
        timed_check = next(c for c in checks if c["noise"] == "philox"
                           and c.get("variant", c.get("trajectory", "fixed")) in ("diag", "fixed"))
        row.update(plain_ms=timed_check["plain_ms"], check_ms=timed_check["ms"],
                   plain_steps=timed_check["steps"], check_chains=timed_check["chains"],
                   checks=[{kk: v for kk, v in c.items() if kk != "launch"} for c in checks])
        rows[label] = row
    return rows


# -- the wider phase: traced densities past 256 coordinates ---------------------------
# The slice's models at full width, past the 256 coordinates a warp a chain
# takes: K3's and K4's wide branches run a group of W warps a chain
# (fused_potential.wide_warps: 2 at D = 261, 4 at 1,024, 8 at MAX_D_WIDE).
# (a) The hierarchical posterior of WIDER_GROUPS groups (D = 261, 15 points
# a group) through adaptive_hmc at each of WIDER_CHAINS (WIDE_WARMUP +
# WIDE_SAMPLES, L = N_LEAPFROG; at 128 chains the JAX router fuses it, at
# 512 and more it sends it to XLA by its VMEM model) beside one eager run
# (WIDER_REF_*); a ChEES run, fused_model_hmc with the dense eager warmup
# (WIDER_DENSE_WARMUP steps), run_fused_blocks resumed from block 2 of
# WIDE_BLOCKS and chain_grid_model_hmc (WIDER_CGM_WARMUP +
# WIDER_CGM_SAMPLES), each at WIDER_CHAINS[0].  (b) A 1,024-D Gaussian
# (wide_gauss_truth at D = 1,024) through fused_model_hmc(warmup="fused")
# at each of WIDER_GAUSS_CHAINS, WIDE_WARMUP + WIDER_GAUSS_SAMPLES steps at
# L = WIDER_GAUSS_LEAPFROG with in-kernel moments: its means held to the
# truth by truth_gate (the chains' means' spread the standard error), its
# standard deviations within WIDER_GAUSS_SD_TOL.  (c) On both, wide_kernels
# at WIDE_CG_CHAINS, with moments for the Gaussian (K3 400 steps, then 500
# in K7 and in K4 from its state), and WIDER_PLAN: PR 19's checks, the dense
# metric at D = 261 only.  (d) A standard normal at MAX_D_WIDE:
# wide_kernels at WIDER_CAP_CHAINS (K3 in tiles of WIDER_CAP_TILE: its tile
# sums are a coordinate a thread over the tile's chains; K7 and K4
# WIDER_CAP_SAMPLES steps, moments), and K3 (one step at a time over
# WIDE_K3_STEPS), K4 and K7 against their plain versions at
# WIDER_CAP_CHECK chains.
WIDER_GROUPS = 128
WIDER_CHAINS = (128, 1024)
# the eager reference: 128 chains, 100 warmup steps (PR 19's), 50 samples
# for time (at 100: 46 s, hyperparameter means within 1.50 and 1.57 SE)
WIDER_REF_CHAINS, WIDER_REF_WARMUP, WIDER_REF_SAMPLES = 128, 100, 50
WIDER_SE = 3.5
# a Gaussian's coordinates are each held to WIDER_SE standard errors of the
# truth as a share: the largest |z| of 1,024 exact coordinates passes 3.5
# with probability ~0.38, so every one within WIDE_SE and at most
# WIDER_SE_SHARE of them past WIDER_SE (~0.05% expected)
WIDER_SE_SHARE = 0.01
WIDER_DENSE_WARMUP = 60
# chain_grid_model_hmc's eager warmup at 128 groups: at 30 steps (the
# 32-group run's) K7 accepted 0 on the CPU and on the card, at 60 0.91 and
# at 100 0.79 on the CPU (the card's run at 100: 0.76)
WIDER_CGM_WARMUP, WIDER_CGM_SAMPLES = 60, 20
# the 1,024-D Gaussian at L = 7: at L = 10 its adapted step (~0.3) puts
# eps L near pi, half a period of each whitened coordinate, so x^2 barely
# moves from step to step; on the CPU's plain version at 128 chains, 2,000
# samples, the standard deviations missed the truth by 2.3-5.0% at L = 10
# (400-2,000 warmup steps) and 0.72% at L = 7
WIDER_GAUSS_D, WIDER_GAUSS_CHAINS, WIDER_GAUSS_SAMPLES = 1024, (128, 512), 2000
WIDER_GAUSS_LEAPFROG, WIDER_GAUSS_SD_TOL = 7, 0.01
WIDER_CAP_CHAINS, WIDER_CAP_TILE, WIDER_CAP_CHECK, WIDER_CAP_SAMPLES = 512, 64, 128, 1000
WIDER_HIER = dict(groups=WIDER_GROUPS, chains=WIDER_CHAINS,
                  ref=(WIDER_REF_CHAINS, WIDER_REF_WARMUP, WIDER_REF_SAMPLES), se=WIDER_SE,
                  dense_warmup=WIDER_DENSE_WARMUP)
# the wider models' checks: K4 diagonal and ChEES on both streams, the
# dense metric on the Philox stream at D = 261 only, K3 one trajectory a
# stream (fixed on staged noise, ChEES on Philox), K7 on both
WIDER_PLAN = {"hierarchical128": tuple(c for c in WIDE_PLAN if (
                  c[0] != "k3" or (c[1] == "fixed") == c[3]) and (c[1] != "dense" or not c[3])),
              "gauss1024": tuple(c for c in WIDE_PLAN if c[1] != "dense" and (
                  c[0] != "k3" or (c[1] == "fixed") == c[3])),
              "cap": tuple(check for staged in (True, False) for check in (
                  ("k4", "diag", (WIDER_CAP_CHECK, 10), staged),
                  ("k4", "chees", (WIDER_CAP_CHECK, 10), staged),
                  ("k3", "fixed", (WIDER_CAP_CHECK, WIDE_K3_STEPS), staged),
                  ("k7", None, (WIDER_CAP_CHECK, 10), staged)))}


def truth_gate(label: str, z: torch.Tensor) -> dict:
    """Hold a Gaussian's coordinates' distances from the truth, in standard
    errors: every one within WIDE_SE, at most WIDER_SE_SHARE of them past
    WIDER_SE.  Returns the largest and the share."""
    worst, share = float(z.max()), float((z > WIDER_SE).double().mean())
    check(worst <= WIDE_SE and share <= WIDER_SE_SHARE,
          f"{label}: means within {worst:.2f} standard errors of the truth (<= {WIDE_SE}), "
          f"{100 * share:.2f}% of the {z.numel()} coordinates past {WIDER_SE} (<= "
          f"{100 * WIDER_SE_SHARE:.0f}%)")
    return {"max_z": worst, "share_past": share}


def wider_problems(dens_mod, cg, dev):
    """label -> (log density, start(C, seed), least flops an evaluation,
    TracedDensity, TracedPotential) of the wider phase's three models,
    compiled now, for phase_build's one nvcc batch."""
    from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE

    ld_h = hierarchical_problem(dev, 1, groups=WIDER_GROUPS)[0]

    def start_h(C, seed):
        return hierarchical_problem(dev, C, seed, groups=WIDER_GROUPS)[2]

    mean, scale = wide_gauss_truth(dev, WIDER_GAUSS_D)

    def ld_g(p):
        return -0.5 * torch.sum(((p["x"] - mean) / scale) ** 2)

    def start_g(C, seed):
        g = torch.Generator().manual_seed(seed)
        return {"x": (0.5 * torch.randn((C, WIDER_GAUSS_D), generator=g)).to(dev)}

    def ld_c(p):
        return -0.5 * torch.sum(p["x"] ** 2)

    def start_c(C, seed):
        g = torch.Generator().manual_seed(seed)
        return {"x": torch.randn((C, MAX_D_WIDE), generator=g).to(dev)}

    out = {}
    for label, ld, start, flops in (
            ("hierarchical128", ld_h, start_h, hierarchical_eval_flops(15, WIDER_GROUPS)),
            ("gauss1024", ld_g, start_g, diag_eval_flops(WIDER_GAUSS_D)),
            # a subtract-free diagonal Gaussian: a square and a sum a coordinate, the half
            ("cap", ld_c, start_c, 2 * MAX_D_WIDE + 1)):
        template = {k: v[0] for k, v in start(1, 0).items()}
        density = dens_mod.device_density(ld, template).to(dev)
        pot = cg.chain_grid_potential_from_scalar(ld, template)[0]
        check(isinstance(density, dens_mod.TracedDensity) and density.wide
              and isinstance(pot, cg.TracedPotential) and pot.compiled.key == density.key,
              f"wider {label}: the density compiler's wide form ({type(density).__name__}, "
              f"D = {density.D})")
        out[label] = (ld, start, flops, density, pot)
    return out


def wider_gauss(build, fp, fused_model_hmc, prob, dev):
    """(b): the 1,024-D Gaussian through fused_model_hmc(warmup="fused") at
    each of WIDER_GAUSS_CHAINS with in-kernel moments, L =
    WIDER_GAUSS_LEAPFROG: its means held to the truth by truth_gate, its
    standard deviations within WIDER_GAUSS_SD_TOL; K3 and K4 timed, W = 4
    warps a chain."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    ld, start_fn, flops, density, _ = prob
    D, W = WIDER_GAUSS_D, fp.wide_warps(WIDER_GAUSS_D)
    mean_t, scale_t = (t.double() for t in wide_gauss_truth(dev, D))
    out, launches = {}, {k: 0 for k in build.LAUNCHES}
    for C in WIDER_GAUSS_CHAINS:
        start = start_fn(C, 110)
        kw = dict(num_warmup=WIDE_WARMUP, num_samples=WIDER_GAUSS_SAMPLES,
                  num_leapfrog=WIDER_GAUSS_LEAPFROG, initial_step_size=0.1, warmup="fused",
                  collect="moments", device=dev)
        build.reset_launch_counts()
        t = time.perf_counter()
        fused_model_hmc(ld, start, 111, **kw)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        with LaunchSpans(fp) as spans:
            t = time.perf_counter()
            res = fused_model_hmc(ld, start, 112, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = dict(build.LAUNCHES)
        warps = (build.last_launch["fused_warmup"].warps,
                 build.last_launch["fused_potential_hmc"].warps)
        check(counts["fused_warmup"] > 0 and counts["fused_potential_hmc"] > 0
              and warps == (W, W),
              f"wider gauss1024 at {C} chains launched K3 {counts['fused_warmup']} and K4 "
              f"{counts['fused_potential_hmc']} times, at {warps} warps a chain (W = {W})")
        m, v = pack_positions(res.mean), pack_positions(res.variance)
        check(bool(torch.isfinite(m).all() and torch.isfinite(v).all())
              and tuple(m.shape) == (C, D),
              f"wider gauss1024 at {C} chains: finite moments of shape ({C}, {D})")
        grand, se, sd = moment_stats(m, v)
        zt = truth_gate(f"wider gauss1024 at {C} chains", (grand - mean_t).abs() / se)
        z = zt["max_z"]
        sd_err = float((sd / scale_t - 1.0).abs().max())
        accept = float(res.accept_rate)
        check(sd_err <= WIDER_GAUSS_SD_TOL and 0.6 < accept < 0.95,
              f"wider gauss1024 at {C} chains: standard deviations within "
              f"{100 * sd_err:.2f}% of the truth (<= {100 * WIDER_GAUSS_SD_TOL:.0f}%), "
              f"acceptance {accept:.4f} in (0.6, 0.95)")
        k3_b, k4_b = traced_bounds(flops, D, C, WIDE_WARMUP, WIDER_GAUSS_SAMPLES, moments=True,
                                   leapfrog=WIDER_GAUSS_LEAPFROG)
        for k in launches:
            launches[k] += counts[k]
        out[C] = {"chains": C, "warmup": WIDE_WARMUP, "samples": WIDER_GAUSS_SAMPLES,
                  "leapfrog": WIDER_GAUSS_LEAPFROG, "cold_ms": cold * 1e3, "e2e_ms": wall * 1e3,
                  "k3_ms": spans.ms("warmup"), "k4_ms": spans.ms("sampling"),
                  "k3_bound_ms": k3_b[0], "k3_bound_by": k3_b[1], "k4_bound_ms": k4_b[0],
                  "k4_bound_by": k4_b[1], "accept": accept, "max_z": z,
                  "share_past_se": zt["share_past"], "sd_rel_err": sd_err,
                  "step_size": float(res.step_size.mean()),
                  "k3_launch": launch_keys(build.last_launch["fused_warmup"]),
                  "k4_launch": launch_keys(build.last_launch["fused_potential_hmc"]),
                  "launches": counts}
        progress(f"wider gauss1024 at {C} chains: e2e {wall * 1e3:.1f} ms (cold "
                 f"{cold * 1e3:.0f}), K3 {out[C]['k3_ms']:.2f} ms (bound {k3_b[0]:.3f}), K4 "
                 f"{out[C]['k4_ms']:.2f} ms (bound {k4_b[0]:.3f}), accept {accept:.4f}, means "
                 f"within {z:.2f} SE, sds within {100 * sd_err:.2f}%")
    return {"runs": out, "launches": launches}


def wider_path(build, fp, dens_mod, cg, cgs, auto, production, fused_model_hmc, problems,
               dev):
    """The wider phase, (a)-(d) above."""
    from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE

    h = wide_hierarchical(build, fp, auto, production, problems["hierarchical128"], dev,
                          cfg=WIDER_HIER, fused_model_hmc=fused_model_hmc)
    h["chain_grid_model_hmc"] = wider_chain_grid_model(build, cgs, problems["hierarchical128"],
                                                      dev)
    g = wider_gauss(build, fp, fused_model_hmc, problems["gauss1024"], dev)
    out = {"hierarchical128": h, "gauss1024": g}
    out["hierarchical128"]["kernels"] = wide_kernels(
        build, fp, dens_mod, cg, "hierarchical128", problems["hierarchical128"], dev,
        plan=WIDER_PLAN["hierarchical128"])
    out["gauss1024"]["kernels"] = wide_kernels(
        build, fp, dens_mod, cg, "gauss1024", problems["gauss1024"], dev,
        plan=WIDER_PLAN["gauss1024"], truth=wide_gauss_truth(dev, WIDER_GAUSS_D),
        leapfrog=WIDER_GAUSS_LEAPFROG)
    zeros = torch.zeros(MAX_D_WIDE, device=dev)
    out["cap"] = {"kernels": wide_kernels(
        build, fp, dens_mod, cg, "cap", problems["cap"], dev, chains=WIDER_CAP_CHAINS,
        tile=WIDER_CAP_TILE, plan=WIDER_PLAN["cap"], truth=(zeros, zeros + 1.0),
        samples=WIDER_CAP_SAMPLES)}
    launches = {k: h["launches"][k] + h["chain_grid_model_hmc"]["launches"][k]
                + g["launches"][k] + sum(out[m]["kernels"]["launches"][k] for m in out)
                for k in build.LAUNCHES}
    return {"models": out, "launches": launches}


def wider_branch(w: dict, k: str) -> dict:
    """The wider phase's rows of K3 (``k = "k3"``), K4 or K7 for the
    ``kernels`` line, as wide_branch gives PR 19's: each model's ms beside
    its bound (the function's least operations), W, the checks' largest
    errors against the plain version, the plain version's ms in one check
    beside the kernel's in the same check, registers, spills, stack and
    nvcc seconds."""
    name = {"k3": "fused_warmup", "k4": "fused_potential_hmc", "k7": "chain_grid_hmc"}[k]
    rows = {}
    for label, m in w.items():
        kern = m["kernels"]
        if k == "k7" or label == "cap":
            # K7 on every model, and the cap's K3 and K4: wide_kernels' runs
            # (K3 WIDE_WARMUP steps, K7 and K4 WIDE_SAMPLES from its state)
            row = {"ms": kern[f"{k}_ms"], "bound_ms": kern[f"{k}_bound_ms"],
                   "bound_by": kern[f"{k}_bound_by"], "chains": kern["chains"],
                   "steps": WIDE_WARMUP if k == "k3" else kern["samples"],
                   "leapfrog": kern["leapfrog"], "collect": kern["collect"]}
            if k == "k7":
                row.update(k4_ms=kern["k4_ms"], **kern["k7_launch"],
                           operands=kern["k7_operands"], nvcc_s=kern["k7_nvcc_s"],
                           ptxas=kern["k7"])
            else:
                row.update(nvcc_s=kern["nvcc_s"], ptxas=kern[k],
                           **(kern["k3_launch"] if k == "k3" else {}),
                           tile=kern["k3_tile"] if k == "k3" else kern["chains"])
        else:
            runs = m["runs"]
            first = min(runs)
            run = runs[first]
            row = {"ms": run[f"{k}_ms"], "bound_ms": run[f"{k}_bound_ms"],
                   "bound_by": run[f"{k}_bound_by"], "chains": run["chains"],
                   "steps": WIDE_WARMUP if k == "k3" else run.get("samples", WIDE_SAMPLES),
                   **run[f"{k}_launch"], "nvcc_s": kern["nvcc_s"], "ptxas": kern[k]}
            row["at_more_chains"] = {C: {"ms": r[f"{k}_ms"], "bound_ms": r[f"{k}_bound_ms"]}
                                     for C, r in runs.items() if C != first}
            if label == "hierarchical128":
                row["chees_ms"] = m["chees"][f"{k}_ms"]
        checks = kern["checks"][k]
        parts = ([m["launches"], m["chain_grid_model_hmc"]["launches"]]
                 if label == "hierarchical128" else
                 [m["launches"]] if label == "gauss1024" else []) + [kern["launches"]]
        row.update(launches=sum(p[name] for p in parts), functor=kern["functor"], D=kern["D"],
                   eval_flops=kern["eval_flops"], emitted_flops=kern["emitted_flops"],
                   max_abs_err=max(c["max_abs_err"] for c in checks))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        # the Philox check of the diagonal metric or fixed trajectory, else
        # (K3 past the cap: ChEES on that stream) the first Philox check
        philox = [c for c in checks if c["noise"] == "philox"]
        timed_check = next((c for c in philox if c.get("variant", c.get("trajectory"))
                            in ("diag", "fixed")), philox[0])
        row.update(plain_ms=timed_check["plain_ms"], check_ms=timed_check["ms"],
                   plain_steps=timed_check["steps"], check_chains=timed_check["chains"],
                   plain_check=timed_check.get("variant", timed_check.get("trajectory")),
                   warps=timed_check["launch"]["lanes"] // 32,
                   checks=[{kk: v for kk, v in c.items() if kk != "launch"} for c in checks])
        rows[label] = row
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from binf_tpu_torch.example import chromatin as chrom
    from binf_tpu_torch.example import polynomial as poly
    from binf_tpu_torch.example.polynomial import make_data, make_posterior
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import chain_grid as cg
    from binf_tpu_torch.ops.kernels import densities as dens_mod
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg
    from binf_tpu_torch.ops.kernels import fused_hmc as fh
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels import leapfrog as lf
    from binf_tpu_torch.ops.kernels import pairwise as pw
    from binf_tpu_torch.ops.kernels import prng
    from binf_tpu_torch.io import checkpoint
    from binf_tpu_torch.ops.math import vandermonde
    from binf_tpu_torch.parallel import production
    from binf_tpu_torch.parallel.runner import init_chains, run_chains
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers import adaptation, auto
    from binf_tpu_torch.samplers import chees as chees_mod
    from binf_tpu_torch.samplers import dense as dense_mod
    from binf_tpu_torch.samplers import chain_grid as cgs
    from binf_tpu_torch.samplers import gibbs as gibbs_mod
    from binf_tpu_torch.samplers import hmc as hmc_mod
    from binf_tpu_torch.samplers import quadratic_hmc as qh
    from binf_tpu_torch.samplers import conjugate, mala as mala_mod, nuts as nuts_mod
    from binf_tpu_torch.samplers import slice as slice_mod, tempering
    from binf_tpu_torch.samplers.fused import fused_model_hmc, fused_regression_hmc
    from binf_tpu_torch import cli, vi

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    progress(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    try:
        dims_problems = family_dims_problems(dev)
        traced_probs = traced_problems(dev)
        poly_traced = polynomial_traced(dens_mod, dev)
        cgt_probs = chain_grid_traced_problems(cli, cg, dev)
        wide_probs = wide_problems(dens_mod, cg, dev)
        wide_shape, wide_grids = wide_shapes(wide_probs, fp)
        wider_probs = wider_problems(dens_mod, cg, dev)
        wider_shape, wider_grids = wide_shapes(wider_probs, fp)
        build_s = phase_build(_build, family_dims_shapes(dims_problems, fp, dens_mod, dev)
                              + traced_shapes(dens_mod, traced_probs, poly_traced) + wide_shape
                              + wider_shape,
                              [pot.compiled for _, _, pot in cgt_probs.values()] + wide_grids
                              + wider_grids)
        philox = phase_philox(prng, dev)

        xses, ys = make_data(torch.Generator().manual_seed(1), device=dev)
        V = vandermonde(torch.linspace(-2.0, 2.0, 20, device=dev), 4)
        prior_var = torch.full((4,), 5.0, device=dev)
        density = fh.LinregDensity(V, ys, prior_var, 1.0, 0.2)
        g = torch.Generator().manual_seed(2)
        q_init = torch.cat([1.0 + 0.1 * torch.randn((N_CHAINS, 4), generator=g),
                            torch.zeros((N_CHAINS, 1))], dim=1).to(dev)

        k2_err = phase_k2_check(fh, density, dev)
        k3_err, k3_plain_ms = phase_k3_check(fp, density, q_init, dev)
        k4_err = phase_k4_check(fp, dens_mod, density, dev)
        k3c_err, k3c_plain_ms = phase_k3_chees_check(fp, density, q_init, dev)

        # -- the main path: counts from 0, one cold run, REPS timed runs ------------
        _build.reset_launch_counts()
        t = time.perf_counter()
        main_path(fh, fp, density, V, ys, prior_var, q_init, 0, dev)
        torch.cuda.synchronize()
        progress(f"main path cold run: {time.perf_counter() - t:.2f}s")
        walls, warm_ms, samp_ms = [], [], []
        for rep in range(REPS):
            # the last run's 1.3 GB of draws go back to the allocator first, so
            # that K2's events hold no cudaMalloc
            draws = None
            t = time.perf_counter()
            draws, acc, eps, im, ev = main_path(fh, fp, density, V, ys, prior_var, q_init,
                                                2 * rep + 2, dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            warm_ms.append(ev[0].elapsed_time(ev[1]))
            samp_ms.append(ev[1].elapsed_time(ev[2]))
        k3_launch = launch_keys(_build.last_launch["fused_warmup"])
        k2_rec = _build.last_launch["fused_linreg_hmc"]
        launches = dict(_build.LAUNCHES)
        e2e = float(np.mean(walls))
        for name in ("philox", "fused_linreg_hmc", "fused_warmup"):
            check(launches[name] > 0, f"main path launched {name} {launches[name]} times")
        accept = float(acc)
        m_ess = posterior_gates("main path", draws, accept, (0.6, 0.95), V, ys, dev)
        progress(f"main path: e2e {e2e * 1e3:.2f} ms (runs {[round(w * 1e3, 2) for w in walls]}), "
                 f"warmup {np.mean(warm_ms):.2f} ms, sampling {np.mean(samp_ms):.2f} ms, "
                 f"accept {accept:.4f}, eps {float(eps):.5f}, min bulk ESS {m_ess:.1f}, "
                 f"ESS/s {m_ess / e2e:.4g}")
        main_out = {
            "chains": N_CHAINS, "warmup": N_WARMUP, "samples": N_SAMPLES,
            "leapfrog": N_LEAPFROG, "e2e_ms": e2e * 1e3, "e2e_runs_ms": [w * 1e3 for w in walls],
            "warmup_ms": float(np.mean(warm_ms)), "sampling_ms": float(np.mean(samp_ms)),
            "accept": accept, "step_size": float(eps), "min_bulk_ess": m_ess,
            "ess_per_s": m_ess / e2e, "build_s": build_s, "launches": launches,
            "k3_launch": k3_launch,
            "k2_launch": dict(launch_keys(k2_rec), rows_in_registers=k2_rec.rows_in_registers)}
        del draws

        # -- plain K2 at the main path's inputs over PLAIN_CUT steps, for its time --------
        qw, eps_c, im_c = fp.fused_warmup_run(density, q_init, 2 * REPS, 0.1,
                                              num_warmup=N_WARMUP, block_chains=N_CHAINS,
                                              device=dev)
        k2_plain_ms, _ = timed(lambda: fh.linreg_hmc_plain(
            density, qw, eps_c.mean().reshape(1), im_c.mean(0), num_steps=PLAIN_CUT,
            num_leapfrog=N_LEAPFROG, seed=2 * REPS + 1))

        # -- the user's route to K2, then the model and ChEES paths ---------------------
        posterior = make_posterior(xses, ys)
        regression_out = regression_path(_build, fh, adaptation, fused_regression_hmc,
                                         posterior, V, ys, dev)
        logdensity = transform_logdensity(posterior.log_prob, {"precision": LogTransform})
        init = {"coefficients": q_init[:, :4], "precision": q_init[:, 4]}
        model_out, mres, _ = model_path("model path", _build, fp, fused_model_hmc, logdensity,
                                        init, V, ys, False, dev)
        chees_out, cres, cspans = model_path("chees path", _build, fp, fused_model_hmc,
                                             logdensity, init, V, ys, True, dev)
        # plain K4 at each path's inputs over PLAIN_CUT of the N_SAMPLES steps
        q_end = torch.cat([mres.final_positions["coefficients"],
                           mres.final_positions["precision"][:, None]], 1)
        k4_plain_ms, _ = timed(lambda: fp.fused_potential_hmc_plain(
            density, q_end, 7, mres.step_size, mres.inverse_mass, num_steps=PLAIN_CUT,
            block_chains=N_CHAINS))
        cq_end = torch.cat([cres.final_positions["coefficients"],
                            cres.final_positions["precision"][:, None]], 1)
        k4c_plain_ms, _ = timed(lambda: fp.fused_potential_hmc_plain(
            density, cq_end, 7, cres.step_size, cres.inverse_mass, num_steps=PLAIN_CUT,
            block_chains=N_CHAINS, trajectory="chees", traj_length=cres.trajectory_length,
            max_leapfrog=CHEES_MAX_LEAP))
        del mres, cres
        sweep = phase_bc_sweep(fp, density, q_init, dev)

        # -- the Gibbs and chromatin paths ---------------------------------------------
        k5_err = phase_k5_check(_build, fg, density, dev)
        k6 = phase_k6_check(pw, chrom.synthetic_restraints, dev)
        start = poly.initial_positions(N_CHAINS, generator=torch.Generator().manual_seed(3),
                                       device=dev)
        q_gibbs = torch.cat([start["coefficients"], start["precision"][:, None]], 1)
        gibbs_out, moments = gibbs_path(_build, fg, V, ys, prior_var, q_gibbs, dev)
        k5_plain_ms, _ = timed(lambda: fg.fused_linreg_gibbs_plain(
            density, q_gibbs, num_steps=PLAIN_CUT, seed=44))
        collapsed_out = collapsed_gibbs_path(_build, poly, init_chains, run_chains, xses, ys,
                                             start, moments, dev)
        chrom_out = chromatin_path(_build, pw, chrom, gibbs_mod, dev)

        # -- the chain-grid and quadratic paths ------------------------------------------
        k7_functor = phase_k7_functor_check(cg, chrom, dev)
        cg_out, gram, q_chk, eps_chk, im_chk = chain_grid_path(
            _build, cg, cgs, adaptation, chrom, pw, hmc_mod, init_chains, run_chains, dev)
        cgt_out = chain_grid_traced_path(_build, cg, fp, dens_mod, cgt_probs, dev)
        cgt_cli = cgt_cli_route(_build, cli)
        cg_out.update(traced=cgt_out["models"], traced_cli=cgt_cli,
                      launches={k: cg_out["launches"][k] + cgt_out["launches"][k]
                                + cgt_cli["launches"].get(k, 0) for k in _build.LAUNCHES})
        k7_err, k7_plain_ms = phase_k7_check(cg, gram, q_chk, eps_chk, im_chk, dev)
        # -- the wide branches: traced densities past 32 coordinates --------------------
        wide_out = wide_path(_build, fp, dens_mod, cg, cgs, auto, production, fused_model_hmc,
                             wide_probs, dev)
        # -- past 256 coordinates: a group of warps a chain -----------------------------
        wider_out = wider_path(_build, fp, dens_mod, cg, cgs, auto, production,
                               fused_model_hmc, wider_probs, dev)
        k8 = phase_k8_check(lf, dev)
        quad_out = quadratic_path(_build, qh, init_chains, run_chains, dev)

        # -- the production driver, the dense and ChEES eager warmups, the router --------
        production_out = production_path(_build, fp, production, checkpoint, logdensity, init,
                                         V, ys, dev)
        router_out = router_path(_build, auto, logdensity, init, dev)
        smem_out = router_smem_path(_build, fp, dens_mod, auto, fused_model_hmc, init, dev)
        dense_out = dense_path(_build, fp, dense_mod, fused_model_hmc, logdensity, init, V, ys,
                               dev)
        chees_xla_out = chees_xla_path(_build, fp, chees_mod, fused_model_hmc, logdensity, init,
                                       V, ys, dev)

        # -- the example families on K3 and K4, the NUTS rule, the other samplers -------
        problems = family_problems(dev)
        families_out, fam_results = families_path(_build, fp, dens_mod, auto, fused_model_hmc,
                                                  problems, dev)
        hier_out = hierarchical_path(_build, fp, dens_mod, auto, fused_model_hmc,
                                     families_out["mufu"], dev,
                                     router_out["hierarchical_profiles"])
        dims_out = family_dims_path(_build, fp, dens_mod, auto, fused_model_hmc, dims_problems,
                                    dev)
        traced_out = traced_path(_build, fp, dens_mod, auto, traced_probs, poly_traced, dev,
                                 router_out["xla"])
        nuts_out = nuts_path(_build, auto, adaptation, hmc_mod, nuts_mod,
                             problems["logistic"][0], chrom, dev)
        samplers_out = samplers_path(
            _build, fp, (mala_mod, nuts_mod, slice_mod, tempering, gibbs_mod, conjugate),
            problems, fam_results, families_out, posterior, dev)
        del fam_results
        smc_out = smc_path(_build, poly, xses, ys, V, dev)

        # -- the VI modules and the command line ---------------------------------------
        vi_out = vi_path(_build, vi, poly, xses, ys, V, smc_out, dev)
        cli_out = cli_path(_build, cli)
        scripts_out = scripts_path(_build, dev)

        # -- the mesh: a world of one on NCCL, two gloo ranks on the card ---------------
        mesh_out = mesh_path(_build, cli, fused_model_hmc, logdensity, init, production, cgs,
                             chrom, smc_out, dev)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    n, d, D = 20, 4, 5
    ev_lin = eval_flops(n, d)
    # K2 writes the draws and reads its start; K3 reads and writes
    # positions and writes a step size and a metric per chain
    # K2's least work: L evaluations a step (the previous yardstick counted L + 1)
    k2_bound = bound_ms(N_SAMPLES * N_CHAINS * D * 4 + N_CHAINS * (D + 1) * 4,
                        N_CHAINS * least_run_flops(ev_lin, D, N_LEAPFROG, N_SAMPLES),
                        philox_calls(N_SAMPLES, N_CHAINS, D))
    k3_bound = bound_ms(N_CHAINS * (3 * D + 1) * 4,
                        N_WARMUP * N_CHAINS * trajectory_flops(ev_lin, D, N_LEAPFROG),
                        philox_calls(N_WARMUP, N_CHAINS, D))
    # K4 on the model path: reads q0, eps and a metric per chain, writes
    # the draws, the final positions and the accept counts
    k4_bytes = N_CHAINS * (2 * D + 1) * 4 + N_SAMPLES * N_CHAINS * D * 4 + N_CHAINS * (D + 1) * 4
    k4_bound = bound_ms(k4_bytes,
                        N_SAMPLES * N_CHAINS * trajectory_flops(ev_lin, D, N_LEAPFROG),
                        philox_calls(N_SAMPLES, N_CHAINS, D))
    # the ChEES path's kernels: the exact leapfrog counts of this run (one
    # tile of all chains), plus K3's second pass over each step's scratch
    Lw = cspans.counts["warmup"].double()
    Ls = cspans.counts["sampling"].double()
    k3c_bound = bound_ms(N_CHAINS * (3 * D + 2) * 4,
                         N_CHAINS * float(trajectory_flops(ev_lin, D, Lw).sum())
                         + N_WARMUP * N_CHAINS * 10 * D,
                         philox_calls(N_WARMUP, N_CHAINS, D))
    k4c_bound = bound_ms(k4_bytes, N_CHAINS * float(trajectory_flops(ev_lin, D, Ls).sum()),
                         philox_calls(N_SAMPLES, N_CHAINS, D))
    chees_out.update(warmup_bound_ms=k3c_bound[0], sampling_bound_ms=k4c_bound[0],
                     warmup_plain_ms=k3c_plain_ms, sampling_plain_ms=k4c_plain_ms,
                     plain_steps=PLAIN_CUT, warmup_plain_steps=K3_CHEES_CHECK_WARMUP)
    model_out.update(sampling_bound_ms=k4_bound[0], sampling_plain_ms=k4_plain_ms,
                     plain_steps=PLAIN_CUT, bc_sweep=sweep)
    paths = (main_out, regression_out, model_out, chees_out, gibbs_out, collapsed_out, chrom_out,
             cg_out, quad_out, production_out, dense_out, chees_xla_out, router_out, smem_out,
             families_out, hier_out, dims_out, traced_out, nuts_out, samplers_out, smc_out,
             vi_out, cli_out, scripts_out, mesh_out, wide_out, wider_out)
    total = {name: sum(p["launches"][name] for p in paths) for name in main_out["launches"]}
    # K5 writes the draws and reads its start; its least work on this run's
    # Philox streams: round 0 and the measured share of round 1, slot 1's
    # call for the measured share whose rounds 0 and 1 both reject
    k5_bound = bound_ms(N_SAMPLES * N_CHAINS * D * 4 + N_CHAINS * D * 4,
                        N_SAMPLES * N_CHAINS
                        * gibbs_flops(n, d, 1.0 + gibbs_out["round0_rejects"]),
                        N_SAMPLES * N_CHAINS * gibbs_philox_calls(d, gibbs_out["rounds01_reject"]))
    gibbs_out.update(kernel_bound_ms=k5_bound[0], kernel_plain_ms=k5_plain_ms,
                     plain_steps=PLAIN_CUT)
    # K6a and K6b read W and logD once, X once; K6b writes the forces
    nb = N_BEADS
    k6a_bound = bound_ms(8 * nb * nb + 12 * nb + 4, pairwise_flops(nb, False), 0)
    k6b_bound = bound_ms(8 * nb * nb + 24 * nb, pairwise_flops(nb, True), 0)
    chrom_out.update(k6a_bound_ms=k6a_bound[0], k6b_bound_ms=k6b_bound[0],
                     k6a_alone_ms=k6["fwd_alone_ms"], k6b_alone_ms=k6["bwd_alone_ms"],
                     k6a_l2_ms=k6["fwd_l2_ms"], k6b_l2_ms=k6["bwd_l2_ms"],
                     k6a_plain_ms=k6["fwd_plain_ms"], k6b_plain_ms=k6["bwd_plain_ms"])
    # K7 at the chain-grid path's shape, its least work: L functor
    # evaluations a chain-step, each unordered pair once (the previous yardstick
    # counted L + 1 evaluations of every ordered pair), the trajectory's
    # updates and Philox; bytes: the draws, the start and end positions, the
    # step sizes, the metric, W and logD once
    D7 = 1 + 3 * CG_BEADS
    k7_bound = bound_ms(CG_SAMPLES * CG_CHAINS * D7 * 4 + CG_CHAINS * (2 * D7 + 2) * 4 + D7 * 4
                        + 8 * CG_BEADS ** 2,
                        CG_CHAINS * least_run_flops(gram_eval_flops(CG_BEADS), D7, CG_LEAP,
                                                    CG_SAMPLES),
                        philox_calls(CG_SAMPLES, CG_CHAINS, D7))
    D7b = 1 + 3 * CG_BIG_BEADS
    k7_big_bound = bound_ms(
        CG_BIG_STEPS * CG_BIG_CHAINS * D7b * 4 + CG_BIG_CHAINS * (2 * D7b + 2) * 4 + D7b * 4
        + 8 * CG_BIG_BEADS ** 2,
        CG_BIG_CHAINS * least_run_flops(gram_eval_flops(CG_BIG_BEADS), D7b, CG_LEAP,
                                        CG_BIG_STEPS),
        philox_calls(CG_BIG_STEPS, CG_BIG_CHAINS, D7b))
    # each of its evaluations reads W, logD and their transposes, which at
    # 256 beads come from the L2 (1 MB an evaluation)
    big_evals = CG_BIG_STEPS * CG_BIG_CHAINS * (CG_LEAP + 1)
    cg_out.update(k7_bound_ms=k7_bound[0], k7_bound_by=k7_bound[1], k7_plain_ms=k7_plain_ms,
                  plain_steps=CG_CHECK_STEPS, k7_functor=k7_functor,
                  big_bound_ms=k7_big_bound[0], big_bound_by=k7_big_bound[1],
                  big_l2_bytes=big_evals * 16 * CG_BIG_BEADS ** 2,
                  big_l2_ms_at_hbm_rate=1e3 * big_evals * 16 * CG_BIG_BEADS ** 2 / PEAK_BYTES)
    # K8 at the quadratic path's shape: L + 1 products q A of 2 C D^2 flops
    # and the drifts and kicks (5 flops a coordinate and step); q, p, A, b
    # and the metric read once, q, p and U written once.  The least time for
    # this float32-accurate work is the lesser of two routes: the products
    # in float32 FMA at the FP32 rate, or as 3xTF32 (three passes) at the
    # dense TF32 rate, the elementwise work at the FP32 rate either way
    k8_bytes = 4 * (4 * Q_CHAINS * Q_DIM + Q_DIM * Q_DIM + 2 * Q_DIM + Q_CHAINS)
    k8_products = 2 * Q_CHAINS * Q_DIM ** 2 * (Q_LEAP + 1)
    k8_elementwise = 5 * Q_CHAINS * Q_DIM * Q_LEAP + 3 * Q_CHAINS * Q_DIM
    k8_simt = bound_ms(k8_bytes, k8_products + k8_elementwise, 0)
    k8_tc = bound_ms(k8_bytes, 3 * k8_products * PEAK_F32 / PEAK_TF32 + k8_elementwise, 0)
    k8_bound = min(k8_simt, k8_tc)
    k8_bound_route = "3xTF32 tensor cores" if k8_tc <= k8_simt else "float32 FMA"
    quad_out.update(k8_ms=k8["ms"], k8_plain_ms=k8["plain_ms"], k8_library_ms=k8["library_ms"],
                    k8_bound_ms=k8_bound[0], k8_bound_by=k8_bound[1],
                    k8_bound_route=k8_bound_route, k8_simt_bound_ms=k8_simt[0])
    for label, ms, prev, bound in (("K1", philox["ms"], PREVIOUS_MS["K1"], philox["bound_ms"]),
                                  ("K2", main_out["sampling_ms"], PREVIOUS_MS["K2"], k2_bound[0]),
                                  ("K7 64 beads", cg_out["k7_ms"], PREVIOUS_MS["K7"], k7_bound[0]),
                                  ("K7 256 beads", cg_out["big_k7_ms"], PREVIOUS_MS["K7 256"],
                                   k7_big_bound[0]),
                                  ("K8", k8["ms"], PREVIOUS_MS["K8"], k8_bound[0]),
                                  ("K6b from HBM", k6["bwd_alone_ms"], PREVIOUS_MS["K6b"],
                                   k6b_bound[0]),
                                  ("K5 in the path's events", gibbs_out["kernel_ms"],
                                   PREVIOUS_MS["K5"], k5_bound[0])):
        progress(f"{label}: {ms:.4g} ms (the previous design {prev} ms), bound {bound:.4g} ms, "
                 f"{100 * bound / ms:.1f}% of it")
    # K3's and K4's family branches: the three families and the
    # hierarchical posterior (plain_ms beside its branch rows, in
    # hierarchical_path's line)
    branches = {**families_out["families"], "hierarchical": hier_out, **dims_out["shapes"]}
    kernels = [
        # the paths run Philox inside K2-K5 and K7 (philox.cuh), each of
        # their launches counts one; ms is philox.cu's kernel standing alone
        # at the main path's volume (in turns with the library call);
        # bound_ms its bytes or its Philox calls' integer work (phase_philox),
        # floors_ms its own SASS's floors, the SASS counts a chain-step
        dict(name="philox", route="cuda", source="binf_tpu_torch/csrc/philox.cuh",
             replaces="binf_tpu/ops/pallas/prng.py:23", launches=total["philox"],
             max_abs_err=philox["max_abs_err"], ms=philox["ms"],
             plain_ms=philox["plain_ms"], plain_steps=PLAIN_CUT, bound_ms=philox["bound_ms"],
             bound_by=philox["bound_by"], library_ms=philox["library_ms"],
             library_call="torch.randn + torch.rand, CUDA generator (not the same bits)",
             floors_ms=philox["floors_ms"],
             bound_share=philox["bound_ms"] / philox["ms"],
             sass_per_chain_step=philox["sass_per_chain_step"]["by_pipe"],
             instructions_per_chain_step=philox["sass_per_chain_step"]["total"],
             step_cycles=philox["step_cycles"], float64_errors=philox["float64_errors"],
             **philox["launch"]),
        dict(name="fused_linreg_hmc", route="cuda", source="binf_tpu_torch/csrc/fused_hmc.cu",
             replaces="binf_tpu/ops/pallas/fused_hmc.py:65",
             launches=total["fused_linreg_hmc"], max_abs_err=k2_err,
             ms=main_out["sampling_ms"], plain_ms=k2_plain_ms, plain_steps=PLAIN_CUT,
             bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None,
             bound_share=k2_bound[0] / main_out["sampling_ms"], **main_out["k2_launch"]),
        # ms: the main path's fixed-trajectory warmup; the ChEES warmup's
        # time, bound and plain time are in the chees_path line.  lanes,
        # ctas, threads, rounds and barriers_per_step: the main path's last
        # timed launch (one 16,384-chain tile), ChEES barriers from the
        # ChEES path's; bc_sweep: K3 ms at each tile width, fixed and ChEES
        dict(name="fused_warmup", route="cuda", source="binf_tpu_torch/csrc/fused_warmup.cu",
             replaces="binf_tpu/ops/pallas/fused_potential.py:478",
             launches=total["fused_warmup"], max_abs_err=max(k3_err, k3c_err),
             ms=main_out["warmup_ms"], plain_ms=k3_plain_ms, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=None, **main_out["k3_launch"],
             chees_barriers_per_step=chees_out["k3_launch"]["barriers_per_step"],
             bc_sweep={bc: {t: r["k3_ms"] for t, r in row.items()} for bc, row in sweep.items()},
             families={n: family_branch(f, "k3") for n, f in branches.items()},
             traced={n: traced_branch(t, "k3") for n, t in traced_out["models"].items()},
             wide=wide_branch(wide_out["models"], "k3"),
             wider=wider_branch(wider_out["models"], "k3")),
        # ms: the model path's sampling; plain_ms over PLAIN_CUT of its
        # steps; lanes to barriers_per_step: the model path's last timed launch;
        # dense_ms: the dense path's K4 launch (8,192 chains, 1,000 steps, the
        # (D, D) metric) against its own bound
        dict(name="fused_potential_hmc", route="cuda",
             source="binf_tpu_torch/csrc/fused_potential.cu",
             replaces="binf_tpu/ops/pallas/fused_potential.py:321",
             launches=total["fused_potential_hmc"], max_abs_err=k4_err,
             ms=model_out["sampling_ms"], plain_ms=k4_plain_ms, plain_steps=PLAIN_CUT,
             bound_ms=k4_bound[0], bound_by=k4_bound[1], library_ms=None,
             dense_ms=dense_out["k4_ms"], dense_bound_ms=dense_out["k4_bound_ms"],
             dense_bound_by=dense_out["k4_bound_by"], **model_out["k4_launch"],
             bc_sweep={bc: {t: r["k4_ms"] for t, r in row.items()} for bc, row in sweep.items()},
             families={n: dict(family_branch(f, "k4"), max_abs_err=f["checks"]["k4_draws"])
                       for n, f in branches.items()},
             traced={n: traced_branch(t, "k4") for n, t in traced_out["models"].items()},
             wide=wide_branch(wide_out["models"], "k4"),
             wider=wider_branch(wider_out["models"], "k4")),
        # ms: the gibbs path's kernel (events around the call, the wrapper's
        # host work included), device_ms the kernel alone (profiler), and
        # bound_share against device_ms; plain_ms over PLAIN_CUT of its
        # sweeps; lanes to rows_in_registers: its last timed launch
        dict(name="fused_gibbs", route="cuda", source="binf_tpu_torch/csrc/fused_gibbs.cu",
             replaces="binf_tpu/ops/pallas/fused_gibbs.py:70", launches=total["fused_gibbs"],
             max_abs_err=k5_err, ms=gibbs_out["kernel_ms"],
             device_ms=gibbs_out["kernel_device_ms"], plain_ms=k5_plain_ms,
             plain_steps=PLAIN_CUT, bound_ms=k5_bound[0], bound_by=k5_bound[1],
             library_ms=None, bound_share=k5_bound[0] / gibbs_out["kernel_device_ms"],
             **gibbs_out["k5_launch"]),
        # ms: device time of a launch at 2,048 beads (K6a a tile and a sum
        # kernel, K6b one kernel), W and logD read from HBM, against the HBM
        # bound (the L2-resident time is in the chromatin_path line);
        # max_abs_err of the loss, relative error <= 1e-5
        dict(name="pairwise_fwd", route="cuda", source="binf_tpu_torch/csrc/pairwise.cu",
             replaces="binf_tpu/ops/pallas/pairwise.py:79", launches=total["pairwise_fwd"],
             max_abs_err=k6["fwd_err"], ms=k6["fwd_alone_ms"],
             plain_ms=k6["fwd_plain_ms"], bound_ms=k6a_bound[0], bound_by=k6a_bound[1],
             library_ms=None, **chrom_out["k6_launch"]["pairwise_fwd"]),
        dict(name="pairwise_bwd", route="cuda", source="binf_tpu_torch/csrc/pairwise.cu",
             replaces="binf_tpu/ops/pallas/pairwise.py:132", launches=total["pairwise_bwd"],
             max_abs_err=k6["bwd_err"], ms=k6["bwd_alone_ms"],
             plain_ms=k6["bwd_plain_ms"], bound_ms=k6b_bound[0], bound_by=k6b_bound[1],
             library_ms=None, bound_share=k6b_bound[0] / k6["bwd_alone_ms"],
             **chrom_out["k6_launch"]["pairwise_bwd"]),
        # ms: the chain-grid path's K7 launch (CUDA events, 200 steps of 2,048
        # chains at 64 beads); plain_ms over CG_CHECK_STEPS of them; the
        # 256-bead time is in the chain_grid_path line; launches: the Gram
        # density's, the traced densities' in their own rows
        dict(name="chain_grid_hmc", route="cuda", source="binf_tpu_torch/csrc/chain_grid.cu",
             replaces="binf_tpu/ops/pallas/chain_grid.py:296",
             launches=total["chain_grid_hmc"] - cgt_out["launches"]["chain_grid_hmc"]
             - wide_out["launches"]["chain_grid_hmc"] - wider_out["launches"]["chain_grid_hmc"],
             max_abs_err=k7_err, ms=cg_out["k7_ms"],
             plain_ms=k7_plain_ms, plain_steps=CG_CHECK_STEPS, bound_ms=k7_bound[0],
             bound_by=k7_bound[1], library_ms=None,
             bound_share=k7_bound[0] / cg_out["k7_ms"], **cg_out["k7_launch"],
             traced={n: cgt_branch(t) for n, t in cg_out["traced"].items() if "k7_ms" in t},
             wide=wide_branch(wide_out["models"], "k7"),
             wider=wider_branch(wider_out["models"], "k7")),
        # ms: device time of one launch at C = 8,192, D = 128, L = 32; plain:
        # the torch.matmul leapfrog; library: the same with addmm kicks;
        # bound_route: the route of the least time (3xTF32 or float32 FMA);
        # kernel_route: the route the launch took
        dict(name="quadratic_leapfrog", route="cuda", source="binf_tpu_torch/csrc/leapfrog.cu",
             replaces="binf_tpu/ops/pallas/leapfrog.py:70",
             launches=total["quadratic_leapfrog"], max_abs_err=k8["err"], ms=k8["ms"],
             plain_ms=k8["plain_ms"], bound_ms=k8_bound[0], bound_by=k8_bound[1],
             library_ms=k8["library_ms"], bound_route=k8_bound_route,
             bound_share=k8_bound[0] / k8["ms"], **quad_out["k8_launch"]),
    ]
    print(json.dumps({"main_path": main_out}))
    print(json.dumps({"regression_path": regression_out}))
    print(json.dumps({"model_path": model_out}))
    print(json.dumps({"chees_path": chees_out}))
    print(json.dumps({"gibbs_path": gibbs_out}))
    print(json.dumps({"collapsed_gibbs_path": collapsed_out}))
    print(json.dumps({"chromatin_path": chrom_out}))
    print(json.dumps({"chain_grid_path": cg_out}))
    print(json.dumps({"quadratic_path": quad_out}))
    print(json.dumps({"production_path": production_out}))
    print(json.dumps({"dense_path": dense_out}))
    print(json.dumps({"chees_xla_path": chees_xla_out}))
    print(json.dumps({"router_path": router_out}))
    print(json.dumps({"router_smem_path": smem_out}))
    print(json.dumps({"families_path": families_out}))
    print(json.dumps({"hierarchical_path": hier_out}))
    print(json.dumps({"family_dims_path": dims_out}, default=str))
    print(json.dumps({"traced_path": traced_out}, default=str))
    print(json.dumps({"nuts_path": nuts_out}))
    print(json.dumps({"samplers_path": samplers_out}))
    print(json.dumps({"smc_path": smc_out}))
    print(json.dumps({"vi_path": vi_out}))
    print(json.dumps({"cli_path": cli_out}))
    print(json.dumps({"scripts_path": scripts_out}))
    print(json.dumps({"mesh_path": mesh_out}))
    print(json.dumps({"wide_path": wide_out}, default=str))
    print(json.dumps({"wider_path": wider_out}, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2:]))
    sys.exit(main())
