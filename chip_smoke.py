#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``binf_tpu_torch/csrc`` (nvcc, first use), holds
each kernel against its plain PyTorch version on the card, then drives
nine paths at full width, each once cold and ``REPS`` times timed (the
regression path once), scored as min bulk ESS (or sweeps) over the
end-to-end wall time:

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
- ``quadratic_path``: ``quadratic_hmc`` through ``init_chains``/``run_chains``
  on the JAX package's recorded leapfrog shape (8,192 chains, D = 128, L =
  32, 200 sweeps), every trajectory in the leapfrog kernel K8.

Besides the paths, K3 and K4 are timed at tiles of 512, 2,048 and 16,384
chains (``SWEEP_BC``, fixed and ChEES; K3 fixed also at L = 1): the
``model_path`` line's ``bc_sweep`` and the ``bc_sweep`` key of both kernels
in the ``kernels`` line.  Their ``lanes``, ``ctas``, ``threads``,
``rounds`` and ``barriers_per_step`` keys are what the timed launch of the
main path (K3) and the model path (K4) reported, the barriers counted by
K3's grid barrier word (``LaunchRecord``).

Every row of the ``kernels`` line carries the grid its timed launch
reported (``_build.LaunchRecord``: CTAs and threads; K2-K4 and K7 also
their lanes a chain and rounds); K2's and K7's also the share of the bound
(``bound_share``), their bounds counting the least work (L evaluations a
step; K7 each unordered pair once).  The previous designs' times from
``PERF.md`` are printed beside the new ones on stderr only.

Progress goes to stderr.  Standard output ends with one JSON line per path,
the card's name and power limit, one JSON line of kernels
(``{"kernels": [...]}``) and, last, ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero; so does a host without a CUDA card.
"""

from __future__ import annotations

import itertools
import json
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
REG_CHAINS, REG_WARMUP, REG_SAMPLES = 8192, 400, 1000
# tile widths at which K3 and K4 are timed besides the paths' own
# (samplers/fused.py::auto_block_chains picks the widest, 16,384 chains)
SWEEP_BC = (512, 2048, 16384)
# Philox seeds of the six-step K3 comparisons, fixed and ChEES, each at
# both tile widths
K3_SHORT_SEEDS = (9, 10, 11, 12)
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
CHROM_HMC_STEPS = 5
CHROM_MAX_STEP = 3e-3
CHROM_EPS_OMEGA = 1.0
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

# the previous designs of K2 (one thread a chain, rows from shared memory),
# K7 (one CTA a chain), K8 (float32 FMA from shared memory) and K6b (tiles
# and a second pass over partials) on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6), printed beside the current kernels' times
PREVIOUS_MS = {"K2": 30.60, "K7": 130.39, "K7 256": 154.78, "K8": 0.4798, "K6b": 0.02871}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, dense TF32 FLOP/s on them, int32 operations/s (64 of the
# 128 lanes per SM)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 494.7e12
PEAK_I32 = 33.5e12
# integer operations of one Philox4x32-10 call: 10 rounds of 2 mul.lo,
# 2 mul.hi and 4 xor, 9 key bumps of 2 adds
PHILOX_CALL_OPS = 98

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def bound_ms(bytes_moved: float, flops: float, int_ops: float):
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = flops / PEAK_F32 + int_ops / PEAK_I32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gibbs_flops(n: int, d: int) -> int:
    """Float operations of one K5 sweep of one chain (csrc/fused_gibbs.cu):
    the residual sum of squares, four Marsaglia-Tsang rounds (14 each with
    their two logs), the precision, P and its right-hand side, the Cholesky
    factor (d square roots, d(d-1)/2 divisions), the forward and two back
    solves, the update, and 4 + d Box-Muller normals at 20 each."""
    chol = sum(2 * k for i in range(d) for k in range(i + 1)) + d + d * (d - 1) // 2
    return (n * (2 * d + 3) + 4 * 14 + 3 + d * (d + 1) // 2 + d + 3 * d + chol
            + 3 * d * d + d + (4 + d) * 20)


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


def philox_ops(steps: int, chains: int, D: int) -> int:
    """Philox work of ``steps`` HMC steps of ``chains`` chains: ceil(D/2)
    momentum slots and the accept uniform per chain and step."""
    return steps * chains * ((D + 1) // 2 + 1) * PHILOX_CALL_OPS


# -- phases ---------------------------------------------------------------------------


def phase_build(build):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    out_dir = build.build_all()
    seconds = time.perf_counter() - t
    progress(f"kernels built in {seconds:.1f}s into {out_dir.name}")
    for log in sorted(out_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                progress(f"ptxas {log.stem}: {line.strip()}")
    return seconds


def phase_philox(prng, dev):
    rng = np.random.default_rng(0)
    ctr = torch.tensor(rng.integers(0, 1 << 32, size=(1 << 16, 4), dtype=np.int64),
                       device=dev)
    seed = 0x299F31D0_A4093822
    bits_kernel = prng.philox_bits(ctr, seed)
    bits_plain = prng.philox4x32_10(ctr, prng._key(seed))
    check(torch.equal(bits_kernel, bits_plain), "Philox bits: kernel == plain, bit for bit")

    z_k, u_k = prng.philox_noise(1234, prng.TAG_SAMPLE, N_CHAINS, 8, 5, step0=100,
                                 device=dev)
    z_p, u_p = prng.philox_noise_plain(1234, prng.TAG_SAMPLE, N_CHAINS, 8, 5, step0=100,
                                       device=dev)
    check(torch.equal(u_k, u_p), "Philox uniforms: kernel == plain, bit for bit")
    err = float((z_k - z_p).abs().max())
    # logf/cosf/sqrtf within 2 ulp on normals up to ~5.6 in magnitude
    check(err <= 1e-5, f"Philox normals: max abs err {err:.3g} <= 1e-5")

    # the noise volume of one main-path run: warmup and sampling steps
    # (device time, so the host's allocation of the 1.8 GB output is not in it)
    steps = N_WARMUP + N_SAMPLES
    ms = device_ms(lambda: prng.philox_noise(7, prng.TAG_SAMPLE, N_CHAINS, steps, 5,
                                             device=dev), reps=3)
    launch = grid_keys(prng._build.last_launch["philox"])

    def plain_volume():
        for s0 in range(0, steps, 500):
            prng.philox_noise_plain(7, prng.TAG_SAMPLE, N_CHAINS, min(500, steps - s0), 5,
                                    step0=s0, device=dev)

    plain_ms, _ = timed(plain_volume)
    bms, by = bound_ms(steps * N_CHAINS * 6 * 4, steps * N_CHAINS * 5 * 20,
                       philox_ops(steps, N_CHAINS, 5))
    progress(f"philox: {ms:.3f} ms kernel, {plain_ms:.1f} ms plain, bound {bms:.3f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                launch=launch)


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
    moved = (draws_k != torch.cat([q0[None], draws_k[:-1]])).any(dim=2)  # (steps, C)
    flips = moved != (margin < 0)
    flipped = flips.any(dim=0)
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
    err = float((draws_k - plain_draws)[:, ~flipped].abs().max())
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
    count); at each of K3_SHORT_SEEDS.  Then 500 steps statistically: the
    kernel and the
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
        counts = torch.zeros((N_WARMUP, tiles), dtype=torch.int32, device=dev)
        out_k = fp.fused_warmup_run(density, q_init, 5, 0.1, num_warmup=N_WARMUP,
                                    block_chains=bc, leapfrog_counts=counts, device=dev, **kw)
        pk = dict(num_warmup=N_WARMUP, block_chains=bc, init_search=False, **kw)
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
                  f"K3 ChEES bc={bc}, {N_WARMUP} steps: {name} per tile rel err "
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


def phase_k5_check(fg, density, dev):
    """K5 against its plain version at the main width on one Philox stream,
    the tolerance ten times the spread that a 1e-6 relative change of the
    start gives the plain version (plus 1e-6); tiling does not change the
    draws; staged noise in the JAX layout gives the plain version's draws."""
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
    cov = torch.linalg.inv(lam * Vd.T @ Vd + torch.eye(4, device=dev, dtype=torch.float64) / 5.0)
    exact = cov @ (lam * Vd.T @ yd)
    c_err = float((coeffs.mean(0) - exact).abs().max())
    check(c_err < 0.1, f"{label}: coefficient mean within {c_err:.3g} of the exact "
                       "conditional Gaussian at the mean precision (< 0.1)")
    ss = ((yd[:, None] - Vd @ coeffs[::64].T) ** 2).sum(0)
    expected = float((11.0 / (0.2 + ss / 2)).mean())
    check(abs(lam / expected - 1.0) < 0.1,
          f"{label}: precision mean {lam:.4f} vs Gamma self-consistency {expected:.4f} "
          "(rtol 0.1)")
    return m_ess


def regression_path(build, fh, adaptation, fused_regression_hmc, posterior, V, ys, dev):
    """``fused_regression_hmc`` on the card at the JAX package's defaults
    (8,192 chains, 400 eager warmup steps, 1,000 K2 steps at L = 10, step
    0.05): a short cold run (20 + 50 steps) and one timed run, CUDA events
    around the warmup and K2; gated as the main path."""
    build.reset_launch_counts()
    t = time.perf_counter()
    fused_regression_hmc(posterior, 5, num_warmup=20, num_samples=50, device=dev)
    torch.cuda.synchronize()
    progress(f"regression path cold run: {time.perf_counter() - t:.2f}s")
    with KernelSpans(adaptation, {"window_adaptation": "warmup"}) as warm, \
            KernelSpans(fh, {"_linreg_hmc_cuda": "k2"}) as k2:
        t = time.perf_counter()
        res = fused_regression_hmc(posterior, 6, device=dev)
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
           "leapfrog": N_LEAPFROG, "e2e_ms": wall * 1e3, "warmup_ms": warm.ms("warmup"),
           "k2_ms": k2.ms("k2"), "accept": accept, "step_size": float(res.step_size),
           "min_bulk_ess": m_ess, "ess_per_s": m_ess / wall, "launches": launches}
    progress(f"regression path: e2e {out['e2e_ms']:.1f} ms, eager warmup "
             f"{out['warmup_ms']:.1f} ms, K2 {out['k2_ms']:.2f} ms, accept {accept:.4f}, eps "
             f"{out['step_size']:.5f}, min bulk ESS {m_ess:.1f}, ESS/s {out['ess_per_s']:.4g}")
    return out


def model_run(fused_model_hmc, logdensity, init, seed, chees, dev):
    return fused_model_hmc(
        logdensity, init, seed, num_warmup=N_WARMUP, num_samples=N_SAMPLES,
        num_leapfrog=N_LEAPFROG, initial_step_size=0.1, block_chains=N_CHAINS,
        warmup="fused", trajectory="chees" if chees else "fixed",
        max_leapfrog=CHEES_MAX_LEAP, device=dev)


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
    k5_launch = grid_keys(build.last_launch["fused_gibbs"])
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
    at precision 5; one cold run and REPS timed runs of 200 sweeps, CUDA
    events around every K6a and K6b launch, then one profiled run."""
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

    def run(seed):
        state = kernel.init({"structure": X0, "precision": torch.tensor(5.0, device=dev)})
        gen = torch.Generator(device=dev).manual_seed(seed)
        precs, accs = [], []
        for _ in range(CHROM_SWEEPS):
            state, infos = kernel.step(gen, state)
            precs.append(state.position["precision"])
            accs.append(infos["structure"].acceptance_prob)
        return state, torch.stack(precs), torch.stack(accs)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    progress(f"chromatin path cold run: {time.perf_counter() - t:.2f}s")
    walls, fwd_ms, bwd_ms, accepts = [], [], [], []
    for rep in range(REPS):
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
    # device time and the card's busy time
    prof = profile_device(lambda: run(2 + REPS), {
        "k6a": ("pairwise_tile_kernel", "sum_partials"),
        "k6b": ("pairwise_forces_kernel",)})
    per_sweep = (CHROM_HMC_STEPS + 2, CHROM_HMC_STEPS + 1)
    for name, k in zip(("pairwise_fwd", "pairwise_bwd"), per_sweep):
        check(launches[name] == (REPS + 1) * CHROM_SWEEPS * k,
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
                   profiled_wall_ms=prof["wall"],
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
        U_k, g_k = cg.gram_value_and_grad(gram, flat)
        U2, g2 = cg.gram_value_and_grad(gram, flat)
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
    the Gram density of the 64-bead chromatin model, one cold run and REPS
    timed runs, CUDA events around the warmup and the K7 launch; then the
    same sampling steps through the eager HMC route from the same warmed-up
    state, and K7 alone at 256 beads."""
    from binf_tpu_torch.diagnostics import ess

    X_true, logD, W, init = chromatin_start(chrom, CG_BEADS, CG_CHAINS, dev)
    gram = chrom.make_gram_logdensity(logD, W, device=dev)
    n_obs = float(W.sum())
    emp_prec = n_obs / float(pw.pairwise_loss_plain(X_true, logD, W))

    def run(seed):
        return cgs.chain_grid_model_hmc(
            gram, init, seed, num_warmup=CG_WARMUP, num_samples=CG_SAMPLES,
            num_leapfrog=CG_LEAP, initial_step_size=CG_STEP0, block_chains=CG_BLOCK, device=dev)

    build.reset_launch_counts()
    t = time.perf_counter()
    run(70)
    torch.cuda.synchronize()
    progress(f"chain-grid path cold run: {time.perf_counter() - t:.2f}s")
    walls, warm_ms, k7_ms = [], [], []
    for rep in range(REPS):
        with Recorded(adaptation, {"window_adaptation": "warmup"}) as warm, \
                KernelSpans(cg, {"_chain_grid_cuda": "k7"}) as k7:
            t = time.perf_counter()
            res = run(71 + rep)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        warm_ms.append(warm.ms("warmup"))
        k7_ms.append(k7.ms("k7"))
    launches = dict(build.LAUNCHES)
    k7_launch = launch_keys(build.last_launch["chain_grid_hmc"])
    check(launches["chain_grid_hmc"] == REPS + 1,
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
    from binf_tpu_torch.ops.math import vandermonde
    from binf_tpu_torch.parallel.runner import init_chains, run_chains
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers import adaptation
    from binf_tpu_torch.samplers import chain_grid as cgs
    from binf_tpu_torch.samplers import gibbs as gibbs_mod
    from binf_tpu_torch.samplers import hmc as hmc_mod
    from binf_tpu_torch.samplers import quadratic_hmc as qh
    from binf_tpu_torch.samplers.fused import fused_model_hmc, fused_regression_hmc

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    progress(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    try:
        build_s = phase_build(_build)
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
        k5_err = phase_k5_check(fg, density, dev)
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
        k7_err, k7_plain_ms = phase_k7_check(cg, gram, q_chk, eps_chk, im_chk, dev)
        k8 = phase_k8_check(lf, dev)
        quad_out = quadratic_path(_build, qh, init_chains, run_chains, dev)
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
                        philox_ops(N_SAMPLES, N_CHAINS, D))
    k3_bound = bound_ms(N_CHAINS * (3 * D + 1) * 4,
                        N_WARMUP * N_CHAINS * trajectory_flops(ev_lin, D, N_LEAPFROG),
                        philox_ops(N_WARMUP, N_CHAINS, D))
    # K4 on the model path: reads q0, eps and a metric per chain, writes
    # the draws, the final positions and the accept counts
    k4_bytes = N_CHAINS * (2 * D + 1) * 4 + N_SAMPLES * N_CHAINS * D * 4 + N_CHAINS * (D + 1) * 4
    k4_bound = bound_ms(k4_bytes,
                        N_SAMPLES * N_CHAINS * trajectory_flops(ev_lin, D, N_LEAPFROG),
                        philox_ops(N_SAMPLES, N_CHAINS, D))
    # the ChEES path's kernels: the exact leapfrog counts of this run (one
    # tile of all chains), plus K3's second pass over each step's scratch
    Lw = cspans.counts["warmup"].double()
    Ls = cspans.counts["sampling"].double()
    k3c_bound = bound_ms(N_CHAINS * (3 * D + 2) * 4,
                         N_CHAINS * float(trajectory_flops(ev_lin, D, Lw).sum())
                         + N_WARMUP * N_CHAINS * 10 * D,
                         philox_ops(N_WARMUP, N_CHAINS, D))
    k4c_bound = bound_ms(k4_bytes, N_CHAINS * float(trajectory_flops(ev_lin, D, Ls).sum()),
                         philox_ops(N_SAMPLES, N_CHAINS, D))
    chees_out.update(warmup_bound_ms=k3c_bound[0], sampling_bound_ms=k4c_bound[0],
                     warmup_plain_ms=k3c_plain_ms, sampling_plain_ms=k4c_plain_ms,
                     plain_steps=PLAIN_CUT)
    model_out.update(sampling_bound_ms=k4_bound[0], sampling_plain_ms=k4_plain_ms,
                     plain_steps=PLAIN_CUT, bc_sweep=sweep)
    paths = (main_out, regression_out, model_out, chees_out, gibbs_out, collapsed_out, chrom_out,
             cg_out, quad_out)
    total = {name: sum(p["launches"][name] for p in paths) for name in main_out["launches"]}
    # K5 writes the draws and reads its start
    k5_bound = bound_ms(N_SAMPLES * N_CHAINS * D * 4 + N_CHAINS * D * 4,
                        N_SAMPLES * N_CHAINS * gibbs_flops(n, d),
                        N_SAMPLES * N_CHAINS * (3 + (d + 1) // 2) * PHILOX_CALL_OPS)
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
                        philox_ops(CG_SAMPLES, CG_CHAINS, D7))
    D7b = 1 + 3 * CG_BIG_BEADS
    k7_big_bound = bound_ms(
        CG_BIG_STEPS * CG_BIG_CHAINS * D7b * 4 + CG_BIG_CHAINS * (2 * D7b + 2) * 4 + D7b * 4
        + 8 * CG_BIG_BEADS ** 2,
        CG_BIG_CHAINS * least_run_flops(gram_eval_flops(CG_BIG_BEADS), D7b, CG_LEAP,
                                        CG_BIG_STEPS),
        philox_ops(CG_BIG_STEPS, CG_BIG_CHAINS, D7b))
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
    for label, ms, prev, bound in (("K2", main_out["sampling_ms"], PREVIOUS_MS["K2"], k2_bound[0]),
                                  ("K7 64 beads", cg_out["k7_ms"], PREVIOUS_MS["K7"], k7_bound[0]),
                                  ("K7 256 beads", cg_out["big_k7_ms"], PREVIOUS_MS["K7 256"],
                                   k7_big_bound[0]),
                                  ("K8", k8["ms"], PREVIOUS_MS["K8"], k8_bound[0]),
                                  ("K6b from HBM", k6["bwd_alone_ms"], PREVIOUS_MS["K6b"],
                                   k6b_bound[0])):
        progress(f"{label}: {ms:.4g} ms (the previous design {prev} ms), bound {bound:.4g} ms, "
                 f"{100 * bound / ms:.1f}% of it")
    kernels = [
        # the paths run Philox inside K2, K3 and K4 (philox.cuh), each of
        # their launches counts one; ms is philox.cu's kernel standing alone
        dict(name="philox", route="cuda", source="binf_tpu_torch/csrc/philox.cuh",
             replaces="binf_tpu/ops/pallas/prng.py:23", launches=total["philox"],
             max_abs_err=philox["max_abs_err"], ms=philox["ms"],
             plain_ms=philox["plain_ms"], bound_ms=philox["bound_ms"],
             bound_by=philox["bound_by"], library_ms=None, **philox["launch"]),
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
             bc_sweep={bc: {t: r["k3_ms"] for t, r in row.items()} for bc, row in sweep.items()}),
        # ms: the model path's sampling; plain_ms over PLAIN_CUT of its
        # steps; lanes to barriers_per_step: the model path's last timed launch
        dict(name="fused_potential_hmc", route="cuda",
             source="binf_tpu_torch/csrc/fused_potential.cu",
             replaces="binf_tpu/ops/pallas/fused_potential.py:321",
             launches=total["fused_potential_hmc"], max_abs_err=k4_err,
             ms=model_out["sampling_ms"], plain_ms=k4_plain_ms, plain_steps=PLAIN_CUT,
             bound_ms=k4_bound[0], bound_by=k4_bound[1], library_ms=None,
             **model_out["k4_launch"],
             bc_sweep={bc: {t: r["k4_ms"] for t, r in row.items()} for bc, row in sweep.items()}),
        # ms: the gibbs path's kernel; plain_ms over PLAIN_CUT of its sweeps
        dict(name="fused_gibbs", route="cuda", source="binf_tpu_torch/csrc/fused_gibbs.cu",
             replaces="binf_tpu/ops/pallas/fused_gibbs.py:70", launches=total["fused_gibbs"],
             max_abs_err=k5_err, ms=gibbs_out["kernel_ms"], plain_ms=k5_plain_ms,
             plain_steps=PLAIN_CUT, bound_ms=k5_bound[0], bound_by=k5_bound[1],
             library_ms=None, **gibbs_out["k5_launch"]),
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
        # 256-bead time is in the chain_grid_path line
        dict(name="chain_grid_hmc", route="cuda", source="binf_tpu_torch/csrc/chain_grid.cu",
             replaces="binf_tpu/ops/pallas/chain_grid.py:296",
             launches=total["chain_grid_hmc"], max_abs_err=k7_err, ms=cg_out["k7_ms"],
             plain_ms=k7_plain_ms, plain_steps=CG_CHECK_STEPS, bound_ms=k7_bound[0],
             bound_by=k7_bound[1], library_ms=None,
             bound_share=k7_bound[0] / cg_out["k7_ms"], **cg_out["k7_launch"]),
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
