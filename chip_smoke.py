#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``binf_tpu_torch/csrc`` (nvcc, first use), holds
each kernel against its plain PyTorch version on the card, then drives
three paths at full width, each once cold and ``REPS`` times timed, scored
as min bulk ESS over the end-to-end wall time:

- ``main_path``: the headline composition of ``bench.py`` (16,384 chains,
  500 fused-warmup steps pooled over one tile of all chains, 4,000 fused
  linear-regression sampling steps at L = 10: K3 then K2);
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
  kernels K6a/K6b) and the exact precision draw, 200 sweeps.

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
# Philox seed of the six-step K3 comparison: no decision of the plain
# version's 512-chain tiles lies within 1e-4 of its threshold
K3_SHORT_SEED = 9
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, int32 operations/s (64 of the 128 lanes per SM)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
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

    def plain_volume():
        for s0 in range(0, steps, 500):
            prng.philox_noise_plain(7, prng.TAG_SAMPLE, N_CHAINS, min(500, steps - s0), 5,
                                    step0=s0, device=dev)

    plain_ms, _ = timed(plain_volume)
    bms, by = bound_ms(steps * N_CHAINS * 6 * 4, steps * N_CHAINS * 5 * 20,
                       philox_ops(steps, N_CHAINS, 5))
    progress(f"philox: {ms:.3f} ms kernel, {plain_ms:.1f} ms plain, bound {bms:.3f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def flip_check(label, draws_k, accept_k, q0, plain_draws, margin, accepts_p, err_tol=1e-2):
    """A whole-run kernel against its plain version on one noise stream.
    An MH decision within rounding of its threshold may flip between two
    float32 implementations; the flips are found from the kernel's draws
    (a step was accepted iff the chain moved) and the plain version's
    decisions (the sign of log u - (E0 - E1)), and each chain's first flip
    is held to its margin.  Returns the largest draw error on the chains
    that took the same decisions throughout."""
    n_steps, n_chains = margin.shape
    moved = (draws_k != torch.cat([q0[None], draws_k[:-1]])).any(dim=2)  # (steps, C)
    flips = moved != (margin < 0)
    flipped = flips.any(dim=0)
    chains = torch.nonzero(flipped).flatten()
    first = flips.float().argmax(dim=0)[chains]
    n_flips = int(chains.numel())
    worst = float(margin[first, chains].abs().max()) if n_flips else 0.0
    progress(f"{label}: {n_flips} of {n_chains} chains flipped an MH decision "
             f"(largest |log u - (E0 - E1)| at a first flip {worst:.3g})")
    print(f"{label} MH flips: {n_flips} of {n_chains} chains over {n_steps} steps")
    # float32 rounding moves E0 - E1 by ~1e-5 here: a decision flips only
    # that close to its threshold.  A 1e-6 relative change of the start
    # flips ~0.1% of the plain version's chains over these steps, so 1% is
    # ten times that.
    check(worst < 1e-3, f"{label}: each chain's first flipped decision lay within 1e-3 "
                        "of its threshold")
    check(n_flips <= n_chains // 100, f"{label}: {n_flips} flipped chains <= 1%")
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
    """K2 against its plain version at the main width on one Philox stream."""
    g = torch.Generator().manual_seed(3)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((N_CHAINS, 5), generator=g)).to(dev)
    eps = torch.tensor([0.2], device=dev)
    im = torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    draws_k, acc_k = fh.fused_linreg_hmc_run(
        q0, 11, density.V, density.y, density.prior_var, 1.0, 0.2, eps, inverse_mass=im,
        num_steps=K2_CHECK_STEPS, steps_per_block=K2_CHECK_STEPS, block_chains=N_CHAINS,
        device=dev)
    plain = fh.linreg_hmc_plain(density, q0, eps, im, num_steps=K2_CHECK_STEPS,
                                num_leapfrog=N_LEAPFROG, seed=11)
    torch.cuda.synchronize()
    err, _ = flip_check("K2", draws_k, acc_k, q0, plain.draws, plain.margin, plain.accepts)
    return err


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
    # six steps first, before the chaos grows.  A decision within rounding
    # of its threshold may flip; the flipped chain then moves its tile's
    # pooled acceptance by ~1/bc, which at 512 chains shifts the step size
    # and with it every chain of the tile, and at 16,384 chains shifts
    # nothing past the tolerances.  So a tile agrees (<= 1% of its chains
    # parted by > 1e-3, metric within 1e-2) unless the plain version took
    # one of its decisions within 1e-4 of the threshold, and at most a
    # quarter of the tiles may be excused so.
    for bc in (512, N_CHAINS):
        tiles = N_CHAINS // bc
        kw = dict(num_warmup=6, num_leapfrog=N_LEAPFROG, block_chains=bc)
        q_k, eps_k, im_k = fp.fused_warmup_run(density, q_init, K3_SHORT_SEED, 0.1,
                                               device=dev, **kw)
        margins = []
        q_p, eps_p, im_p = fp.fused_warmup_plain(density, q_init, K3_SHORT_SEED, 0.1,
                                                 target_accept=0.8, init_search=False,
                                                 margins=margins, **kw)
        near = (torch.stack(margins).abs() < 1e-4).reshape(-1, tiles, bc).any(2).any(0)
        parted = ((q_k - q_p).abs().amax(dim=1) > 1e-3).reshape(tiles, bc).float().mean(1)
        rel_i = ((im_k - im_p).abs() / im_p).reshape(tiles, bc * 5).amax(1)
        agree = (parted <= 0.01) & (rel_i <= 1e-2)
        excused = int((~agree & near).sum())
        check(bool((agree | near).all()) and excused <= tiles // 4,
              f"K3 bc={bc}, 6 steps: {int(agree.sum())} of {tiles} tiles agree (<= 1% of "
              f"chains parted by > 1e-3, metric rel err <= 1e-2), {excused} excused for a "
              f"decision within 1e-4 of its threshold; worst tile: "
              f"{float(parted.max()):.2%} parted, metric {float(rel_i.max()):.3g}")
        # six steps leave a one-step final buffer: eps is the reset value
        check(bool(torch.equal(eps_k, eps_p)), f"K3 bc={bc}, 6 steps: eps equal")
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
    (plus 1e-4), unless it was excused: by
    an MH decision within 1e-4 of its threshold, or by a leapfrog count
    that flipped with its argument within rounding of an integer (checked
    count by count).  Then 500 steps statistically: the kernel and the
    plain version must agree on eps, the metric and T per tile and pooled
    within three times the spread that two 1e-6 relative changes of the
    start give the plain version in this same run, plus 2%."""
    kw = dict(num_leapfrog=N_LEAPFROG, trajectory="chees", max_leapfrog=CHEES_MAX_LEAP,
              target_accept=0.651)

    def perturbed(k):
        noise = torch.randn(q_init.shape, generator=torch.Generator().manual_seed(6 + k))
        return q_init * (1.0 + 1e-6 * noise.to(dev))

    for bc in (512, N_CHAINS):
        tiles = N_CHAINS // bc
        counts_k = torch.zeros((6, tiles), dtype=torch.int32, device=dev)
        counts_p = torch.zeros_like(counts_k)
        out_k = fp.fused_warmup_run(density, q_init, K3_SHORT_SEED, 0.1, num_warmup=6,
                                    block_chains=bc, leapfrog_counts=counts_k, device=dev, **kw)
        margins, args = [], []
        pk = dict(num_warmup=6, block_chains=bc, init_search=False, **kw)
        out_p = fp.fused_warmup_plain(density, q_init, K3_SHORT_SEED, 0.1, margins=margins,
                                      leap_args=args, leapfrog_counts=counts_p, **pk)
        out_s = fp.fused_warmup_plain(density, perturbed(0), K3_SHORT_SEED, 0.1, **pk)
        torch.cuda.synchronize()
        leap_flipped = leap_flip_check(f"K3 ChEES bc={bc}", counts_k, counts_p,
                                       torch.stack(args))
        near = ((torch.stack(margins).abs() < 1e-4).reshape(-1, tiles, bc).any(2).any(0)
                | leap_flipped)

        def dist(a, b):
            # positions: the 90th percentile over a tile's chains (a chain
            # whose decision flipped in the perturbed run does not set it)
            return ((a[0] - b[0]).abs().amax(1).reshape(tiles, bc).quantile(0.9, dim=1),
                    ((a[2] - b[2]).abs() / b[2]).reshape(tiles, bc * 5).amax(1))

        (q_kp, i_kp), (q_sp, i_sp) = dist(out_k, out_p), dist(out_s, out_p)
        agree = (q_kp <= 10 * q_sp + 1e-4) & (i_kp <= 10 * i_sp + 1e-4)
        excused = int((~agree & near).sum())
        # a flipped leapfrog count moves every chain of its tile, so one
        # tile may be excused even where there is only one
        check(bool((agree | near).all()) and excused <= max(tiles // 4, 1),
              f"K3 ChEES bc={bc}, 6 steps: {int(agree.sum())} of {tiles} tiles agree "
              f"(positions and metric within 10 x the perturbed plain distance + 1e-4), "
              f"{excused} excused for a flip; worst tile: positions {float(q_kp.max()):.3g} "
              f"(perturbed {float(q_sp.max()):.3g}), metric {float(i_kp.max()):.3g}")
        # six steps leave a one-step final buffer: eps is the reset value
        # exp(0); T is exp(log T) clamped, within a rounding on agreeing tiles
        eps_k, T_k, eps_p, T_p = out_k[1], out_k[3], out_p[1], out_p[3]
        rel_T = ((T_k - T_p).abs() / T_p).reshape(tiles, bc)[agree]
        worst_T = float(rel_T.max()) if rel_T.numel() else 0.0
        check(bool(torch.equal(eps_k, eps_p)) and worst_T <= 1e-4,
              f"K3 ChEES bc={bc}, 6 steps: eps equal, T within 1e-4 on agreeing tiles")
    errs, plain_ms = [], None
    for bc in (N_CHAINS,):
        tiles = N_CHAINS // bc
        counts = torch.zeros((N_WARMUP, tiles), dtype=torch.int32, device=dev)
        out_k = fp.fused_warmup_run(density, q_init, 5, 0.1, num_warmup=N_WARMUP,
                                    block_chains=bc, leapfrog_counts=counts, device=dev, **kw)
        pk = dict(num_warmup=N_WARMUP, block_chains=bc, init_search=False, **kw)
        ms_p, out_p = timed(lambda: fp.fused_warmup_plain(density, q_init, 5, 0.1, **pk))
        spread_runs = [fp.fused_warmup_plain(density, perturbed(k), 5, 0.1, **pk)
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


def posterior_gates(label, draws, accept, accept_range, V, ys, dev):
    """The main path's posterior checks on draws ``(steps, C, 5)`` in
    (coefficients, log precision) space (``accept`` None: no acceptance
    gate); returns min bulk ESS."""
    from binf_tpu_torch.diagnostics import ess

    m_ess = min(float(ess(draws[:, :, :4]).min()), float(ess(torch.exp(draws[:, :, 4]))))
    check(bool(torch.isfinite(draws).all()) and draws.shape == (N_SAMPLES, N_CHAINS, 5),
          f"{label}: finite draws of shape ({N_SAMPLES}, {N_CHAINS}, 5)")
    if accept is not None:  # Gibbs draws are exact: no acceptance to gate
        lo, hi = accept_range
        check(lo < accept < hi, f"{label}: acceptance {accept:.4f} in ({lo}, {hi})")
    check(np.isfinite(m_ess) and m_ess > 0, f"{label}: min bulk ESS {m_ess:.1f} > 0")
    kept = draws[N_SAMPLES // 4:].double()
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
           "min_bulk_ess": m_ess, "ess_per_s": m_ess / e2e, "launches": launches}
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
    check(launches["fused_gibbs"] > 0, f"gibbs path launched fused_gibbs "
                                       f"{launches['fused_gibbs']} times")
    check(bool((draws[..., 4] > 0).all()), "gibbs path: every precision draw positive")
    unc = torch.cat([draws[..., :4], torch.log(draws[..., 4:])], dim=-1)
    m_ess = posterior_gates("gibbs path", unc, None, None, V, ys, dev)
    n_draws = N_SAMPLES * N_CHAINS
    check(m_ess > 0.5 * n_draws, f"gibbs path: min bulk ESS {m_ess:.4g} > half the "
                                 f"{n_draws} draws (collapsed Gibbs draws are nearly iid)")
    e2e = float(np.mean(walls))
    kept = draws[N_SAMPLES // 4:].double()
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
    # one more run under the profiler, outside the timed ones: the kernels'
    # device time and the card's busy time
    prof = profile_device(lambda: run(2 + REPS), {
        "k6a": ("pairwise_tile_kernel<false>", "pairwise_tile_kernelILb0", "sum_partials"),
        "k6b": ("pairwise_tile_kernel<true>", "pairwise_tile_kernelILb1", "sum_forces")})
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
        # the device kernels of a K6a or K6b launch: a tile and a sum kernel
        out.update(k6a_device_ms=prof["k6a"][0], k6b_device_ms=prof["k6b"][0],
                   k6a_device_launch_ms=2 * prof["k6a"][0] / max(prof["k6a"][1], 1),
                   k6b_device_launch_ms=2 * prof["k6b"][0] / max(prof["k6b"][1], 1),
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
    from binf_tpu_torch.ops.kernels import densities as dens_mod
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg
    from binf_tpu_torch.ops.kernels import fused_hmc as fh
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels import pairwise as pw
    from binf_tpu_torch.ops.kernels import prng
    from binf_tpu_torch.ops.math import vandermonde
    from binf_tpu_torch.parallel.runner import init_chains, run_chains
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers import gibbs as gibbs_mod
    from binf_tpu_torch.samplers.fused import fused_model_hmc

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
            t = time.perf_counter()
            draws, acc, eps, im, ev = main_path(fh, fp, density, V, ys, prior_var, q_init,
                                                2 * rep + 2, dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            warm_ms.append(ev[0].elapsed_time(ev[1]))
            samp_ms.append(ev[1].elapsed_time(ev[2]))
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
            "ess_per_s": m_ess / e2e, "build_s": build_s, "launches": launches}
        del draws

        # -- plain K2 at the main path's inputs, for its time ---------------------------
        qw, eps_c, im_c = fp.fused_warmup_run(density, q_init, 2 * REPS, 0.1,
                                              num_warmup=N_WARMUP, block_chains=N_CHAINS,
                                              device=dev)
        k2_plain_ms, _ = timed(lambda: fh.linreg_hmc_plain(
            density, qw, eps_c.mean().reshape(1), im_c.mean(0), num_steps=N_SAMPLES,
            num_leapfrog=N_LEAPFROG, seed=2 * REPS + 1))

        # -- the model and ChEES paths through fused_model_hmc --------------------------
        posterior = make_posterior(xses, ys)
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
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    n, d, D = 20, 4, 5
    ev_lin = eval_flops(n, d)
    # K2 writes the draws and reads its start; K3 reads and writes
    # positions and writes a step size and a metric per chain
    k2_bound = bound_ms(N_SAMPLES * N_CHAINS * D * 4 + N_CHAINS * (D + 1) * 4,
                        N_SAMPLES * N_CHAINS * trajectory_flops(ev_lin, D, N_LEAPFROG),
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
                     plain_steps=PLAIN_CUT)
    paths = (main_out, model_out, chees_out, gibbs_out, collapsed_out, chrom_out)
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
    kernels = [
        # the paths run Philox inside K2, K3 and K4 (philox.cuh), each of
        # their launches counts one; ms is philox.cu's kernel standing alone
        dict(name="philox", route="cuda", source="binf_tpu_torch/csrc/philox.cuh",
             replaces="binf_tpu/ops/pallas/prng.py:23", launches=total["philox"],
             max_abs_err=philox["max_abs_err"], ms=philox["ms"],
             plain_ms=philox["plain_ms"], bound_ms=philox["bound_ms"],
             bound_by=philox["bound_by"], library_ms=None),
        dict(name="fused_linreg_hmc", route="cuda", source="binf_tpu_torch/csrc/fused_hmc.cu",
             replaces="binf_tpu/ops/pallas/fused_hmc.py:65",
             launches=total["fused_linreg_hmc"], max_abs_err=k2_err,
             ms=main_out["sampling_ms"], plain_ms=k2_plain_ms, bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
        # ms: the main path's fixed-trajectory warmup; the ChEES warmup's
        # time, bound and plain time are in the chees_path line
        dict(name="fused_warmup", route="cuda", source="binf_tpu_torch/csrc/fused_warmup.cu",
             replaces="binf_tpu/ops/pallas/fused_potential.py:478",
             launches=total["fused_warmup"], max_abs_err=max(k3_err, k3c_err),
             ms=main_out["warmup_ms"], plain_ms=k3_plain_ms, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=None),
        # ms: the model path's sampling; plain_ms over PLAIN_CUT of its steps
        dict(name="fused_potential_hmc", route="cuda",
             source="binf_tpu_torch/csrc/fused_potential.cu",
             replaces="binf_tpu/ops/pallas/fused_potential.py:321",
             launches=total["fused_potential_hmc"], max_abs_err=k4_err,
             ms=model_out["sampling_ms"], plain_ms=k4_plain_ms, plain_steps=PLAIN_CUT,
             bound_ms=k4_bound[0], bound_by=k4_bound[1], library_ms=None),
        # ms: the gibbs path's kernel; plain_ms over PLAIN_CUT of its sweeps
        dict(name="fused_gibbs", route="cuda", source="binf_tpu_torch/csrc/fused_gibbs.cu",
             replaces="binf_tpu/ops/pallas/fused_gibbs.py:70", launches=total["fused_gibbs"],
             max_abs_err=k5_err, ms=gibbs_out["kernel_ms"], plain_ms=k5_plain_ms,
             plain_steps=PLAIN_CUT, bound_ms=k5_bound[0], bound_by=k5_bound[1],
             library_ms=None),
        # ms: device time of a launch (tile and sum kernels) at 2,048 beads,
        # W and logD read from HBM, against the HBM bound (the L2-resident
        # time is in the chromatin_path line); max_abs_err of the loss,
        # relative error <= 1e-5
        dict(name="pairwise_fwd", route="cuda", source="binf_tpu_torch/csrc/pairwise.cu",
             replaces="binf_tpu/ops/pallas/pairwise.py:79", launches=total["pairwise_fwd"],
             max_abs_err=k6["fwd_err"], ms=k6["fwd_alone_ms"],
             plain_ms=k6["fwd_plain_ms"], bound_ms=k6a_bound[0], bound_by=k6a_bound[1],
             library_ms=None),
        dict(name="pairwise_bwd", route="cuda", source="binf_tpu_torch/csrc/pairwise.cu",
             replaces="binf_tpu/ops/pallas/pairwise.py:132", launches=total["pairwise_bwd"],
             max_abs_err=k6["bwd_err"], ms=k6["bwd_alone_ms"],
             plain_ms=k6["bwd_plain_ms"], bound_ms=k6b_bound[0], bound_by=k6b_bound[1],
             library_ms=None),
    ]
    print(json.dumps({"main_path": main_out}))
    print(json.dumps({"model_path": model_out}))
    print(json.dumps({"chees_path": chees_out}))
    print(json.dumps({"gibbs_path": gibbs_out}))
    print(json.dumps({"collapsed_gibbs_path": collapsed_out}))
    print(json.dumps({"chromatin_path": chrom_out}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
