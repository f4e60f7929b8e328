#!/usr/bin/env python3
"""Where the time goes in the whole-run kernels K2, K4, K5 and K7, the
leapfrog K8 and the restraint kernels K6a and K6b, on one NVIDIA card.

    python3 scripts/kernel_cycles.py [--out FILE] [--sections k8,k6,...]
    python3 scripts/kernel_cycles.py --package DIR --sections kernels,k5_rows
    python3 scripts/kernel_cycles.py --ab DIR [--pairs N]

Builds ``scripts/kernel_cycles.cu`` (nvcc, with the package's headers),
then reports, as one JSON line on stdout (and in ``--out`` if given), the
sections asked for (all by default):

- ``linreg``: cycles of one linear-regression evaluation and its update
  (clock64() around a loop of dependent evaluations) in a launch of one
  warp, and at the main path's width (16,384 chains) its cycles and its
  nanoseconds a chain (CUDA events over the launch), for one thread a
  chain with the rows read from shared memory (the evaluation of K2's
  previous design), K4's lane functor at G = 2 and K2's register form;
  one step's Philox noise at D = 5 (``philox_step``; the philox unit's
  probe, ``prng.step_noise_cycles``) and in its previous logf/cosf/sqrtf
  form (``philox_step_reference``);
- ``k7_warp``: cycles of an evaluation of K7's warp functor, one chain
  alone and 2,048 chains 8 to a CTA at 64 beads, and one chain at 256
  beads (matrices from device memory);
- ``kernels``: K2, K4 and K7 launched through the package on one warp
  (K7: one chain) and at the paths' widths (K7 also at 256 beads),
  nanoseconds a step and an evaluation from CUDA events (K4: L + 1
  evaluations a step, K2 and K7: L); K3's fixed warmup (16,384 chains x
  500 steps) and K1 standing alone at the main path's noise volume
  (16,384 chains x 4,500 steps, D = 5), device ms;
- ``families``: K3 then K4 on the logistic, AR(1), mixture and
  hierarchical posteriors at the families path's shape (8,192 chains, 400
  + 500 steps) at the width the package picks
  (``chip_smoke.family_width_sweep``, mean of 3 runs);
- ``k8``: K8 through the package at the quadratic path's shape (8,192
  chains, D = 128) at L = 0, 1 and 32 (device ms a launch, the route it
  took), a step's microseconds, and the SM clock and power under it;
- ``k6``: K6a and K6b through the package at 2,048 beads under
  torch.profiler, each device kernel's microseconds a launch, W and logD
  from HBM and from L2;
- ``k5``: K5 through the package on 32 chains and at the gibbs path's
  shape (16,384 chains x 4,000 sweeps: device ms, ns and cycles a sweep at
  the SM clock measured under it, the grid and lanes it reported); the
  cycles of each sweep phase apart (noise, residual sum of squares, Gamma
  draw, Cholesky factor and solves, draw store) at each lane-group width G
  it is built for, each in a loop of dependent
  repetitions, on one warp and at full width; the share of the path's
  sweeps whose Gamma round 0 rejects (and rounds 0 and 1); the SM clock
  and power under K5;
- ``k5_rows``: K5 at d = 4, 16,384 chains x 4,000 sweeps on the
  polynomial's data at n = 20 (every row in registers), 37 and 1,001 (the
  rows past 24 from shared memory): the kernel's device ms (profiler) at
  every lane-group width G the package is built for and through the
  package's own entry point, and whether each width's draws equal the
  entry point's;
- ``k1_keys``: K1 standing alone at the main path's noise volume in two
  builds of ``csrc/philox.cu``: as written, the ten round keys a kernel
  parameter (``keyed``), and handed the seed, the keys bumped in every
  Philox call as the inlining kernels have them (``seed``); device ms in
  turns, registers, and whether both wrote the same bits;
- ``clocks``: the SM clock and power (``nvidia-smi``) sampled while K2
  runs at the main path's shape for a few seconds, and the card's name and
  power limit.

With ``--package DIR`` the package is imported from the checkout ``DIR``
(another commit's kernels, e.g. the parent's unpacked by ``git archive``,
timed on the same card in the same call), for the sections that do not
run this checkout's probe library (all but linreg, k7_warp and k5).

``--ab DIR`` times K2, K3 (fixed) and K4 (fixed) at the main path's
shapes (16,384 chains; K2 and K4 4,000 steps, K3 500) and K7 at the
chain-grid path's (the Gram density of 64 beads, 2,048 chains, 200
steps) (CUDA events, the mean of AB_CALLS calls a turn) from the
checkout ``DIR`` and from this one, each package in a worker process of
its own started once, in ``--pairs`` pairs of turns (DIR, this, this,
DIR, ...), and prints each turn and, per kernel, the medians, their
ratio, the share of pairs this checkout won and the spread of DIR's
turns, whether both packages wrote the same bits (a digest of each
kernel's first output), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

C_MAIN, STEPS_MAIN, LEAP = 16384, 4000, 10
STEPS_WARMUP = 500
# chip_smoke.py's quadratic and chromatin shapes
Q_CHAINS, Q_DIM, Q_LEAP = 8192, 128, 32
N_BEADS = 2048
SECTIONS = ("linreg", "k7_warp", "kernels", "families", "k8", "k6", "k5", "k5_rows", "k1_keys",
            "clocks")
# the sections that run the probe library built from kernel_cycles.cu
PROBE_SECTIONS = ("linreg", "k7_warp", "k5")


def build():
    from binf_tpu_torch.ops.kernels import _build

    out = _build.BUILD_ROOT / "kernel_cycles"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libkernel_cycles.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o", str(lib),
           str(ROOT / "scripts" / "kernel_cycles.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines() if "registers" in ln]
    return ctypes.CDLL(str(lib)), regs


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def device_events(fn, reps: int):
    """Device ms a call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), the card asleep while the host queues them, so that a short
    kernel is not timed at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def events(fn):
    """Device ms of one call of ``fn`` (CUDA events)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def linreg_probes(lib, density, dev):
    """Cycles an evaluation (a step's noise) for each probe, one warp and
    full width."""
    from binf_tpu_torch.ops.kernels import prng

    f = lib.probe_linreg
    f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    (V, y, ipv, pm), n, hna, rate = density.cuda_operands()
    g = torch.Generator().manual_seed(0)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((C_MAIN, 5), generator=g)).to(dev)
    # 0-2 probe_linreg's, then the philox unit's step probe in both forms
    names = ("k2_shared_rows", "lanes_g2", "registers", "philox_step", "philox_step_reference")
    out = {}
    for which, name in enumerate(names):
        row = {}
        for label, chains, threads, reps in (("one_warp", 16 if which == 1 else 32, 32, 2000),
                                             ("full", C_MAIN, 64 if which == 0 else 128, 400)):
            sink = torch.empty(chains, device=dev)
            cyc = torch.zeros(chains, dtype=torch.int64, device=dev)

            def run():
                if which >= 3:
                    cyc.copy_(prng.step_noise_cycles(which == 4, chains, threads, reps,
                                                     device=dev))
                    return
                err = f(which, ptr(V), ptr(y), ptr(ipv), ptr(pm), n, hna, rate, ptr(q0), chains,
                        threads, reps, ptr(sink), ptr(cyc), stream())
                if err:
                    raise RuntimeError(f"probe {name} {label}: CUDA error {err}")

            run()
            ms = events(run)
            c = cyc.double() / reps
            row[label] = {"chains": chains, "threads_per_cta": threads, "reps": reps,
                          "cycles_median": float(c.median()), "cycles_max": float(c.max()),
                          "ms": ms, "ns_per_eval": 1e6 * ms / reps}
        out[name] = row
    return out


def kernel_launches(dev):
    """K2, K4 and K7 through the package: one warp (one chain for K7) and
    the paths' widths; K3 (fixed) and K1 at the main path's."""
    from binf_tpu_torch.example import chromatin as chrom
    from binf_tpu_torch.ops.kernels import chain_grid as cg
    from binf_tpu_torch.ops.kernels import fused_hmc as fh
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels import prng

    density = main_density(dev)
    g = torch.Generator().manual_seed(1)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    eps = torch.tensor([0.2], device=dev)
    im = torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    out = {}
    for label, C, steps in (("one_warp", 32, 2000), ("full", C_MAIN, STEPS_MAIN)):
        q0 = (truth + 0.1 * torch.randn((C, 5), generator=g)).to(dev)

        def k2():
            return fh.fused_linreg_hmc_run(q0, 3, density.V, density.y, density.prior_var, 1.0,
                                           0.2, eps, inverse_mass=im, num_steps=steps,
                                           block_chains=C, steps_per_block=steps, device=dev)

        def k4():
            c = 16 if label == "one_warp" else C
            return fp.fused_potential_hmc_run(density, q0[:c], 3, eps, im, num_steps=steps,
                                              block_chains=c, steps_per_block=steps, device=dev)

        for name, fn in (("k2", k2), ("k4", k4)):
            fn()
            ms = events(fn)
            evals = LEAP if name == "k2" else LEAP + 1
            out.setdefault(name, {})[label] = {"chains": C if name == "k2" or label == "full"
                                               else 16, "steps": steps, "ms": ms,
                                               "ns_per_step": 1e6 * ms / steps,
                                               "ns_per_eval": 1e6 * ms / steps / evals}
    q0 = (truth + 0.1 * torch.randn((C_MAIN, 5), generator=g)).to(dev)

    def k3():
        return fp.fused_warmup_run(density, q0, 3, 0.1, num_warmup=STEPS_WARMUP,
                                   block_chains=C_MAIN, device=dev)

    def k1():
        return prng.philox_noise(7, prng.TAG_SAMPLE, C_MAIN, STEPS_WARMUP + STEPS_MAIN, 5,
                                 device=dev)

    k3()
    out["k3"] = {"full": {"chains": C_MAIN, "steps": STEPS_WARMUP, "ms": events(k3)}}
    out["k1"] = {"full": {"chains": C_MAIN, "steps": STEPS_WARMUP + STEPS_MAIN,
                          "ms": device_events(k1, 5)}}
    from binf_tpu_torch.ops.kernels import _build

    for label, n, C, steps in (("one_chain", 64, 1, 20), ("full", 64, 2048, 200),
                               ("full_256_beads", 256, 256, 100)):
        X, logD, W = chrom.synthetic_restraints(torch.Generator(device=dev).manual_seed(0), n,
                                                observe_frac=0.3, device=dev)
        gram = chrom.make_gram_logdensity(logD, W, device=dev)
        imk = {"structure": torch.full((n, 3), 0.01, device=dev),
               "precision": torch.tensor(0.01, device=dev)}
        noise = torch.randn((C, n, 3), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
        q0 = {"structure": X + 0.1 * noise, "precision": torch.full((C,), 3.0, device=dev)}

        def k7():
            return cg.chain_grid_hmc_run(gram, q0, 5, 0.003 * (64 / n) ** 0.5, imk, {},
                                         num_steps=steps, num_leapfrog=LEAP, block_chains=1,
                                         steps_per_block=steps, device=dev)
        k7()
        ms = events(k7)
        rec = _build.last_launch["chain_grid_hmc"]
        out.setdefault("k7", {})[label] = {"beads": n, "chains": C, "steps": steps, "ms": ms,
                                           "ns_per_step": 1e6 * ms / steps,
                                           "ns_per_eval": 1e6 * ms / steps / LEAP,
                                           "threads_a_chain": rec.lanes, "ctas": rec.ctas,
                                           "threads": rec.threads, "rounds": rec.rounds}
    return out


def family_launches(dev):
    """K3 and K4 on each family's device density at the families path's
    shape, at the width the package picks."""
    import chip_smoke as cs
    from binf_tpu_torch.ops.kernels import densities as dens_mod
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    problems = {**cs.family_problems(dev), "hierarchical": cs.hierarchical_family(dev)}
    out = {}
    for name, (logdensity, start_fn, _) in problems.items():
        start = start_fn(cs.FAM_CHAINS, 40)
        density = dens_mod.device_density(logdensity, {k: v[0] for k, v in start.items()}).to(dev)
        G = fp.lanes_for(density)
        row = cs.family_width_sweep(fp, density, pack_positions(start).contiguous(), dev, reps=3,
                                    widths=[G])[G]
        out[name] = {"lanes": G, "k3_ms": row["k3_ms"], "k4_ms": row["k4_ms"]}
    return out


def k7_warp_probe(lib, dev):
    from binf_tpu_torch.example import chromatin as chrom

    f = lib.probe_k7_warp
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = {}
    for label, n, chains, warps, reps in (("one_chain_64", 64, 1, 1, 50),
                                          ("full_64", 64, 2048, 8, 20),
                                          ("one_chain_256", 256, 1, 1, 5)):
        X, logD, W = chrom.synthetic_restraints(torch.Generator(device=dev).manual_seed(0), n,
                                                observe_frac=0.3, device=dev)
        Wt, logDt = W.T.contiguous(), logD.T.contiguous()
        noise = torch.randn((chains, n, 3), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
        q0 = torch.cat([torch.full((chains, 1), 3.0, device=dev),
                        (X + 0.1 * noise).reshape(chains, -1)], 1).contiguous()
        sink = torch.empty(chains, device=dev)
        cyc = torch.zeros(chains, dtype=torch.int64, device=dev)
        res = ctypes.c_int(0)

        def run():
            err = f(ptr(W), ptr(logD), ptr(Wt), ptr(logDt), n, ptr(q0), chains, warps, reps,
                    ptr(sink), ptr(cyc), ctypes.byref(res), stream())
            if err:
                raise RuntimeError(f"probe k7_warp {label}: CUDA error {err}")

        run()
        ms = events(run)
        c = cyc.double() / reps
        out[label] = {"beads": n, "chains": chains, "warps_per_cta": warps, "reps": reps,
                      "resident": res.value, "cycles_median": float(c.median()),
                      "cycles_max": float(c.max()), "ms": ms, "us_per_eval": 1e3 * ms / reps}
    return out


def main_density(dev, n=20):
    """The polynomial's regression (d = 4) on ``n`` points of its data, the
    main path's at n = 20."""
    from binf_tpu_torch.example.polynomial import make_data
    from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity
    from binf_tpu_torch.ops.math import vandermonde

    xs, ys = make_data(torch.Generator().manual_seed(1), n_points=n, device=dev)
    V = vandermonde(xs, 4)
    return LinregDensity(V, ys, torch.full((4,), 5.0, device=dev), 1.0, 0.2)


def clocks_under(fn, seconds: float = 4.0):
    """nvidia-smi's SM clock and power every 0.1 s while ``fn`` runs back to
    back (each call synchronised), and the card's name and power limit."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            if r.returncode == 0 and r.stdout.strip():
                clk, pw = r.stdout.strip().splitlines()[0].split(",")
                samples.append((float(clk), float(pw)))
            time.sleep(0.1)

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=poll)
    th.start()
    t = time.perf_counter()
    runs = 0
    while time.perf_counter() - t < seconds:
        fn()
        torch.cuda.synchronize()
        runs += 1
    stop.set()
    th.join()
    clk = np.array([s[0] for s in samples])
    pw = np.array([s[1] for s in samples])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    return {"card": card, "runs": runs, "samples": len(samples),
            "sm_mhz_min": float(clk.min()), "sm_mhz_median": float(np.median(clk)),
            "sm_mhz_max": float(clk.max()), "power_w_median": float(np.median(pw)),
            "power_w_max": float(pw.max()), "device": torch.cuda.get_device_name()}


def clocks_under_k2(dev):
    """The SM clock and power while K2 runs at the main path's shape."""
    from binf_tpu_torch.ops.kernels import fused_hmc as fh

    density = main_density(dev)
    q0 = (torch.tensor([2.0, -4.0, 1.0, 1.5, 0.9]) + 0.1 * torch.randn(
        (C_MAIN, 5), generator=torch.Generator().manual_seed(2))).to(dev)
    eps, im = torch.tensor([0.2], device=dev), torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1],
                                                            device=dev)
    return clocks_under(lambda: fh.fused_linreg_hmc_run(
        q0, 5, density.V, density.y, density.prior_var, 1.0, 0.2, eps, inverse_mass=im,
        num_steps=STEPS_MAIN, block_chains=C_MAIN, steps_per_block=50, device=dev))


def quadratic_operands(dev, C=Q_CHAINS, D=Q_DIM):
    """chip_smoke.py's quadratic target (bench_kernels.py:36-40) and a
    momentum, drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    M = 0.05 * torch.randn((D, D), generator=g, device=dev)
    A = M @ M.T + torch.eye(D, device=dev)
    b = torch.randn(D, generator=g, device=dev)
    q, p = (torch.randn((C, D), generator=g, device=dev) for _ in range(2))
    return q, p, A, b, torch.tensor(0.15, device=dev)


def k8_launches(dev):
    """K8 through the package at the quadratic path's shape: device ms a
    launch (CUDA events over back-to-back launches) at L = 0, 1 and 32, so
    (t(32) - t(0)) / 32 is one step (drift, product, kick) and t(0) the
    staging, one product and the stores; the route and grid it reported;
    the SM clock and power while it runs back to back."""
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import leapfrog as lf

    q, p, A, b, eps = quadratic_operands(dev)
    out = {}
    for L in (0, 1, Q_LEAP):
        def call():
            return lf.quadratic_leapfrog(q, p, A, b, eps, L, device=dev, return_potential=True)
        ms = device_events(call, 100)
        rec = _build.last_launch["quadratic_leapfrog"]
        out[f"L{L}"] = {"ms": ms, "ctas": rec.ctas, "threads": rec.threads,
                        "route": getattr(rec, "route", "simt")}
    out["us_per_step"] = 1e3 * (out[f"L{Q_LEAP}"]["ms"] - out["L0"]["ms"]) / Q_LEAP
    out["clocks"] = clocks_under(
        lambda: [lf.quadratic_leapfrog(q, p, A, b, eps, Q_LEAP, device=dev) for _ in range(200)],
        seconds=3.0)
    return out


def k6_launches(dev, n=N_BEADS, copies=4):
    """K6a and K6b through the package at N beads under torch.profiler: each
    device kernel's mean microseconds a launch, W and logD from HBM
    (``copies`` copies taken in turn, 134 MB at 2,048 beads against the 50
    MB L2) and from L2 (one copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from binf_tpu_torch.example import chromatin as chrom
    from binf_tpu_torch.ops.kernels import pairwise as pw

    g = torch.Generator(device=dev).manual_seed(n)
    X, logD, W = chrom.synthetic_restraints(g, n, observe_frac=0.3, device=dev)
    X = X + 0.1 * torch.randn(X.shape, generator=g, device=dev)
    sets = {"hbm": [(logD.clone(), W.clone()) for _ in range(copies)], "l2": [(logD, W)]}
    out = {}
    for label, fn in (("k6a", pw.pairwise_loss_cuda), ("k6b", pw.pairwise_forces_cuda)):
        for where, ops in sets.items():
            reps = 40
            fn(X, *ops[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for r in range(reps):
                    fn(X, *ops[r % len(ops)])
                torch.cuda.synchronize()
            per = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    per.setdefault(e.name, []).append(e.time_range.elapsed_us())
            out.setdefault(label, {})[where] = {
                name: {"launches": len(v), "us_mean": float(np.mean(v)),
                       "us_median": float(np.median(v))} for name, v in per.items()}
    return out


K5_PHASES = ("noise", "residual_sum", "gamma_rounds", "cholesky_solves", "draw_store")


def kernel_device_ms(fn, key: str, reps: int = 3) -> float:
    """The shortest device time in ms of the kernels whose names hold
    ``key`` over ``reps`` calls of ``fn``, under torch.profiler: the
    caller's host work and its stream synchronisations fall outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return min(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and key in e.name) / 1e3


def gibbs_start(dev, C=C_MAIN):
    """chip_smoke.py's K5 check start: coefficients near 1, precision 1."""
    g = torch.Generator().manual_seed(5)
    return torch.cat([1.0 + 0.1 * torch.randn((C, 4), generator=g), torch.ones((C, 1))],
                     1).to(dev)


def k5_phases(lib, density, dev):
    """Cycles of each of K5's sweep phases (clock64() around a loop of
    dependent repetitions) with G lanes a chain, in a launch of one warp
    and at the gibbs path's width (16,384 chains)."""
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg

    f = lib.probe_k5_phase
    f.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] \
        + [ctypes.c_float] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    f.restype = ctypes.c_int
    vtv, vty, ipv, pm, gd, gc = fg._operands(density)
    q0 = gibbs_start(dev)
    out = {}
    for which, name in enumerate(K5_PHASES):
        for G in fg.LANE_WIDTHS:
            row = {}
            for label, chains, reps in (("one_warp", 32 // G, 2000), ("full", C_MAIN, 400)):
                sink = torch.empty(chains, device=dev)
                cyc = torch.zeros(chains, dtype=torch.int64, device=dev)
                buf = torch.empty((reps if which == 4 else 1, chains, 5), device=dev)

                def run():
                    err = f(which, G, ptr(density.V), ptr(density.y), ptr(vtv), ptr(vty),
                            ptr(ipv), ptr(pm), density.n, gd, gc, 0.2, ptr(q0), chains, reps,
                            ptr(sink), ptr(cyc), ptr(buf), stream())
                    if err:
                        raise RuntimeError(f"probe k5 {name} G={G} {label}: CUDA error {err}")

                run()
                ms = events(run)
                c = cyc.double() / reps
                row[label] = {"chains": chains, "reps": reps, "cycles_median": float(c.median()),
                              "cycles_max": float(c.max()), "ms": ms,
                              "ns_per_rep": 1e6 * ms / reps}
            out[f"{name}_g{G}"] = row
    return out


K5_ROWS = (20, 37, 1001)


def k5_rows(dev):
    """K5 at the gibbs path's shape on ``n`` points of the polynomial's data,
    each n of ``K5_ROWS``: the kernel's device ms (profiler, best of 3
    launches) through the entry point and at every lane-group width G the
    package is built for (forced through the module's private launcher),
    the grid each launch reported, and whether its draws equal the entry
    point's."""
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg

    q0 = gibbs_start(dev)
    out = {}
    for n in K5_ROWS:
        density = main_density(dev, n)

        def entry():
            return fg.fused_linreg_gibbs_run(q0, 41, density.V, density.y, density.prior_var,
                                             1.0, 0.2, num_steps=STEPS_MAIN,
                                             block_chains=C_MAIN, steps_per_block=50,
                                             device=dev)
        runs = {"entry": entry}
        for G in getattr(fg, "LANE_WIDTHS", ()):
            runs[f"g{G}"] = functools.partial(fg._gibbs_cuda, density, q0, num_steps=STEPS_MAIN,
                                              seed=41, noise=None, lanes=G)
        ref = entry()
        row = {}
        for name, fn in runs.items():
            equal = bool(torch.equal(fn(), ref))
            ms = kernel_device_ms(fn, "fused_linreg_gibbs")
            rec = _build.last_launch["fused_gibbs"]
            row[name] = {"ms": ms, "ns_per_sweep": 1e6 * ms / STEPS_MAIN, "lanes": rec.lanes,
                         "ctas": rec.ctas, "threads": rec.threads,
                         "rows_in_registers": rec.rows_in_registers, "equal_to_entry": equal}
        out[f"n{n}"] = row
        del ref
        torch.cuda.empty_cache()
    return out


def k5_launches(dev):
    """K5 through the package: 32 chains (2,000 sweeps; one CTA, at most a
    warp a scheduler) and the gibbs path's shape (16,384 chains, 4,000 sweeps): ms under CUDA events
    around the call (best of 3; the wrapper's host work included), the
    kernel's own device ms (profiler), ns and cycles a sweep of the kernel
    and the grid the launch reported."""
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg

    density = main_density(dev)
    out = {}
    for label, C, steps in (("chains_32", 32, 2000), ("full", C_MAIN, STEPS_MAIN)):
        q0 = gibbs_start(dev, C)

        def run():
            return fg.fused_linreg_gibbs_run(q0, 41, density.V, density.y, density.prior_var,
                                             1.0, 0.2, num_steps=steps, block_chains=C,
                                             steps_per_block=50, device=dev)
        run()
        ms = min(events(run) for _ in range(3))
        dev_ms = kernel_device_ms(run, "fused_linreg_gibbs")
        rec = _build.last_launch["fused_gibbs"]
        out[label] = {"chains": C, "sweeps": steps, "events_ms": ms, "ms": dev_ms,
                      "ns_per_sweep": 1e6 * dev_ms / steps,
                      "lanes": rec.lanes, "ctas": rec.ctas, "threads": rec.threads,
                      "rows_in_registers": rec.rows_in_registers}
    return out


def k5_section(lib, dev):
    """K5: its launches, its phases apart, the share of the gibbs path's
    sweeps (seed 41) whose Gamma round 0 rejects, and the SM clock and
    power under it at the gibbs path's shape."""
    from binf_tpu_torch.ops.kernels import fused_gibbs as fg

    density = main_density(dev)
    out = {"launches": k5_launches(dev), "phases": k5_phases(lib, density, dev)}
    shape = 1.0 + 0.5 * density.n
    from chip_smoke import gamma_rejections

    rej0, rej01 = gamma_rejections(41, shape, C_MAIN, STEPS_MAIN, dev)
    out["rejections"] = {"round0_rejects": rej0, "rounds01_reject": rej01}
    q0 = gibbs_start(dev)
    out["clocks"] = clocks_under(lambda: fg.fused_linreg_gibbs_run(
        q0, 41, density.V, density.y, density.prior_var, 1.0, 0.2, num_steps=STEPS_MAIN,
        block_chains=C_MAIN, steps_per_block=50, device=dev))
    mhz = out["clocks"]["sm_mhz_median"]
    for row in out["launches"].values():
        row["cycles_per_sweep"] = row["ns_per_sweep"] * mhz * 1e-3
    return out


def k1_keys(dev):
    """K1 (``binf_philox_noise``) in its keyed and seed forms, built from
    this checkout's ``csrc/philox.cu`` side by side, at 16,384 chains x
    4,500 steps, D = 5: device ms in turns (keyed, seed, seed, keyed,
    keyed, seed), ptxas's line for ``philox_noise_kernel<5, true>``, and
    whether both forms' normals and uniforms are equal."""
    import re

    from binf_tpu_torch.ops.kernels import _build

    keyed = (_build.CSRC / "philox.cu").read_text()
    seed = keyed
    for a, b in (("philox_noise_kernel(const PhiloxKeys keys,",
                  "philox_noise_kernel(uint64_t seed,"),
                 ("step_noise<D>(keys, tag,", "step_noise<D>(seed, tag,"),
                 ("  const binf::PhiloxKeys keys(seed);\n", ""),
                 ("          keys, tag, n_chains,", "          seed, tag, n_chains,")):
        if a not in seed:
            raise RuntimeError(f"k1_keys: csrc/philox.cu no longer holds {a!r}")
        seed = seed.replace(a, b)
    out = _build.BUILD_ROOT / "k1_keys"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for form, text in (("keyed", keyed), ("seed", seed)):
        (out / f"philox_{form}.cu").write_text(text)
        procs[form] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o",
             str(out / f"libphilox_{form}.so"), str(out / f"philox_{form}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for form, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({form}):\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and "philox_noise_kernelILi5ELb1E" in entry and "registers" in line:
                regs[form] = line.strip()
        libs[form] = ctypes.CDLL(str(out / f"libphilox_{form}.so"))
        libs[form].binf_philox_noise.argtypes = [
            ctypes.c_int, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    steps = STEPS_WARMUP + STEPS_MAIN
    z = {f: torch.empty((steps, C_MAIN, 5), device=dev) for f in libs}
    u = {f: torch.empty((steps, C_MAIN), device=dev) for f in libs}
    grid = (ctypes.c_int * 2)()

    def run(form):
        err = libs[form].binf_philox_noise(5, 7, 1, C_MAIN, steps, 0, ptr(z[form]), ptr(u[form]),
                                           stream(), grid)
        if err:
            raise RuntimeError(f"k1_keys: CUDA error {err} ({form})")

    turns = [(f, device_events(lambda: run(f), 10))
             for f in ("keyed", "seed", "seed", "keyed", "keyed", "seed")]
    return {"turns_ms": turns,
            "ms": {f: sum(t for g, t in turns if g == f) / 3 for f in libs},
            "same_bits": torch.equal(z["keyed"], z["seed"]) and torch.equal(u["keyed"], u["seed"]),
            "ptxas": regs}


AB_CALLS = 5


def digest(out) -> str:
    """A hash of a kernel's output tensors (its bits)."""
    import hashlib

    h = hashlib.sha256()
    for t in out:
        for v in (t.values() if isinstance(t, dict) else [t]):
            if torch.is_tensor(v):
                h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def serve_ab(dev) -> None:
    """Worker of ``--ab``: K2, K3 (fixed) and K4 (fixed) at the main
    path's shapes and K7 at the chain-grid path's; prints ``ready`` and a
    JSON object of each kernel's output digest, then for each line read
    one JSON object of each kernel's ms (the mean of AB_CALLS calls)."""
    from binf_tpu_torch.example import chromatin as chrom
    from binf_tpu_torch.ops.kernels import chain_grid as cg
    from binf_tpu_torch.ops.kernels import fused_hmc as fh
    from binf_tpu_torch.ops.kernels import fused_potential as fp

    density = main_density(dev)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((C_MAIN, 5), generator=torch.Generator().manual_seed(1)))
    q0, eps = q0.to(dev), torch.tensor([0.2], device=dev)
    im = torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    kernels = {
        "k2": lambda: fh.fused_linreg_hmc_run(q0, 3, density.V, density.y, density.prior_var,
                                              1.0, 0.2, eps, inverse_mass=im,
                                              num_steps=STEPS_MAIN, block_chains=C_MAIN,
                                              steps_per_block=STEPS_MAIN, device=dev),
        "k3": lambda: fp.fused_warmup_run(density, q0, 3, 0.1, num_warmup=STEPS_WARMUP,
                                          block_chains=C_MAIN, device=dev),
        "k4": lambda: fp.fused_potential_hmc_run(density, q0, 3, eps, im, num_steps=STEPS_MAIN,
                                                 block_chains=C_MAIN,
                                                 steps_per_block=STEPS_MAIN, device=dev)}
    X, logD, W = chrom.synthetic_restraints(torch.Generator(device=dev).manual_seed(0), 64,
                                            observe_frac=0.3, device=dev)
    gram = chrom.make_gram_logdensity(logD, W, device=dev)
    imk = {"structure": torch.full((64, 3), 0.01, device=dev),
           "precision": torch.tensor(0.01, device=dev)}
    noise = torch.randn((2048, 64, 3), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    qk = {"structure": X + 0.1 * noise, "precision": torch.full((2048,), 3.0, device=dev)}
    kernels["k7"] = lambda: cg.chain_grid_hmc_run(gram, qk, 5, 0.003, imk, {}, num_steps=200,
                                                  num_leapfrog=LEAP, block_chains=1,
                                                  steps_per_block=200, device=dev)
    digests = {k: digest(fn()) for k, fn in kernels.items()}
    torch.cuda.synchronize()
    print("ready", flush=True)
    print(json.dumps(digests), flush=True)
    for _ in sys.stdin:
        print(json.dumps({k: float(np.mean([events(fn) for _ in range(AB_CALLS)]))
                          for k, fn in kernels.items()}), flush=True)


def ab(other: str, pairs: int) -> dict:
    """K2, K3 and K4 from the checkout ``other`` and from this one in turns
    (``--ab``)."""
    here = str(Path(__file__).resolve().parents[1])
    sides = {"other": other, "this": here}
    workers = {k: subprocess.Popen([sys.executable, __file__, "--package", d, "--serve-ab"],
                                   stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
               for k, d in sides.items()}
    try:
        digests = {}
        for k, w in workers.items():
            if w.stdout.readline().strip() != "ready":
                raise RuntimeError(f"the {k} worker did not start (exit {w.wait()})")
            digests[k] = json.loads(w.stdout.readline())
        turns = []
        for i in range(pairs):
            for k in (("other", "this") if i % 2 == 0 else ("this", "other")):
                workers[k].stdin.write("go\n")
                workers[k].stdin.flush()
                turns.append((k, json.loads(workers[k].stdout.readline())))
    finally:
        for w in workers.values():
            w.stdin.close()
        for w in workers.values():
            try:
                w.wait(timeout=60)
            except subprocess.TimeoutExpired:
                w.kill()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    return {"card": card, "shape": {"chains": C_MAIN, "k2_k4_steps": STEPS_MAIN,
                                    "k3_steps": STEPS_WARMUP, "calls": AB_CALLS},
            "packages": sides, "turns": turns, "digests": digests,
            **{k: dict(ab_summary([(side, t[k]) for side, t in turns]),
                       same_bits=digests["this"][k] == digests["other"][k])
               for k in ("k2", "k3", "k4", "k7")}}


def ab_summary(turns) -> dict:
    """Each side's ms and median, their ratio, the share of pairs this
    checkout ran faster, and the spread of the other's own turns (the
    distance between their quartiles)."""
    ms = {k: [t for s, t in turns if s == k] for k in ("other", "this")}
    med = {k: float(np.median(v)) for k, v in ms.items()}
    q1, q3 = np.percentile(ms["other"], [25, 75])
    wins = np.mean([t < o for t, o in zip(ms["this"], ms["other"])])
    return {"ms": ms, "median_ms": med, "this_over_other": med["this"] / med["other"],
            "this_faster_share": float(wins), "other_quartile_spread_ms": float(q3 - q1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated subset of {','.join(SECTIONS)}")
    ap.add_argument("--package", help="import binf_tpu_torch from this checkout (the "
                    "sections without probes)")
    ap.add_argument("--ab", metavar="DIR",
                    help="K2, K3, K4 and K7 from DIR and from this checkout in turns")
    ap.add_argument("--pairs", type=int, default=20, help="pairs of turns of --ab")
    ap.add_argument("--serve-ab", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ab:
        line = json.dumps({"ab": ab(args.ab, args.pairs)})
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
        print(line)
        return 0
    sections = args.sections.split(",")
    if args.package and not args.serve_ab and set(sections) & set(PROBE_SECTIONS):
        ap.error(f"--package times another checkout's kernels: not with "
                 f"{','.join(PROBE_SECTIONS)}")
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    if not torch.cuda.is_available():
        print("kernel_cycles: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from binf_tpu_torch.ops.kernels import _build

    if args.serve_ab:
        _build.build_all()
        serve_ab(dev)
        return 0
    if set(sections) - {"k1_keys"}:
        _build.build_all()
    lib, regs = build() if set(sections) & set(PROBE_SECTIONS) else (None, [])
    density = main_density(dev)
    probes = {"linreg": lambda: linreg_probes(lib, density, dev),
              "k7_warp": lambda: k7_warp_probe(lib, dev),
              "kernels": lambda: kernel_launches(dev), "families": lambda: family_launches(dev),
              "k8": lambda: k8_launches(dev),
              "k6": lambda: k6_launches(dev), "k5": lambda: k5_section(lib, dev),
              "k5_rows": lambda: k5_rows(dev), "k1_keys": lambda: k1_keys(dev),
              "clocks": lambda: clocks_under_k2(dev)}
    res = {"ptxas": regs, **{name: probes[name]() for name in sections}}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
