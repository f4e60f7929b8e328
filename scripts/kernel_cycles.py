#!/usr/bin/env python3
"""Where the time of an evaluation goes in the whole-run kernels K2, K4 and
K7, on one NVIDIA card.

    python3 scripts/kernel_cycles.py [--out FILE]

Builds ``scripts/kernel_cycles.cu`` (nvcc, with the package's headers),
then reports, as one JSON line on stdout (and in ``--out`` if given):

- ``linreg``: cycles of one linear-regression evaluation and its update
  (clock64() around a loop of dependent evaluations) in a launch of one
  warp, and at the main path's width (16,384 chains) its cycles and its
  nanoseconds a chain (CUDA events over the launch), for one thread a
  chain with the rows read from shared memory (the evaluation of K2's
  previous design), K4's lane functor at G = 2 and K2's register form;
  one step's Philox noise;
- ``kernels``: K2, K4 and K7 launched through the package on one warp
  (K7: one chain) and at the paths' widths (K7 also at 256 beads),
  nanoseconds a step and an evaluation from CUDA events (K4: L + 1
  evaluations a step, K2 and K7: L);
- ``k7_warp``: cycles of an evaluation of K7's warp functor, one chain
  alone and 2,048 chains 8 to a CTA at 64 beads, and one chain at 256
  beads (matrices from device memory);
- ``clocks``: the SM clock and power (``nvidia-smi``) sampled while K2
  runs at the main path's shape for a few seconds, and the card's name and
  power limit.
"""

from __future__ import annotations

import argparse
import ctypes
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


def events(fn):
    """Device ms of one call of ``fn`` (CUDA events)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def linreg_probes(lib, density, dev):
    """Cycles an evaluation for each probe, one warp and full width."""
    f = lib.probe_linreg
    f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    (V, y, ipv, pm), n, hna, rate = density.cuda_operands()
    g = torch.Generator().manual_seed(0)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((C_MAIN, 5), generator=g)).to(dev)
    names = {0: "k2_shared_rows", 1: "lanes_g2", 2: "registers", 3: "philox_step"}
    out = {}
    for which, name in names.items():
        row = {}
        for label, chains, threads, reps in (("one_warp", 16 if which == 1 else 32, 32, 2000),
                                             ("full", C_MAIN, 64 if which == 0 else 128, 400)):
            sink = torch.empty(chains, device=dev)
            cyc = torch.zeros(chains, dtype=torch.int64, device=dev)

            def run():
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
    the paths' widths."""
    from binf_tpu_torch.example import chromatin as chrom
    from binf_tpu_torch.ops.kernels import chain_grid as cg
    from binf_tpu_torch.ops.kernels import fused_hmc as fh
    from binf_tpu_torch.ops.kernels import fused_potential as fp

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


def main_density(dev):
    from binf_tpu_torch.example.polynomial import make_data
    from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity
    from binf_tpu_torch.ops.math import vandermonde

    _, ys = make_data(torch.Generator().manual_seed(1), device=dev)
    V = vandermonde(torch.linspace(-2.0, 2.0, 20, device=dev), 4)
    return LinregDensity(V, ys, torch.full((4,), 5.0, device=dev), 1.0, 0.2)


def clocks_under_k2(dev, seconds: float = 4.0):
    """nvidia-smi's SM clock and power every 0.1 s while K2 runs back to back."""
    from binf_tpu_torch.ops.kernels import fused_hmc as fh

    density = main_density(dev)
    q0 = (torch.tensor([2.0, -4.0, 1.0, 1.5, 0.9]) + 0.1 * torch.randn(
        (C_MAIN, 5), generator=torch.Generator().manual_seed(2))).to(dev)
    eps, im = torch.tensor([0.2], device=dev), torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1],
                                                            device=dev)
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            if r.returncode == 0 and r.stdout.strip():
                clk, pw = r.stdout.strip().splitlines()[0].split(",")
                samples.append((float(clk), float(pw)))
            time.sleep(0.1)

    def k2():
        fh.fused_linreg_hmc_run(q0, 5, density.V, density.y, density.prior_var, 1.0, 0.2, eps,
                                inverse_mass=im, num_steps=STEPS_MAIN, block_chains=C_MAIN,
                                steps_per_block=50, device=dev)
    k2()
    torch.cuda.synchronize()
    th = threading.Thread(target=poll)
    th.start()
    t = time.perf_counter()
    runs = 0
    while time.perf_counter() - t < seconds:
        k2()
        torch.cuda.synchronize()
        runs += 1
    stop.set()
    th.join()
    clk = np.array([s[0] for s in samples])
    pw = np.array([s[1] for s in samples])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    return {"card": card, "k2_runs": runs, "samples": len(samples),
            "sm_mhz_min": float(clk.min()), "sm_mhz_median": float(np.median(clk)),
            "sm_mhz_max": float(clk.max()), "power_w_median": float(np.median(pw)),
            "power_w_max": float(pw.max()), "device": torch.cuda.get_device_name(dev)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_cycles: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from binf_tpu_torch.ops.kernels import _build

    _build.build_all()
    lib, regs = build()
    density = main_density(dev)
    res = {"ptxas": regs, "linreg": linreg_probes(lib, density, dev),
           "k7_warp": k7_warp_probe(lib, dev), "kernels": kernel_launches(dev),
           "clocks": clocks_under_k2(dev)}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
