#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``binf_tpu_torch/csrc`` (nvcc, first use), holds
each kernel against its plain PyTorch version on the card, then drives the
main path of the headline benchmark at full width: one adaptive HMC run on
the polynomial-regression posterior (16,384 chains, 500 fused-warmup steps
pooled over one tile of all chains, then 4,000 fused sampling steps at
L = 10), once cold and four times timed, scored as min bulk ESS over the
end-to-end wall time.  Progress goes to stderr.  Standard output ends
with the card's name and power limit, one JSON line per kernel
(``{"kernels": [...]}``) and, last, ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero; so does a host without a CUDA card.
"""

from __future__ import annotations

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
REPS = 4
K2_CHECK_STEPS = 200
# Philox seed of the six-step K3 comparison: no decision of the plain
# version's 512-chain tiles lies within 1e-4 of its threshold
K3_SHORT_SEED = 9

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


def eval_flops(n: int, d: int) -> int:
    """Float operations of one linear-regression potential-and-gradient
    evaluation (csrc/linreg_density.cuh): per data point d FMAs for the
    residual, one subtract, one FMA for the sum of squares and d FMAs for
    the gradient; then the prior and the log-precision terms."""
    return n * (4 * d + 3) + 6 * d + 12


def trajectory_flops(n: int, d: int, L: int) -> int:
    """One HMC step: L + 1 evaluations, L drift-and-kick updates of the
    d+1 coordinates (5 flops each), momentum and kinetic terms."""
    D = d + 1
    return (L + 1) * eval_flops(n, d) + L * 5 * D + 8 * D


def bound_ms(bytes_moved: float, flops: float, int_ops: float):
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = flops / PEAK_F32 + int_ops / PEAK_I32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    steps = N_WARMUP + N_SAMPLES
    prng.philox_noise(7, prng.TAG_SAMPLE, N_CHAINS, 16, 5, device=dev)
    ms, _ = timed(lambda: prng.philox_noise(7, prng.TAG_SAMPLE, N_CHAINS, steps, 5,
                                            device=dev), reps=3)

    def plain_volume():
        for s0 in range(0, steps, 500):
            prng.philox_noise_plain(7, prng.TAG_SAMPLE, N_CHAINS, min(500, steps - s0), 5,
                                    step0=s0, device=dev)

    plain_ms, _ = timed(plain_volume)
    calls = steps * N_CHAINS * 4  # 3 normal slots + the uniform slot
    bms, by = bound_ms(steps * N_CHAINS * 6 * 4, steps * N_CHAINS * 5 * 20,
                       calls * PHILOX_CALL_OPS)
    progress(f"philox: {ms:.3f} ms kernel, {plain_ms:.1f} ms plain, bound {bms:.3f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_k2_check(fh, density, dev):
    """K2 against its plain version at the main width on one Philox stream."""
    g = torch.Generator().manual_seed(3)
    truth = torch.tensor([2.0, -4.0, 1.0, 1.5, float(np.log(2.5))])
    q0 = (truth + 0.1 * torch.randn((N_CHAINS, 5), generator=g)).to(dev)
    eps = torch.tensor([0.2], device=dev)
    im = torch.tensor([0.05, 0.1, 0.02, 0.02, 0.1], device=dev)
    V, y = density.V, density.y
    draws_k, acc_k = fh.fused_linreg_hmc_run(
        q0, 11, V, y, density.prior_var, 1.0, 0.2, eps, inverse_mass=im,
        num_steps=K2_CHECK_STEPS, steps_per_block=K2_CHECK_STEPS, block_chains=N_CHAINS,
        device=dev)
    plain = fh.linreg_hmc_plain(density, q0, eps, im, num_steps=K2_CHECK_STEPS,
                                num_leapfrog=N_LEAPFROG, seed=11)
    torch.cuda.synchronize()
    # a step was accepted iff the chain moved; the plain version records
    # its decisions as the sign of log u - (E0 - E1)
    moved = (draws_k != torch.cat([q0[None], draws_k[:-1]])).any(dim=2)  # (steps, C)
    flips = moved != (plain.margin < 0)
    flipped = flips.any(dim=0)
    chains = torch.nonzero(flipped).flatten()
    first = flips.float().argmax(dim=0)[chains]
    n_flips = int(chains.numel())
    worst = float(plain.margin[first, chains].abs().max()) if n_flips else 0.0
    progress(f"K2 check: {n_flips} of {N_CHAINS} chains flipped an MH decision "
             f"(largest |log u - (E0 - E1)| at a first flip {worst:.3g})")
    print(f"K2 MH flips: {n_flips} of {N_CHAINS} chains over {K2_CHECK_STEPS} steps")
    # float32 rounding moves E0 - E1 by ~1e-5 here: a decision flips only
    # that close to its threshold.  A 1e-6 relative change of the start
    # flips ~0.1% of the plain version's chains over these steps, so 1% is
    # ten times that.
    check(worst < 1e-3, "K2: each chain's first flipped decision lay within 1e-3 "
                        "of its threshold")
    check(n_flips <= N_CHAINS // 100, f"K2: {n_flips} flipped chains <= 1%")
    # on chains that took the same decisions throughout: the same 1e-6
    # change of the start moves the plain draws by up to 1.3e-3
    err = float((draws_k - plain.draws)[:, ~flipped].abs().max())
    check(err <= 1e-2, f"K2 draws: max abs err {err:.3g} <= 1e-2 on unflipped chains")
    n_dec = K2_CHECK_STEPS * N_CHAINS
    check(abs(int(moved.sum()) - float(acc_k) * n_dec) < 1.0,
          "K2 accept rate counts the kernel's own accepted steps")
    acc_p = float(plain.accepts.sum()) / n_dec
    check(abs(float(acc_k) - acc_p) * n_dec <= int(flips.sum()),
          f"K2 accept rate {float(acc_k):.6f} vs plain {acc_p:.6f}, apart by no more "
          f"than the {int(flips.sum())} flipped decisions")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from binf_tpu_torch.diagnostics import ess
    from binf_tpu_torch.example.polynomial import make_data
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import fused_hmc as fh
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels import prng
    from binf_tpu_torch.ops.math import vandermonde

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

        # -- score and posterior checks ----------------------------------------------
        m_ess = min(float(ess(draws[:, :, :4]).min()), float(ess(torch.exp(draws[:, :, 4]))))
        accept = float(acc)
        progress(f"main path: e2e {e2e * 1e3:.2f} ms (runs {[round(w * 1e3, 2) for w in walls]}), "
                 f"warmup {np.mean(warm_ms):.2f} ms, sampling {np.mean(samp_ms):.2f} ms, "
                 f"accept {accept:.4f}, eps {float(eps):.5f}, min bulk ESS {m_ess:.1f}, "
                 f"ESS/s {m_ess / e2e:.4g}")
        check(bool(torch.isfinite(draws).all()) and draws.shape == (N_SAMPLES, N_CHAINS, 5),
              "main path: finite draws of shape (4000, 16384, 5)")
        check(0.6 < accept < 0.95, f"main path: acceptance {accept:.4f} in (0.6, 0.95)")
        check(np.isfinite(m_ess) and m_ess > 0, f"main path: min bulk ESS {m_ess:.1f} > 0")
        kept = draws[N_SAMPLES // 4:].double()
        coeffs = kept[..., :4].reshape(-1, 4)
        prec = torch.exp(kept[..., 4]).reshape(-1)
        Vd, yd = V.double(), ys.double()
        lam = float(prec.mean())
        cov = torch.linalg.inv(lam * Vd.T @ Vd + torch.eye(4, device=dev, dtype=torch.float64) / 5.0)
        exact = cov @ (lam * Vd.T @ yd)
        c_err = float((coeffs.mean(0) - exact).abs().max())
        check(c_err < 0.1, f"main path: coefficient mean within {c_err:.3g} of the exact "
                           "conditional Gaussian at the mean precision (< 0.1)")
        ss = ((yd[:, None] - Vd @ coeffs[::64].T) ** 2).sum(0)
        expected = float((11.0 / (0.2 + ss / 2)).mean())
        check(abs(lam / expected - 1.0) < 0.1,
              f"main path: precision mean {lam:.4f} vs Gamma self-consistency "
              f"{expected:.4f} (rtol 0.1)")
        for name in ("philox", "fused_linreg_hmc", "fused_warmup"):
            check(launches[name] > 0, f"main path launched {name} {launches[name]} times")

        # -- plain K2 at the main path's inputs, for its time ---------------------------
        qw, eps_c, im_c = fp.fused_warmup_run(density, q_init, 2 * REPS, 0.1,
                                              num_warmup=N_WARMUP, block_chains=N_CHAINS,
                                              device=dev)
        k2_plain_ms, _ = timed(lambda: fh.linreg_hmc_plain(
            density, qw, eps_c.mean().reshape(1), im_c.mean(0), num_steps=N_SAMPLES,
            num_leapfrog=N_LEAPFROG, seed=2 * REPS + 1))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    n, d = 20, 4
    # K2 writes the draws and reads its start; K3 reads and writes
    # positions and writes a step size and a metric per chain
    k2_bound = bound_ms(N_SAMPLES * N_CHAINS * 5 * 4 + N_CHAINS * (5 + 1) * 4,
                        N_SAMPLES * N_CHAINS * trajectory_flops(n, d, N_LEAPFROG),
                        N_SAMPLES * N_CHAINS * 4 * PHILOX_CALL_OPS)
    k3_bound = bound_ms(N_CHAINS * (3 * 5 + 1) * 4,
                        N_WARMUP * N_CHAINS * trajectory_flops(n, d, N_LEAPFROG),
                        N_WARMUP * N_CHAINS * 4 * PHILOX_CALL_OPS)
    kernels = [
        # the main path runs Philox inside K2 and K3 (philox.cuh), each of
        # their launches counts one; ms is philox.cu's kernel standing alone
        dict(name="philox", route="cuda", source="binf_tpu_torch/csrc/philox.cuh",
             replaces="binf_tpu/ops/pallas/prng.py:23", launches=launches["philox"],
             max_abs_err=philox["max_abs_err"], ms=philox["ms"],
             plain_ms=philox["plain_ms"], bound_ms=philox["bound_ms"],
             bound_by=philox["bound_by"], library_ms=None),
        dict(name="fused_linreg_hmc", route="cuda", source="binf_tpu_torch/csrc/fused_hmc.cu",
             replaces="binf_tpu/ops/pallas/fused_hmc.py:65",
             launches=launches["fused_linreg_hmc"], max_abs_err=k2_err,
             ms=float(np.mean(samp_ms)), plain_ms=k2_plain_ms, bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
        dict(name="fused_warmup", route="cuda", source="binf_tpu_torch/csrc/fused_warmup.cu",
             replaces="binf_tpu/ops/pallas/fused_potential.py:478",
             launches=launches["fused_warmup"], max_abs_err=k3_err,
             ms=float(np.mean(warm_ms)), plain_ms=k3_plain_ms, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=None),
    ]
    print(json.dumps({"main_path": {
        "chains": N_CHAINS, "warmup": N_WARMUP, "samples": N_SAMPLES, "leapfrog": N_LEAPFROG,
        "e2e_ms": e2e * 1e3, "e2e_runs_ms": [w * 1e3 for w in walls],
        "warmup_ms": float(np.mean(warm_ms)), "sampling_ms": float(np.mean(samp_ms)),
        "accept": accept, "step_size": float(eps), "min_bulk_ess": m_ess,
        "ess_per_s": m_ess / e2e, "build_s": build_s}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
