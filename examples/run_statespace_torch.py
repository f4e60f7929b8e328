#!/usr/bin/env python
"""State-space (AR(1) trajectory) demo on the PyTorch/CUDA port: the
counterpart of ``examples/run_statespace.py``, K3 and K4 on a sequential
model, cross-checked by eager NUTS.

Every observation depends on the whole parameter history.  The port runs
the recurrence in its CUDA functor (``csrc/ar1_density.cuh``, the steps
split over a lane group as one affine scan), so warmup and sampling run as
two kernels; an eager NUTS run (``samplers/nuts.py`` under
``warmup_and_run``) cross-checks the posterior.

Run: python examples/run_statespace_torch.py [--chains 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the NUTS cross-check: chains (at most), warmup and sampling steps
NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES = 64, 300, 300


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--timesteps", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    ap.add_argument("--persistent-cache", action="store_true",
                    help="accepted for the JAX script's flag; the port's kernels are cached "
                         "in their build directory anyway")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.diagnostics import summary
    from binf_tpu_torch.example.statespace import (
        TRUE_DYNAMICS,
        TRUE_PRECISION,
        initial_positions,
        make_ar1_posterior,
        synthetic_ar1_data,
    )
    from binf_tpu_torch.ops.kernels._build import build_dir
    from binf_tpu_torch.parallel.runner import warmup_and_run
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers.fused import eager_logdensity, fused_model_hmc
    from binf_tpu_torch.samplers.nuts import nuts

    dev = resolve_device(args.device)
    if args.persistent_cache:
        print(f"--persistent-cache: the port caches its kernels in {build_dir()}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def key(seed):
        return torch.Generator().manual_seed(seed)

    y = synthetic_ar1_data(key(0), args.timesteps, device=dev)
    post = make_ar1_posterior(y, device=dev)
    print(f"AR(1) trajectory: {args.timesteps} timesteps, "
          f"{args.chains} chains, device={kind}")

    # the bound log_prob under the transform: the port recognises it and
    # runs its device density in K3 and K4
    logdensity = transform_logdensity(post.log_prob, {"precision": LogTransform})
    pos = initial_positions(args.chains, key(1), device=dev)
    pos = {**pos, "precision": torch.log(pos["precision"])}

    # -- the fused warmup and sampling kernels --------------------------------
    t0 = time.perf_counter()
    result = fused_model_hmc(
        logdensity, pos, torch.Generator(device=dev).manual_seed(2),
        num_warmup=args.warmup, num_samples=args.samples,
        block_chains=min(512, args.chains), warmup="fused", device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0

    burn = args.samples // 4
    dyn = result.samples["dynamics"][burn:]
    prec = torch.exp(result.samples["precision"][burn:]).mean().item()
    stats = summary({"dynamics": dyn})
    print(f"fused HMC: {args.samples * args.chains:,} draws in {elapsed:.1f}s "
          f"(accept {float(result.accept_rate):.2f})")
    m = dyn.reshape(-1, 3).mean(0).cpu().numpy()
    print(f"dynamics = [{m[0]:+.3f} {m[1]:+.3f} {m[2]:+.3f}]   "
          f"truth {TRUE_DYNAMICS}  "
          f"rhat {stats['dynamics']['rhat'].cpu().numpy().round(3)}")
    print(f"precision ~ {prec:.1f}   truth {TRUE_PRECISION}")

    # -- eager NUTS cross-check ----------------------------------------------
    n_ref = min(args.chains, NUTS_CHAINS)
    ref_pos = {k: v[:n_ref] for k, v in pos.items()}
    batched = eager_logdensity(logdensity, {k: v[0] for k, v in ref_pos.items()}, dev)

    def make_kernel(step_size, inverse_mass):
        return nuts(batched, step_size=step_size, max_doublings=6, inverse_mass=inverse_mass)

    t0 = time.perf_counter()
    samples, _, _ = warmup_and_run(
        make_kernel, ref_pos, torch.Generator(device=dev).manual_seed(3),
        num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
    )
    ref = samples["dynamics"][NUTS_SAMPLES // 4:].reshape(-1, 3).mean(0).cpu().numpy()
    print(f"NUTS cross-check ({time.perf_counter()-t0:.1f}s): "
          f"dynamics = {ref.round(3)}  (max |delta| "
          f"{np.abs(ref - m).max():.3f})")


if __name__ == "__main__":
    main()
