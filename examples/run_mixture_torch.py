#!/usr/bin/env python
"""Gaussian-mixture demo on the PyTorch/CUDA port: the counterpart of
``examples/run_mixture.py``, K3 and K4 (the fused warmup and sampling
kernels) on a sort/logsumexp model.

The density sorts the component means (identifiability under label
switching) and reduces a per-point ``logsumexp`` over components; the port
runs it through its CUDA functor (``csrc/mixture_density.cuh``), which
``fused_model_hmc`` finds from the posterior's own ``log_prob``.  After
sampling, posterior-mean responsibilities classify held-out points.

Run: python examples/run_mixture_torch.py [--chains 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--points", type=int, default=240)
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
    from binf_tpu_torch.example.mixture import (
        TRUE_MEANS,
        TRUE_SIGMA,
        TRUE_WEIGHTS,
        classify,
        initial_positions,
        make_mixture_posterior,
        synthetic_mixture_data,
    )
    from binf_tpu_torch.ops.kernels._build import build_dir
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    dev = resolve_device(args.device)
    if args.persistent_cache:
        print(f"--persistent-cache: the port caches its kernels in {build_dir()}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def key(seed):
        return torch.Generator().manual_seed(seed)

    y = synthetic_mixture_data(key(0), args.points, device=dev)
    post = make_mixture_posterior(y, device=dev)
    print(f"Gaussian mixture: {args.points} points, 3 components, "
          f"{args.chains} chains, device={kind}")

    pos = initial_positions(args.chains, generator=key(1), device=dev)

    t0 = time.perf_counter()
    # the bound log_prob (not a lambda around it): the port recognises it
    # and runs its device density in K3 and K4
    result = fused_model_hmc(
        post.log_prob, pos, torch.Generator(device=dev).manual_seed(2),
        num_warmup=args.warmup, num_samples=args.samples,
        block_chains=min(512, args.chains), warmup="fused", device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0

    burn = args.samples // 4
    flat = {k: v[burn:].reshape((-1,) + tuple(v.shape[2:])).cpu().numpy()
            for k, v in result.samples.items()}
    mus = np.sort(flat["means"], axis=1).mean(0)
    logw = flat["log_weights"]
    w = np.exp(logw - np.log(np.exp(logw).sum(1, keepdims=True))).mean(0)
    sigma = np.exp(flat["log_sigma"]).mean()
    stats = summary({"means": torch.sort(result.samples["means"][burn:], dim=-1).values})

    print(f"fused HMC: {args.samples * args.chains:,} draws in {elapsed:.1f}s "
          f"(accept {float(result.accept_rate):.2f})")
    print(f"means   = {mus.round(3)}   truth {np.sort(TRUE_MEANS)}  "
          f"rhat {stats['means']['rhat'].cpu().numpy().round(3)}")
    print(f"weights = {w.round(3)}   truth {TRUE_WEIGHTS}")
    print(f"sigma   ~ {sigma:.3f}   truth {TRUE_SIGMA}")

    # posterior-predictive classification of held-out points
    y_new = synthetic_mixture_data(key(9), 32, device=dev)
    sub = {k: torch.as_tensor(v[:: max(1, len(v) // 256)], device=dev) for k, v in flat.items()}
    labels = classify(y_new, sub)
    # accuracy against nearest-true-mean assignment
    true_labels = np.argmin(
        np.abs(y_new.cpu().numpy()[:, None] - np.sort(TRUE_MEANS)[None, :]), axis=1
    )
    acc = float((labels.cpu().numpy() == true_labels).mean())
    print(f"held-out classification vs nearest-true-mean: {acc:.0%} agreement")


if __name__ == "__main__":
    main()
