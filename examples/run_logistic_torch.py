#!/usr/bin/env python
"""Bayesian logistic regression demo on the PyTorch/CUDA port: the
counterpart of ``examples/run_logistic.py``, fused-kernel HMC (the eager
window warmup, then K4) with a Laplace cross-check.

A Bernoulli GLM on the model DSL (LinearForwardModel + BernoulliErrorModel):
recovers the weights, reports the null feature's credible interval, and
prints held-out predictive accuracy from the posterior-predictive mean.

Run: python examples/run_logistic_torch.py [--chains 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAPLACE_STEPS = 1500


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--chains", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    ap.add_argument("--persistent-cache", action="store_true",
                    help="accepted for the JAX script's flag; the port's kernels are cached "
                         "in their build directory anyway")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.diagnostics import summary
    from binf_tpu_torch.example.logistic import (
        TRUE_WEIGHTS,
        initial_positions,
        make_logistic_posterior,
        predict_proba,
        synthetic_logistic_data,
    )
    from binf_tpu_torch.ops.kernels._build import build_dir
    from binf_tpu_torch.samplers.fused import fused_model_hmc

    dev = resolve_device(args.device)
    if args.persistent_cache:
        print(f"--persistent-cache: the port caches its kernels in {build_dir()}")
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"backend: {dev.type}  devices: {n_dev}")

    def key(seed):
        return torch.Generator().manual_seed(seed)

    X, y = synthetic_logistic_data(key(0), args.n, device=dev)
    X_test, y_test = synthetic_logistic_data(key(7), 500, device=dev)
    post = make_logistic_posterior(X, y, device=dev)
    d = X.shape[1]

    t0 = time.time()
    # the bound log_prob: the port recognises it and runs K4 over its
    # device density
    result = fused_model_hmc(
        post.log_prob,
        initial_positions(args.chains, key(1), device=dev),
        torch.Generator(device=dev).manual_seed(2),
        num_warmup=args.warmup,
        num_samples=args.samples,
        num_leapfrog=10,
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    n_draws = args.samples * args.chains
    print(f"fused HMC: {elapsed:.1f}s  ({n_draws / elapsed:,.0f} draws/s)  "
          f"accept {float(result.accept_rate):.2f}")

    keep = args.samples // 3
    w = result.samples["weights"][keep:]
    stats = {k: v.cpu().numpy() for k, v in summary({"weights": w})["weights"].items()}
    print(f"\n{'':12s}{'true':>8s}{'mean':>8s}{'sd':>8s}{'rhat':>8s}")
    for j in range(d):
        print(f"weight[{j}]   {TRUE_WEIGHTS[j]:8.2f}{stats['mean'][j]:8.2f}"
              f"{stats['std'][j]:8.2f}{stats['rhat'][j]:8.3f}")

    flat = w.reshape(-1, d).cpu().numpy()
    lo, hi = np.percentile(flat[:, 3], [2.5, 97.5])
    print(f"\nnull feature 95% CI: [{lo:+.2f}, {hi:+.2f}] "
          f"({'contains 0' if lo < 0 < hi else 'EXCLUDES 0'})")

    p_test = predict_proba(X_test, torch.as_tensor(flat[::7], device=dev)).cpu().numpy()
    acc = ((p_test > 0.5) == y_test.cpu().numpy()).mean()
    print(f"held-out predictive accuracy: {acc:.3f}")

    # Laplace cross-check (MAP should sit at the posterior mean for n=200)
    from binf_tpu_torch.vi import laplace_approximation

    lap = laplace_approximation(post, 3, num_steps=LAPLACE_STEPS, device=dev)
    gap = np.abs(lap.mode["weights"].cpu().numpy() - flat.mean(0)).max()
    print(f"Laplace MAP vs MCMC mean: max gap {gap:.3f} "
          f"(converged={bool(lap.converged)})")


if __name__ == "__main__":
    main()
