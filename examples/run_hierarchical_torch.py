#!/usr/bin/env python
"""Hierarchical nonlinear model demo on the PyTorch/CUDA port: the
counterpart of ``examples/run_hierarchical.py``, window-adapted eager NUTS
with an ADVI cross-check.

G logistic growth curves with partial pooling, observed through a Gaussian
channel (curve points) and a Poisson channel (per-group event counts)
sharing the group parameters.  NUTS steps every chain's tree in lockstep
on the card (``samplers/nuts.py`` under ``warmup_and_run``), over the
posterior's closed-form potential where it has a device density (2 to 16
groups).

Run: python examples/run_hierarchical_torch.py [--groups 8] [--chains 32] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ADVI_STEPS, ADVI_DRAWS = 2500, 1000


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    ap.add_argument("--persistent-cache", action="store_true",
                    help="accepted for the JAX script's flag; the port's kernels are cached "
                         "in their build directory anyway")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.diagnostics import summary
    from binf_tpu_torch.example.hierarchical import (
        TRUE_MU,
        TRUE_TAU,
        make_hierarchical_posterior,
        synthetic_hierarchical_data,
    )
    from binf_tpu_torch.ops.kernels._build import build_dir
    from binf_tpu_torch.parallel.runner import warmup_and_run
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers.fused import eager_logdensity
    from binf_tpu_torch.samplers.nuts import nuts
    from binf_tpu_torch.vi import advi, variational_sample

    dev = resolve_device(args.device)
    if args.persistent_cache:
        print(f"--persistent-cache: the port caches its kernels in {build_dir()}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def key(seed):
        return torch.Generator().manual_seed(seed)

    x, y, counts, gp_true = synthetic_hierarchical_data(key(0), args.groups, device=dev)
    post = make_hierarchical_posterior(x, y, counts, args.groups, device=dev)
    print(f"{args.groups} groups, {y.shape[0]} curve points + "
          f"{args.groups} Poisson counts, device={kind}")

    logdensity = transform_logdensity(post.log_prob, {"precision": LogTransform})

    n = args.chains
    positions = {
        "group_params": 0.1 * torch.randn((n, args.groups, 2), generator=key(1)).to(dev),
        "mu": torch.zeros((n, 2), device=dev),
        "log_tau": torch.full((n, 2), -1.0, device=dev),
        "precision": torch.full((n,), 2.0, device=dev),
    }
    batched = eager_logdensity(logdensity, {k: v[0] for k, v in positions.items()}, dev)

    def make_kernel(step_size, inverse_mass):
        return nuts(batched, step_size=step_size, max_doublings=7, inverse_mass=inverse_mass)

    t0 = time.perf_counter()
    samples, final, adapt = warmup_and_run(
        make_kernel, positions, torch.Generator(device=dev).manual_seed(2),
        num_warmup=args.warmup, num_samples=args.samples,
        initial_step_size=0.05, target_accept=0.85,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0

    n_draws = args.samples * n
    print(f"NUTS: {n_draws:,} draws in {elapsed:.1f}s "
          f"(eps={float(adapt.step_size):.3f})")
    stats = summary({"mu": samples["mu"], "log_tau": samples["log_tau"]})
    mu = stats["mu"]["mean"].cpu().numpy()
    tau = np.exp(samples["log_tau"].reshape(-1, 2).mean(0).cpu().numpy())
    print(f"mu     = [{mu[0]:+.3f} {mu[1]:+.3f}]   truth {TRUE_MU}  "
          f"rhat {stats['mu']['rhat'].cpu().numpy().round(3)}")
    print(f"tau    ~ [{tau[0]:.3f} {tau[1]:.3f}]   truth {TRUE_TAU}")
    prec = torch.exp(samples["precision"]).mean().item()
    print(f"precision ~ {prec:.1f}   truth 25.0")

    t0 = time.perf_counter()
    fit = advi(post, torch.Generator(device=dev).manual_seed(3), num_steps=ADVI_STEPS,
               learning_rate=0.02, device=dev)
    vi = variational_sample(post, fit, torch.Generator(device=dev).manual_seed(4), ADVI_DRAWS)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"ADVI ({time.perf_counter()-t0:.1f}s): "
          f"mu = {vi['mu'].mean(0).cpu().numpy().round(3)}  "
          f"ELBO = {float(fit.final_elbo):.1f}")


if __name__ == "__main__":
    main()
