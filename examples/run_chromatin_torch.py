#!/usr/bin/env python
"""Chromatin-style structure determination demo on the PyTorch/CUDA port:
the counterpart of ``examples/run_chromatin.py`` (the reference's science
domain): infer a 3D polymer structure from noisy pairwise log-distance
restraints.

Pipeline: synthetic ground truth -> Gibbs alternation of [HMC over the
(N, 3) structure (the restraint loss and its forces from the pairwise
kernels K6a and K6b on the card), exact conjugate Gamma draw of the
restraint precision].

Run: python examples/run_chromatin_torch.py [--beads 128] [--sweeps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--beads", type=int, default=128)
    ap.add_argument("--sweeps", type=int, default=200)
    ap.add_argument("--hmc-steps", type=int, default=5)
    ap.add_argument("--step-size", type=float, default=3e-3)
    ap.add_argument("--observe-frac", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    ap.add_argument("--persistent-cache", action="store_true",
                    help="accepted for the JAX script's flag; the port's kernels are cached "
                         "in their build directory anyway")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.example.chromatin import (
        make_chromatin_posterior,
        restraint_precision_block,
        synthetic_restraints,
    )
    from binf_tpu_torch.ops.kernels._build import build_dir
    from binf_tpu_torch.samplers.gibbs import gibbs, hmc_block

    dev = resolve_device(args.device)
    if args.persistent_cache:
        print(f"--persistent-cache: the port caches its kernels in {build_dir()}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def key(seed):
        return torch.Generator().manual_seed(seed)

    # the restraints are drawn on the device, by a generator of the device
    X_true, log_target, W = synthetic_restraints(
        torch.Generator(device=dev).manual_seed(0), args.beads,
        observe_frac=args.observe_frac, device=dev,
    )
    posterior = make_chromatin_posterior(log_target, W, block=min(256, args.beads))
    print(f"{args.beads} beads, {int(W.sum())} restraints, "
          f"device={kind}")

    kernel = gibbs({
        "structure": hmc_block(
            posterior, "structure", step_size=args.step_size,
            num_integration_steps=args.hmc_steps,
        ),
        "precision": restraint_precision_block(posterior),
    })

    X0 = X_true + 0.3 * torch.randn(X_true.shape, generator=key(1)).to(dev)
    state = kernel.init({"structure": X0, "precision": torch.tensor(5.0, device=dev)})

    generator = torch.Generator(device=dev).manual_seed(2)
    precs, accs = [], []
    t0 = time.perf_counter()
    for _ in range(args.sweeps):
        state, infos = kernel.step(generator, state)
        precs.append(state.position["precision"])
        accs.append(infos["structure"].acceptance_prob)
    precs, accs = torch.stack(precs).cpu().numpy(), torch.stack(accs).cpu().numpy()
    elapsed = time.perf_counter() - t0

    n_pairs = float(W.sum()) * args.sweeps * (args.hmc_steps + 2)
    print(f"{args.sweeps} Gibbs sweeps in {elapsed:.2f}s "
          f"({args.sweeps/elapsed:.1f} sweeps/s, "
          f"{n_pairs/elapsed/1e9:.2f} G restraint-evals/s)")
    print(f"HMC acceptance: {float(accs.mean()):.2f}  "
          f"precision estimate: {float(precs[-50:].mean()):.1f} (truth 25)")

    # structure quality: restrained-pair distance error vs ground truth
    X = state.position["structure"].cpu().numpy()
    Xt = X_true.cpu().numpy()

    def dists(A):
        d = A[:, None, :] - A[None, :, :]
        return np.sqrt(np.maximum((d**2).sum(-1), 1e-12))

    mask = W.cpu().numpy() > 0
    rel = np.abs(dists(X) - dists(Xt))[mask] / np.maximum(dists(Xt)[mask], 0.1)
    print(f"median restrained-distance error vs truth: {np.median(rel):.3f}")


if __name__ == "__main__":
    main()
