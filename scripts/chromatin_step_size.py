#!/usr/bin/env python3
"""How a fixed HMC step size fares on the chromatin Gibbs alternation, and
the restrained pair that bounds it.

    python3 scripts/chromatin_step_size.py [--beads 2048] [--sweeps 200]
                                           [--problems 4] [--step-sizes 3e-3 ...]

Runs on the card.  Each problem is drawn as ``examples/run_chromatin.py``
draws its own: the restraints from a generator seeded with the problem's
number (0, 1, ...), the start X_true + 0.3 noise from a generator seeded
with 1, precision 5; all generators are the card's, as ``chip_smoke.py``'s
chromatin path draws its problem 0.  For every problem and step size
(default: the reference's 3e-3, ``run_chromatin.py:32``) it runs the
sweeps under two HMC noise seeds and prints one JSON line with: the
closest restrained pair of the truth ``d_min``; the leapfrog stability
number ``eps * 2 sqrt(lambda) / d_min`` of that pair's restraint near its
target, at the noise's empirical precision lambda (leapfrog is unstable
above 2); the mean HMC acceptance over the first 40 sweeps and over all;
the precision at the end; and the largest energy error of a rejected
proposal.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beads", type=int, default=2048)
    ap.add_argument("--sweeps", type=int, default=200)
    ap.add_argument("--problems", type=int, default=4)
    ap.add_argument("--step-sizes", type=float, nargs="+", default=[3e-3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chromatin_step_size: no CUDA device", file=sys.stderr)
        return 2

    from binf_tpu_torch.example import chromatin
    from binf_tpu_torch.ops.kernels.pairwise import pairwise_loss_plain
    from binf_tpu_torch.samplers.gibbs import gibbs, hmc_block

    dev = torch.device("cuda")
    for problem in range(args.problems):
        X, D, W = chromatin.synthetic_restraints(torch.Generator(device=dev).manual_seed(problem),
                                                 args.beads, observe_frac=0.3, device=dev)
        X0 = X + 0.3 * torch.randn(X.shape, generator=torch.Generator(device=dev).manual_seed(1),
                                   device=dev)
        post = chromatin.make_chromatin_posterior(D, W, block=256)
        d_min = float(torch.cdist(X.double(), X.double())[W > 0].min())
        lam = float(W.sum() / pairwise_loss_plain(X, D, W))
        for eps in args.step_sizes:
            kernel = gibbs({"structure": hmc_block(post, "structure", step_size=eps,
                                                   num_integration_steps=5),
                            "precision": chromatin.restraint_precision_block(post)})
            for noise_seed in (1, 2):
                state = kernel.init({"structure": X0,
                                     "precision": torch.tensor(5.0, device=dev)})
                gen = torch.Generator(device=dev).manual_seed(noise_seed)
                accs, worst = [], 0.0
                for _ in range(args.sweeps):
                    state, infos = kernel.step(gen, state)
                    info = infos["structure"]
                    accs.append(float(info.acceptance_prob))
                    if not bool(info.accepted):
                        worst = max(worst, float(info.energy_error))
                print(json.dumps({
                    "problem": problem, "step_size": eps, "noise_seed": noise_seed,
                    "d_min": d_min, "empirical_precision": lam,
                    "eps_omega": eps * 2 * lam ** 0.5 / d_min,
                    "accept_first_40": sum(accs[:40]) / len(accs[:40]),
                    "accept": sum(accs) / len(accs),
                    "final_precision": float(state.position["precision"]),
                    "largest_rejected_energy_error": worst}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
