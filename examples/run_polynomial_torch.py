#!/usr/bin/env python
"""End-to-end polynomial regression demo on the PyTorch/CUDA port: the
counterpart of ``examples/run_polynomial.py`` (the reference
``example_script.py`` workload).

The reference runs ONE chain for 30,000 Python-loop Gibbs sweeps, then
thins to 500 samples (``example_script.py:33-41``).  Here: 1,024 chains x
300 Gibbs sweeps (collapsed conjugate blocks) stepped as one batch on the
card, with convergence diagnostics, MAP, posterior predictive, and (if
matplotlib is present) the reference's three plots.

Run: python examples/run_polynomial_torch.py [--chains 1024] [--sweeps 300] [--device cpu]
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
    ap.add_argument("--sweeps", type=int, default=300)
    ap.add_argument("--burn", type=int, default=100)
    ap.add_argument("--thin", type=int, default=1)
    ap.add_argument("--sampler", choices=["collapsed", "rwm", "hmc"],
                    default="collapsed")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.diagnostics import summary
    from binf_tpu_torch.example.polynomial import (
        TRUE_COEFFICIENTS,
        TRUE_PRECISION,
        get_map,
        initial_positions,
        make_collapsed_gibbs_kernel,
        make_data,
        make_gibbs_kernel,
        make_posterior,
    )
    from binf_tpu_torch.parallel.runner import init_chains, run_chains

    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def key(seed):
        return torch.Generator().manual_seed(seed)

    xses, ys = make_data(key(1), device=dev)
    posterior = make_posterior(xses, ys)

    if args.sampler == "collapsed":
        kernel = make_collapsed_gibbs_kernel(posterior)
    elif args.sampler == "rwm":
        kernel = make_gibbs_kernel(posterior, rwmc_stepsize=0.1)
    else:
        kernel = make_gibbs_kernel(posterior, coefficients_sampler="hmc",
                                   rwmc_stepsize=0.05)

    states = init_chains(kernel, initial_positions(args.chains, generator=key(0), device=dev))

    t0 = time.perf_counter()
    final, samples = run_chains(kernel, torch.Generator(device=dev).manual_seed(0), states,
                                args.sweeps, thin=args.thin)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0

    kept = {k: v[args.burn:] for k, v in samples.items()}
    n_draws = kept["precision"].shape[0] * kept["precision"].shape[1]
    print(f"{n_draws:,} posterior draws in {elapsed:.3f}s "
          f"({n_draws / elapsed:,.0f} draws/s) on {kind}")

    stats = {k: {s: v.cpu().numpy() for s, v in d.items()} for k, d in summary(kept).items()}
    print(f"{'param':<16}{'mean':>10}{'std':>10}{'rhat':>8}{'ess':>12}{'truth':>10}")
    truth = list(TRUE_COEFFICIENTS) + [TRUE_PRECISION]
    rows = [(f"coefficients[{j}]",
             float(stats["coefficients"]["mean"][j]),
             float(stats["coefficients"]["std"][j]),
             float(stats["coefficients"]["rhat"][j]),
             float(stats["coefficients"]["ess"][j]),
             truth[j]) for j in range(4)]
    rows.append(("precision",
                 float(stats["precision"]["mean"]),
                 float(stats["precision"]["std"]),
                 float(stats["precision"]["rhat"]),
                 float(stats["precision"]["ess"]),
                 truth[4]))
    for name, mean, std, rhat, ess_v, tr in rows:
        print(f"{name:<16}{mean:>10.3f}{std:>10.3f}{rhat:>8.3f}{ess_v:>12.0f}{tr:>10.2f}")

    # MAP estimate over a subsample (reference ``get_MAP``)
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in kept.items()}
    n_flat = flat["precision"].shape[0]
    idx = torch.randperm(n_flat, generator=key(3))[:min(2000, n_flat)].to(dev)
    sub = {k: v[idx] for k, v in flat.items()}
    lps = torch.func.vmap(
        lambda c, p: posterior.log_prob(coefficients=c, precision=p)
    )(sub["coefficients"], sub["precision"])
    m = get_map(sub, lps)
    print(f"MAP coefficients: {m.coefficients.cpu().numpy().round(3)}  "
          f"precision: {float(m.precision):.3f}")

    if args.plot:
        from binf_tpu_torch.example.plots import plot_fit, plot_hists, plot_prediction_tube

        fig = plot_hists(sub, truth[:4], truth[4])
        fig.savefig("polynomial_hists.png", dpi=120)
        import matplotlib.pyplot as plt

        _, ax = plt.subplots()
        plot_fit(xses, ys, np.linspace(-2, 2, 100), m.coefficients, truth[:4], ax=ax)
        c = m.coefficients.cpu().numpy()
        fit = np.polyval(c[::-1], np.linspace(-2, 2, 100))
        plot_prediction_tube(sub, np.linspace(-2, 2, 40), fit.min() - 3, fit.max() + 3, ax=ax)
        ax.figure.savefig("polynomial_fit.png", dpi=120)
        print("wrote polynomial_hists.png, polynomial_fit.png")


if __name__ == "__main__":
    main()
