#!/usr/bin/env python3
"""The lane-group width sweep of K3's and K4's logistic, AR(1), mixture and
hierarchical branches: the measurement behind ``fused_potential.FAMILY_LANES``.

    python3 scripts/family_lanes.py [--widths 1 4 8 16 32] [--reps 1]
                                    [--families logistic ar1 mixture hierarchical]
                                    [--out chiprun_out/family_lanes.json]

Runs on the card.  The package instantiates these branches at one lane
and at the chosen width only; this script builds the others too (the
hierarchical posterior's at G = 1, 2, 4, 8, the widths that divide its 8
groups, whatever ``--widths`` says): it
copies ``binf_tpu_torch/csrc`` into the git-ignored build directory, adds
a unit ``fused_{warmup,potential}.<family>.g<G>.cu`` for every width that
has none, and compiles the copy with ``BINF_FAMILY_SWEEP`` defined (which
makes ``csrc/densities.cuh::with_density`` dispatch every width), into a
build directory of its own.  Then, at ``chip_smoke.py``'s families-path
shape (8,192 chains, 400 + 500 steps, L = 10, the same problems, and
the hierarchical path's posterior and start), it
holds each width's functor, K3 and K4 against their plain versions
(``chip_smoke.phase_family_check``, K4's draws at each width also against
those at the chosen width) and times K3 and K4 at each width
(``chip_smoke.family_width_sweep``: CUDA events, registers a thread, CTAs
an SM, K3's geometry).  Prints the card's name and power limit and one
JSON line per family; ``--out`` keeps them all.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = {"logistic": ("LogisticDensity<{D}>", range(1, 9)),
            "ar1": ("AR1Density", (None,)),
            "mixture": ("MixtureDensity<3>", (None,)),
            "hierarchical": ("HierarchicalDensity<8>", (None,))}
# the widths of the hierarchical branch: a lane owns whole groups
HIER_WIDTHS = (1, 2, 4, 8)
MACROS = {"fused_warmup": ("BINF_K3_INSTANTIATE", "fused_warmup_kernel.cuh"),
          "fused_potential": ("BINF_K4_INSTANTIATE", "fused_potential_kernel.cuh")}


def sweep_sources(_build, widths) -> None:
    """Point ``_build`` at a copy of csrc holding a unit for every family
    and width, compiled with BINF_FAMILY_SWEEP."""
    csrc = _build.BUILD_ROOT / "family_lanes_csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    for kernel, (macro, header) in MACROS.items():
        for family, (functor, dims) in FAMILIES.items():
            for G in HIER_WIDTHS if family == "hierarchical" else widths:
                unit = csrc / (f"{kernel}.{family}.cu" if G == 1 else
                               f"{kernel}.{family}.g{G}.cu")
                if unit.exists():
                    continue
                lines = [f"{macro}({functor.format(D=D)}, {G})" for D in dims]
                unit.write_text(f'#include "{header}"\n\nnamespace binf {{\n\n'
                                + "\n".join(lines) + "\n\n}  // namespace binf\n")
    _build.CSRC = csrc
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DBINF_FAMILY_SWEEP")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[1, 4, 8, 16, 32])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--families", nargs="+", default=list(FAMILIES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("family_lanes: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2

    import chip_smoke as cs
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import densities as dens_mod
    from binf_tpu_torch.ops.kernels import fused_potential as fp
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

    sweep_sources(_build, args.widths)
    # the copy's units run every swept width (not a shape's own library)
    for functor in ("LogisticDensity", "AR1Density", "MixtureDensity"):
        fp.FAMILY_WIDTHS[functor] = tuple(sorted({*fp.FAMILY_WIDTHS[functor], *args.widths}))
    fp.FAMILY_WIDTHS["HierarchicalDensity"] = HIER_WIDTHS
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.progress(f"card: {card}; building the sweep's units into {_build.build_dir()}")
    _build.build_all()
    problems = {**cs.family_problems(dev), "hierarchical": cs.hierarchical_family(dev)}
    rows = {}
    try:
        for name in args.families:
            logdensity, start_fn, _ = problems[name]
            start = start_fn(cs.FAM_CHAINS, 40)
            template = {k: v[0] for k, v in start.items()}
            density = dens_mod.device_density(logdensity, template).to(dev)
            widths = HIER_WIDTHS if name == "hierarchical" else args.widths
            checks = cs.phase_family_check(f"family lanes {name}", fp, dens_mod, density,
                                           logdensity, start, dev, widths=widths)
            times = cs.family_width_sweep(fp, density, pack_positions(start).contiguous(), dev,
                                          reps=args.reps, widths=widths)
            rows[name] = {"functor": density.functor, "chosen": fp.lanes_for(density),
                          "chains": cs.FAM_CHAINS, "warmup": cs.FAM_WARMUP,
                          "samples": cs.FAM_SAMPLES, "leapfrog": cs.N_LEAPFROG,
                          "reps": args.reps, "checks": checks, "widths": times}
            print(json.dumps({"family": name, **rows[name]}, default=str), flush=True)
    except cs.CheckFailed as e:
        print(f"family_lanes: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "families": rows}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
