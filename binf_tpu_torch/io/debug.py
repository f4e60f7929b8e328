"""Determinism guards and NaN/inf localisation (port of
``binf_tpu/io/debug.py``).

* :func:`validate_density` evaluates a density's components, its log
  density and its gradient at given values and reports which produced a
  non-finite number;
* :func:`check_determinism` runs a kernel twice from the same seed and
  state and reports whether the results are equal bit for bit (catching
  nondeterministic reductions or generator misuse);
* :func:`finite_or_neginf` wraps a log density so a non-finite value
  becomes -inf (a rejected proposal) instead of a NaN in the Metropolis
  test.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from binf_tpu_torch.ops.tree import tree_leaves

__all__ = ["validate_density", "check_determinism", "finite_or_neginf"]


def validate_density(density, values=None, **kw) -> dict[str, Any]:
    """Evaluate every posterior component (or the whole density) and its
    gradient, and report whether each is finite.  Returns the report; it
    raises nothing, for interactive debugging and pre-flight checks."""
    from binf_tpu_torch.core.density import as_value_dict

    vals = as_value_dict(values, **kw)
    report: dict[str, Any] = {}

    def check_one(name, fn):
        try:
            v = fn()
            report[name] = {"value": float(torch.sum(v)),
                            "finite": bool(torch.isfinite(v).all())}
        except Exception as e:  # the report names the failure
            report[name] = {"error": f"{type(e).__name__}: {e}"}

    if hasattr(density, "components"):
        for cname, comp in density.components.items():
            sub = {k: vals[k] for k in comp.variables}
            check_one(f"log_prob[{cname}]", lambda c=comp, s=sub: c.log_prob(s))
    check_one("log_prob", lambda: density.log_prob(vals))
    try:
        for k, g in density.gradient(vals).items():
            report[f"grad[{k}]"] = {"max_abs": float(torch.max(torch.abs(g))),
                                    "finite": bool(torch.isfinite(g).all())}
    except Exception as e:  # the report names the failure
        report["gradient"] = {"error": f"{type(e).__name__}: {e}"}
    report["ok"] = all(v.get("finite", True) for v in report.values() if isinstance(v, dict))
    return report


def check_determinism(kernel, seed: int, state: Any, steps: int = 5) -> bool:
    """Run ``steps`` kernel steps twice, each from a fresh generator seeded
    with ``seed`` on the state's device; True iff the two final states are
    equal bit for bit."""
    device = tree_leaves(state)[0].device

    def run():
        generator = torch.Generator(device=device).manual_seed(seed)
        s = state
        for _ in range(steps):
            s, _ = kernel.step(generator, s)
        return s

    a, b = run(), run()
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))
               if torch.is_tensor(x))


def finite_or_neginf(logdensity_fn: Callable) -> Callable:
    """Guard a log density: a non-finite value becomes -inf (the proposal
    is rejected and the chain survives)."""

    def guarded(position):
        v = logdensity_fn(position)
        return torch.where(torch.isfinite(v), v, -torch.inf)

    return guarded
