"""Metrics, logging and profiling hooks (port of ``binf_tpu/io/metrics.py``).

* :func:`aggregate_info` reduces a kernel's info (leading axes: steps
  and/or chains) to scalar run statistics: acceptance rates, divergence
  counts, means;
* :class:`MetricsLogger` writes one JSON line per logging block;
* :func:`trace` profiles a block with ``torch.profiler`` (the card's
  kernels too, where there is one) and writes a Chrome trace;
* :data:`named_scope` is ``torch.profiler.record_function``, which names a
  region in that trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Mapping

import torch

named_scope = torch.profiler.record_function

__all__ = ["aggregate_info", "MetricsLogger", "trace", "named_scope"]


def aggregate_info(info: Any) -> dict[str, float]:
    """Reduce kernel info trees (NamedTuples, dicts, tensors) to host-side
    scalars: ``<name>_rate`` and ``<name>_count`` for a boolean field,
    ``<name>_mean`` for a numeric one."""
    out: dict[str, float] = {}

    def visit(prefix: str, node: Any):
        if hasattr(node, "_fields"):
            for f in node._fields:
                visit(f"{prefix}.{f}" if prefix else f, getattr(node, f))
        elif isinstance(node, Mapping):
            for k, v in node.items():
                visit(f"{prefix}.{k}" if prefix else str(k), v)
        elif torch.is_tensor(node):
            if node.dtype == torch.bool:
                out[f"{prefix}_rate"] = float(node.float().mean())
                out[f"{prefix}_count"] = float(node.sum())
            elif node.is_floating_point():
                out[f"{prefix}_mean"] = float(node.mean())
            elif not node.is_complex():
                out[f"{prefix}_mean"] = float(node.float().mean())

    visit("", info)
    return out


class MetricsLogger:
    """JSON-lines metrics logger with step counters and samples a second."""

    def __init__(self, stream=None, prefix: str = "binf_tpu_torch"):
        self.stream = stream or sys.stderr
        self.prefix = prefix
        self._t0 = time.perf_counter()
        self._last_t = self._t0
        self._last_steps = 0

    def log(self, step: int, n_chains: int = 1, **metrics: float) -> None:
        now = time.perf_counter()
        dt = now - self._last_t
        dsteps = step - self._last_steps
        rec = {
            "ts": round(now - self._t0, 3),
            "step": step,
            **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()},
        }
        if dsteps > 0 and dt > 0:
            rec["steps_per_sec"] = round(dsteps / dt, 2)
            rec["chain_steps_per_sec"] = round(dsteps * n_chains / dt, 1)
        self._last_t, self._last_steps = now, step
        self.stream.write(json.dumps({self.prefix: rec}) + "\n")
        self.stream.flush()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (Chrome trace format); ``None`` does
    nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
