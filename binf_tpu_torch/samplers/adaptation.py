"""Warmup schedule (port of the part of ``binf_tpu/samplers/adaptation.py``
that the fused warmup needs)."""

from __future__ import annotations

__all__ = ["_stan_boundaries"]


def _stan_boundaries(num_steps: int, initial_buffer=75, final_buffer=50, first_window=25):
    """Stan warmup partition: ``(initial_buffer, final_buffer, boundaries)``.

    ``boundaries`` are the steps where the mass estimate is harvested into
    the metric, the Welford accumulator is reset, and dual averaging is
    restarted at the current step size.  Expanding windows (25, 50, 100, ...)
    with the LAST window extended so its boundary lands exactly at
    ``num_steps - final_buffer``: the final buffer then re-adapts the step
    size under the final metric (Stan semantics)."""
    if num_steps < initial_buffer + final_buffer + first_window:
        initial_buffer = max(1, int(0.15 * num_steps))
        final_buffer = max(1, int(0.1 * num_steps))
    slow_end = num_steps - final_buffer
    boundaries = []
    pos, w = initial_buffer, first_window
    while pos < slow_end:
        end = pos + w
        if end + 2 * w > slow_end:  # too little room for the next window
            end = slow_end
        boundaries.append(min(end, slow_end))
        pos, w = end, w * 2
    return initial_buffer, final_buffer, tuple(boundaries)
