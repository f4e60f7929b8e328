"""ChEES-HMC support (port of the part of ``binf_tpu/samplers/chees.py``
that the fused kernels need): the Halton table that jitters the trajectory
lengths.  The eager ChEES sampler waits for the eager sampler path
(ROADMAP section 1)."""

from __future__ import annotations

import numpy as np

__all__ = ["halton_sequence"]


def halton_sequence(n: int, base: int = 2) -> np.ndarray:
    """Van der Corput / Halton sequence in (0, 1), float64."""
    out = np.zeros(n)
    for i in range(n):
        f, r, x = 1.0, 0.0, i + 1
        while x > 0:
            f /= base
            r += f * (x % base)
            x //= base
        out[i] = r
    return out
