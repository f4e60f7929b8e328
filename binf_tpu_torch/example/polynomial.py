"""The polynomial-regression reference workload (port of the data half of
``binf_tpu/example/polynomial.py``): a degree-3 polynomial with unknown
Gaussian noise precision.  Ground truth: coefficients [2.0, -4.0, 1.0, 1.5],
precision 2.5, 20 data points on [-2, 2].  Random draws come from a
``torch.Generator`` where the JAX package takes a key."""

from __future__ import annotations

import math

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.math import polyval

__all__ = [
    "N_DATA_POINTS",
    "TRUE_COEFFICIENTS",
    "TRUE_PRECISION",
    "initial_positions",
    "make_data",
]

TRUE_COEFFICIENTS = (2.0, -4.0, 1.0, 1.5)
TRUE_PRECISION = 2.5
N_DATA_POINTS = 20


def make_data(generator: torch.Generator, n_points: int = N_DATA_POINTS, device=None):
    """Synthetic dataset ``(xses, ys)``: the true polynomial on
    ``linspace(-2, 2, n_points)`` plus noise of precision 2.5 drawn from
    ``generator``."""
    dev = resolve_device(device)
    xses = torch.linspace(-2.0, 2.0, n_points, device=dev)
    coeffs = torch.tensor(TRUE_COEFFICIENTS, device=dev)
    noise = torch.randn((n_points,), generator=generator, device=generator.device)
    ys = polyval(xses, coeffs) + noise.to(dev) / math.sqrt(TRUE_PRECISION)
    return xses, ys


def initial_positions(n_chains: int, n_coefficients: int = 4,
                      generator: torch.Generator | None = None, device=None):
    """Chain-batched start state: coefficients = 1, precision = 1 (the
    reference's start), jittered across chains when ``generator`` is given."""
    dev = resolve_device(device)
    coefficients = torch.ones((n_chains, n_coefficients), device=dev)
    precision = torch.ones((n_chains,), device=dev)
    if generator is None:
        return {"coefficients": coefficients, "precision": precision}

    def normal(shape):
        return torch.randn(shape, generator=generator, device=generator.device).to(dev)

    return {
        "coefficients": coefficients + 0.1 * normal((n_chains, n_coefficients)),
        "precision": precision * torch.exp(0.1 * normal((n_chains,))),
    }
