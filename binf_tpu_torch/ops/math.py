"""Numerics the main path needs (port of ``binf_tpu/ops/math.py``):
the polynomial design matrix and streaming Welford moments."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "WelfordState",
    "polyval",
    "vandermonde",
    "welford_init",
    "welford_mean",
    "welford_update",
    "welford_variance",
]


def vandermonde(x: torch.Tensor, n: int, dtype=None) -> torch.Tensor:
    """Vandermonde matrix ``V[i, j] = x_i ** j``, shape ``(len(x), n)``: the
    polynomial design matrix."""
    x = torch.as_tensor(x, dtype=dtype)
    powers = torch.arange(n, dtype=x.dtype, device=x.device)
    return x[:, None] ** powers[None, :]


def polyval(x: torch.Tensor, coefficients: torch.Tensor) -> torch.Tensor:
    """``sum_j c_j x**j`` at every x (``numpy.polynomial.polynomial.polyval``
    semantics), as one matrix product."""
    V = vandermonde(x, coefficients.shape[-1], dtype=coefficients.dtype)
    return V @ coefficients


class WelfordState(NamedTuple):
    """Streaming mean and sum of squared deviations of a tensor."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(template: torch.Tensor) -> WelfordState:
    return WelfordState(
        count=torch.zeros((), dtype=torch.float32, device=template.device),
        mean=torch.zeros_like(template),
        m2=torch.zeros_like(template),
    )


def welford_update(state: WelfordState, sample: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = sample - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (sample - mean)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_mean(state: WelfordState) -> torch.Tensor:
    return state.mean


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    """Sample variance; with ``regularize`` shrunk toward 1e-3 by 5/(n+5),
    Stan's mass-matrix regularisation (what the fused warmup harvests)."""
    n = state.count
    v = state.m2 / torch.clamp_min(n - 1.0, 1.0)
    if regularize:
        w = n / (n + 5.0)
        v = w * v + (1.0 - w) * 1e-3
    return v
