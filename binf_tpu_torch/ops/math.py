"""Numerics utilities (port of ``binf_tpu/ops/math.py``): overflow-safe
exp and log, a stable log-sum-exp, the Lanczos ``lgamma`` and the A&S
``i0e`` polynomials, the polynomial design matrix, and streaming Welford
moments over a tensor or a dict of tensors."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from binf_tpu_torch.ops.tree import tree_map

__all__ = [
    "EXP_MAX",
    "EXP_MIN",
    "WelfordState",
    "i0e",
    "lgamma",
    "log_sum_exp",
    "polyval",
    "safe_exp",
    "safe_log",
    "vandermonde",
    "welford_init",
    "welford_mean",
    "welford_update",
    "welford_variance",
]

# clip range of safe_exp, inside float32's finite range
EXP_MAX = 80.0
EXP_MIN = -80.0


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with the argument clipped to avoid overflow to inf."""
    return torch.exp(torch.clamp(torch.as_tensor(x), EXP_MIN, EXP_MAX))


def safe_log(x: torch.Tensor, eps: float = 1e-38) -> torch.Tensor:
    """log with the argument floored to avoid -inf/nan on zeros."""
    return torch.log(torch.clamp_min(torch.as_tensor(x), eps))


def log_sum_exp(x: torch.Tensor, axis: int | None = None, keepdims: bool = False):
    """Numerically stable log(sum(exp(x))), over all elements when ``axis``
    is None."""
    x = torch.as_tensor(x)
    if axis is None:
        out = torch.logsumexp(x.reshape(-1), dim=0)
        return out.reshape((1,) * x.dim()) if keepdims else out
    return torch.logsumexp(x, dim=axis, keepdim=keepdims)


# Lanczos approximation (g=7, n=9), the polynomial the JAX package uses in
# place of its lgamma primitive; accurate to ~1e-6 relative in float32
_LANCZOS_G = 7.0
_LANCZOS_COEF = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)
_HALF_LOG_2PI = 0.9189385332046727


def lgamma(x) -> torch.Tensor:
    """log Gamma(x) for x > 0 in float32, with the reflection formula below
    0.5 (the same series as the JAX package, not ``torch.lgamma``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    small = x < 0.5
    z = torch.where(small, 1.0 - x, x) - 1.0
    series = torch.full_like(z, _LANCZOS_COEF[0])
    for i, c in enumerate(_LANCZOS_COEF[1:], start=1):
        series = series + c / (z + i)
    t = z + _LANCZOS_G + 0.5
    main = _HALF_LOG_2PI + (z + 0.5) * torch.log(t) - t + torch.log(series)
    sin_pix = torch.sin(math.pi * torch.where(small, x, 0.5))
    reflected = torch.log(math.pi / torch.clamp_min(torch.abs(sin_pix), 1e-30)) - main
    return torch.where(small, reflected, main)


def i0e(x) -> torch.Tensor:
    """exp(-|x|) I0(x) from the Abramowitz & Stegun 9.8.1 / 9.8.2
    polynomials (float32, ~1e-7 absolute), as the JAX package computes it."""
    ax = torch.abs(torch.as_tensor(x, dtype=torch.float32))
    t_small = (ax / 3.75) ** 2
    p_small = 1.0 + t_small * (3.5156229 + t_small * (3.0899424 + t_small * (
        1.2067492 + t_small * (0.2659732 + t_small * (0.0360768 + t_small * 0.0045813)))))
    small = p_small * torch.exp(-ax)
    t_big = 3.75 / torch.clamp_min(ax, 3.75)
    p_big = 0.39894228 + t_big * (0.01328592 + t_big * (0.00225319 + t_big * (
        -0.00157565 + t_big * (0.00916281 + t_big * (-0.02057706 + t_big * (
            0.02635537 + t_big * (-0.01647633 + t_big * 0.00392377)))))))
    big = p_big / torch.sqrt(torch.clamp_min(ax, 3.75))
    return torch.where(ax <= 3.75, small, big)


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
    """Streaming mean and sum of squared deviations of a tensor or a dict of
    tensors."""

    count: torch.Tensor
    mean: torch.Tensor | dict
    m2: torch.Tensor | dict


def welford_init(template) -> WelfordState:
    leaves = [template] if torch.is_tensor(template) else list(template.values())
    device = leaves[0].device if leaves else None
    return WelfordState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=tree_map(torch.zeros_like, template),
        m2=tree_map(torch.zeros_like, template),
    )


def welford_update(state: WelfordState, sample) -> WelfordState:
    count = state.count + 1.0
    delta = tree_map(lambda s, m: s - m, sample, state.mean)
    mean = tree_map(lambda m, d: m + d / count, state.mean, delta)
    m2 = tree_map(lambda a, d, s, m: a + d * (s - m), state.m2, delta, sample, mean)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_mean(state: WelfordState):
    return state.mean


def welford_variance(state: WelfordState, regularize: bool = True):
    """Sample variance; with ``regularize`` shrunk toward 1e-3 by 5/(n+5),
    Stan's mass-matrix regularisation (what the fused warmup harvests)."""
    n = state.count

    def var(m2):
        v = m2 / torch.clamp_min(n - 1.0, 1.0)
        if regularize:
            w = n / (n + 5.0)
            v = w * v + (1.0 - w) * 1e-3
        return v

    return tree_map(var, state.m2)
