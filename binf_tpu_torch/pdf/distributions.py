"""Distribution library: log densities and samplers as plain functions
(port of ``binf_tpu/pdf/distributions.py``).

Every ``*_log_prob`` is elementwise unless it says otherwise, fully
normalised, float32 by default, and built from the same formulas as the JAX
package, with the package's own ``lgamma`` and ``i0e`` polynomials
(``ops/math.py``).  Samplers take a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from binf_tpu_torch.ops.math import i0e, lgamma

__all__ = [
    "bernoulli_log_prob",
    "beta_log_prob",
    "binomial_log_prob",
    "categorical_log_prob",
    "cauchy_log_prob",
    "dirichlet_log_prob",
    "exponential_log_prob",
    "gamma_log_prob",
    "gamma_sample",
    "halfnormal_log_prob",
    "inverse_gamma_log_prob",
    "laplace_log_prob",
    "lognormal_log_prob",
    "mv_normal_diag_log_prob",
    "mv_normal_full_log_prob",
    "negative_binomial_log_prob",
    "normal_log_prob",
    "normal_sample",
    "poisson_log_prob",
    "student_t_log_prob",
    "truncated_normal_log_prob",
    "uniform_log_prob",
    "von_mises_log_prob",
    "weibull_log_prob",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _t(x, like=None) -> torch.Tensor:
    """``x`` as a tensor; a Python number takes ``like``'s dtype and device."""
    if torch.is_tensor(x):
        return x
    if like is not None and torch.is_tensor(like):
        return torch.as_tensor(x, dtype=like.dtype if like.is_floating_point()
                               else torch.float32, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32)


# -- Gaussian family ------------------------------------------------------------


def normal_log_prob(x, loc=0.0, scale=1.0) -> torch.Tensor:
    """Elementwise N(loc, scale^2) log-density (not summed)."""
    x = _t(x)
    scale = _t(scale, x)
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)


def normal_sample(generator: torch.Generator, shape, loc=0.0, scale=1.0) -> torch.Tensor:
    z = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return loc + scale * z


def halfnormal_log_prob(x, scale=1.0) -> torch.Tensor:
    x = _t(x)
    z = x / scale
    lp = math.log(2.0) - 0.5 * _LOG_2PI - torch.log(_t(scale, x)) - 0.5 * z * z
    return torch.where(x >= 0, lp, -math.inf)


def mv_normal_diag_log_prob(x, loc, scale_diag) -> torch.Tensor:
    """Multivariate normal with diagonal covariance; sums over the last axis."""
    return torch.sum(normal_log_prob(x, loc, scale_diag), dim=-1)


def mv_normal_full_log_prob(x, loc, cov_chol) -> torch.Tensor:
    """Multivariate normal with covariance L L^T, given its Cholesky factor
    L: one triangular solve and a reduction."""
    x = _t(x)
    d = x.shape[-1]
    diff = x - loc
    chol_b = torch.broadcast_to(cov_chol, diff.shape[:-1] + cov_chol.shape[-2:])
    z = torch.linalg.solve_triangular(chol_b, diff[..., None], upper=False)[..., 0]
    half_logdet = torch.sum(torch.log(torch.diagonal(cov_chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(z * z, dim=-1) - half_logdet - 0.5 * d * _LOG_2PI


# -- Gamma family ---------------------------------------------------------------


def gamma_log_prob(x, concentration, rate=1.0) -> torch.Tensor:
    """Gamma(shape=concentration, rate) log-density, fully normalised."""
    x = _t(x)
    a = _t(concentration, x).to(x.dtype)
    b = _t(rate, x).to(x.dtype)
    lp = (a - 1.0) * torch.log(x) - b * x + a * torch.log(b) - lgamma(a)
    return torch.where(x > 0, lp, -math.inf)


def _standard_gamma(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws by Marsaglia & Tsang (2000), redrawing the
    rejected entries until every one is accepted; alpha < 1 is boosted by
    a uniform power.  Draws on ``alpha``'s device, whose generator
    ``generator`` must be."""
    dev = alpha.device
    if generator.device.type != dev.type or (
            dev.type == "cuda" and generator.device.index not in (None, dev.index)):
        raise ValueError(f"a generator on {generator.device} cannot draw on {dev}")
    alpha = alpha.to(torch.float32)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a.shape, generator=generator, device=dev)
        u = torch.rand(a.shape, generator=generator, device=dev)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=generator, device=dev)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def gamma_sample(generator: torch.Generator, concentration, rate=1.0, shape=()) -> torch.Tensor:
    """Gamma(concentration, rate) draws of ``shape`` (default: the
    concentration's) on the concentration's device; a Python number lies
    on the generator's device."""
    conc = (concentration if torch.is_tensor(concentration) else
            torch.as_tensor(concentration, dtype=torch.float32, device=generator.device))
    alpha = torch.broadcast_to(conc, tuple(shape) or conc.shape)
    return _standard_gamma(generator, alpha.contiguous()) / rate


def inverse_gamma_log_prob(x, concentration, scale) -> torch.Tensor:
    x = _t(x)
    a, b = _t(concentration, x), _t(scale, x)
    lp = a * torch.log(b) - lgamma(a) - (a + 1.0) * torch.log(x) - b / x
    return torch.where(x > 0, lp, -math.inf)


def exponential_log_prob(x, rate=1.0) -> torch.Tensor:
    x = _t(x)
    rate = _t(rate, x)
    lp = torch.log(rate) - rate * x
    return torch.where(x >= 0, lp, -math.inf)


# -- bounded and heavy-tailed -----------------------------------------------------


def uniform_log_prob(x, low=0.0, high=1.0) -> torch.Tensor:
    x = _t(x)
    low, high = _t(low, x), _t(high, x)
    inside = (x >= low) & (x <= high)
    return torch.where(inside, -torch.log(high - low), -math.inf)


def beta_log_prob(x, a, b) -> torch.Tensor:
    x = _t(x)
    a, b = _t(a, x), _t(b, x)
    lp = ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
          + lgamma(a + b) - lgamma(a) - lgamma(b))
    return torch.where((x > 0) & (x < 1), lp, -math.inf)


def laplace_log_prob(x, loc=0.0, scale=1.0) -> torch.Tensor:
    x = _t(x)
    scale = _t(scale, x)
    return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)


def student_t_log_prob(x, df, loc=0.0, scale=1.0) -> torch.Tensor:
    x = _t(x)
    df, scale = _t(df, x), _t(scale, x)
    z = (x - loc) / scale
    half = 0.5 * (df + 1.0)
    return (lgamma(half) - lgamma(0.5 * df) - 0.5 * torch.log(df * math.pi)
            - torch.log(scale) - half * torch.log1p(z * z / df))


def cauchy_log_prob(x, loc=0.0, scale=1.0) -> torch.Tensor:
    x = _t(x)
    z = (x - loc) / scale
    return -torch.log(math.pi * scale * (1.0 + z * z))


def lognormal_log_prob(x, loc=0.0, scale=1.0) -> torch.Tensor:
    x = _t(x)
    logx = torch.log(x)
    lp = normal_log_prob(logx, loc, scale) - logx
    return torch.where(x > 0, lp, -math.inf)


# -- discrete ---------------------------------------------------------------------


def poisson_log_prob(k, rate) -> torch.Tensor:
    rate = _t(rate)
    k = _t(k, rate).to(rate.dtype)
    return k * torch.log(rate) - rate - lgamma(k + 1.0)


def bernoulli_log_prob(x, logits) -> torch.Tensor:
    """x in {0, 1}; logits = log(p / (1 - p)), through the stable softplus."""
    logits = _t(logits)
    x = _t(x, logits).to(logits.dtype)
    return x * logits - F.softplus(logits)


def binomial_log_prob(k, n, logits) -> torch.Tensor:
    """k successes in n trials, success log-odds = logits."""
    logits = _t(logits)
    k = _t(k, logits).to(logits.dtype)
    n = _t(n, logits).to(logits.dtype)
    log_comb = lgamma(n + 1.0) - lgamma(k + 1.0) - lgamma(n - k + 1.0)
    return log_comb + k * logits - n * F.softplus(logits)


def negative_binomial_log_prob(k, total_count, logits) -> torch.Tensor:
    """Failures k before ``total_count`` successes; logits = log-odds of the
    failure probability."""
    logits = _t(logits)
    k = _t(k, logits).to(logits.dtype)
    r = _t(total_count, logits).to(logits.dtype)
    log_comb = lgamma(k + r) - lgamma(k + 1.0) - lgamma(r)
    return log_comb + k * logits - (k + r) * F.softplus(logits)


def categorical_log_prob(k, logits) -> torch.Tensor:
    """Index k in [0, C) with unnormalised logits (..., C); k's batch
    dimensions broadcast against the logits' batch dimensions."""
    logits = _t(logits)
    k = _t(k).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    logits_b = torch.broadcast_to(logits, k.shape + logits.shape[-1:])
    gathered = torch.gather(logits_b, -1, k[..., None])[..., 0]
    return gathered - logz


def dirichlet_log_prob(x, concentration) -> torch.Tensor:
    """x on the simplex, summed over the last axis."""
    x = _t(x)
    a = _t(concentration, x)
    norm = lgamma(torch.sum(a, dim=-1)) - torch.sum(lgamma(a), dim=-1)
    lp = torch.sum((a - 1.0) * torch.log(x), dim=-1) + norm
    return torch.where((x > 0).all(dim=-1), lp, -math.inf)


def weibull_log_prob(x, concentration, scale) -> torch.Tensor:
    x = _t(x)
    k, lam = _t(concentration, x), _t(scale, x)
    z = x / lam
    lp = torch.log(k / lam) + (k - 1.0) * torch.log(z) - z ** k
    return torch.where(x > 0, lp, -math.inf)


def von_mises_log_prob(x, loc, concentration) -> torch.Tensor:
    """Angle x in radians; normalised with log I0(kappa)."""
    x = _t(x)
    kappa = _t(concentration, x)
    log_i0 = torch.log(i0e(kappa)) + kappa
    return kappa * torch.cos(x - loc) - math.log(2.0 * math.pi) - log_i0


def truncated_normal_log_prob(x, loc, scale, low, high) -> torch.Tensor:
    x = _t(x)
    loc, scale, low, high = (_t(v, x) for v in (loc, scale, low, high))
    zl = (low - loc) / scale
    zh = (high - loc) / scale
    log_norm = torch.log(torch.special.ndtr(zh) - torch.special.ndtr(zl))
    lp = normal_log_prob(x, loc, scale) - log_norm
    return torch.where((x >= low) & (x <= high), lp, -math.inf)
