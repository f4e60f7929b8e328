"""Particle resampling schemes: systematic, stratified and multinomial
(port of ``binf_tpu/smc/resampling.py``).

Each is O(N): normalised weights, their cumulative sum, and a sorted
search of grid points against it.  Each draws its uniforms from an
explicit ``torch.Generator`` on the weights' device.
"""

from __future__ import annotations

import torch

__all__ = [
    "effective_sample_size",
    "multinomial_resample",
    "stratified_resample",
    "systematic_resample",
]


def effective_sample_size(log_weights: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """ESS = (sum w)^2 / sum w^2 from unnormalised log weights."""
    lw = log_weights - torch.logsumexp(log_weights, dim=axis, keepdim=True)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=axis))


def _resample_indices(cum_weights: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """For each position the first index whose cumulative weight reaches
    it (``searchsorted``, side left), held below N: where rounding leaves
    the last cumulative weight under a position, the JAX package's gather
    clamps the same index."""
    idx = torch.searchsorted(cum_weights.contiguous(), positions.contiguous(), right=False)
    return torch.clamp_max(idx, cum_weights.shape[0] - 1)


def _cdf(log_weights: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)


def _uniform(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def systematic_resample(generator: torch.Generator, log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic (low-variance) resampling: one uniform offset, N evenly
    spaced points through the CDF.  Returns ancestor indices (N,)."""
    n = log_weights.shape[0]
    u = _uniform(generator, (), log_weights)
    positions = (torch.arange(n, dtype=log_weights.dtype, device=log_weights.device) + u) / n
    return _resample_indices(_cdf(log_weights), positions)


def stratified_resample(generator: torch.Generator, log_weights: torch.Tensor) -> torch.Tensor:
    """One uniform in each stratum [i/N, (i+1)/N)."""
    n = log_weights.shape[0]
    u = _uniform(generator, (n,), log_weights)
    positions = (torch.arange(n, dtype=log_weights.dtype, device=log_weights.device) + u) / n
    return _resample_indices(_cdf(log_weights), positions)


def multinomial_resample(generator: torch.Generator, log_weights: torch.Tensor) -> torch.Tensor:
    """N independent draws from the categorical of the weights."""
    n = log_weights.shape[0]
    return torch.multinomial(torch.softmax(log_weights, dim=0), n, replacement=True,
                             generator=generator)


RESAMPLERS = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
}
