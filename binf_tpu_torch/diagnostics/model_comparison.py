"""Predictive model comparison: WAIC and PSIS-LOO (port of
``binf_tpu/diagnostics/model_comparison.py``).

Both criteria work from a matrix of pointwise log-likelihoods
``log p(y_i | theta_s)`` of shape (draws, n_data):

* **WAIC** (Watanabe): elpd = sum_i [log mean_s exp(ll) - var_s(ll)];
* **PSIS-LOO** (Vehtari et al. 2017): leave-one-out by importance sampling
  with truncated weights, and a Pareto tail-shape diagnostic per datum.

The arithmetic is float32 on the draws' device, batched over the data
axis where the JAX package maps a function over it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from binf_tpu_torch.ops.math import log_sum_exp

__all__ = ["LOOResult", "WAICResult", "pointwise_log_likelihood", "psis_loo", "waic"]


def pointwise_log_likelihood(likelihood, samples: dict) -> torch.Tensor:
    """(draws, n_data) pointwise log-likelihoods of a Likelihood at flat
    posterior draws ``samples`` (each ``(draws, ...)``).  Implemented for
    the Gaussian error model (by precision, fully normalised per datum),
    the one the JAX package implements."""
    from binf_tpu_torch.model.error import GaussianErrorModel

    em, fwm = likelihood.error_model, likelihood.forward_model
    if not isinstance(em, GaussianErrorModel):
        raise NotImplementedError(f"pointwise log-lik not implemented for {type(em).__name__}")
    y = em.data

    def one(draw):
        mock = fwm._evaluate({k: draw[k] for k in fwm.variables})
        prec = draw["precision"]
        return (-0.5 * prec * (mock - y) ** 2 + 0.5 * torch.log(prec)
                - 0.5 * math.log(2.0 * math.pi))

    return torch.func.vmap(one)(samples)


class WAICResult(NamedTuple):
    elpd: torch.Tensor  # expected log pointwise predictive density
    p_eff: torch.Tensor  # effective number of parameters
    waic: torch.Tensor  # -2 elpd (deviance scale)
    elpd_i: torch.Tensor  # per-datum contributions


def waic(ll: torch.Tensor) -> WAICResult:
    """WAIC from ``ll`` (draws, n_data) pointwise log-likelihoods."""
    ll = torch.as_tensor(ll)
    lpd_i = log_sum_exp(ll, axis=0) - math.log(float(ll.shape[0]))
    p_i = torch.var(ll, dim=0, unbiased=True)
    elpd_i = lpd_i - p_i
    elpd = elpd_i.sum()
    return WAICResult(elpd=elpd, p_eff=p_i.sum(), waic=-2.0 * elpd, elpd_i=elpd_i)


class LOOResult(NamedTuple):
    elpd: torch.Tensor
    elpd_i: torch.Tensor
    pareto_k: torch.Tensor  # per-datum tail-shape diagnostic (k < 0.7 is good)


def _fit_pareto_k(x: torch.Tensor) -> torch.Tensor:
    """Tail-shape estimate from the largest fifth (at least 5) of the raw
    weights ``x`` (draws, ...), per trailing index: a method-of-moments fit
    of the generalised Pareto shape, adequate as a diagnostic."""
    m = x.shape[0]
    tail = torch.sort(x, dim=0).values[-max(m // 5, 5):]
    exc = tail - tail[:1] + 1e-12
    mean = exc.mean(dim=0)
    var = ((exc - mean) ** 2).mean(dim=0) + 1e-12
    return 0.5 * (1.0 - mean * mean / var)


def psis_loo(ll: torch.Tensor) -> LOOResult:
    """PSIS-LOO from ``ll`` (draws, n_data): importance ratios 1 / p(y_i |
    theta_s) truncated at S^(3/4) times their mean (Vehtari et al.'s
    truncation), and each datum's Pareto k of the raw ratios."""
    ll = torch.as_tensor(ll)
    s = ll.shape[0]
    log_r = -ll
    log_r = log_r - log_r.max(dim=0, keepdim=True).values
    r = torch.exp(log_r)
    bound = (float(s) ** 0.75) * r.mean(dim=0, keepdim=True)
    log_w = torch.log(torch.minimum(r, bound))
    elpd_i = log_sum_exp(ll + log_w, axis=0) - log_sum_exp(log_w, axis=0)
    return LOOResult(elpd=elpd_i.sum(), elpd_i=elpd_i, pareto_k=_fit_pareto_k(r))
