"""Bayesian logistic regression (port of ``binf_tpu/example/logistic.py``):
labels ``y_i ~ Bernoulli(sigmoid(x_i . w))`` through the generic
``LinearForwardModel`` and ``BernoulliErrorModel``, with an independent
Gaussian prior on the weights.  Every variable is unconstrained.

The builders take the data as numpy arrays or tensors, so the JAX package's
synthetic data builds the same posterior here; :func:`synthetic_logistic_data`
draws data of the same recipe from a ``torch.Generator`` (not the JAX
package's numbers).  On the card ``fused_model_hmc`` runs this posterior's
``log_prob`` through the ``LogisticDensity`` functor
(``ops/kernels/densities.py``).  Data and starts go to the card unless
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.model import BernoulliErrorModel, LinearForwardModel
from binf_tpu_torch.pdf import GaussianPrior, Likelihood, Posterior

__all__ = [
    "N_DATA_POINTS",
    "TRUE_WEIGHTS",
    "initial_positions",
    "make_logistic_posterior",
    "predict_proba",
    "synthetic_logistic_data",
]

TRUE_WEIGHTS = (1.5, -2.0, 0.75, 0.0, 1.0)  # the last but one is a null feature
N_DATA_POINTS = 200


def as_data(x, dev) -> torch.Tensor:
    """A numpy array or tensor as float32 on ``dev``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.array(x, np.float32))
    return x.to(dev, torch.float32)


def synthetic_logistic_data(generator: torch.Generator, n: int = N_DATA_POINTS, device=None):
    """A standardised design (the first column the intercept) and Bernoulli
    labels of ``TRUE_WEIGHTS``, drawn from ``generator``."""
    dev = resolve_device(device)
    d = len(TRUE_WEIGHTS)
    X = torch.randn((n, d - 1), generator=generator, device=generator.device).to(dev)
    X = torch.cat([torch.ones((n, 1), device=dev), X], dim=1)
    p = torch.sigmoid(X @ torch.tensor(TRUE_WEIGHTS, device=dev))
    u = torch.rand((n,), generator=generator, device=generator.device).to(dev)
    return X, (u < p).to(torch.float32)


def make_logistic_posterior(X, y, prior_variance: float = 4.0, device=None) -> Posterior:
    """The posterior of ``weights (d,)`` given the design ``X (n, d)`` and
    labels ``y (n,)``: N(0, prior_variance I) prior."""
    dev = resolve_device(device)
    X = as_data(X, dev)
    d = X.shape[1]
    lik = Likelihood.create("labels", LinearForwardModel(design=X, variable="weights"),
                            BernoulliErrorModel.create(as_data(y, dev)))
    prior = GaussianPrior.create(torch.zeros(d, device=dev),
                                 torch.full((d,), prior_variance, device=dev),
                                 variable="weights")
    return Posterior.create({"labels": lik}, {"weights_prior": prior})


def initial_positions(n_chains: int, generator: torch.Generator | None = None,
                      d: int = len(TRUE_WEIGHTS), device=None):
    """``weights = 0.1 z`` per chain, ``z`` standard normal from
    ``generator`` (seed 0 when None)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return {"weights": 0.1 * torch.randn((n_chains, d), generator=g, device=g.device).to(dev)}


def predict_proba(X_new, weight_draws: torch.Tensor) -> torch.Tensor:
    """Posterior-predictive P(y = 1 | x): the Bernoulli mean averaged over
    flat weight draws ``(draws, d)``."""
    X_new = as_data(X_new, weight_draws.device)
    return torch.sigmoid(weight_draws @ X_new.T).mean(dim=0)
