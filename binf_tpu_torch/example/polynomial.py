"""The polynomial-regression reference workload (port of the data and
model half of ``binf_tpu/example/polynomial.py``): a degree-3 polynomial
with unknown Gaussian noise precision.  Ground truth: coefficients
[2.0, -4.0, 1.0, 1.5], precision 2.5, 20 data points on [-2, 2].  Random
draws come from a ``torch.Generator`` where the JAX package takes a key.
The Gibbs kernels are not ported yet (ROADMAP section 1)."""

from __future__ import annotations

import math

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.model import GaussianErrorModel, PolynomialForwardModel
from binf_tpu_torch.ops.math import polyval
from binf_tpu_torch.pdf import GammaPrior, GaussianPrior, Likelihood, Posterior

__all__ = [
    "N_DATA_POINTS",
    "TRUE_COEFFICIENTS",
    "TRUE_PRECISION",
    "initial_positions",
    "make_data",
    "make_likelihood",
    "make_posterior",
    "make_priors",
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


def _tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def make_likelihood(xses, ys, n_coefficients: int = 4) -> Likelihood:
    """Polynomial forward model with a Gaussian error model on ``ys``
    (numpy arrays or tensors)."""
    fwm = PolynomialForwardModel.create(_tensor(xses), n_coefficients)
    em = GaussianErrorModel.create(_tensor(ys).to(fwm.vandermonde.device))
    return Likelihood.create("points", fwm, em)


def make_priors(n_coefficients: int = 4, device=None):
    """Gamma(1.0, 0.2) on the precision and N(0, 5 I) on the coefficients."""
    return {
        "precision_prior": GammaPrior.create(torch.tensor(1.0, device=device),
                                             torch.tensor(0.2, device=device),
                                             variable="precision"),
        "coefficients_prior": GaussianPrior.create(
            torch.zeros(n_coefficients, device=device),
            torch.full((n_coefficients,), 5.0, device=device),
            variable="coefficients",
        ),
    }


def make_posterior(xses, ys, n_coefficients: int = 4) -> Posterior:
    """The reference's posterior: the likelihood of ``make_likelihood`` and
    the priors of ``make_priors``, on the device of the data."""
    lik = make_likelihood(xses, ys, n_coefficients)
    dev = lik.forward_model.vandermonde.device
    return Posterior.create({"points": lik}, make_priors(n_coefficients, device=dev))


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
