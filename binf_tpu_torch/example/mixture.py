"""A finite Gaussian mixture (port of ``binf_tpu/example/mixture.py``):
the log likelihood is a per-point log-sum-exp over components, and the
component means are sorted inside the density, the usual constraint
against label switching.

The mixture is a direct ``Density``, not a forward/error composition: the
observation density itself is multimodal.  The builder takes the data as a
numpy array or a tensor, so the JAX package's synthetic data builds the
same posterior here; :func:`synthetic_mixture_data` draws data of the same
recipe from a ``torch.Generator``.  On the card ``fused_model_hmc`` runs
``make_mixture_posterior(y, 3).log_prob`` through the ``MixtureDensity``
functor (``ops/kernels/densities.py``).  Data and starts go to the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.core.density import Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.example.logistic import as_data
from binf_tpu_torch.pdf import GaussianPrior, Posterior

__all__ = [
    "GaussianMixtureLikelihood",
    "N_DATA_POINTS",
    "TRUE_MEANS",
    "TRUE_SIGMA",
    "TRUE_WEIGHTS",
    "classify",
    "initial_positions",
    "make_mixture_posterior",
    "synthetic_mixture_data",
]

TRUE_MEANS = (-2.0, 0.5, 3.0)
TRUE_WEIGHTS = (0.3, 0.45, 0.25)
TRUE_SIGMA = 0.6
N_DATA_POINTS = 240


@frozen_dataclass
class GaussianMixtureLikelihood(Density):
    """sum_i log sum_k w_k N(y_i | sort(means)_k, sigma^2), without the
    ``-log(2 pi)/2`` of each point.

    Variables: ``means (K,)``, sorted inside the density;
    ``log_weights (K,)``, normalised by log-sum-exp, so unconstrained;
    ``log_sigma ()``, the shared scale."""

    data: torch.Tensor  # (n,)
    fixed: ValueDict
    n_components: int = static_field(default=3)
    name: str = static_field(default="mixture")

    @classmethod
    def create(cls, data, n_components: int = 3, name: str = "mixture"):
        return cls(data=torch.as_tensor(data, dtype=torch.float32), fixed={},
                   n_components=n_components, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        k = self.n_components
        return (VariableSpec("means", shape=(k,), differentiable=True),
                VariableSpec("log_weights", shape=(k,), differentiable=True),
                VariableSpec("log_sigma", shape=(), differentiable=True))

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        mus = torch.sort(values["means"], dim=-1).values
        logw = values["log_weights"]
        logw = logw - torch.logsumexp(logw, dim=-1, keepdim=True)
        log_sigma = values["log_sigma"]
        inv_var = torch.exp(-2.0 * log_sigma)[..., None, None]
        d = self.data[:, None] - mus[..., None, :]
        comp = -0.5 * inv_var * d * d - log_sigma[..., None, None] + logw[..., None, :]
        return torch.logsumexp(comp, dim=-1).sum(-1)


def synthetic_mixture_data(generator: torch.Generator, n: int = N_DATA_POINTS, device=None):
    """``n`` points of the true mixture, drawn from ``generator``."""
    dev = resolve_device(device)
    u = torch.rand((n,), generator=generator, device=generator.device).to(dev)
    z = torch.searchsorted(torch.cumsum(torch.tensor(TRUE_WEIGHTS, device=dev), 0), u)
    z = torch.clamp_max(z, len(TRUE_MEANS) - 1)
    e = torch.randn((n,), generator=generator, device=generator.device).to(dev)
    return torch.tensor(TRUE_MEANS, device=dev)[z] + TRUE_SIGMA * e


def make_mixture_posterior(y, n_components: int = 3, device=None) -> Posterior:
    """The mixture likelihood of ``y (n,)`` with priors means ~ N(0, 25),
    log_weights ~ N(0, 1), log_sigma ~ N(0, 1)."""
    dev = resolve_device(device)
    k = n_components
    priors = {
        "means_prior": GaussianPrior.create(torch.zeros(k, device=dev),
                                            torch.full((k,), 25.0, device=dev),
                                            variable="means"),
        "log_weights_prior": GaussianPrior.create(torch.zeros(k, device=dev),
                                                  torch.ones(k, device=dev),
                                                  variable="log_weights"),
        "log_sigma_prior": GaussianPrior.create(torch.zeros((), device=dev),
                                                torch.ones((), device=dev),
                                                variable="log_sigma"),
    }
    lik = GaussianMixtureLikelihood.create(as_data(y, dev), k)
    return Posterior.create({"mixture": lik}, priors)


def initial_positions(n_chains: int, n_components: int = 3,
                      generator: torch.Generator | None = None, device=None):
    """Means spread over [-1, 1] plus 0.5 z, log-weights and log-sigma
    0.1 z, per chain, from ``generator`` (seed 0 when None)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=g, device=g.device).to(dev)

    spread = torch.linspace(-1.0, 1.0, n_components, device=dev)
    return {"means": spread + 0.5 * normal((n_chains, n_components)),
            "log_weights": 0.1 * normal((n_chains, n_components)),
            "log_sigma": 0.1 * normal((n_chains,))}


def classify(y_new, samples: dict) -> torch.Tensor:
    """Hard labels of ``y_new`` by the argmax of the posterior-mean
    responsibilities over flat draws; labels index the sorted means."""
    mus = torch.sort(samples["means"], dim=-1).values  # (S, K)
    y_new = as_data(y_new, mus.device)
    logw = samples["log_weights"]
    logw = logw - torch.logsumexp(logw, dim=-1, keepdim=True)
    inv_var = torch.exp(-2.0 * samples["log_sigma"])
    d = y_new[None, :, None] - mus[:, None, :]
    comp = -0.5 * inv_var[:, None, None] * d * d + logw[:, None, :]
    return torch.softmax(comp, dim=-1).mean(dim=0).argmax(dim=-1)
