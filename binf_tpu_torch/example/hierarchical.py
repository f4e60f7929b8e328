"""A hierarchical nonlinear model with Gaussian and Poisson observation
channels (port of ``binf_tpu/example/hierarchical.py``):

* G groups with parameters theta_g = (log_amplitude_g, rate_g);
* a logistic curve per group, f(x; theta_g) = exp(la_g) sigmoid(rate_g x),
  seen at n points with iid Gaussian noise of a shared precision;
* a count per group through a Poisson channel of log rate la_g + offset, a
  second likelihood sharing ``group_params``;
* partial pooling: theta_g ~ N(mu, diag(tau^2)), mu ~ N(0, 2^2),
  log_tau ~ N(-1, 1).

Free variables: group_params (G, 2), mu (2,), log_tau (2,), precision ().
At 8 groups (the CLI's model) the state has D = 21 coordinates and a CUDA
functor (``csrc/hierarchical_density.cuh``, recognised under ``{"precision":
LogTransform}`` by ``ops/kernels/densities.py``): the router
(``samplers/auto.py``) sends it to the fused kernels K3 and K4.  At other
group counts it has none and runs on the eager samplers
(``samplers/hmc.py``, ``samplers/nuts.py``).
:func:`make_hierarchical_posterior` takes the JAX package's synthetic
data as numpy arrays; :func:`synthetic_hierarchical_data` draws data of
the same recipe, every value from the ``torch.Generator`` it is handed.
Data go to the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.core.density import ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.example.logistic import as_data
from binf_tpu_torch.model.error import GaussianErrorModel, PoissonErrorModel
from binf_tpu_torch.model.forward import ForwardModel
from binf_tpu_torch.pdf import GammaPrior, Likelihood, Posterior
from binf_tpu_torch.pdf import distributions as dist
from binf_tpu_torch.pdf.priors import Prior

__all__ = [
    "COUNT_OFFSET",
    "CountRateModel",
    "HierarchicalPrior",
    "LogisticCurvesModel",
    "TRUE_MU",
    "TRUE_PRECISION",
    "TRUE_TAU",
    "make_hierarchical_posterior",
    "synthetic_hierarchical_data",
]

TRUE_MU = (0.8, 1.2)  # (log_amplitude, rate)
TRUE_TAU = (0.3, 0.25)
TRUE_PRECISION = 25.0
COUNT_OFFSET = 2.0


def _group_spec(n_groups: int) -> VariableSpec:
    return VariableSpec("group_params", shape=(n_groups, 2), differentiable=True)


@frozen_dataclass
class LogisticCurvesModel(ForwardModel):
    """mock[g, i] = exp(la_g) sigmoid(rate_g x_i), flattened to (G n,)."""

    x: torch.Tensor  # (n,)
    n_groups: int = static_field()
    name: str = static_field(default="logistic_curves")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (_group_spec(self.n_groups),)

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        gp = values["group_params"]  # (..., G, 2)
        amp = torch.exp(gp[..., 0])[..., None]
        curves = amp * torch.sigmoid(gp[..., 1][..., None] * self.x)
        return curves.reshape(curves.shape[:-2] + (-1,))


@frozen_dataclass
class CountRateModel(ForwardModel):
    """The Poisson log rate of each group: offset + log_amplitude_g."""

    offset: torch.Tensor
    n_groups: int = static_field()
    name: str = static_field(default="count_rates")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (_group_spec(self.n_groups),)

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        return self.offset + values["group_params"][..., 0]


@frozen_dataclass
class HierarchicalPrior(Prior):
    """Partial pooling: theta_g ~ N(mu, diag(exp(log_tau)^2)),
    mu ~ N(0, 2^2), log_tau ~ N(-1, 1)."""

    fixed: ValueDict
    n_groups: int = static_field()
    name: str = static_field(default="hierarchy")

    @classmethod
    def create(cls, n_groups: int):
        return cls(fixed={}, n_groups=n_groups)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (_group_spec(self.n_groups),
                VariableSpec("mu", shape=(2,), differentiable=True),
                VariableSpec("log_tau", shape=(2,), differentiable=True))

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        gp, mu, log_tau = values["group_params"], values["mu"], values["log_tau"]
        tau = torch.exp(log_tau)
        pooled = torch.sum(dist.normal_log_prob(gp, mu[None, :], tau[None, :]))
        hyper_mu = torch.sum(dist.normal_log_prob(mu, 0.0, 2.0))
        hyper_tau = torch.sum(dist.normal_log_prob(log_tau, -1.0, 1.0))
        return pooled + hyper_mu + hyper_tau

    def sample(self, generator: torch.Generator) -> ValueDict:
        def normal(shape):
            return torch.randn(shape, generator=generator, device=generator.device)

        mu = 2.0 * normal((2,))
        log_tau = -1.0 + normal((2,))
        gp = mu[None, :] + torch.exp(log_tau)[None, :] * normal((self.n_groups, 2))
        return {"group_params": gp, "mu": mu, "log_tau": log_tau}


def synthetic_hierarchical_data(generator: torch.Generator, n_groups: int = 8,
                                n_points: int = 15, device=None):
    """Ground truth and observations drawn from ``generator``: ``(x, y
    (G n,), counts (G,), true group params)``."""
    dev = resolve_device(device)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=generator.device).to(dev)

    x = torch.linspace(-3.0, 3.0, n_points, device=dev)
    gp = (torch.tensor(TRUE_MU, device=dev)
          + torch.tensor(TRUE_TAU, device=dev) * normal((n_groups, 2)))
    curves = torch.exp(gp[:, 0])[:, None] * torch.sigmoid(gp[:, 1][:, None] * x[None, :])
    y = curves.reshape(-1) + normal((n_groups * n_points,)) / math.sqrt(TRUE_PRECISION)
    rates = torch.exp(COUNT_OFFSET + gp[:, 0])
    counts = torch.poisson(rates.to(generator.device), generator=generator).to(dev)
    return x, y, counts, gp


def make_hierarchical_posterior(x, y, counts, n_groups: int, device=None) -> Posterior:
    """The posterior of the curves ``y (G n,)`` at points ``x (n,)`` and the
    ``counts (G,)``, with a Gamma(2, 0.1) prior on the precision."""
    dev = resolve_device(device)
    x, y, counts = (as_data(a, dev) for a in (x, y, counts))
    gauss = Likelihood.create("curves", LogisticCurvesModel(x=x, n_groups=n_groups),
                              GaussianErrorModel.create(y, full_normalization=True))
    poisson = Likelihood.create(
        "counts", CountRateModel(offset=torch.tensor(COUNT_OFFSET, device=dev),
                                 n_groups=n_groups),
        PoissonErrorModel.create(counts, log_link=True))
    priors = {"hierarchy": HierarchicalPrior.create(n_groups),
              "precision_prior": GammaPrior.create(torch.tensor(2.0, device=dev),
                                                   torch.tensor(0.1, device=dev),
                                                   variable="precision")}
    return Posterior.create({"curves": gauss, "counts": poisson}, priors)
