"""A sequential forward model, AR(1) dynamics (port of
``binf_tpu/example/statespace.py``): the mock data is the deterministic
trajectory

    x_t = phi x_{t-1} + drift,   x_0 given,   mock = (x_0 ... x_{T-1})

with ``phi = tanh(phi_raw)``, so every output depends on the whole
parameter history.  The JAX package's ``lax.scan`` is a loop over the
``num_steps`` steps here, on ``dynamics`` of shape ``(..., 3)``.

The builder takes the observations as a numpy array or a tensor, so the
JAX package's synthetic data builds the same posterior here;
:func:`synthetic_ar1_data` draws data of the same recipe from a
``torch.Generator``.  On the card ``fused_model_hmc`` runs
``transform_logdensity(posterior.log_prob, {"precision": LogTransform})``
through the ``AR1Density`` functor (``ops/kernels/densities.py``).  Data
and starts go to the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.core.density import ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.example.logistic import as_data
from binf_tpu_torch.model.error import GaussianErrorModel
from binf_tpu_torch.model.forward import ForwardModel
from binf_tpu_torch.pdf import GammaPrior, GaussianPrior, Likelihood, Posterior

__all__ = [
    "AR1TrajectoryModel",
    "N_TIMESTEPS",
    "TRUE_DYNAMICS",
    "TRUE_PRECISION",
    "initial_positions",
    "make_ar1_posterior",
    "synthetic_ar1_data",
]

# (phi_raw, drift, x0): phi = tanh(0.9) ~= 0.716
TRUE_DYNAMICS = (0.9, 0.5, -1.0)
TRUE_PRECISION = 25.0
N_TIMESTEPS = 64


@frozen_dataclass
class AR1TrajectoryModel(ForwardModel):
    """mock_t = x_t with x_t = tanh(phi_raw) x_{t-1} + drift."""

    num_steps: int = static_field(default=N_TIMESTEPS)
    name: str = static_field(default="ar1_trajectory")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec("dynamics", shape=(3,), differentiable=True),)

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        dyn = values["dynamics"]
        phi, drift, x = torch.tanh(dyn[..., 0]), dyn[..., 1], dyn[..., 2]
        xs = []
        for _ in range(self.num_steps):
            xs.append(x)
            x = phi * x + drift
        return torch.stack(xs, dim=-1)


def synthetic_ar1_data(generator: torch.Generator, num_steps: int = N_TIMESTEPS, device=None):
    """Noisy observations of the true trajectory, noise drawn from
    ``generator``."""
    dev = resolve_device(device)
    traj = AR1TrajectoryModel(num_steps=num_steps)(
        dynamics=torch.tensor(TRUE_DYNAMICS, device=dev))
    noise = torch.randn((num_steps,), generator=generator, device=generator.device).to(dev)
    return traj + noise / math.sqrt(TRUE_PRECISION)


def make_ar1_posterior(y, device=None) -> Posterior:
    """dynamics ~ N(0, 4 I); precision ~ Gamma(2, 0.1); Gaussian errors on
    the observations ``y (T,)``."""
    dev = resolve_device(device)
    y = as_data(y, dev)
    lik = Likelihood.create("trajectory", AR1TrajectoryModel(num_steps=int(y.shape[0])),
                            GaussianErrorModel.create(y))
    priors = {
        "dynamics_prior": GaussianPrior.create(torch.zeros(3, device=dev),
                                               torch.full((3,), 4.0, device=dev),
                                               variable="dynamics"),
        "precision_prior": GammaPrior.create(torch.tensor(2.0, device=dev),
                                             torch.tensor(0.1, device=dev),
                                             variable="precision"),
    }
    return Posterior.create({"trajectory": lik}, priors)


def initial_positions(n_chains: int, generator: torch.Generator | None = None, device=None):
    """``dynamics = 0.1 z``, ``precision = exp(0.1 z')`` per chain, from
    ``generator`` (seed 0 when None); the precision is constrained."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=g, device=g.device).to(dev)

    return {"dynamics": 0.1 * normal((n_chains, 3)),
            "precision": torch.exp(0.1 * normal((n_chains,)))}
