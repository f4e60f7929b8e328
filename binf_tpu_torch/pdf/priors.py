"""Priors: named-variable densities built on the distribution library (port
of ``binf_tpu/pdf/priors.py``).

A prior is a frozen dataclass over one named variable, with its
hyperparameters as tensor fields.  ``sample(generator)`` draws one value of
its free variables from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable

import torch

from binf_tpu_torch.core.density import Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.pdf import distributions as dist

__all__ = [
    "ExponentialPrior",
    "FunctionPrior",
    "GammaPrior",
    "GaussianPrior",
    "HalfNormalPrior",
    "Prior",
    "UniformPrior",
]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _draw(generator: torch.Generator, fn, shape, like: torch.Tensor) -> torch.Tensor:
    return fn(tuple(shape), generator=generator, device=generator.device).to(like.device)


class Prior(Density):
    """Marker base class of priors; priors can also draw one value of their
    free variables with ``sample(generator)``."""

    def sample(self, generator: torch.Generator) -> ValueDict:  # pragma: no cover
        raise NotImplementedError(f"{type(self).__name__} has no sampler")


@frozen_dataclass
class GammaPrior(Prior):
    """Gamma(shape, rate) prior over a positive scalar, fully normalised."""

    shape_param: torch.Tensor
    rate: torch.Tensor
    fixed: ValueDict
    variable: str = static_field(default="precision")
    name: str = static_field(default="gamma_prior")

    @classmethod
    def create(cls, shape, rate, variable: str = "precision", name: str | None = None):
        return cls(shape_param=_f32(shape), rate=_f32(rate), fixed={}, variable=variable,
                   name=name or f"{variable}_prior")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=(), differentiable=True),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return dist.gamma_log_prob(values[self.variable], self.shape_param, self.rate)

    def sample(self, generator: torch.Generator) -> ValueDict:
        draw = dist.gamma_sample(generator, self.shape_param, self.rate)
        return {self.variable: draw.to(self.shape_param.device)}


@frozen_dataclass
class GaussianPrior(Prior):
    """Independent Gaussian prior over a (vector) variable, one mean and
    variance per component, fully normalised."""

    means: torch.Tensor
    variances: torch.Tensor
    fixed: ValueDict
    variable: str = static_field(default="coefficients")
    name: str = static_field(default="gaussian_prior")

    @classmethod
    def create(cls, means, variances, variable: str = "coefficients",
               name: str | None = None):
        means = _f32(means)
        variances = torch.broadcast_to(_f32(variances).to(means.device), means.shape)
        return cls(means=means, variances=variances.contiguous(), fixed={},
                   variable=variable, name=name or f"{variable}_prior")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=tuple(self.means.shape),
                             differentiable=True),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        x = values[self.variable]
        return torch.sum(dist.normal_log_prob(x, self.means, torch.sqrt(self.variances)))

    def sample(self, generator: torch.Generator) -> ValueDict:
        eps = _draw(generator, torch.randn, self.means.shape, self.means)
        return {self.variable: self.means + torch.sqrt(self.variances) * eps}


@frozen_dataclass
class ExponentialPrior(Prior):
    rate: torch.Tensor
    fixed: ValueDict
    variable: str = static_field(default="rate")
    name: str = static_field(default="exponential_prior")

    @classmethod
    def create(cls, rate, variable: str, name: str | None = None):
        return cls(rate=_f32(rate), fixed={}, variable=variable,
                   name=name or f"{variable}_prior")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=(), differentiable=True),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return torch.sum(dist.exponential_log_prob(values[self.variable], self.rate))

    def sample(self, generator: torch.Generator) -> ValueDict:
        u = _draw(generator, torch.rand, (), self.rate)
        return {self.variable: -torch.log1p(-u) / self.rate}


@frozen_dataclass
class UniformPrior(Prior):
    low: torch.Tensor
    high: torch.Tensor
    fixed: ValueDict
    variable: str = static_field(default="x")
    var_shape: tuple[int, ...] = static_field(default=())
    name: str = static_field(default="uniform_prior")

    @classmethod
    def create(cls, low, high, variable: str, var_shape=(), name: str | None = None):
        return cls(low=_f32(low), high=_f32(high), fixed={}, variable=variable,
                   var_shape=tuple(var_shape), name=name or f"{variable}_prior")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=self.var_shape, differentiable=False),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return torch.sum(dist.uniform_log_prob(values[self.variable], self.low, self.high))

    def sample(self, generator: torch.Generator) -> ValueDict:
        u = _draw(generator, torch.rand, self.var_shape, self.low)
        return {self.variable: self.low + (self.high - self.low) * u}


@frozen_dataclass
class HalfNormalPrior(Prior):
    scale: torch.Tensor
    fixed: ValueDict
    variable: str = static_field(default="scale")
    name: str = static_field(default="halfnormal_prior")

    @classmethod
    def create(cls, scale, variable: str, name: str | None = None):
        return cls(scale=_f32(scale), fixed={}, variable=variable,
                   name=name or f"{variable}_prior")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=(), differentiable=True),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return torch.sum(dist.halfnormal_log_prob(values[self.variable], self.scale))

    def sample(self, generator: torch.Generator) -> ValueDict:
        z = _draw(generator, torch.randn, (), self.scale)
        return {self.variable: torch.abs(z) * self.scale}


@frozen_dataclass
class FunctionPrior(Prior):
    """Prior from any log density ``fn(values) -> scalar`` over the declared
    variables: the escape hatch for custom models."""

    fixed: ValueDict
    fn: Callable[[ValueDict], torch.Tensor] = static_field()
    specs: tuple[VariableSpec, ...] = static_field()
    name: str = static_field(default="function_prior")

    @classmethod
    def create(cls, fn, specs, name: str = "function_prior"):
        return cls(fixed={}, fn=fn, specs=tuple(specs), name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return self.specs

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return self.fn(values)
