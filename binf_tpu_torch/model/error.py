"""Error models: p(observed data | mock data, noise parameters) (port of
``binf_tpu/model/error.py``).

An error model is a Density over the distinguished ``mock_data`` variable
plus its noise parameters, with the observed data as a field.  Families:
Gaussian (by precision), Student-t, Laplace, Poisson, Bernoulli and
log-normal.
"""

from __future__ import annotations

import math

import torch

from binf_tpu_torch.core.density import MOCK_DATA, Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.pdf import distributions as dist

__all__ = [
    "MOCK_DATA",
    "BernoulliErrorModel",
    "ErrorModel",
    "GaussianErrorModel",
    "LaplaceErrorModel",
    "LogNormalErrorModel",
    "PoissonErrorModel",
    "StudentTErrorModel",
]


def _data(data) -> torch.Tensor:
    return torch.as_tensor(data, dtype=torch.float32)


class ErrorModel(Density):
    """Marker base: a Density whose variables include ``mock_data``.
    Concrete subclasses hold the observed data in a ``data`` field."""

    @property
    def n_data(self) -> int:
        return int(self.data.shape[0])

    def _data_spec(self) -> VariableSpec:
        return VariableSpec(MOCK_DATA, shape=tuple(self.data.shape), differentiable=True)


@frozen_dataclass
class GaussianErrorModel(ErrorModel):
    """iid Gaussian noise by precision:

        log p = -0.5 prec sum((mock - y)^2) + (n/2) log prec  [- (n/2) log 2 pi]

    the bracket only with ``full_normalization``."""

    data: torch.Tensor
    fixed: ValueDict
    full_normalization: bool = static_field(default=False)
    name: str = static_field(default="gaussian_error")

    @classmethod
    def create(cls, data, full_normalization: bool = False, name: str = "gaussian_error"):
        return cls(data=_data(data), fixed={}, full_normalization=full_normalization,
                   name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (self._data_spec(), VariableSpec("precision", shape=(), differentiable=True))

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        mock, prec = values[MOCK_DATA], values["precision"]
        n = self.data.shape[0]
        resid = mock - self.data
        lp = -0.5 * prec * torch.sum(resid * resid) + 0.5 * n * torch.log(prec)
        if self.full_normalization:
            lp = lp - 0.5 * n * math.log(2.0 * math.pi)
        return lp


@frozen_dataclass
class StudentTErrorModel(ErrorModel):
    """iid Student-t noise (robust regression); variables: mock_data, scale."""

    data: torch.Tensor
    fixed: ValueDict
    df: float = static_field(default=4.0)
    name: str = static_field(default="student_t_error")

    @classmethod
    def create(cls, data, df: float = 4.0, name: str = "student_t_error"):
        return cls(data=_data(data), fixed={}, df=df, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (self._data_spec(), VariableSpec("scale", shape=(), differentiable=True))

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        mock, scale = values[MOCK_DATA], values["scale"]
        return torch.sum(dist.student_t_log_prob(self.data, self.df, mock, scale))


@frozen_dataclass
class LaplaceErrorModel(ErrorModel):
    """iid Laplace noise; variables: mock_data, scale."""

    data: torch.Tensor
    fixed: ValueDict
    name: str = static_field(default="laplace_error")

    @classmethod
    def create(cls, data, name: str = "laplace_error"):
        return cls(data=_data(data), fixed={}, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (self._data_spec(), VariableSpec("scale", shape=(), differentiable=True))

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        mock, scale = values[MOCK_DATA], values["scale"]
        return torch.sum(dist.laplace_log_prob(self.data, mock, scale))


@frozen_dataclass
class PoissonErrorModel(ErrorModel):
    """Poisson counts with rate = mock_data, or exp(mock_data) with
    ``log_link``; no noise variables."""

    data: torch.Tensor
    fixed: ValueDict
    log_link: bool = static_field(default=False)
    name: str = static_field(default="poisson_error")

    @classmethod
    def create(cls, data, log_link: bool = False, name: str = "poisson_error"):
        return cls(data=_data(data), fixed={}, log_link=log_link, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (self._data_spec(),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        mock = values[MOCK_DATA]
        rate = torch.exp(mock) if self.log_link else torch.clamp_min(mock, 1e-10)
        return torch.sum(dist.poisson_log_prob(self.data, rate))


@frozen_dataclass
class BernoulliErrorModel(ErrorModel):
    """Bernoulli observations with logits = mock_data:
    log p = sum_i [y_i eta_i - log(1 + exp(eta_i))], through softplus."""

    data: torch.Tensor  # 0/1 labels, float32
    fixed: ValueDict
    name: str = static_field(default="bernoulli_error")

    @classmethod
    def create(cls, data, name: str = "bernoulli_error"):
        return cls(data=_data(data), fixed={}, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (self._data_spec(),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return torch.sum(dist.bernoulli_log_prob(self.data, values[MOCK_DATA]))


@frozen_dataclass
class LogNormalErrorModel(ErrorModel):
    """Log-normal noise on positive data: log y ~ N(log mock, 1/precision);
    variables: mock_data, precision."""

    data: torch.Tensor
    fixed: ValueDict
    name: str = static_field(default="lognormal_error")

    @classmethod
    def create(cls, data, name: str = "lognormal_error"):
        return cls(data=_data(data), fixed={}, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (self._data_spec(), VariableSpec("precision", shape=(), differentiable=True))

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        mock, prec = values[MOCK_DATA], values["precision"]
        n = self.data.shape[0]
        resid = torch.log(self.data) - torch.log(torch.clamp_min(mock, 1e-12))
        return -0.5 * prec * torch.sum(resid * resid) + 0.5 * n * torch.log(prec)
