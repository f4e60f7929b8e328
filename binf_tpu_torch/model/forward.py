"""Forward models: parameters -> idealised ("mock") data (port of
``binf_tpu/model/forward.py``).

A forward model is a frozen dataclass called on a value dict; its
Jacobian comes from ``torch.func.jacfwd`` unless the model has an
analytic one.  Models: a linear map of a fixed design, a polynomial (its
Vandermonde matrix), any curve ``fn(x, values)`` written in PyTorch
(``ParametricCurveModel``) and the distances of selected bead pairs of a
3-D structure (``PairwiseDistanceModel``).
"""

from __future__ import annotations

from typing import Callable

import torch

from binf_tpu_torch.core.density import ValueDict, VariableSpec, as_value_dict
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.ops.math import vandermonde

__all__ = [
    "ForwardModel",
    "LinearForwardModel",
    "PairwiseDistanceModel",
    "ParametricCurveModel",
    "PolynomialForwardModel",
]


class ForwardModel:
    """Base forward model: named parameters -> mock data."""

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:  # pragma: no cover
        raise NotImplementedError

    @property
    def variables(self) -> tuple[str, ...]:
        return tuple(sorted(s.name for s in self.variable_specs))

    @property
    def differentiable_variables(self) -> tuple[str, ...]:
        return tuple(sorted(s.name for s in self.variable_specs if s.differentiable))

    def _evaluate(self, values: ValueDict) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, values=None, **kw) -> torch.Tensor:
        vals = as_value_dict(values, **kw)
        given, expect = set(vals), set(self.variables)
        if given != expect:
            raise ValueError(
                f"{type(self).__name__} expects variables {sorted(expect)}, "
                f"got {sorted(given)}"
            )
        return self._evaluate(vals)

    def jacobian(self, values=None, **kw) -> ValueDict:
        """d(mock data)/d(variable) for each differentiable variable, as
        ``{name: tensor of shape mock_shape + variable_shape}``."""
        vals = as_value_dict(values, **kw)
        diff = [v for v in self.differentiable_variables if v in vals]
        rest = {k: v for k, v in vals.items() if k not in diff}

        def f(dv: ValueDict) -> torch.Tensor:
            return self._evaluate({**rest, **dv})

        return torch.func.jacfwd(f)({k: vals[k] for k in diff})


@frozen_dataclass
class LinearForwardModel(ForwardModel):
    """mock = X @ theta for a fixed design matrix X (any basis expansion)."""

    design: torch.Tensor
    name: str = static_field(default="linear")
    variable: str = static_field(default="theta")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=(self.design.shape[-1],),
                             differentiable=True),)

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        return self.design @ values[self.variable]


@frozen_dataclass
class PolynomialForwardModel(ForwardModel):
    """Polynomial regression: mock_i = sum_j c_j x_i**j, one product with
    the Vandermonde matrix, which is also the analytic Jacobian."""

    vandermonde: torch.Tensor  # (n_points, n_coefficients)
    name: str = static_field(default="polynomial")
    variable: str = static_field(default="coefficients")

    @classmethod
    def create(cls, xses, n_coefficients: int, variable: str = "coefficients"):
        V = vandermonde(torch.as_tensor(xses, dtype=torch.float32), n_coefficients)
        return cls(vandermonde=V, variable=variable)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=(self.vandermonde.shape[-1],),
                             differentiable=True),)

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        return self.vandermonde @ values[self.variable]

    def jacobian(self, values=None, **kw) -> ValueDict:
        # d mock / d c = V, a constant
        return {self.variable: self.vandermonde}


@frozen_dataclass
class ParametricCurveModel(ForwardModel):
    """Any nonlinear curve ``mock_i = f(x_i; theta)``: ``fn(x, values) ->
    mock`` is a PyTorch function of the points and the value dict, and
    ``specs`` declares its variables."""

    x: torch.Tensor
    fn: Callable[[torch.Tensor, ValueDict], torch.Tensor] = static_field()
    specs: tuple[VariableSpec, ...] = static_field()
    name: str = static_field(default="curve")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return self.specs

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        return self.fn(self.x, values)


@frozen_dataclass
class PairwiseDistanceModel(ForwardModel):
    """Distance restraints of a 3-D structure: ``mock_k = || X[i_k] -
    X[j_k] ||`` for the selected pairs, from ``sqrt(max(sum d^2, 1e-12))``
    so that the gradient stays finite where two beads coincide."""

    n_beads: int = static_field()
    pairs_i: torch.Tensor = None  # (K,) int64
    pairs_j: torch.Tensor = None  # (K,) int64
    name: str = static_field(default="distances")
    variable: str = static_field(default="structure")

    @classmethod
    def create(cls, n_beads: int, pairs, variable: str = "structure"):
        pairs = torch.as_tensor(pairs, dtype=torch.int64)
        return cls(n_beads=n_beads, pairs_i=pairs[:, 0], pairs_j=pairs[:, 1], variable=variable)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec(self.variable, shape=(self.n_beads, 3), differentiable=True),)

    def _evaluate(self, values: ValueDict) -> torch.Tensor:
        X = values[self.variable]
        d = X[self.pairs_i] - X[self.pairs_j]
        return torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 1e-12))
