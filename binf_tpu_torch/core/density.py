"""Core model DSL: densities over named variables, with conditioning (port
of ``binf_tpu/core/density.py``).

A :class:`Density` is an immutable dataclass.  Its free variables are named
by its variable specs minus the ones it is conditioned on; ``log_prob`` is
a function ``dict[str, Tensor] -> scalar``; ``fix`` /
``conditional_factory`` return a new density with fewer free variables and
the fixed values stored in it.  Gradients come from ``torch.func.grad``.

Value dicts are strict: a call must give exactly the free variables, no
more and no fewer.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from binf_tpu_torch.core.modules import frozen_dataclass, replace, static_field

ValueDict = dict[str, torch.Tensor]

__all__ = ["MOCK_DATA", "Density", "ValueDict", "VariableSpec", "as_value_dict"]

# the variable linking a forward model's output to its error model
MOCK_DATA = "mock_data"


@frozen_dataclass
class VariableSpec:
    """Static description of a named model variable: shape, dtype and
    whether gradients flow to it."""

    name: str = static_field()
    shape: tuple[int, ...] = static_field(default=())
    dtype: Any = static_field(default=torch.float32)
    differentiable: bool = static_field(default=True)


def as_value_dict(values: Mapping[str, Any] | None = None, **kw: Any) -> ValueDict:
    """Normalize (mapping, kwargs) into a dict of tensors."""
    out: dict[str, Any] = {}
    if values:
        out.update(values)
    out.update(kw)
    return {k: torch.as_tensor(v) for k, v in out.items()}


class Density:
    """Base class of priors, likelihoods and posteriors.

    Concrete subclasses are frozen dataclasses that declare
    ``variable_specs`` (every original variable), a ``fixed`` dict field
    (the values conditioned on) and ``_log_prob(values)`` over all original
    variables.
    """

    # -- structure ------------------------------------------------------------

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:  # pragma: no cover
        raise NotImplementedError

    @property
    def variable_names(self) -> tuple[str, ...]:
        """All original variables, fixed or not (sorted)."""
        return tuple(sorted(s.name for s in self.variable_specs))

    @property
    def variables(self) -> tuple[str, ...]:
        """Free (not fixed) variables, sorted by name."""
        fixed = self.fixed
        return tuple(v for v in self.variable_names if v not in fixed)

    @property
    def differentiable_variables(self) -> tuple[str, ...]:
        diff = {s.name for s in self.variable_specs if s.differentiable}
        return tuple(v for v in self.variables if v in diff)

    def spec(self, name: str) -> VariableSpec:
        for s in self.variable_specs:
            if s.name == name:
                return s
        raise KeyError(name)

    # -- values ---------------------------------------------------------------

    def _complete_values(self, values: ValueDict) -> ValueDict:
        """The free-variable values given, merged with the fixed ones; the
        values must cover exactly the free variables."""
        free = set(self.variables)
        given = set(values)
        if given != free:
            raise ValueError(
                f"{type(self).__name__}: value dict must cover exactly the free "
                f"variables {sorted(free)}; missing={sorted(free - given)}, "
                f"unexpected={sorted(given - free)}"
            )
        return {**self.fixed, **values}

    # -- evaluation -------------------------------------------------------------

    def _log_prob(self, values: ValueDict) -> torch.Tensor:  # pragma: no cover
        """Density math over a complete value dict (all original variables)."""
        raise NotImplementedError

    def log_prob(self, values: Mapping[str, Any] | None = None, **kw: Any) -> torch.Tensor:
        """Log density at the given free-variable values."""
        vals = as_value_dict(values, **kw)
        return self._log_prob(self._complete_values(vals))

    def __call__(self, values: Mapping[str, Any] | None = None, **kw: Any) -> torch.Tensor:
        """Probability density: exp of :meth:`log_prob`."""
        return torch.exp(self.log_prob(values, **kw))

    def _split_differentiable(self, vals: ValueDict):
        diff_names = [v for v in self.differentiable_variables if v in vals]
        rest = {k: v for k, v in vals.items() if k not in diff_names}

        def f(dv: ValueDict) -> torch.Tensor:
            return self.log_prob({**rest, **dv})

        return f, {k: vals[k] for k in diff_names}

    def gradient(self, values: Mapping[str, Any] | None = None, **kw: Any) -> ValueDict:
        """Gradient of ``log_prob`` with respect to the differentiable free
        variables, as a dict keyed by name (``torch.func.grad``)."""
        f, dv = self._split_differentiable(as_value_dict(values, **kw))
        return torch.func.grad(f)(dv)

    def value_and_gradient(
        self, values: Mapping[str, Any] | None = None, **kw: Any
    ) -> tuple[torch.Tensor, ValueDict]:
        f, dv = self._split_differentiable(as_value_dict(values, **kw))
        grad, value = torch.func.grad_and_value(f)(dv)
        return value, grad

    # -- conditioning -----------------------------------------------------------

    def fix(self, values: Mapping[str, Any] | None = None, **kw: Any) -> "Density":
        """Condition on the given variables, returning a new density whose
        free set no longer holds them."""
        vals = as_value_dict(values, **kw)
        unknown = set(vals) - set(self.variables)
        if unknown:
            raise ValueError(
                f"{type(self).__name__}: cannot fix non-free variable(s) "
                f"{sorted(unknown)}; free variables are {list(self.variables)}"
            )
        return replace(self, fixed={**self.fixed, **vals})

    def conditional_factory(self, values: Mapping[str, Any] | None = None,
                            **kw: Any) -> "Density":
        """Alias of :meth:`fix`, the reference's name."""
        return self.fix(values, **kw)

    def update_fixed(self, values: Mapping[str, Any] | None = None, **kw: Any) -> "Density":
        """Replace the values of already-fixed variables (same free set)."""
        vals = as_value_dict(values, **kw)
        unknown = set(vals) - set(self.fixed)
        if unknown:
            raise ValueError(f"not fixed: {sorted(unknown)}")
        return replace(self, fixed={**self.fixed, **vals})

    def set_fixed_from(self, other: "Density") -> "Density":
        """Fix this density's free variables at the other's fixed values,
        where it has them."""
        known = set(self.variables)
        return self.fix({k: v for k, v in other.fixed.items() if k in known})

    # -- misc -------------------------------------------------------------------

    def init_values(self, generator: torch.Generator | None = None) -> ValueDict:
        """Zero value dict for the free variables, with the shapes and dtypes
        of their specs."""
        return {name: torch.zeros(self.spec(name).shape, dtype=self.spec(name).dtype)
                for name in self.variables}
