"""Derived variables: functional parameter binding (port of
``binf_tpu/pdf/parameters.py``).

:class:`Reparameterized` wraps a Density and computes some of its variables
from new ones at call time (``scale = precision ** -0.5``); its free set
swaps the derived names for their inputs, and ``torch.func.grad``
differentiates through the derivation.  This derives parameters of the
density; it is not a change of variables of the random variable (no
Jacobian): for that, see :mod:`binf_tpu_torch.pdf.transforms`.
"""

from __future__ import annotations

from typing import Callable

import torch

from binf_tpu_torch.core.density import Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field

__all__ = ["Derivation", "Reparameterized", "precision_from_scale", "scale_from_precision"]


@frozen_dataclass
class Derivation:
    """``target = fn(**{name: value for name in inputs})``."""

    target: str = static_field()
    inputs: tuple[str, ...] = static_field()
    fn: Callable[..., torch.Tensor] = static_field()
    input_specs: tuple[VariableSpec, ...] = static_field(default=())


def scale_from_precision(variable: str = "scale", source: str = "precision") -> Derivation:
    """scale = precision ** -0.5."""
    return Derivation(target=variable, inputs=(source,),
                      fn=lambda precision: precision ** -0.5,
                      input_specs=(VariableSpec(source, shape=(), differentiable=True),))


def precision_from_scale(variable: str = "precision", source: str = "scale") -> Derivation:
    """precision = scale ** -2."""
    return Derivation(target=variable, inputs=(source,),
                      fn=lambda scale: scale ** -2.0,
                      input_specs=(VariableSpec(source, shape=(), differentiable=True),))


@frozen_dataclass
class Reparameterized(Density):
    """A Density whose listed variables are computed from new variables."""

    base: Density
    fixed: ValueDict
    derivations: tuple[Derivation, ...] = static_field(default=())
    name: str = static_field(default="reparameterized")

    @classmethod
    def create(cls, base: Density, *derivations: Derivation, name: str | None = None):
        unknown = {d.target for d in derivations} - set(base.variables)
        if unknown:
            raise ValueError(
                f"derived target(s) {sorted(unknown)} are not free variables "
                f"of {type(base).__name__}"
            )
        return cls(base=base, fixed={}, derivations=tuple(derivations),
                   name=name or f"reparam_{getattr(base, 'name', 'density')}")

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        derived = {d.target for d in self.derivations}
        specs: dict[str, VariableSpec] = {}
        for s in self.base.variable_specs:
            if s.name not in derived and s.name in self.base.variables:
                specs[s.name] = s
        for d in self.derivations:
            for s in d.input_specs:
                specs.setdefault(s.name, s)
        return tuple(specs.values())

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        vals = dict(values)
        for d in self.derivations:
            vals[d.target] = d.fn(**{k: vals[k] for k in d.inputs})
        base_vals = {k: vals[k] for k in self.base.variables}
        return self.base._log_prob({**self.base.fixed, **base_vals})
