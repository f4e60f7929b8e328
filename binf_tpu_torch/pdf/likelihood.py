"""Likelihood = error model composed with a forward model (port of
``binf_tpu/pdf/likelihood.py``).

The likelihood's variables are the union of the forward model's and the
error model's, less ``mock_data``; values are routed to each submodel by
name and the log density is ``em.log_prob(mock_data=fwm(theta), ...)``.
Gradients run through the composition with ``torch.func.grad``.
"""

from __future__ import annotations

from typing import Any

import torch

from binf_tpu_torch.core.density import MOCK_DATA, Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field

__all__ = ["Likelihood"]


@frozen_dataclass
class Likelihood(Density):
    """p(data | variables) = error_model(mock_data=forward_model(vars), ...)."""

    forward_model: Any
    error_model: Any
    fixed: ValueDict
    name: str = static_field(default="likelihood")
    # weight on the log-likelihood (SMC tempering, data annealing)
    temper: float | torch.Tensor = 1.0

    @classmethod
    def create(cls, name: str, forward_model, error_model):
        return cls(forward_model=forward_model, error_model=error_model, fixed={}, name=name)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        # the union less mock_data and less what the error model already fixes
        em_fixed = set(self.error_model.fixed)
        specs: dict[str, VariableSpec] = {}
        for s in self.forward_model.variable_specs:
            specs[s.name] = s
        for s in self.error_model.variable_specs:
            if s.name != MOCK_DATA and s.name not in specs and s.name not in em_fixed:
                specs[s.name] = s
        return tuple(specs.values())

    def _split_values(self, values: ValueDict) -> tuple[ValueDict, ValueDict]:
        """Route a complete value dict to the (forward-model, error-model)
        parts; a name both submodels know goes to both."""
        fwm_names = set(self.forward_model.variables)
        em_names = set(self.error_model.variables) - {MOCK_DATA}
        fwm_vals = {k: v for k, v in values.items() if k in fwm_names}
        em_vals = {k: v for k, v in values.items() if k in em_names}
        return fwm_vals, em_vals

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        fwm_vals, em_vals = self._split_values(values)
        mock = self.forward_model._evaluate(fwm_vals)
        em_all = {**self.error_model.fixed, **em_vals, MOCK_DATA: mock}
        return self.temper * self.error_model._log_prob(em_all)
