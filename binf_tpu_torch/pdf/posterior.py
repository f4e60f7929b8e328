"""Posterior: the sum of its likelihoods' and priors' log densities (port
of ``binf_tpu/pdf/posterior.py``).

Each component receives exactly its own free variables; conditioning the
posterior conditions every component through the flat ``fixed`` dict.
Gradients are dicts of tensors from ``torch.func.grad``.
"""

from __future__ import annotations

import torch

from binf_tpu_torch.core.density import Density, ValueDict, VariableSpec, as_value_dict
from binf_tpu_torch.core.modules import frozen_dataclass, replace, static_field

__all__ = ["Posterior"]


@frozen_dataclass
class Posterior(Density):
    """Unnormalised posterior over the union of its components' variables."""

    likelihoods: dict[str, Density]
    priors: dict[str, Density]
    fixed: ValueDict
    name: str = static_field(default="posterior")

    @classmethod
    def create(cls, likelihoods: dict[str, Density], priors: dict[str, Density],
               name: str = "posterior"):
        return cls(likelihoods=dict(likelihoods), priors=dict(priors), fixed={}, name=name)

    @property
    def components(self) -> dict[str, Density]:
        return {**self.likelihoods, **self.priors}

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        specs: dict[str, VariableSpec] = {}
        for comp in self.components.values():
            for name in comp.variables:  # the component's free variables only
                if name not in specs:
                    specs[name] = comp.spec(name)
        return tuple(specs.values())

    @property
    def differentiable_variables(self) -> tuple[str, ...]:
        diff: set[str] = set()
        for comp in self.components.values():
            diff.update(comp.differentiable_variables)
        return tuple(v for v in self.variables if v in diff)

    def _component_values(self, comp: Density, values: ValueDict) -> ValueDict:
        """A complete posterior value dict restricted to one component's
        free variables."""
        return {k: values[k] for k in comp.variables}

    def _sum(self, comps, values: ValueDict) -> torch.Tensor:
        total = torch.zeros(())
        for comp in comps:
            total = total + comp._log_prob({**comp.fixed,
                                            **self._component_values(comp, values)})
        return total

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        return self._sum(self.components.values(), values)

    def component_log_probs(self, values=None, **kw) -> dict[str, torch.Tensor]:
        """Log density of each component (diagnostics, tempering)."""
        vals = self._complete_values(as_value_dict(values, **kw))
        return {name: comp._log_prob({**comp.fixed, **self._component_values(comp, vals)})
                for name, comp in self.components.items()}

    def tempered(self, beta) -> "Posterior":
        """This posterior with every likelihood raised to the power beta and
        the priors left as they are (the SMC tempering path)."""
        new_liks = {name: replace(lik, temper=beta) if hasattr(lik, "temper") else lik
                    for name, lik in self.likelihoods.items()}
        return replace(self, likelihoods=new_liks)

    def sample_prior(self, generator: torch.Generator) -> ValueDict:
        """One joint draw from all prior components; raises if a free
        variable has no prior with a sampler."""
        out: ValueDict = {}
        for prior in self.priors.values():
            out.update(prior.sample(generator))
        missing = set(self.variables) - set(out)
        if missing:
            raise ValueError(f"no prior sampler covers variable(s) {sorted(missing)}")
        return {k: v for k, v in out.items() if k in self.variables}

    def log_likelihood(self, values=None, **kw) -> torch.Tensor:
        """The sum of the likelihood components only (SMC weights)."""
        vals = self._complete_values(as_value_dict(values, **kw))
        return self._sum(self.likelihoods.values(), vals)
