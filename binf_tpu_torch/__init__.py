"""binf_tpu_torch: the port of ``binf_tpu`` to PyTorch and CUDA on an
NVIDIA H100.

It mirrors the JAX package's layout, one module for each module of the
reference, and runs each TPU kernel as a hand-written CUDA kernel:

* ``core``, ``model``, ``pdf``: the model DSL (frozen dataclasses,
  named-variable densities, forward and error models, priors,
  likelihoods and posteriors), whose classes this package exports;
* ``example``: the polynomial workload (with its MAP draw and posterior
  predictive density), the chromatin structure posterior, and the
  logistic, AR(1) state-space, Gaussian mixture and hierarchical families;
* ``ops.kernels``: the fused whole-run kernels with their Philox
  generator (the Stan-window warmup with fixed or ChEES trajectories, the
  linear-regression sampler, the general sampler over a device density
  with functors for the linear regression, diagonal Gaussian, logistic,
  AR(1) and mixture posteriors, the collapsed Gibbs sampler, the
  chain-grid sampler, the quadratic leapfrog) and the pairwise restraint
  loss with its forces;
* ``samplers``: the user's routes to the kernels
  (``fused.fused_model_hmc`` with eager, dense or fused warmups, the
  router ``auto.adaptive_hmc``, ``chain_grid.chain_grid_model_hmc``,
  ``quadratic_hmc``) and the eager samplers: HMC with a diagonal or dense
  metric, ChEES-HMC, random-walk Metropolis, MALA, NUTS, elliptical and
  random-direction slice sampling, parallel tempering, Gibbs and
  conjugate blocks, with the Stan window, dense and ChEES warmups;
* ``parallel``: ``runner`` and the production driver (blocks,
  checkpoints, bitwise resume), with ``io``'s checkpoints, run
  configuration, metrics and guards;
* ``diagnostics``: split R-hat and ESS, which score a run.

Entry points run on the card unless given ``device="cpu"``, where they run
the kernels' plain PyTorch versions.  ``frozen_dataclass`` stands where the
reference exports ``pytree_dataclass``.
"""

from binf_tpu_torch.core import Density, ValueDict, VariableSpec, frozen_dataclass, static_field
from binf_tpu_torch.model import (
    ErrorModel,
    ForwardModel,
    GaussianErrorModel,
    PolynomialForwardModel,
)
from binf_tpu_torch.pdf import GammaPrior, GaussianPrior, Likelihood, Posterior, Prior

__version__ = "0.1.0"

__all__ = [
    "Density",
    "ValueDict",
    "VariableSpec",
    "frozen_dataclass",
    "static_field",
    "ErrorModel",
    "ForwardModel",
    "GaussianErrorModel",
    "PolynomialForwardModel",
    "GammaPrior",
    "GaussianPrior",
    "Likelihood",
    "Posterior",
    "Prior",
    "__version__",
]
