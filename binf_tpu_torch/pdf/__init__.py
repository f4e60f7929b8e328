from binf_tpu_torch.pdf import distributions
from binf_tpu_torch.pdf.likelihood import Likelihood
from binf_tpu_torch.pdf.posterior import Posterior
from binf_tpu_torch.pdf.priors import (
    ExponentialPrior,
    FunctionPrior,
    GammaPrior,
    GaussianPrior,
    HalfNormalPrior,
    Prior,
    UniformPrior,
)

__all__ = [
    "ExponentialPrior",
    "FunctionPrior",
    "GammaPrior",
    "GaussianPrior",
    "HalfNormalPrior",
    "Likelihood",
    "Posterior",
    "Prior",
    "UniformPrior",
    "distributions",
]
