from binf_tpu_torch.example import hierarchical, logistic, mixture, statespace
from binf_tpu_torch.example.hierarchical import (
    CountRateModel,
    HierarchicalPrior,
    LogisticCurvesModel,
    make_hierarchical_posterior,
    synthetic_hierarchical_data,
)
from binf_tpu_torch.example.logistic import make_logistic_posterior, synthetic_logistic_data
from binf_tpu_torch.example.mixture import (
    GaussianMixtureLikelihood,
    make_mixture_posterior,
    synthetic_mixture_data,
)
from binf_tpu_torch.example.polynomial import (
    N_DATA_POINTS,
    TRUE_COEFFICIENTS,
    TRUE_PRECISION,
    get_map,
    initial_positions,
    make_collapsed_gibbs_kernel,
    make_data,
    make_gibbs_kernel,
    make_likelihood,
    make_posterior,
    make_priors,
    predict,
)
from binf_tpu_torch.example.statespace import (
    AR1TrajectoryModel,
    make_ar1_posterior,
    synthetic_ar1_data,
)

__all__ = [
    "AR1TrajectoryModel",
    "CountRateModel",
    "GaussianMixtureLikelihood",
    "HierarchicalPrior",
    "LogisticCurvesModel",
    "N_DATA_POINTS",
    "TRUE_COEFFICIENTS",
    "TRUE_PRECISION",
    "get_map",
    "hierarchical",
    "initial_positions",
    "logistic",
    "make_ar1_posterior",
    "make_collapsed_gibbs_kernel",
    "make_data",
    "make_gibbs_kernel",
    "make_hierarchical_posterior",
    "make_likelihood",
    "make_logistic_posterior",
    "make_mixture_posterior",
    "make_posterior",
    "make_priors",
    "mixture",
    "predict",
    "statespace",
    "synthetic_ar1_data",
    "synthetic_hierarchical_data",
    "synthetic_logistic_data",
    "synthetic_mixture_data",
]
