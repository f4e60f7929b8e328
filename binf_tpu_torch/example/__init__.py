from binf_tpu_torch.example.polynomial import (
    N_DATA_POINTS,
    TRUE_COEFFICIENTS,
    TRUE_PRECISION,
    initial_positions,
    make_collapsed_gibbs_kernel,
    make_data,
    make_gibbs_kernel,
    make_likelihood,
    make_posterior,
    make_priors,
)

__all__ = [
    "N_DATA_POINTS",
    "TRUE_COEFFICIENTS",
    "TRUE_PRECISION",
    "initial_positions",
    "make_collapsed_gibbs_kernel",
    "make_data",
    "make_gibbs_kernel",
    "make_likelihood",
    "make_posterior",
    "make_priors",
]
