from binf_tpu_torch.ops.math import (
    polyval,
    vandermonde,
    welford_init,
    welford_mean,
    welford_update,
    welford_variance,
)

__all__ = [
    "polyval",
    "vandermonde",
    "welford_init",
    "welford_mean",
    "welford_update",
    "welford_variance",
]
