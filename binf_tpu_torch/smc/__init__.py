"""Sequential Monte Carlo (port of ``binf_tpu/smc``): adaptive tempered SMC
and the particle resamplers."""

from binf_tpu_torch.smc.resampling import (
    effective_sample_size,
    multinomial_resample,
    stratified_resample,
    systematic_resample,
)
from binf_tpu_torch.smc.smc import SMCResult, tempered_smc

__all__ = [
    "SMCResult",
    "effective_sample_size",
    "multinomial_resample",
    "stratified_resample",
    "systematic_resample",
    "tempered_smc",
]
