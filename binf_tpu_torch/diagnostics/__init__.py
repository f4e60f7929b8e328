from binf_tpu_torch.diagnostics.model_comparison import (
    LOOResult,
    WAICResult,
    pointwise_log_likelihood,
    psis_loo,
    waic,
)
from binf_tpu_torch.diagnostics.rhat import (
    ess,
    ess_bulk,
    ess_tail,
    rhat,
    split_rhat,
    summary,
)

__all__ = [
    "LOOResult",
    "WAICResult",
    "ess",
    "ess_bulk",
    "ess_tail",
    "pointwise_log_likelihood",
    "psis_loo",
    "rhat",
    "split_rhat",
    "summary",
    "waic",
]
