from binf_tpu_torch.diagnostics.rhat import (
    ess,
    ess_bulk,
    ess_tail,
    rhat,
    split_rhat,
    summary,
)

__all__ = [
    "ess",
    "ess_bulk",
    "ess_tail",
    "rhat",
    "split_rhat",
    "summary",
]
