"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions
(the counterpart of ``binf_tpu/ops/pallas``).  CUDA sources live in
``binf_tpu_torch/csrc`` and are compiled at first use (``_build``)."""

from binf_tpu_torch.ops.kernels._build import LAUNCHES, reset_launch_counts
from binf_tpu_torch.ops.kernels.chain_grid import (
    ChainGridResult,
    chain_grid_hmc_plain,
    chain_grid_hmc_run,
    chain_grid_potential_from_scalar,
    group_value_and_grad,
)
from binf_tpu_torch.ops.kernels.densities import (
    CallableDensity,
    DiagGaussianDensity,
    device_density,
)
from binf_tpu_torch.ops.kernels.fused_gibbs import (
    fused_linreg_gibbs_plain,
    fused_linreg_gibbs_run,
)
from binf_tpu_torch.ops.kernels.fused_hmc import (
    LinregDensity,
    fused_linreg_hmc_run,
    linreg_hmc_plain,
    linreg_unconstrained_logdensity,
)
from binf_tpu_torch.ops.kernels.fused_potential import (
    FusedRunResult,
    fused_potential_hmc_plain,
    fused_potential_hmc_run,
    fused_warmup_plain,
    fused_warmup_run,
    pack_positions,
    pack_template,
    unpack_draws,
)
from binf_tpu_torch.ops.kernels.leapfrog import quadratic_leapfrog, quadratic_leapfrog_reference
from binf_tpu_torch.ops.kernels.pairwise import (
    PairwiseRestraintLoss,
    pairwise_restraint_loss,
    pairwise_restraint_loss_pallas,
    pairwise_restraint_loss_reference,
)
from binf_tpu_torch.ops.kernels.prng import philox_bits, philox_noise

__all__ = [
    "CallableDensity",
    "ChainGridResult",
    "DiagGaussianDensity",
    "FusedRunResult",
    "LAUNCHES",
    "LinregDensity",
    "PairwiseRestraintLoss",
    "chain_grid_hmc_plain",
    "chain_grid_hmc_run",
    "chain_grid_potential_from_scalar",
    "device_density",
    "fused_linreg_gibbs_plain",
    "fused_linreg_gibbs_run",
    "fused_linreg_hmc_run",
    "fused_potential_hmc_plain",
    "fused_potential_hmc_run",
    "fused_warmup_plain",
    "fused_warmup_run",
    "group_value_and_grad",
    "linreg_hmc_plain",
    "linreg_unconstrained_logdensity",
    "pack_positions",
    "pack_template",
    "pairwise_restraint_loss",
    "pairwise_restraint_loss_pallas",
    "pairwise_restraint_loss_reference",
    "philox_bits",
    "philox_noise",
    "quadratic_leapfrog",
    "quadratic_leapfrog_reference",
    "reset_launch_counts",
    "unpack_draws",
]
