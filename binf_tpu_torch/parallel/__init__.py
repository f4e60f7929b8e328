"""Multi-chain and multi-device execution: the runner (``init_chains``,
``run_chains``, ``warmup_and_run``), the production driver
(``run_blocks``, ``run_fused_blocks``: blocks, checkpoints, bitwise
resume), meshes on ``torch.distributed`` (``mesh.py``), explicit
collectives (``collectives.py``) and data-axis sharding
(``data_parallel.py``).  Every entry point that takes ``mesh=`` follows
the contract in ``mesh.py``'s docstring."""

from binf_tpu_torch.parallel.collectives import (
    distributed_systematic_indices,
    pmean_over_chains,
    take_along_chain,
)
from binf_tpu_torch.parallel.mesh import (
    CHAIN_AXIS,
    DATA_AXIS,
    HOST_AXIS,
    chain_sharding,
    gather_chains,
    initialize_distributed,
    make_chain_mesh,
    replicate,
    shard_chains,
)
from binf_tpu_torch.parallel.production import InferenceResult, run_blocks
from binf_tpu_torch.parallel.runner import init_chains, run_chains, warmup_and_run

__all__ = [
    "CHAIN_AXIS",
    "DATA_AXIS",
    "HOST_AXIS",
    "chain_sharding",
    "make_chain_mesh",
    "replicate",
    "shard_chains",
    "init_chains",
    "run_chains",
    "warmup_and_run",
    "distributed_systematic_indices",
    "pmean_over_chains",
    "take_along_chain",
    "InferenceResult",
    "run_blocks",
    "gather_chains",
    "initialize_distributed",
]
