"""binf_tpu_torch: the port of ``binf_tpu`` to PyTorch and CUDA on an
NVIDIA H100.

It mirrors the JAX package's layout, one module for each module of the
reference, and runs each TPU kernel as a hand-written CUDA kernel.  So far
it holds the model DSL (``core``, ``model``, ``pdf``) and the polynomial
and chromatin workloads built with it (``example``); the fused whole-run
kernels with their Philox generator (``ops.kernels``): the Stan-window
warmup with fixed or ChEES trajectories, the linear-regression sampler,
the general sampler over a device density, the collapsed Gibbs sampler, the
chain-grid sampler and the quadratic leapfrog, and the pairwise restraint
loss with its forces; the user's routes to them,
``samplers.fused.fused_model_hmc`` (with eager, dense or fused warmups),
the router ``samplers.auto.adaptive_hmc``, ``samplers.chain_grid.
chain_grid_model_hmc`` and ``samplers.quadratic_hmc``; the eager samplers
(HMC with a diagonal or dense metric, ChEES-HMC, random-walk Metropolis,
Gibbs and conjugate blocks) with the Stan window, dense and ChEES warmups
and ``parallel.runner``; the production driver
(``parallel.production``: blocks, checkpoints, bitwise resume) with its
checkpoints, run configuration, metrics and guards (``io``); and the
diagnostics that score a run (``diagnostics``).  Entry points run on the
card unless given ``device="cpu"``, where they run the kernels' plain
PyTorch versions.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
