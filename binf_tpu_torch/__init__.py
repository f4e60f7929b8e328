"""binf_tpu_torch: the port of ``binf_tpu`` to PyTorch and CUDA on an
NVIDIA H100.

It mirrors the JAX package's layout, one module for each module of the
reference, and runs each TPU kernel as a hand-written CUDA kernel.  So far
it holds the main path of the headline benchmark: the polynomial data
(``example``), the fused Stan-window warmup and fused linear-regression HMC
kernels with their Philox generator (``ops.kernels``), and the diagnostics
that score a run (``diagnostics``).  Entry points run on the card unless
given ``device="cpu"``, where they run the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
