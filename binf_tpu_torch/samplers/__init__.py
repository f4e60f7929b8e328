"""Samplers.  Ported so far: the kernel contract (``base``), ``hmc``,
``rwm``, the Gibbs blocks (``gibbs``) and the exact conjugate blocks
(``conjugate``), all stepping chain batches; the warmup adaptation
(``adaptation``: dual averaging, batched Welford, ``window_adaptation``,
``find_reasonable_step_size``); the fused whole-run entry point
``fused.fused_model_hmc`` (``warmup="xla"`` or ``"fused"``); the chain-grid
driver ``chain_grid.chain_grid_model_hmc``; HMC for quadratic potentials
(``quadratic_hmc``); and the Halton table of ``chees``."""
