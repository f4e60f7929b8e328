"""Samplers.  Ported so far: the kernel contract (``base``), ``hmc`` (with
a diagonal or a dense metric, ``hmc.DenseMetric``), ``rwm``, the Gibbs
blocks (``gibbs``) and the exact conjugate blocks (``conjugate``), all
stepping chain batches; the warmup adaptation (``adaptation``: dual
averaging, batched Welford, ``window_adaptation``,
``find_reasonable_step_size``); dense-metric HMC and its window warmup
(``dense``: ``flatten_spec``, ``dense_hmc``, ``dense_window_adaptation``);
ChEES-HMC (``chees``: ``leapfrog_dynamic``, ``chees_adaptation``,
``chees_hmc``, the Halton table); the fused whole-run entry point
``fused.fused_model_hmc`` (``warmup="xla"``, ``"dense"`` or ``"fused"``,
fixed or ChEES trajectories) and ``fused.fused_regression_hmc``; the
router ``auto.adaptive_hmc`` / ``auto.route_algorithm``; the chain-grid
driver ``chain_grid.chain_grid_model_hmc``; and HMC for quadratic
potentials (``quadratic_hmc``)."""
