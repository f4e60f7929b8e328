"""Samplers (port of ``binf_tpu/samplers``), every kernel stepping a whole
batch of chains: the kernel contract (``base``), HMC with a diagonal or a
dense metric (``hmc``), random-walk Metropolis (``rwm``), MALA
(``mala``), multinomial NUTS (``nuts``), elliptical and random-direction
slice sampling (``slice``), parallel tempering (``tempering``), the Gibbs
blocks (``gibbs``) and the exact conjugate blocks (``conjugate``); the
warmup adaptation (``adaptation``); dense-metric HMC and its warmup
(``dense``); ChEES-HMC (``chees``); the fused whole-run entry points
(``fused``); the router (``auto``); the chain-grid driver
(``chain_grid``); and HMC for quadratic potentials (``quadratic_hmc``).

The JAX package's names are exported here and imported at first use.  A
kernel builder named like its module (``hmc``, ``rwm``, ``mala``,
``nuts``, ``gibbs``, ``quadratic_hmc``) is reached through the module
(``samplers.nuts.nuts``): the package's attribute of that name is the
module, as code that imports the modules expects.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "auto": ("RoutingDecision", "adaptive_hmc", "route_algorithm", "route_trajectory_sampler"),
    "chain_grid": ("chain_grid_model_hmc",),
    "adaptation": ("DualAveragingState", "dual_averaging_init", "dual_averaging_step_size",
                   "dual_averaging_update", "find_reasonable_step_size", "window_adaptation"),
    "base": ("LogDensityFn", "Position", "SamplerKernel", "make_logdensity", "run_kernel",
             "sample_chain"),
    "chees": ("ChEESResult", "chees_adaptation", "chees_hmc"),
    "conjugate": ("gamma_precision_block", "gaussian_linear_block"),
    "gibbs": ("GibbsState", "direct_block", "hmc_block", "mala_block", "mh_block",
              "nuts_block"),
    "dense": ("DenseAdaptationResult", "DenseHMCState", "dense_hmc", "dense_window_adaptation"),
    "hmc": ("DenseMetric", "HMCInfo", "HMCState"),
    "mala": ("MALAInfo", "MALAState"),
    "nuts": ("NUTSInfo", "NUTSState"),
    "quadratic_hmc": ("QuadraticHMCState",),
    "rwm": ("RWMInfo", "RWMState"),
    "slice": ("EllipticalSliceInfo", "EllipticalSliceState", "SliceInfo", "SliceState",
              "elliptical_slice", "slice_sampler"),
    "tempering": ("PTInfo", "PTState", "geometric_betas", "parallel_tempering"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    globals()[name] = value
    return value
