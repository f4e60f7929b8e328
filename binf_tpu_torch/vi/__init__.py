"""Variational inference and its kin (port of ``binf_tpu/vi``): Pathfinder
(and its HMC initialisation), SVGD, the Laplace approximation and ADVI,
each an eager loop over the posterior's log density, on the card unless
``device="cpu"``."""

from binf_tpu_torch.vi.pathfinder import (
    PathfinderResult,
    pathfinder,
    pathfinder_init,
)
from binf_tpu_torch.vi.svgd import SVGDResult, svgd
from binf_tpu_torch.vi.laplace import (
    LaplaceResult,
    inverse_mass_from_laplace,
    laplace_approximation,
    laplace_sample,
)
from binf_tpu_torch.vi.advi import (
    ADVIResult,
    FullRankParams,
    MeanFieldParams,
    advi,
    variational_sample,
)

__all__ = [
    "PathfinderResult",
    "pathfinder",
    "pathfinder_init",
    "SVGDResult",
    "svgd",
    "LaplaceResult",
    "inverse_mass_from_laplace",
    "laplace_approximation",
    "laplace_sample",
    "ADVIResult",
    "FullRankParams",
    "MeanFieldParams",
    "advi",
    "variational_sample",
]
