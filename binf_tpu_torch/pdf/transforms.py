"""Bijective transforms to unconstrained space, with their log-Jacobians
(port of ``binf_tpu/pdf/transforms.py``).

``transform_logdensity(logdensity_fn, transforms)`` pulls a log density
back to unconstrained space: ``log p_u(u) = log p(f(u)) + log |df/du|``.
It returns a :class:`TransformedLogDensity`, a callable that keeps the log
density and its transforms, so that the fused samplers can recognise a
posterior of a family that has a CUDA functor
(``ops/kernels/densities.py::device_density``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from binf_tpu_torch.core.modules import frozen_dataclass, static_field

# the JAX package takes these two aliases from its samplers/base.py
Position = Any  # dict of named tensors
LogDensityFn = Callable[[Position], torch.Tensor]

__all__ = [
    "IdentityTransform",
    "LogDensityFn",
    "LogTransform",
    "Position",
    "SigmoidTransform",
    "SoftplusTransform",
    "Transform",
    "TransformedLogDensity",
    "constrain",
    "default_transforms",
    "transform_logdensity",
    "unconstrain",
]


class Transform(NamedTuple):
    """forward: unconstrained -> constrained; inverse: the reverse;
    log_det_jac(u): log |d forward / d u| summed over elements."""

    name: str
    forward: Callable[[torch.Tensor], torch.Tensor]
    inverse: Callable[[torch.Tensor], torch.Tensor]
    log_det_jac: Callable[[torch.Tensor], torch.Tensor]


IdentityTransform = Transform(
    "identity",
    lambda u: u,
    lambda x: x,
    lambda u: torch.zeros((), dtype=torch.float32),
)

# positive variables: x = exp(u)
LogTransform = Transform(
    "log",
    lambda u: torch.exp(u),
    lambda x: torch.log(torch.as_tensor(x)),
    lambda u: torch.sum(u),
)

# positive variables with softer tails: x = softplus(u)
SoftplusTransform = Transform(
    "softplus",
    lambda u: F.softplus(u),
    lambda x: x + torch.log(-torch.expm1(-x)),
    lambda u: torch.sum(-F.softplus(-u)),
)


def SigmoidTransform(low: float = 0.0, high: float = 1.0) -> Transform:
    """Variables on (low, high): x = low + (high - low) sigmoid(u)."""
    width = high - low

    def forward(u):
        return low + width * torch.sigmoid(u)

    def inverse(x):
        p = (x - low) / width
        return torch.log(p) - torch.log1p(-p)

    def log_det_jac(u):
        return torch.sum(math.log(width) - F.softplus(-u) - F.softplus(u))

    return Transform("sigmoid", forward, inverse, log_det_jac)


def constrain(transforms: dict[str, Transform], u: Position) -> Position:
    return {k: (transforms[k].forward(v) if k in transforms else v) for k, v in u.items()}


def unconstrain(transforms: dict[str, Transform], x: Position) -> Position:
    return {k: (transforms[k].inverse(v) if k in transforms else v) for k, v in x.items()}


@frozen_dataclass
class TransformedLogDensity:
    """``logdensity_fn`` pulled back to unconstrained space by
    ``transforms``; calling it on an unconstrained position dict gives the
    log density there."""

    logdensity_fn: LogDensityFn = static_field()
    transforms: dict[str, Transform] = static_field()

    def __call__(self, u: Position) -> torch.Tensor:
        x = constrain(self.transforms, u)
        ldj = torch.zeros(())
        for k, t in self.transforms.items():
            if k in u:
                ldj = ldj + t.log_det_jac(u[k])
        return self.logdensity_fn(x) + ldj


def transform_logdensity(logdensity_fn: LogDensityFn,
                         transforms: dict[str, Transform]) -> TransformedLogDensity:
    """Pull a log density back to unconstrained space."""
    return TransformedLogDensity(logdensity_fn=logdensity_fn, transforms=dict(transforms))


_POSITIVE_NAMES = ("precision", "scale", "rate", "sigma", "variance", "tau")


def default_transforms(density) -> dict[str, Transform]:
    """Per-variable transforms by name: positive-looking names get a log
    transform; names already in log or unconstrained space get none."""
    out: dict[str, Transform] = {}
    for name in density.variables:
        if name.startswith("log_") or name.startswith("unconstrained_"):
            continue
        if name in _POSITIVE_NAMES or any(
                name.endswith("_" + p) or name.startswith(p + "_") for p in _POSITIVE_NAMES):
            out[name] = LogTransform
    return out
