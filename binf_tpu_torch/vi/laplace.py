"""Laplace approximation: the MAP and the Gaussian of the curvature there
(port of ``binf_tpu/vi/laplace.py``).

The MAP is found in unconstrained space with Adam (the JAX package's
``optax.adam``, in its order of operations) and polished by five damped
Newton steps; the posterior covariance is the inverse Hessian of
``-log p`` at the mode, ``torch.func.hessian`` over the flat position (in
``samplers/dense.py::flatten_spec``'s order, the reference's
``ravel_pytree`` order).  The result seeds HMC mass matrices
(:func:`inverse_mass_from_laplace`) and gives the Laplace estimate of the
log evidence.

The reference runs the Adam steps as one ``lax.scan``; here they are an
eager loop, on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.pdf.transforms import (
    Position,
    Transform,
    constrain,
    default_transforms,
    transform_logdensity,
)
from binf_tpu_torch.samplers.dense import flatten_spec
from binf_tpu_torch.vi._common import (
    adam_init,
    adam_update,
    cholesky_or_nan,
    flat_spec,
    generator,
    unconstrained_start,
    value_and_grad,
)

__all__ = ["LaplaceResult", "laplace_approximation", "laplace_sample",
           "inverse_mass_from_laplace"]


class LaplaceResult(NamedTuple):
    mode: Position  # constrained-space MAP
    mode_unconstrained: torch.Tensor  # flat
    cov: torch.Tensor  # (d, d) in unconstrained space
    chol_cov: torch.Tensor
    log_prob_at_mode: torch.Tensor
    log_evidence_laplace: torch.Tensor  # Laplace evidence estimate
    converged: torch.Tensor


def laplace_approximation(
    posterior,
    key=None,
    num_steps: int = 2000,
    learning_rate: float = 0.05,
    transforms: dict[str, Transform] | None = None,
    initial_position: Position | None = None,
    device=None,
) -> LaplaceResult:
    """Adam ascent to the MAP, then the exact Hessian -> Gaussian posterior.

    ``key`` is unused (the fit is deterministic), kept for the reference's
    signature.  Runs on the card unless ``device="cpu"``; the posterior's
    data must lie on that device."""
    dev = resolve_device(device)
    if transforms is None:
        transforms = default_transforms(posterior)
    logdensity = transform_logdensity(posterior.log_prob, transforms)
    u0 = unconstrained_start(posterior, transforms, initial_position, dev)
    pack, unpack, d = flatten_spec(u0)

    def neg_logp(flat):
        return -logdensity(unpack(flat))

    vg = value_and_grad(neg_logp)

    def grad(flat):
        return vg(flat)[1]

    hessian = torch.func.hessian(neg_logp)
    flat = pack(u0)
    state = adam_init([flat])
    for _ in range(num_steps):
        (flat,), state = adam_update([flat], [grad(flat)], state, learning_rate)

    # Newton polish: a few damped steps with the exact Hessian
    eye = torch.eye(d, device=dev)
    for _ in range(5):
        step = torch.linalg.solve(hessian(flat) + 1e-6 * eye, grad(flat))
        new = flat - step
        flat = torch.where(neg_logp(new) < neg_logp(flat), new, flat)

    H = hessian(flat) + 1e-8 * eye
    cov = torch.linalg.inv(H)
    # symmetrize for numerical safety
    cov = 0.5 * (cov + cov.T)
    chol = cholesky_or_nan(cov + 1e-10 * eye)

    lp_mode = -neg_logp(flat)
    sign, logdet_H = torch.linalg.slogdet(H)
    log_evidence = lp_mode + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet_H

    grad_norm = torch.linalg.vector_norm(grad(flat))
    return LaplaceResult(
        mode=constrain(transforms, unpack(flat)),
        mode_unconstrained=flat,
        cov=cov,
        chol_cov=chol,
        log_prob_at_mode=lp_mode,
        log_evidence_laplace=log_evidence,
        converged=(grad_norm < 1e-2) & (sign > 0),
    )


def _standard_normal(gen: torch.Generator, shape, dev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev)


def laplace_sample(
    posterior,
    result: LaplaceResult,
    key,
    num_samples: int,
    transforms: dict[str, Transform] | None = None,
) -> Position:
    """Draw constrained-space samples from the Laplace Gaussian, on the
    device of the fit; ``key`` is an int seed or a ``torch.Generator``
    there."""
    if transforms is None:
        transforms = default_transforms(posterior)
    _, unpack, d = flat_spec(posterior, transforms)
    dev = result.mode_unconstrained.device
    eps = _standard_normal(generator(key, dev), (num_samples, d), dev)
    flats = result.mode_unconstrained[None, :] + eps @ result.chol_cov.T
    return constrain(transforms, unpack(flats))


def inverse_mass_from_laplace(posterior, result: LaplaceResult,
                              transforms: dict[str, Transform] | None = None):
    """Diagonal inverse-mass dict for HMC/NUTS from the Laplace covariance
    diagonal: a principled warm start for adaptation."""
    if transforms is None:
        transforms = default_transforms(posterior)
    _, unpack, _ = flat_spec(posterior, transforms)
    return unpack(torch.diagonal(result.cov))
