"""Stein variational gradient descent (port of ``binf_tpu/vi/svgd.py``).

A deterministic interacting-particle method (Liu & Wang 2016) whose update
is two dense (n, n) kernel matrices against the (n, d) gradient matrix,
in unconstrained space with the same transforms as HMC and ADVI:

    phi(x_i) = 1/n sum_j [ k(x_j, x_i) grad_j log p(x_j) + grad_j k(x_j, x_i) ]

with an RBF kernel and the median heuristic for its bandwidth; the
particles move by Adam on ``-phi``.  The steps are an eager loop (the
reference's one ``lax.scan``), on the card unless ``device="cpu"``.
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
    unconstrain,
)
from binf_tpu_torch.vi._common import (adam_init, adam_update, flat_spec, generator,
                                       value_and_grad)

__all__ = ["SVGDResult", "svgd"]


class SVGDResult(NamedTuple):
    particles: Position  # constrained space, (n, ...)
    grad_norm_trace: torch.Tensor


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    m = s.shape[0]
    return 0.5 * (s[(m - 1) // 2] + s[m // 2])


def _rbf_and_grad(X: torch.Tensor):
    """RBF kernel matrix and sum_j grad_{x_j} k(x_j, x_i), median bandwidth."""
    n = X.shape[0]
    diff = X[:, None, :] - X[None, :, :]  # (n, n, d)
    sq = torch.sum(diff * diff, dim=-1)  # (n, n)
    h = torch.clamp_min(_median(sq) / math.log(n + 1.0), 1e-6)
    K = torch.exp(-sq / h)  # (n, n)
    # sum_j grad_{x_j} k(x_j, x_i) = sum_j K_ji * 2 (x_i - x_j) / h
    grad_K = 2.0 / h * (X * torch.sum(K, dim=0)[:, None] - K.T @ X)
    return K, grad_K


def svgd(
    posterior,
    key,
    num_particles: int = 256,
    num_steps: int = 1000,
    learning_rate: float = 0.05,
    transforms: dict[str, Transform] | None = None,
    initial_particles: Position | None = None,
    device=None,
) -> SVGDResult:
    """Run SVGD; returns the transported particle set (constrained space).

    Without ``initial_particles`` the particles are ``num_particles`` draws
    of ``posterior.sample_prior`` from ``key`` (an int seed or a
    ``torch.Generator`` on the fit's device); with them the run is
    deterministic.  Runs on the card unless ``device="cpu"``; the
    posterior's data must lie on that device."""
    dev = resolve_device(device)
    if transforms is None:
        transforms = default_transforms(posterior)
    logdensity = transform_logdensity(posterior.log_prob, transforms)

    if initial_particles is None:
        gen = generator(key, dev)
        draws = [posterior.sample_prior(gen) for _ in range(num_particles)]
        initial_particles = {k: torch.stack([p[k] for p in draws]) for k in draws[0]}
    particles = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                 for k, v in initial_particles.items()}
    num_particles = next(iter(particles.values())).shape[0]
    pack, unpack, _ = flat_spec(posterior, transforms)
    X = pack(unconstrain(transforms, particles))  # (n, d)

    mapped = torch.func.vmap(logdensity)
    grad_logp = value_and_grad(lambda f: mapped(unpack(f)))
    state = adam_init([X])
    trace = []
    for _ in range(num_steps):
        G = grad_logp(X)[1]  # (n, d)
        G = torch.where(torch.isfinite(G), G, 0.0)
        K, grad_K = _rbf_and_grad(X)
        phi = (K @ G + grad_K) / num_particles  # (n, d)
        (X,), state = adam_update([X], [-phi], state, learning_rate)
        trace.append(torch.linalg.vector_norm(phi) / num_particles)

    return SVGDResult(particles=constrain(transforms, unpack(X)),
                      grad_norm_trace=torch.stack(trace))
