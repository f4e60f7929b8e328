"""Helpers shared by the VI modules: Adam in ``optax.adam``'s order of
operations, gradients by autograd, seeds to generators, flat unconstrained starts, and a Cholesky
factor that is NaN where the matrix is not positive definite.

``torch.optim.Adam`` computes Adam's update in another order (it folds the
bias corrections into the step size and adds ``eps`` to the corrected
square root).  Over the thousands of steps of a Laplace or ADVI fit that
order shows in the low bits; the order here keeps the port within float32
rounding of the JAX package step by step: the moments as ``(1 - b) g^k +
b m``, each bias correction ``1 - b^t`` formed in float32 and divided out,
``eps`` outside the square root (``eps_root = 0``), then the step scaled
by ``-learning_rate`` and added.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from binf_tpu_torch.pdf.transforms import unconstrain
from binf_tpu_torch.samplers.dense import flatten_spec

LOG_2PI = math.log(2.0 * math.pi)


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def adam_init(params: list) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def adam_update(params: list, grads: list, state: AdamState, learning_rate: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step on ``params`` (a list of tensors) from ``grads``;
    returns ``(new_params, new_state)``."""
    count = state.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    # float32 on the host, as optax forms them: no copy to the card a step
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    new = [p + ((m / c1) / (torch.sqrt(v / c2) + eps)) * (-learning_rate)
           for p, m, v in zip(params, mu, nu)]
    return new, AdamState(count, mu, nu)


def value_and_grad(fn):
    """``x -> (fn(x), d sum(fn(x)) / dx)`` by reverse-mode autograd: each
    row of a batched ``fn`` gets its own gradient.  ``torch.func.grad``
    computes the same but costs several times more host time over the
    model DSL's many small calls."""

    def vg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = fn(x)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    return vg


def generator(key, dev: torch.device) -> torch.Generator:
    """``key``, an int seed or a ``torch.Generator``, as a generator that
    draws on ``dev``."""
    if isinstance(key, torch.Generator):
        if key.device.type != dev.type:
            raise ValueError(f"the generator lies on {key.device}, the fit on {dev}")
        return key
    return torch.Generator(device=dev).manual_seed(int(key))


def unconstrained_start(posterior, transforms, position, dev) -> dict:
    """The unconstrained start of a fit, float32 on ``dev``: ``position``
    (the posterior's zero values when None) pulled back by ``transforms``,
    a non-finite coordinate (the log of a zero precision) set to 0."""
    template = position or posterior.init_values()
    u0 = unconstrain(transforms, {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                                  for k, v in template.items()})
    return {k: torch.where(torch.isfinite(v), v, 0.0) for k, v in u0.items()}


def flat_spec(posterior, transforms):
    """``(pack, unpack, d)`` of the posterior's unconstrained positions, in
    ``jax.flatten_util.ravel_pytree``'s order (sorted names)."""
    return flatten_spec(unconstrained_start(posterior, transforms, None, torch.device("cpu")))


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of each matrix of ``a``, NaN where one is
    not positive definite (``jnp.linalg.cholesky``'s answer; torch raises)."""
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.nan, chol)
