"""ADVI: automatic differentiation variational inference (port of
``binf_tpu/vi/advi.py``).

Standard ADVI (Kucukelbir et al. 2017): pull the posterior back to
unconstrained space, fit a Gaussian q by maximising the reparameterised
ELBO with Adam, Monte-Carlo gradients through ``torch.func.vmap`` over the
ELBO samples:

* **mean-field**: q = N(mu, diag(sigma^2)) as a dict of variables;
* **full-rank**: q = N(mu, L L^T) over the flat position
  (``samplers/dense.py::flatten_spec``, the reference's ``ravel_pytree``
  order), capturing posterior correlations.

Each step draws its ``(num_elbo_samples, d)`` standard normals flat, in
that order (a mean-field variable takes its slice); the reference splits
a key per step, per sample and per variable.  The optimisation is an
eager loop (the reference's one ``lax.scan``), on the card unless
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

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
    LOG_2PI,
    adam_init,
    adam_update,
    flat_spec,
    generator,
    unconstrained_start,
)

__all__ = [
    "ADVIResult",
    "MeanFieldParams",
    "FullRankParams",
    "advi",
    "variational_sample",
]


class MeanFieldParams(NamedTuple):
    mu: Position
    log_sigma: Position


class FullRankParams(NamedTuple):
    mu: torch.Tensor  # (d,)
    chol_flat: torch.Tensor  # lower-triangular entries, row by row, (d(d+1)/2,)


class ADVIResult(NamedTuple):
    params: Any
    elbo_trace: torch.Tensor
    final_elbo: torch.Tensor


def _meanfield_sample(params: MeanFieldParams, eps: Position) -> tuple[Position, torch.Tensor]:
    """``u = mu + sigma eps`` and ``log q(u)`` from standard normals ``eps``
    (a dict like ``params.mu``, with or without leading sample axes)."""
    u, logq = {}, 0
    for k in sorted(params.mu):
        mu, ls, e = params.mu[k], params.log_sigma[k], eps[k]
        u[k] = mu + torch.exp(ls) * e
        # the sum over the variable's own axes (none for a scalar: an empty
        # dim tuple would sum over the sample axes too)
        sq = (e * e).reshape(e.shape[:e.dim() - mu.dim()] + (-1,)).sum(dim=-1)
        logq = logq + (-0.5 * sq - torch.sum(ls) - 0.5 * mu.numel() * LOG_2PI)
    return u, logq


def _tril_unflatten(flat: torch.Tensor, d: int) -> torch.Tensor:
    L = torch.zeros((d, d), dtype=flat.dtype, device=flat.device)
    rows, cols = torch.tril_indices(d, d, device=flat.device)
    return L.index_put((rows, cols), flat)


def _fullrank_sample(params: FullRankParams, eps: torch.Tensor,
                     d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``u = mu + L eps`` and ``log q(u)`` from standard normals ``eps``,
    ``(..., d)``; L's diagonal is made positive by a softplus."""
    L = _tril_unflatten(params.chol_flat, d)
    # softplus-positive diagonal for identifiability/stability
    diag_raw = torch.diagonal(L)
    diag = F.softplus(diag_raw) + 1e-6
    L = L - torch.diag(diag_raw) + torch.diag(diag)
    u = params.mu + eps @ L.T
    logq = -0.5 * torch.sum(eps * eps, dim=-1) - torch.sum(torch.log(diag)) - 0.5 * d * LOG_2PI
    return u, logq


def advi(
    posterior,
    key,
    num_steps: int = 2000,
    num_elbo_samples: int = 16,
    learning_rate: float = 0.05,
    method: str = "meanfield",
    transforms: dict[str, Transform] | None = None,
    initial_position: Position | None = None,
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    device=None,
) -> ADVIResult:
    """Fit q to ``posterior``; returns an :class:`ADVIResult`.  Draw
    posterior samples afterwards with :func:`variational_sample`.

    ``key`` is an int seed or a ``torch.Generator`` on the fit's device.
    ``optimizer``, where the reference takes an optax transformation, is a
    factory ``params -> torch.optim.Optimizer`` over the list of parameter
    tensors; the default is Adam at ``learning_rate`` in optax's order of
    operations.  Runs on the card unless ``device="cpu"``; the posterior's
    data must lie on that device."""
    dev = resolve_device(device)
    gen = generator(key, dev)
    if transforms is None:
        transforms = default_transforms(posterior)
    d = flat_spec(posterior, transforms)[2]
    return _advi(posterior, lambda step: torch.randn((num_elbo_samples, d), generator=gen,
                                                     device=dev),
                 num_steps, learning_rate, method, transforms, initial_position, optimizer, dev)


def _advi(posterior, noise: Callable[[int], torch.Tensor], num_steps: int,
          learning_rate: float, method: str, transforms, initial_position, optimizer,
          dev) -> ADVIResult:
    """ADVI with step ``t``'s ELBO normals ``noise(t)``, ``(S, d)`` flat."""
    logdensity = transform_logdensity(posterior.log_prob, transforms)
    u0 = unconstrained_start(posterior, transforms, initial_position, dev)
    _, unpack, d = flatten_spec(u0)
    names = sorted(u0)
    logdensities = torch.func.vmap(logdensity)

    if method == "meanfield":
        params = [u0[k] for k in names] + [torch.full_like(u0[k], -1.0) for k in names]

        def to_params(leaves):
            n = len(names)
            return MeanFieldParams(mu=dict(zip(names, leaves[:n])),
                                   log_sigma=dict(zip(names, leaves[n:])))

        def sample_u(p, eps):
            return _meanfield_sample(p, unpack(eps))

    elif method == "fullrank":
        pack = flatten_spec(u0)[0]
        tril0 = torch.zeros(d * (d + 1) // 2, device=dev)
        # the diagonal's raw entries start at -1 (softplus(-1) ~ 0.31)
        diag_positions = torch.cumsum(torch.arange(1, d + 1, device=dev), 0) - 1
        tril0[diag_positions] = -1.0
        params = [pack(u0), tril0]

        def to_params(leaves):
            return FullRankParams(mu=leaves[0], chol_flat=leaves[1])

        def sample_u(p, eps):
            u, logq = _fullrank_sample(p, eps, d)
            return unpack(u), logq

    else:
        raise ValueError(method)

    def negative_elbo(leaves, eps):
        u, logq = sample_u(to_params(leaves), eps)
        return -torch.mean(logdensities(u) - logq)

    trace = []
    if optimizer is None:
        state = adam_init(params)
        for t in range(num_steps):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True) for p in params]
                loss = negative_elbo(leaves, noise(t))
                grads = torch.autograd.grad(loss, leaves)
            params, state = adam_update(params, list(grads), state, learning_rate)
            trace.append(-loss.detach())
    else:
        params = [p.detach().clone().requires_grad_(True) for p in params]
        opt = optimizer(params)
        for t in range(num_steps):
            opt.zero_grad()
            loss = negative_elbo(params, noise(t))
            loss.backward()
            opt.step()
            trace.append(-loss.detach())
        params = [p.detach() for p in params]

    elbo_trace = torch.stack(trace)
    return ADVIResult(
        params=to_params(params),
        elbo_trace=elbo_trace,
        final_elbo=torch.mean(elbo_trace[-max(num_steps // 20, 1):]),
    )


def variational_sample(
    posterior,
    result: ADVIResult,
    key,
    num_samples: int,
    transforms: dict[str, Transform] | None = None,
) -> Position:
    """Draw constrained-space samples from a fitted variational family (the
    method is read from the params' type), on the fit's device; ``key`` is
    an int seed or a ``torch.Generator`` there."""
    if transforms is None:
        transforms = default_transforms(posterior)
    params = result.params
    _, unpack, d = flat_spec(posterior, transforms)
    if isinstance(params, MeanFieldParams):
        dev = next(iter(params.mu.values())).device
        eps = torch.randn((num_samples, d), generator=generator(key, dev), device=dev)
        u, _ = _meanfield_sample(params, unpack(eps))
        return constrain(transforms, u)
    if isinstance(params, FullRankParams):
        dev = params.mu.device
        eps = torch.randn((num_samples, d), generator=generator(key, dev), device=dev)
        u, _ = _fullrank_sample(params, eps, d)
        return constrain(transforms, unpack(u))
    raise TypeError(type(params))
