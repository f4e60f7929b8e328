"""Chromatin-structure distance-restraint posterior (port of
``binf_tpu/example/chromatin.py``).

Infer bead coordinates X in R^{N x 3} from noisy pairwise log-distance
restraints:

* log-normal distance restraints over a dense symmetric weight matrix,
  through the restraint kernels K6a/K6b (``ops/kernels/pairwise.py``);
* a harmonic backbone (polymer-chain) prior between consecutive beads;
* a Gamma prior on the restraint precision, with its exact conjugate
  Gibbs block (:func:`restraint_precision_block`).

Gradients with respect to the structure flow through the restraint
kernel's ``torch.autograd.Function``.  :func:`make_gram_logdensity` is the
same posterior in Gram form over ``{"structure", log "precision"}``, the
density the chain-grid kernel K7 runs (``csrc/gram_density.cuh``).
:func:`make_sharded_restraint_loss` evaluates the restraint field with
its rows split over a mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.core.density import Density, ValueDict, VariableSpec
from binf_tpu_torch.core.modules import frozen_dataclass, static_field
from binf_tpu_torch.ops.kernels.pairwise import pairwise_restraint_loss
from binf_tpu_torch.pdf import GammaPrior, Posterior
from binf_tpu_torch.pdf.distributions import gamma_sample
from binf_tpu_torch.pdf.priors import Prior

__all__ = [
    "BackbonePrior",
    "DistanceRestraintLikelihood",
    "GramChromatinDensity",
    "chromatin_problem_from_numpy",
    "make_chromatin_posterior",
    "make_gram_logdensity",
    "make_sharded_restraint_loss",
    "restraint_precision_block",
    "synthetic_restraints",
]


@frozen_dataclass
class DistanceRestraintLikelihood(Density):
    """p(logD | X, precision): log-normal restraints over all weighted pairs.

        log p = -0.5 precision loss(X) + 0.5 K log(precision) + const,

    ``loss`` the restraint loss and ``K = sum_ij W_ij`` (each unordered pair
    counts twice in both)."""

    log_target: torch.Tensor  # (N, N) target log-distances
    weights: torch.Tensor  # (N, N) symmetric, zero diagonal
    n_observed: torch.Tensor  # K, the sum of the weights
    fixed: ValueDict
    n_beads: int = static_field()
    block: int = static_field(default=256)
    use_pallas: bool | None = static_field(default=None)
    name: str = static_field(default="restraints")
    temper: float | torch.Tensor = 1.0

    @classmethod
    def create(cls, log_target, weights, block: int = 256, use_pallas=None):
        log_target = torch.as_tensor(log_target, dtype=torch.float32).contiguous()
        weights = torch.as_tensor(weights, dtype=torch.float32,
                                  device=log_target.device).contiguous()
        return cls(log_target=log_target, weights=weights, n_observed=torch.sum(weights),
                   fixed={}, n_beads=int(log_target.shape[0]), block=block,
                   use_pallas=use_pallas)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec("structure", shape=(self.n_beads, 3), differentiable=True),
                VariableSpec("precision", shape=(), differentiable=True))

    def loss(self, X: torch.Tensor) -> torch.Tensor:
        return pairwise_restraint_loss(X, self.log_target, self.weights, self.block,
                                       self.use_pallas)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        prec = values["precision"]
        return self.temper * (-0.5 * prec * self.loss(values["structure"])
                              + 0.5 * self.n_observed * torch.log(prec))


@frozen_dataclass
class BackbonePrior(Prior):
    """Harmonic polymer backbone: consecutive beads at distance d0,

        log p = -0.5 k_spring sum_i (|x_{i+1} - x_i| - d0)^2
                - 0.5 k_center N |mean(X)|^2,

    the second term pinning the center of mass (the translations would
    otherwise leave the posterior improper)."""

    fixed: ValueDict
    n_beads: int = static_field()
    d0: float = static_field(default=1.0)
    k_spring: float = static_field(default=10.0)
    k_center: float = static_field(default=0.01)
    name: str = static_field(default="backbone")

    @classmethod
    def create(cls, n_beads: int, d0: float = 1.0, k_spring: float = 10.0):
        return cls(fixed={}, n_beads=n_beads, d0=d0, k_spring=k_spring)

    @property
    def variable_specs(self) -> tuple[VariableSpec, ...]:
        return (VariableSpec("structure", shape=(self.n_beads, 3), differentiable=True),)

    def _log_prob(self, values: ValueDict) -> torch.Tensor:
        X = values["structure"]
        seg = X[1:] - X[:-1]
        d = torch.sqrt(torch.clamp_min(torch.sum(seg * seg, dim=-1), 1e-12))
        backbone = -0.5 * self.k_spring * torch.sum((d - self.d0) ** 2)
        center = -0.5 * self.k_center * torch.sum(torch.mean(X, dim=0) ** 2) * self.n_beads
        return backbone + center

    def sample(self, generator: torch.Generator) -> ValueDict:
        """A random-walk polymer with steps of length d0, centred, drawn on
        the generator's device."""
        steps = torch.randn((self.n_beads, 3), generator=generator, device=generator.device)
        steps = steps / torch.linalg.norm(steps, dim=-1, keepdim=True) * self.d0
        X = torch.cumsum(steps, dim=0)
        return {"structure": X - torch.mean(X, dim=0, keepdim=True)}


def synthetic_restraints(generator: torch.Generator, n_beads: int, observe_frac: float = 0.2,
                         noise_prec: float = 25.0, device=None):
    """A random-walk polymer and noisy log-distance observations of a
    random symmetric subset of its pairs, drawn on ``device`` (the card
    unless the caller asks for the CPU) by a generator of that device.

    Returns ``(X_true (N, 3), log_target (N, N), W (N, N))``.  The noise is
    symmetrised as ``(e + e^T) / 2``, which halves its variance: the
    precision the restraints carry is about twice ``noise_prec``.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"a generator on {generator.device} cannot draw on {dev}")
    X_true = BackbonePrior.create(n_beads).sample(generator)["structure"]
    diff = X_true[:, None, :] - X_true[None, :, :]
    d = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, -1), 1e-12))
    noise = torch.randn((n_beads, n_beads), generator=generator, device=dev) / noise_prec ** 0.5
    noise = 0.5 * (noise + noise.T)
    log_target = torch.log(torch.clamp_min(d, 1e-6)) + noise
    raw = torch.rand((n_beads, n_beads), generator=generator, device=dev)
    W = (0.5 * (raw + raw.T) < observe_frac).to(torch.float32)
    W = W * (1.0 - torch.eye(n_beads, device=dev))
    return X_true, log_target, W


def chromatin_problem_from_numpy(X_true, log_target, W, device=None):
    """``(X_true, log_target, W)`` from numpy arrays (such as the JAX
    package's ``synthetic_restraints``) as float32 tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in (X_true, log_target, W))


def restraint_precision_block(posterior, likelihood_name: str = "restraints",
                              prior_name: str = "precision_prior"):
    """Exact conjugate Gibbs draw of the restraint precision:
    ``lambda | X ~ Gamma(alpha + K/2, beta + loss(X)/2)``, one restraint
    loss (K6a) per draw."""
    from binf_tpu_torch.samplers.conjugate import ConjugateInfo
    from binf_tpu_torch.samplers.gibbs import direct_block

    lik = posterior.likelihoods[likelihood_name]
    prior = posterior.priors[prior_name]

    def sample_fn(generator: torch.Generator, position):
        loss = lik.loss(position["structure"])
        shape = prior.shape_param + 0.5 * lik.n_observed
        draw = gamma_sample(generator, shape) / (prior.rate + 0.5 * loss)
        info = ConjugateInfo(torch.ones((), dtype=torch.bool, device=loss.device),
                             torch.ones((), device=loss.device))
        return {"precision": draw}, info

    return direct_block(sample_fn)


def make_chromatin_posterior(log_target, weights, gamma_shape: float = 2.0,
                             gamma_rate: float = 0.1, block: int = 256,
                             use_pallas=None) -> Posterior:
    """Restraints, backbone and a Gamma(shape, rate) precision prior, on the
    device of ``log_target``."""
    lik = DistanceRestraintLikelihood.create(log_target, weights, block=block,
                                             use_pallas=use_pallas)
    dev = lik.log_target.device
    priors = {
        "backbone": BackbonePrior.create(lik.n_beads),
        "precision_prior": GammaPrior.create(torch.tensor(gamma_shape, device=dev),
                                             torch.tensor(gamma_rate, device=dev),
                                             variable="precision"),
    }
    return Posterior.create({"restraints": lik}, priors)


class GramChromatinDensity(nn.Module):
    """The unconstrained chromatin log density in Gram form (port of
    ``binf_tpu/example/chromatin.py::make_gram_logdensity``), over
    ``{"structure": (..., N, 3), "precision": (...)}`` with the precision in
    log space:

        log p = -1/2 lambda sum_ij W_ij r_ij^2 + 1/2 K u      (restraints)
                - 1/2 k_spring sum_i (|x_{i+1} - x_i| - d0)^2  (backbone)
                - 1/2 k_center N |mean(X)|^2                   (centring)
                + (a - 1) u - b lambda + u                     (Gamma, Jacobian)

    with ``u`` the log precision, ``lambda = exp(u)``, ``K = sum(W)``,
    ``r_ij = 1/2 log d2_ij - logD_ij`` and ``d2 = max(|x_i|^2 + |x_j|^2 - 2
    x_i . x_j, 1e-12)`` (the JAX package's Gram form; its ``X X^T`` is
    summed here coordinate by coordinate, the kernel's order, not by a
    matrix product).  The sum runs over all N^2 ordered pairs; neither W
    nor logD need be symmetric.  Calling the module gives the log density,
    batch-polymorphic over leading chain axes; :meth:`potential_and_grad`
    gives ``U = -log p`` and its gradient in closed form, the arithmetic of
    the chain-grid kernel's functor (``csrc/gram_density.cuh``, named by
    ``functor``)."""

    functor = "GramChromatinDensity"

    def __init__(self, log_target, weights, gamma_shape: float = 2.0,
                 gamma_rate: float = 0.1, d0: float = 1.0, k_spring: float = 10.0,
                 k_center: float = 0.01, device=None):
        super().__init__()
        dev = resolve_device(device)
        logD, W = ((a if torch.is_tensor(a) else torch.tensor(np.asarray(a, np.float32)))
                   .to(device=dev, dtype=torch.float32).contiguous()
                   for a in (log_target, weights))
        n = logD.shape[0]
        if logD.shape != (n, n) or W.shape != (n, n):
            raise ValueError(f"log_target and weights must be (N, N); got {tuple(logD.shape)}, "
                             f"{tuple(W.shape)}")
        self.register_buffer("logD", logD)
        self.register_buffer("W", W)
        self.register_buffer("k_obs", torch.sum(W))
        self.gamma_shape, self.gamma_rate = float(gamma_shape), float(gamma_rate)
        self.d0, self.k_spring, self.k_center = float(d0), float(k_spring), float(k_center)

    @property
    def n_beads(self) -> int:
        return self.logD.shape[0]

    def _field(self, X):
        """Raw and floored squared distances ``(..., N, N)`` in Gram form,
        and the residuals.  ``x . y`` and ``|x|^2`` are summed coordinate
        by coordinate in one order, as the kernel's functor sums them: in
        float32 the Gram form cancels for close pairs, and this way both
        round it alike."""
        x = [X[..., c] for c in range(3)]
        sq = (x[0] * x[0] + x[1] * x[1] + x[2] * x[2])[..., :, None]
        gram = (x[0][..., :, None] * x[0][..., None, :] + x[1][..., :, None] * x[1][..., None, :]
                + x[2][..., :, None] * x[2][..., None, :])
        raw = sq + sq.transpose(-1, -2) - 2.0 * gram
        d2 = torch.clamp_min(raw, 1e-12)
        return raw, d2, 0.5 * torch.log(d2) - self.logD

    def _logdensity(self, X, u, r):
        prec = torch.exp(u)
        loss = torch.sum(self.W * r * r, dim=(-2, -1))
        restraint = -0.5 * prec * loss + 0.5 * self.k_obs * u
        seg = X[..., 1:, :] - X[..., :-1, :]
        d = torch.sqrt(torch.clamp_min(torch.sum(seg * seg, dim=-1, keepdim=True), 1e-12))
        backbone = -0.5 * self.k_spring * torch.sum((d - self.d0) ** 2, dim=(-2, -1))
        center = -0.5 * self.k_center * torch.sum(
            torch.mean(X, dim=-2, keepdim=True) ** 2, dim=(-2, -1)) * self.n_beads
        gamma = (self.gamma_shape - 1.0) * u - self.gamma_rate * prec + u
        return restraint + backbone + center + gamma, loss, seg

    def forward(self, pos: dict) -> torch.Tensor:
        X, u = pos["structure"], pos["precision"]
        return self._logdensity(X, u, self._field(X)[2])[0]

    def loss(self, X: torch.Tensor) -> torch.Tensor:
        """The restraint loss ``sum_ij W_ij r_ij^2`` of structures ``(...,
        N, 3)``: given it, the precision is ``Gamma(a + K/2, b + loss/2)``."""
        r = self._field(X)[2]
        return torch.sum(self.W * r * r, dim=(-2, -1))

    def potential_and_grad(self, pos: dict):
        """``(U (...), {"precision": dU/du (...), "structure": dU/dX (..., N,
        3)})``: the row forces ``sum_j (W_ij r_ij + W_ji r_ji) / d2_ij (x_i
        - x_j)`` over pairs with ``d2`` above its floor, the backbone
        springs, the centring pull and the precision's terms."""
        X, u = pos["structure"], pos["precision"]
        raw, d2, r = self._field(X)
        logp, loss, seg = self._logdensity(X, u, r)
        prec = torch.exp(u)
        A = self.W * r
        H = torch.where(raw > 1e-12, (A + A.transpose(-1, -2)) / d2, 0.0)
        F = torch.sum(H[..., None] * (X[..., :, None, :] - X[..., None, :, :]), dim=-2)
        s2 = torch.sum(seg * seg, dim=-1, keepdim=True)
        d = torch.sqrt(torch.clamp_min(s2, 1e-12))
        spring = torch.where(s2 > 1e-12, self.k_spring * (d - self.d0) / d, 0.0) * seg
        g_back = torch.zeros_like(X)
        g_back[..., 1:, :] += spring
        g_back[..., :-1, :] -= spring
        mean = torch.mean(X, dim=-2, keepdim=True)
        g_X = prec[..., None, None] * F + g_back + self.k_center * mean
        g_u = 0.5 * prec * loss - 0.5 * self.k_obs - self.gamma_shape + self.gamma_rate * prec
        return -logp, {"precision": g_u, "structure": g_X}


def make_gram_logdensity(log_target, weights, gamma_shape: float = 2.0, gamma_rate: float = 0.1,
                         d0: float = 1.0, k_spring: float = 10.0, k_center: float = 0.01,
                         device=None) -> GramChromatinDensity:
    """The chromatin log density in Gram form, as a
    :class:`GramChromatinDensity` on ``device`` (the card unless the caller
    asks for the CPU); ``log_target`` and ``weights`` are numpy arrays or
    tensors."""
    return GramChromatinDensity(log_target, weights, gamma_shape, gamma_rate, d0, k_spring,
                                k_center, device=device)


class _ShardedRestraintLoss(torch.autograd.Function):
    """The restraint loss of a row-sharded field: ``(loss, forces)`` of
    structures ``X (..., N, 3)`` against this rank's rows of ``logD`` and
    ``W``.  The forward evaluates the plain row block on each structure,
    all-reduces the losses and all-gathers the rows' forces, so the
    backward, ``g * forces``, makes no collective (and runs under
    ``vmap``); the ``vmap`` rule moves the batch dimension to 0."""

    @staticmethod
    def forward(X, logD_rows, W_rows, mesh, axis):
        from binf_tpu_torch.ops.kernels.pairwise import pairwise_restraint_block
        from binf_tpu_torch.parallel.collectives import all_gather_rows, sum_over_ranks
        from binf_tpu_torch.parallel.mesh import mesh_axis

        index = mesh_axis(mesh, axis)[1]
        m = logD_rows.shape[0]
        flat = X.reshape((-1,) + tuple(X.shape[-2:]))

        def block(x):
            return pairwise_restraint_block(x[index * m:(index + 1) * m], x, logD_rows, W_rows)

        loss, forces = torch.func.vmap(block)(flat)
        loss = sum_over_ranks(loss, mesh, axis)
        forces = all_gather_rows(forces, mesh, dim=1, axis=axis)
        return loss.reshape(X.shape[:-2]), forces.reshape(X.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g, _):
        (forces,) = ctx.saved_tensors
        return g[..., None, None] * forces, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, X, logD_rows, W_rows, mesh, axis):
        if in_dims[1] is not None or in_dims[2] is not None:
            raise NotImplementedError("the restraint field is not batched")
        if in_dims[0] is None:
            return _ShardedRestraintLoss.apply(X, logD_rows, W_rows, mesh, axis), (None, None)
        out = _ShardedRestraintLoss.apply(X.movedim(in_dims[0], 0), logD_rows, W_rows, mesh,
                                          axis)
        return out, (0, 0)


def make_sharded_restraint_loss(mesh, axis: str = "data"):
    """Row-sharded O(N^2) restraint evaluation: ``loss_fn(X, logD, W)``.

    Each rank holds its ``(N/R, N)`` rows of ``logD`` and ``W`` (pass the
    global matrices, from which it takes them, or ``DTensor``\\ s) and the
    replicated ``(N, 3)`` structure.  The forward evaluates
    ``ops/kernels/pairwise.py::pairwise_restraint_block`` on its rows
    (plain torch, as the JAX package's block is plain XLA) and all-reduces
    the scalar.  The gradient is each rank's forces for its rows
    (symmetric-W factor 2), all-gathered to ``(N, 3)`` because the
    structure is replicated here: 12 bytes a bead, where the JAX package
    leaves the gradient row-sharded.  Memory and work are O(N^2 / R) a
    rank.  The loss differentiates under ``torch.func.grad`` and
    ``torch.func.vmap``."""
    from binf_tpu_torch.parallel.mesh import local_rows

    def loss_fn(X, logD, W):
        logD_rows, W_rows = local_rows((logD, W), mesh, axis)
        return _ShardedRestraintLoss.apply(X, logD_rows, W_rows, mesh, axis)[0]

    return loss_fn
