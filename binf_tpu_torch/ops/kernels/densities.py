"""Device densities: what the whole-run kernels K3 (fused warmup) and K4
(fused sampling) run on the card.

The JAX package traces any log density into its kernels
(``binf_tpu/ops/pallas/fused_potential.py::tile_potential_from_scalar``)
and recognises the linear-regression posterior by introspection
(``binf_tpu/samplers/fused.py::_introspect``).  A CUDA kernel cannot take
an arbitrary Python function, so here a kernel runs a *device density*: an
object with

- ``D``, the number of unconstrained coordinates;
- ``potential_and_grad(q (..., D)) -> (U (...), grad U (..., D))`` in plain
  PyTorch, which the plain versions of the kernels run;
- ``functor``, the name of the CUDA functor (``csrc/*_density.cuh``) the
  kernels are instantiated with, ``cuda_operands()``, that functor's
  operands, and ``shared_floats()``, the shared memory they take.

Two families have one: :class:`LinregDensity` (``csrc/linreg_density.cuh``)
and :class:`DiagGaussianDensity` (``csrc/diag_gaussian_density.cuh``).
:func:`device_density` returns one for a device density or for the
port's ``transform_logdensity`` of a linear-regression posterior, and
raises for any other callable.  :class:`CallableDensity` runs any callable
through ``torch.func`` in the plain versions, on the CPU only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity, _f32

__all__ = [
    "CallableDensity",
    "DensityOperands",
    "DiagGaussianDensity",
    "LinregDensity",
    "device_density",
    "is_device_density",
]

# csrc/densities.cuh: the family codes of with_density
FAMILIES = {"LinregDensity": 0, "DiagGaussianDensity": 1}

NO_DEVICE_DENSITY = (
    "this log density has no CUDA functor, so the fused kernels cannot run it "
    "on the card; device densities exist for the linear-regression posterior "
    "(a linear or polynomial forward model, a Gaussian error model, a "
    "GammaPrior on the precision under LogTransform and a GaussianPrior on "
    "the coefficients) and for DiagGaussianDensity.  Other models run on the "
    "card through the eager samplers (samplers/hmc.py with "
    "parallel/runner.py::warmup_and_run); a functor for another family goes in "
    "csrc/densities.cuh, not written yet (ROADMAP section 1); on the CPU "
    "(device='cpu') any callable runs through the plain versions"
)


class DensityOperands(ctypes.Structure):
    """``csrc/densities.cuh::DensityOperands``: up to four device pointers,
    one int and two floats, whose meaning each functor fixes."""

    _fields_ = [("p0", ctypes.c_void_p), ("p1", ctypes.c_void_p),
                ("p2", ctypes.c_void_p), ("p3", ctypes.c_void_p),
                ("n", ctypes.c_int), ("f0", ctypes.c_float), ("f1", ctypes.c_float)]


def is_device_density(obj) -> bool:
    return getattr(obj, "functor", None) in FAMILIES and hasattr(obj, "potential_and_grad")


def operands(density, dev) -> tuple[DensityOperands, int, list]:
    """The functor's operands as the C struct, the family code, and the
    tensors the struct points into (keep them alive until the launch)."""
    tensors, n, f0, f1 = density.cuda_operands()
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"density operands must be contiguous float32 tensors on {dev}")
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    ptrs += [ctypes.c_void_p(None)] * (4 - len(ptrs))
    return DensityOperands(*ptrs, n, f0, f1), FAMILIES[density.functor], list(tensors)


class DiagGaussianDensity(nn.Module):
    """U(q) = 1/2 sum_k ((q_k - m_k) / s_k)^2: an axis-aligned Gaussian with
    means ``m (D,)`` and standard deviations ``s (D,)``; the functor is
    ``csrc/diag_gaussian_density.cuh``."""

    functor = "DiagGaussianDensity"

    def __init__(self, mean, scale):
        super().__init__()
        mean = _f32(mean, None).reshape(-1)
        self.register_buffer("mean", mean)
        self.register_buffer("scale", _f32(scale, mean.device).reshape(mean.shape))

    @property
    def D(self) -> int:
        return self.mean.shape[0]

    def potential_and_grad(self, q: torch.Tensor):
        z = (q - self.mean) / self.scale
        return 0.5 * (z * z).sum(-1), z / self.scale

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]

    def cuda_operands(self):
        return (self.mean, self.scale), 0, 0.0, 0.0

    def shared_floats(self) -> int:
        return 2 * self.D


class CallableDensity:
    """Any ``logdensity(position dict) -> scalar`` as a plain density over
    flat positions ``(..., D)`` (pack order: sorted names), with value and
    gradient from ``torch.func``.  It has no CUDA functor: the fused runs
    take it on the CPU only."""

    functor = None

    def __init__(self, logdensity_fn, template: dict):
        # fused_potential imports this module for its CUDA operands
        from binf_tpu_torch.ops.kernels.fused_potential import pack_template, unpack_draws

        self.logdensity_fn = logdensity_fn
        self.spec = pack_template(template)
        self.D = sum(size for _, _, size in self.spec)

        def neg(q_flat):
            return -self.logdensity_fn(unpack_draws(q_flat, self.spec))

        self._vg = torch.func.vmap(torch.func.grad_and_value(neg))

    def potential_and_grad(self, q: torch.Tensor):
        flat = q.reshape(-1, self.D)
        g, u = self._vg(flat)
        return u.reshape(q.shape[:-1]), g.reshape(q.shape)


def _linreg_from_posterior(fn, template) -> LinregDensity | None:
    """The rules of ``samplers/fused.py::_introspect``, held strictly: the
    position must be exactly (coefficients, precision) and the posterior
    exactly one linear or polynomial Gaussian likelihood, a GammaPrior on
    the precision under LogTransform and a GaussianPrior on the
    coefficients, nothing fixed and nothing tempered; else None."""
    from binf_tpu_torch.model.error import GaussianErrorModel
    from binf_tpu_torch.model.forward import LinearForwardModel, PolynomialForwardModel
    from binf_tpu_torch.pdf.posterior import Posterior
    from binf_tpu_torch.pdf.priors import GammaPrior, GaussianPrior
    from binf_tpu_torch.pdf.transforms import LogTransform, TransformedLogDensity

    if not isinstance(fn, TransformedLogDensity):
        return None
    post = getattr(fn.logdensity_fn, "__self__", None)
    if not (isinstance(post, Posterior) and fn.logdensity_fn.__func__ is Posterior.log_prob):
        return None
    if post.fixed or len(post.likelihoods) != 1 or len(post.priors) != 2:
        return None
    (lik,) = post.likelihoods.values()
    fwm, em = getattr(lik, "forward_model", None), getattr(lik, "error_model", None)
    if not (isinstance(fwm, (LinearForwardModel, PolynomialForwardModel))
            and isinstance(em, GaussianErrorModel)):
        return None
    if lik.fixed or em.fixed or not (isinstance(lik.temper, float) and lik.temper == 1.0):
        return None
    coef = fwm.variable
    gamma = [p for p in post.priors.values() if isinstance(p, GammaPrior)
             and p.variable == "precision" and not p.fixed]
    gauss = [p for p in post.priors.values() if isinstance(p, GaussianPrior)
             and p.variable == coef and not p.fixed]
    if len(gamma) != 1 or len(gauss) != 1:
        return None
    if fn.transforms.keys() != {"precision"} or fn.transforms["precision"] is not LogTransform:
        return None
    V = fwm.design if isinstance(fwm, LinearForwardModel) else fwm.vandermonde
    d = V.shape[1]
    shapes = {k: tuple(torch.as_tensor(v).shape) for k, v in template.items()}
    # the kernels' layout is (c, log lambda): coefficients sort first
    if shapes != {coef: (d,), "precision": ()} or coef > "precision":
        return None
    return LinregDensity(V, em.data, gauss[0].variances, float(gamma[0].shape_param),
                         float(gamma[0].rate), prior_mean=gauss[0].means)


def device_density(logdensity_fn, template: dict):
    """The device density of ``logdensity_fn`` over positions shaped like
    ``template``: ``logdensity_fn`` itself if it is one, the
    :class:`LinregDensity` of a linear-regression posterior passed through
    the port's ``transform_logdensity(posterior.log_prob, {"precision":
    LogTransform})``; for anything else ``NotImplementedError``."""
    if is_device_density(logdensity_fn):
        D = sum(int(np.prod(torch.as_tensor(v).shape)) for v in template.values())
        if D != logdensity_fn.D:
            raise ValueError(f"template has {D} coordinates, the density {logdensity_fn.D}")
        return logdensity_fn
    found = _linreg_from_posterior(logdensity_fn, template)
    if found is None:
        raise NotImplementedError(NO_DEVICE_DENSITY)
    return found
