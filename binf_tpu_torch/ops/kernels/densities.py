"""Device densities: what the whole-run kernels K3 (fused warmup) and K4
(fused sampling) run on the card.

The JAX package traces any log density into its kernels
(``binf_tpu/ops/pallas/fused_potential.py::tile_potential_from_scalar``)
and recognises the linear-regression posterior by introspection
(``binf_tpu/samplers/fused.py::_introspect``).  Here a kernel runs a
*device density*: an object with

- ``D``, the number of unconstrained coordinates;
- ``potential_and_grad(q (..., D)) -> (U (...), grad U (..., D))`` in plain
  PyTorch, which the plain versions of the kernels run;
- ``functor``, the name of the CUDA functor (``csrc/*_density.cuh``) the
  kernels are instantiated with, ``cuda_operands()``, that functor's
  operands, and ``shared_floats()``, the shared memory they take.

Six families have a hand-written functor: :class:`LinregDensity`
(``csrc/linreg_density.cuh``), :class:`DiagGaussianDensity`
(``csrc/diag_gaussian_density.cuh``), :class:`LogisticDensity`
(``csrc/logistic_density.cuh``), :class:`AR1Density`
(``csrc/ar1_density.cuh``), :class:`MixtureDensity`
(``csrc/mixture_density.cuh``) and :class:`HierarchicalDensity`
(``csrc/hierarchical_density.cuh``).  Any other log density gets a
generated one: :class:`TracedDensity`, whose functor the density compiler
(``ops/kernels/density_compiler.py``) emits from the aten graph of its
value and gradient, as the JAX package's interpreter runs any
tile-compilable density.  :func:`device_density` returns a device density
for a device density, for the posteriors it recognises by introspection
(as strictly as the JAX package's ``_introspect``: the port's
``transform_logdensity`` of a linear-regression posterior, the
``log_prob`` of ``example/logistic.py``'s posterior, ``transform_logdensity``
of ``example/statespace.py``'s AR(1) posterior under ``{"precision":
LogTransform}``, the ``log_prob`` of ``example/mixture.py``'s posterior
of 2 to 8 components, and ``transform_logdensity`` of
``example/hierarchical.py``'s posterior of 2 to 16 groups under the same
transform), and else the compiled :class:`TracedDensity`; it raises
``density_compiler.UnsupportedOpError`` (a ``NotImplementedError``) for
what the compiler refuses.  The potentials of the families equal minus the
posterior's log density, constants included.  :func:`density_eval` runs a
functor once at many points on the card.  :class:`CallableDensity` runs
any callable through ``torch.func`` in the plain versions.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import nn

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE
from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity, _f32

__all__ = [
    "AR1Density",
    "CallableDensity",
    "DensityOperands",
    "DiagGaussianDensity",
    "HierarchicalDensity",
    "LinregDensity",
    "LogisticDensity",
    "MixtureDensity",
    "TracedDensity",
    "density_eval",
    "device_density",
    "is_device_density",
    "recognise",
]

# csrc/densities.cuh: the family codes of with_density
FAMILIES = {"LinregDensity": 0, "DiagGaussianDensity": 1, "LogisticDensity": 2,
            "AR1Density": 3, "MixtureDensity": 4, "HierarchicalDensity": 5,
            "TracedDensity": 6}

# the dimensions csrc/densities.cuh::with_density instantiates each family at
FAMILY_DIMS = {"LinregDensity": range(2, 9), "DiagGaussianDensity": range(1, 9),
               "LogisticDensity": range(1, 9), "AR1Density": (4,), "MixtureDensity": (7,),
               "HierarchicalDensity": (21,), "TracedDensity": ()}
# the dimensions K3 and K4 run each family at: FAMILY_DIMS through the units
# of csrc, the others through a unit of their own built at first use
# (_build.shape_libraries): linear regression up to 16 coefficients, the
# diagonal Gaussian and the logistic regression up to 32, the mixture at K =
# 2..8 (D = 2 K + 1), the hierarchical posterior at 2..16 groups (D = 2 NG + 5),
# a traced density up to 4,096 (density_compiler.MAX_D_WIDE): one lane a
# chain up to 32 (MAX_D), a group of warps a chain past it (the wide form:
# one warp up to 256, up to 8 past it, fused_potential.wide_warps)
MIXTURE_COMPONENTS = range(2, 9)
HIERARCHICAL_GROUPS = range(2, 17)
KERNEL_DIMS = {"LinregDensity": range(2, 18), "DiagGaussianDensity": range(1, 33),
               "LogisticDensity": range(1, 33), "AR1Density": (4,),
               "MixtureDensity": tuple(2 * k + 1 for k in MIXTURE_COMPONENTS),
               "HierarchicalDensity": tuple(2 * g + 5 for g in HIERARCHICAL_GROUPS),
               "TracedDensity": range(1, MAX_D_WIDE + 1)}

NO_DEVICE_DENSITY = (
    "the density compiler (ops/kernels/density_compiler.py) refuses this log density "
    "before any build, so the fused kernels cannot run it on the card; such a model runs "
    "on the card through the eager samplers (samplers/hmc.py, samplers/nuts.py with "
    "parallel/runner.py::warmup_and_run, or adaptive_hmc, whose router sends it there); "
    "on the CPU (device='cpu') any callable runs through the plain versions"
)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


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


def _gauss_const(variances) -> float:
    """sum_k log(2 pi v_k) / 2: the normalising constant of independent
    Gaussian priors, in float64."""
    v = torch.as_tensor(variances).double().cpu().reshape(-1)
    return float((_HALF_LOG_2PI + 0.5 * torch.log(v)).sum())


class LogisticDensity(nn.Module):
    """U(w) = sum_i [softplus(x_i . w) - y_i x_i . w] + sum_k (w_k - m_k)^2
    / (2 v_k) + C: the logistic-regression posterior's potential, C its
    prior's constant; the functor is ``csrc/logistic_density.cuh``."""

    functor = "LogisticDensity"

    def __init__(self, X, y, prior_var, prior_mean=None):
        super().__init__()
        X = _f32(X, None)
        n, d = X.shape
        dev = X.device
        pv = _f32(prior_var, dev).reshape(d)
        self.register_buffer("X", X)
        self.register_buffer("y", _f32(y, dev).reshape(n))
        self.register_buffer("ipv", (1.0 / pv).contiguous())
        pm = torch.zeros(d) if prior_mean is None else prior_mean
        self.register_buffer("prior_mean", _f32(pm, dev).reshape(d))
        self.const = _gauss_const(pv)

    @property
    def D(self) -> int:
        return self.X.shape[1]

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def potential_and_grad(self, q: torch.Tensor):
        eta = q @ self.X.T
        lik = (torch.nn.functional.softplus(eta) - self.y * eta).sum(-1)
        qc = q - self.prior_mean
        U = lik + 0.5 * (qc * qc * self.ipv).sum(-1) + self.const
        return U, (torch.sigmoid(eta) - self.y) @ self.X + qc * self.ipv

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]

    def cuda_operands(self):
        return (self.X, self.y, self.ipv, self.prior_mean), self.n, self.const, 0.0

    def shared_floats(self) -> int:
        # csrc/logistic_density.cuh: rows of x_i and y_i at an odd stride
        return self.n * ((self.D + 1) | 1) + 2 * self.D


class AR1Density(nn.Module):
    """The AR(1) trajectory posterior in (phi_raw, drift, x0, log lambda)
    space, minus its log density (``csrc/ar1_density.cuh`` states it):
    ``y (T,)``, N(m, v) priors on the dynamics, Gamma(a, b) on lambda under
    the log transform.  The functor carries the trajectory and its three
    tangents through the recurrence step by step; the plain version takes
    them in closed form over all T steps at once (powers and prefix sums of
    phi), a few batched calls in place of T small ones."""

    functor = "AR1Density"
    D = 4

    def __init__(self, y, prior_var, prior_mean, gamma_shape: float, gamma_rate: float):
        super().__init__()
        y = _f32(y, None).reshape(-1)
        dev = y.device
        pv = _f32(prior_var, dev).reshape(3)
        a, b = float(gamma_shape), float(gamma_rate)
        const = math.lgamma(a) - a * math.log(b) + _gauss_const(pv)
        self.register_buffer("y", y)
        self.register_buffer("ipv", (1.0 / pv).contiguous())
        self.register_buffer("prior_mean", _f32(prior_mean, dev).reshape(3))
        # T/2 + a (the log-precision's coefficient), b, and the constant
        self.register_buffer("scal", torch.tensor([0.5 * y.shape[0] + a, b, const],
                                                  dtype=torch.float32, device=dev))

    @property
    def n(self) -> int:
        return self.y.shape[0]

    def potential_and_grad(self, q: torch.Tensor):
        phi, drift, x0, t = q.unbind(-1)
        phi = torch.tanh(phi)
        # the recurrence in closed form over the T steps at once:
        # x_s = phi^s x0 + drift S_s with S_s = sum_{j<s} phi^j, and its
        # tangents phi^s, S_s and s phi^(s-1) x0 + drift sum_{j<s} j phi^(j-1)
        s = torch.arange(self.n, dtype=q.dtype, device=q.device)
        P = phi[..., None] ** s  # phi^s
        dP = torch.where(s > 0, s * phi[..., None] ** torch.clamp_min(s - 1, 0), 0.0)
        S = torch.cumsum(P, -1) - P
        dS = torch.cumsum(dP, -1) - dP
        x = P * x0[..., None] + drift[..., None] * S
        r = x - self.y
        sumsq = (r * r).sum(-1)
        a_phi = (r * (dP * x0[..., None] + drift[..., None] * dS)).sum(-1)
        a_drift = (r * S).sum(-1)
        a_x0 = (r * P).sum(-1)
        lam = torch.exp(t)
        coef_t, rate, const = self.scal.unbind()
        qc = q[..., :3] - self.prior_mean
        U = (0.5 * lam * sumsq - coef_t * t + rate * lam
             + 0.5 * (qc * qc * self.ipv).sum(-1) + const)
        g_dyn = torch.stack([lam * a_phi * (1.0 - phi * phi), lam * a_drift, lam * a_x0], -1)
        g_t = 0.5 * lam * sumsq - coef_t + rate * lam
        return U, torch.cat([g_dyn + qc * self.ipv, g_t[..., None]], -1)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]

    def cuda_operands(self):
        return (self.y, self.ipv, self.prior_mean, self.scal), self.n, 0.0, 0.0

    def shared_floats(self) -> int:
        return self.n + 9


class MixtureDensity(nn.Module):
    """The K-component Gaussian mixture posterior over (log_sigma,
    log_weights (K), means (K)), minus its log density
    (``csrc/mixture_density.cuh`` states it): ``y (n,)`` and N(m, v)
    priors on all D = 2 K + 1 coordinates, in pack order (K follows from
    their length).  The means are sorted, ties kept in order as the
    functor's network and ``jnp.sort`` keep them, and their gradient goes
    back through the permutation."""

    functor = "MixtureDensity"

    def __init__(self, y, prior_var, prior_mean):
        super().__init__()
        y = _f32(y, None).reshape(-1)
        dev = y.device
        pv = _f32(prior_var, dev).reshape(-1)
        if pv.numel() % 2 != 1 or pv.numel() < 3:
            raise ValueError(f"a mixture has 2 K + 1 coordinates, not {pv.numel()}")
        self.K = (pv.numel() - 1) // 2
        self.register_buffer("y", y)
        self.register_buffer("ipv", (1.0 / pv).contiguous())
        self.register_buffer("prior_mean", _f32(prior_mean, dev).reshape(self.D))
        self.const = _gauss_const(pv)

    @property
    def D(self) -> int:
        return 2 * self.K + 1

    @property
    def n(self) -> int:
        return self.y.shape[0]

    def potential_and_grad(self, q: torch.Tensor):
        K = self.K
        s, lw, m_raw = q[..., 0], q[..., 1:1 + K], q[..., 1 + K:]
        m, perm = torch.sort(m_raw, dim=-1, stable=True)
        l = lw - torch.logsumexp(lw, dim=-1, keepdim=True)
        iv = torch.exp(-2.0 * s)[..., None, None]
        d = self.y[:, None] - m[..., None, :]  # (..., n, K)
        c = -0.5 * iv * (d * d) - s[..., None, None] + l[..., None, :]
        L = torch.logsumexp(c, dim=-1)
        r = torch.exp(c - L[..., None])
        dL_s = (iv[..., 0, 0] * (r * d * d).sum((-2, -1)) - self.n)[..., None]
        dL_lw = r.sum(-2) - self.n * torch.exp(l)
        dL_m = torch.zeros_like(m_raw).scatter(-1, perm, iv[..., 0] * (r * d).sum(-2))
        qc = q - self.prior_mean
        U = -L.sum(-1) + 0.5 * (qc * qc * self.ipv).sum(-1) + self.const
        return U, qc * self.ipv - torch.cat([dL_s, dL_lw, dL_m], -1)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]

    def cuda_operands(self):
        return (self.y, self.ipv, self.prior_mean), self.n, self.const, 0.0

    def shared_floats(self) -> int:
        return self.n + 2 * self.D


class HierarchicalDensity(nn.Module):
    """The hierarchical posterior of ``example/hierarchical.py`` over
    (group_params (G, 2), log_tau (2), mu (2), log precision), minus its
    log density under ``{"precision": LogTransform}``
    (``csrc/hierarchical_density.cuh`` states it): curve points ``x (n,)``,
    curves ``y (G n,)``, ``counts (G,)``, the counts' log-rate offset and
    the Gamma(a, b) prior on the precision.  The constants that depend on
    the data alone (the log 2 pi terms, sum lgamma(c + 1), the Gamma's) are
    made here once, in float64.  The kernels run it at G = 2..16 groups
    (``HIERARCHICAL_GROUPS``; a unit of csrc at 8)."""

    functor = "HierarchicalDensity"

    def __init__(self, x, y, counts, n_groups: int, offset: float = 2.0,
                 gamma_shape: float = 2.0, gamma_rate: float = 0.1):
        super().__init__()
        x = _f32(x, None).reshape(-1)
        dev = x.device
        n, G = x.shape[0], int(n_groups)
        counts = _f32(counts, dev).reshape(G)
        a, b = float(gamma_shape), float(gamma_rate)
        N = G * n
        c64 = counts.double().cpu()
        const = ((0.5 * N + G + 2) * math.log(2.0 * math.pi) + 2.0 * math.log(2.0)
                 + float(torch.lgamma(c64 + 1.0).sum()) - a * math.log(b) + math.lgamma(a))
        self.n_groups = G
        self.register_buffer("x", x)
        self.register_buffer("y", _f32(y, dev).reshape(N))
        self.register_buffer("counts", counts)
        # the counts' offset, the log precision's coefficient N/2 + a, b, C
        self.register_buffer("scal", torch.tensor([float(offset), 0.5 * N + a, b, const],
                                                  dtype=torch.float32, device=dev))

    @property
    def D(self) -> int:
        return 2 * self.n_groups + 5

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def potential_and_grad(self, q: torch.Tensor):
        G = self.n_groups
        gp = q[..., :2 * G].reshape(q.shape[:-1] + (G, 2))
        la, r = gp[..., 0], gp[..., 1]
        lt, mu, t = q[..., 2 * G:2 * G + 2], q[..., 2 * G + 2:2 * G + 4], q[..., -1]
        offset, coef_t, rate, const = self.scal.unbind()
        amp = torch.exp(la)
        s = torch.sigmoid(r[..., None] * self.x)  # (..., G, n)
        m = amp[..., None] * s
        res = m - self.y.reshape(G, -1)
        S = (res * res).sum((-2, -1))
        lam = torch.exp(t)
        eta = offset + la
        e = torch.exp(eta)
        itau = torch.exp(-lt)
        dz = (gp - mu[..., None, :]) * itau[..., None, :]
        U = (0.5 * lam * S - coef_t * t + rate * lam + (e - self.counts * eta).sum(-1)
             + 0.5 * (dz * dz).sum((-2, -1)) + G * lt.sum(-1) + 0.125 * (mu * mu).sum(-1)
             + 0.5 * ((lt + 1.0) ** 2).sum(-1) + const)
        g_la = lam[..., None] * (res * m).sum(-1) + e - self.counts + dz[..., 0] * itau[..., :1]
        g_r = (lam[..., None] * amp * (res * s * (1.0 - s) * self.x).sum(-1)
               + dz[..., 1] * itau[..., 1:])
        g_lt = G - (dz * dz).sum(-2) + (lt + 1.0)
        g_mu = 0.25 * mu - (dz * itau[..., None, :]).sum(-2)
        g_t = 0.5 * lam * S - coef_t + rate * lam
        grad = torch.cat([torch.stack([g_la, g_r], -1).reshape(q.shape[:-1] + (2 * G,)),
                          g_lt, g_mu, g_t[..., None]], -1)
        return U, grad

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]

    def cuda_operands(self):
        return (self.x, self.y, self.counts, self.scal), self.n, 0.0, 0.0

    def shared_floats(self) -> int:
        return self.n + self.n_groups * self.n + self.n_groups + 4


_EVAL_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def density_eval(density, q: torch.Tensor, device=None, lanes: int | None = None):
    """``(U (n,), grad U (n, D))`` of a device density at ``q (n, D)``: one
    launch of ``csrc/density_eval.cuh`` on the card, a group of ``lanes``
    lanes a point through the functor K3 and K4 run at that width (by
    default ``fused_potential.lanes_for(density)``, theirs; a width not
    instantiated raises); on the CPU its plain ``potential_and_grad``."""
    dev = resolve_device(device)
    q = q.to(dev, torch.float32).contiguous()
    if dev.type != "cuda":
        return density.potential_and_grad(q)
    if not is_device_density(density):
        raise NotImplementedError(f"{type(density).__name__} has no CUDA functor")
    from binf_tpu_torch.ops.kernels.fused_potential import _libraries, lanes_for

    if lanes is None:
        lanes = lanes_for(density)
    n, D = q.shape
    if D not in KERNEL_DIMS[density.functor]:
        raise NotImplementedError(f"no unit runs {density.functor} at D={D}")
    ops, family, keep = operands(density, dev)
    U = torch.empty(n, dtype=torch.float32, device=dev)
    g = torch.empty_like(q)
    grid = (ctypes.c_int * 2)()
    lib = _libraries(density, lanes)[1]
    fn = _build.bind(lib, "binf_density_eval", _EVAL_ARGS)
    _build.count_launch("density_eval")
    err = fn(family, D, lanes, ctypes.byref(ops), _build.ptr(q), n, _build.ptr(U),
             _build.ptr(g), _build.stream_ptr(dev), grid)
    _build.check(lib, err, f"binf_density_eval launch (lanes={lanes})")
    _build.last_launch["density_eval"] = _build.LaunchRecord(lanes, grid[0], grid[1], False, 1,
                                                             1, 0, None)
    del keep
    return U, g


class CallableDensity:
    """Any ``logdensity(position dict) -> scalar`` as a plain density over
    flat positions ``(..., D)`` (pack order: sorted names), with value and
    gradient from ``torch.func``.  It has no CUDA functor: the fused runs
    take it on the CPU; on the card :class:`TracedDensity` runs the same
    callable."""

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


class TracedDensity(nn.Module):
    """Any log density the density compiler takes
    (``ops/kernels/density_compiler.py``), as a device density: the functor
    ``Traced_<key>`` the compiler emitted (``source``, a header on
    ``csrc/traced_density.cuh``), its constant buffer ``operands`` (staged
    in shared memory by K3 and K4), and ``flops``, its float operations an
    evaluation.  The kernels run it at one lane a chain up to ``D`` = 32,
    and past it (``wide``, up to ``density_compiler.MAX_D_WIDE``) its wide
    form at a group of warps a chain (``csrc/fused_wide.cuh``,
    ``fused_potential.wide_warps``); its first use on the card builds K3's and
    K4's units of its shape
    (``_build.shape_libraries``, keyed by ``key``, the hash of the emitted
    text: the same model on new data of the same shapes reuses them).  The
    plain version is ``torch.func`` on the callable, as
    :class:`CallableDensity`."""

    functor = "TracedDensity"

    def __init__(self, logdensity_fn, template: dict):
        super().__init__()
        from binf_tpu_torch.ops.kernels.density_compiler import compile_density

        self.compiled = compile_density(logdensity_fn, template)
        self.register_buffer("operands", self.compiled.operands.clone())
        self._plain = CallableDensity(logdensity_fn, template)

    @property
    def D(self) -> int:
        return self.compiled.D

    @property
    def key(self) -> str:
        return self.compiled.key

    @property
    def wide(self) -> bool:
        """Past 32 coordinates: K3 and K4 run the wide form, a group of warps
        a chain."""
        return self.compiled.wide

    @property
    def source(self) -> str:
        """The emitted header: what the model compiles to."""
        return self.compiled.source

    @property
    def flops(self) -> int:
        return self.compiled.flops

    def potential_and_grad(self, q: torch.Tensor):
        return self._plain.potential_and_grad(q)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]

    def cuda_operands(self):
        return (self.operands,), self.operands.numel(), 0.0, 0.0

    def shared_floats(self) -> int:
        return self.compiled.operands.numel()


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


def _bound_posterior(fn):
    """The Posterior whose own ``log_prob`` ``fn`` is, unfixed, else None."""
    from binf_tpu_torch.pdf.posterior import Posterior

    post = getattr(fn, "__self__", None)
    if not (isinstance(post, Posterior) and getattr(fn, "__func__", None) is Posterior.log_prob):
        return None
    return None if post.fixed else post


def _shapes(template) -> dict:
    return {k: tuple(torch.as_tensor(v).shape) for k, v in template.items()}


def _priors(post, kind) -> dict:
    """The posterior's priors, by variable, if every one is an unfixed
    ``kind`` on one variable, else None."""
    out = {}
    for p in post.priors.values():
        if not isinstance(p, kind) or p.fixed or p.variable in out:
            return None
        out[p.variable] = p
    return out


def _logistic_from_posterior(fn, template) -> LogisticDensity | None:
    """``make_logistic_posterior(X, y).log_prob``, held strictly: one
    likelihood of a LinearForwardModel under a BernoulliErrorModel, nothing
    fixed or tempered, one GaussianPrior on the weights, 1 <= d <= 32 and no
    transform; else None."""
    from binf_tpu_torch.model.error import BernoulliErrorModel
    from binf_tpu_torch.model.forward import LinearForwardModel
    from binf_tpu_torch.pdf.priors import GaussianPrior

    post = _bound_posterior(fn)
    if post is None or len(post.likelihoods) != 1:
        return None
    (lik,) = post.likelihoods.values()
    fwm, em = getattr(lik, "forward_model", None), getattr(lik, "error_model", None)
    if not (isinstance(fwm, LinearForwardModel) and isinstance(em, BernoulliErrorModel)):
        return None
    if lik.fixed or em.fixed or not (isinstance(lik.temper, float) and lik.temper == 1.0):
        return None
    priors = _priors(post, GaussianPrior)
    d = fwm.design.shape[1]
    if priors is None or set(priors) != {fwm.variable} or d not in KERNEL_DIMS["LogisticDensity"]:
        return None
    if _shapes(template) != {fwm.variable: (d,)}:
        return None
    prior = priors[fwm.variable]
    return LogisticDensity(fwm.design, em.data, prior.variances, prior.means)


def _ar1_from_posterior(fn, template) -> AR1Density | None:
    """``transform_logdensity(make_ar1_posterior(y).log_prob, {"precision":
    LogTransform})``, held strictly: one likelihood of an AR1TrajectoryModel
    under a GaussianErrorModel (by precision, not fully normalised),
    nothing fixed or tempered, a GaussianPrior on the dynamics and a
    GammaPrior on the precision; else None."""
    from binf_tpu_torch.example.statespace import AR1TrajectoryModel
    from binf_tpu_torch.model.error import GaussianErrorModel
    from binf_tpu_torch.pdf.priors import GammaPrior, GaussianPrior
    from binf_tpu_torch.pdf.transforms import LogTransform, TransformedLogDensity

    if not isinstance(fn, TransformedLogDensity):
        return None
    if fn.transforms.keys() != {"precision"} or fn.transforms["precision"] is not LogTransform:
        return None
    post = _bound_posterior(fn.logdensity_fn)
    if post is None or len(post.likelihoods) != 1 or len(post.priors) != 2:
        return None
    (lik,) = post.likelihoods.values()
    fwm, em = getattr(lik, "forward_model", None), getattr(lik, "error_model", None)
    if not (isinstance(fwm, AR1TrajectoryModel) and isinstance(em, GaussianErrorModel)):
        return None
    if lik.fixed or em.fixed or not (isinstance(lik.temper, float) and lik.temper == 1.0):
        return None
    by_var = {p.variable: p for p in post.priors.values() if not p.fixed}
    gauss, gamma = by_var.get("dynamics"), by_var.get("precision")
    if not (isinstance(gauss, GaussianPrior) and isinstance(gamma, GammaPrior)):
        return None
    if fwm.num_steps != em.data.shape[0] or em.full_normalization:
        return None
    if _shapes(template) != {"dynamics": (3,), "precision": ()}:
        return None
    return AR1Density(em.data, gauss.variances, gauss.means, float(gamma.shape_param),
                      float(gamma.rate))


def _mixture_from_posterior(fn, template) -> MixtureDensity | None:
    """``make_mixture_posterior(y, K).log_prob`` at K = 2..8, held
    strictly: one unfixed GaussianMixtureLikelihood of K components and
    unfixed GaussianPriors on exactly its three variables, no transform;
    else None."""
    from binf_tpu_torch.example.mixture import GaussianMixtureLikelihood
    from binf_tpu_torch.pdf.priors import GaussianPrior

    post = _bound_posterior(fn)
    if post is None or len(post.likelihoods) != 1:
        return None
    (lik,) = post.likelihoods.values()
    if not isinstance(lik, GaussianMixtureLikelihood) or lik.fixed:
        return None
    K = lik.n_components
    if K not in MIXTURE_COMPONENTS:
        return None
    priors = _priors(post, GaussianPrior)
    names = ("log_sigma", "log_weights", "means")  # pack order
    if priors is None or set(priors) != set(names):
        return None
    if _shapes(template) != {"log_sigma": (), "log_weights": (K,), "means": (K,)}:
        return None
    if any(tuple(priors[k].means.shape) != _shapes(template)[k] for k in names):
        return None
    var = torch.cat([priors[k].variances.reshape(-1) for k in names])
    mean = torch.cat([priors[k].means.reshape(-1) for k in names])
    return MixtureDensity(lik.data, var, mean)


def _hierarchical_from_posterior(fn, template) -> HierarchicalDensity | None:
    """``transform_logdensity(make_hierarchical_posterior(x, y, counts,
    G).log_prob, {"precision": LogTransform})`` at G = 2..16, held
    strictly: exactly that transform; two unfixed, untempered likelihoods,
    the curves (LogisticCurvesModel under a fully normalised
    GaussianErrorModel) and the counts (CountRateModel under a
    PoissonErrorModel with its log link), on G groups; exactly an unfixed
    HierarchicalPrior of G groups and an unfixed GammaPrior on the
    precision; the template's shapes; else None."""
    from binf_tpu_torch.example.hierarchical import (CountRateModel, HierarchicalPrior,
                                                     LogisticCurvesModel)
    from binf_tpu_torch.model.error import GaussianErrorModel, PoissonErrorModel
    from binf_tpu_torch.pdf.priors import GammaPrior
    from binf_tpu_torch.pdf.transforms import LogTransform, TransformedLogDensity

    if not isinstance(fn, TransformedLogDensity):
        return None
    if fn.transforms.keys() != {"precision"} or fn.transforms["precision"] is not LogTransform:
        return None
    post = _bound_posterior(fn.logdensity_fn)
    if post is None or len(post.likelihoods) != 2 or len(post.priors) != 2:
        return None
    hier = [p for p in post.priors.values() if isinstance(p, HierarchicalPrior)]
    if len(hier) != 1 or hier[0].n_groups not in HIERARCHICAL_GROUPS:
        return None
    G = hier[0].n_groups
    curves = counts = None
    for lik in post.likelihoods.values():
        fwm, em = getattr(lik, "forward_model", None), getattr(lik, "error_model", None)
        if lik.fixed or getattr(em, "fixed", True) or getattr(fwm, "n_groups", None) != G:
            return None
        if not (isinstance(lik.temper, float) and lik.temper == 1.0):
            return None
        if isinstance(fwm, LogisticCurvesModel) and isinstance(em, GaussianErrorModel):
            curves = (fwm, em)
        elif isinstance(fwm, CountRateModel) and isinstance(em, PoissonErrorModel):
            counts = (fwm, em)
    if curves is None or counts is None:
        return None
    (cm, gauss), (rm, pois) = curves, counts
    if not gauss.full_normalization or not pois.log_link:
        return None
    if gauss.data.shape != (G * cm.x.shape[0],) or pois.data.shape != (G,):
        return None
    gamma = [p for p in post.priors.values() if isinstance(p, GammaPrior)
             and p.variable == "precision"]
    if len(gamma) != 1 or hier[0].fixed or gamma[0].fixed:
        return None
    if torch.as_tensor(rm.offset).numel() != 1:
        return None
    if _shapes(template) != {"group_params": (G, 2), "log_tau": (2,), "mu": (2,),
                             "precision": ()}:
        return None
    return HierarchicalDensity(cm.x, gauss.data, pois.data, G, float(rm.offset),
                               float(gamma[0].shape_param), float(gamma[0].rate))


_RECOGNISED = (_linreg_from_posterior, _logistic_from_posterior, _ar1_from_posterior,
               _mixture_from_posterior, _hierarchical_from_posterior)


def recognise(logdensity_fn, template: dict):
    """``logdensity_fn`` itself if it is a device density (over positions
    shaped like ``template``), else the density of a posterior this module
    recognises (the port's ``transform_logdensity`` of a linear-regression
    posterior under ``{"precision": LogTransform}``, the logistic
    posterior's ``log_prob`` at d <= 32, the AR(1) posterior's under the
    same transform, the mixture posterior's ``log_prob`` at 2 to 8
    components, the hierarchical posterior's of 2 to 16 groups under that
    transform), else None.  Nothing is compiled."""
    if is_device_density(logdensity_fn):
        D = sum(int(np.prod(torch.as_tensor(v).shape)) for v in template.values())
        if D != logdensity_fn.D:
            raise ValueError(f"template has {D} coordinates, the density {logdensity_fn.D}")
        return logdensity_fn
    for family in _RECOGNISED:
        found = family(logdensity_fn, template)
        if found is not None:
            return found
    return None


def device_density(logdensity_fn, template: dict):
    """The device density of ``logdensity_fn`` over positions shaped like
    ``template``: what :func:`recognise` finds, else the
    :class:`TracedDensity` the density compiler makes of it, traced now
    with the data as they are.  What the compiler refuses raises
    ``density_compiler.UnsupportedOpError`` (a ``NotImplementedError``),
    whose message begins ``not tile-compilable:`` and names the reason;
    any other failure of the trace raises as it is.  Whether K3 and K4
    take what it returns is ``fused_potential.kernel_refusal``'s to say."""
    from binf_tpu_torch.ops.kernels.density_compiler import UnsupportedOpError

    found = recognise(logdensity_fn, template)
    if found is not None:
        return found
    try:
        return TracedDensity(logdensity_fn, template)
    except UnsupportedOpError as e:
        err = UnsupportedOpError(f"not tile-compilable: {e}; {NO_DEVICE_DENSITY}")
        err.reason = f"not tile-compilable: {e}"  # what the router quotes
        raise err from None
