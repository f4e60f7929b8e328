"""Whole-run fused HMC for Bayesian linear regression with unknown noise
(K2; port of ``binf_tpu/ops/pallas/fused_hmc.py``).

Model family (the polynomial example and any basis regression):

    y ~ N(V c, 1/lambda),  c_k ~ N(m_k, prior_var_k),  lambda ~ Gamma(a, b)

sampled in unconstrained space q = (c, t = log lambda):

    -log p(q) = e^t/2 ||Vc-y||^2 - (n/2 + a) t + b e^t + sum (c-m)^2/(2 prior_var)

:class:`LinregDensity` holds the data and gives the potential and its hand
gradient in plain PyTorch; ``csrc/linreg_density.cuh`` is the same functor
on the card.  :func:`fused_linreg_hmc_run` runs the whole sampling run in
one CUDA kernel (``csrc/fused_hmc.cu``) for a run on the card, or its plain
version :func:`linreg_hmc_plain` on the CPU.  Positions keep the JAX
package's public layout ``(C, d+1)``.  Each launch leaves its grid in
``_build.last_launch["fused_linreg_hmc"]``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.prng import TAG_SAMPLE, staged_noise, step_noise

__all__ = [
    "LinregDensity",
    "PlainRun",
    "fused_linreg_hmc_run",
    "leapfrog_trajectory",
    "linreg_hmc_plain",
    "linreg_unconstrained_logdensity",
]

# shared memory a block may use without opting in (48 KB), in floats
_SMEM_FLOATS = 12288
# K2's noise slots: 128 chains a CTA, 9 floats each (csrc/fused_hmc.cu::kK2Slot)
_K2_SLOT_FLOATS = 128 * 9


def _f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(x, np.float32), device=device)


class LinregDensity(nn.Module):
    """The linear-regression potential in (c, log lambda) space.

    Buffers: ``V (n, d)``, ``y (n,)``, ``prior_var (d,)``, ``prior_mean (d,)``,
    ``gamma_shape`` and ``gamma_rate`` (0-d).  :meth:`potential_and_grad` is the
    closed form and hand gradient of ``fused_hmc.py::_kernel``.  A device
    density (``ops/kernels/densities.py``) over ``D = d + 1`` coordinates.
    """

    functor = "LinregDensity"

    def __init__(self, V, y, prior_var, gamma_shape, gamma_rate, prior_mean=None):
        super().__init__()
        V = _f32(V, None)
        if V.dim() != 2:
            raise ValueError(f"V must be (n, d); got shape {tuple(V.shape)}")
        n, d = V.shape
        dev = V.device
        self.register_buffer("V", V)
        self.register_buffer("y", _f32(y, dev).reshape(n))
        self.register_buffer("prior_var", _f32(prior_var, dev).reshape(d))
        pm = torch.zeros(d) if prior_mean is None else prior_mean
        self.register_buffer("prior_mean", _f32(pm, dev).reshape(d))
        self.register_buffer("gamma_shape", _f32(gamma_shape, dev).reshape(()))
        self.register_buffer("gamma_rate", _f32(gamma_rate, dev).reshape(()))

    @classmethod
    def from_numpy(cls, V, y, prior_var, gamma_shape, gamma_rate, prior_mean=None):
        """Build from the JAX side's parameters (numpy arrays or floats)."""
        return cls(np.asarray(V), np.asarray(y), np.asarray(prior_var),
                   float(gamma_shape), float(gamma_rate),
                   None if prior_mean is None else np.asarray(prior_mean))

    @property
    def d(self) -> int:
        return self.V.shape[1]

    @property
    def n(self) -> int:
        return self.V.shape[0]

    @property
    def D(self) -> int:
        return self.d + 1

    def cuda_operands(self):
        """Operands of ``csrc/linreg_density.cuh``: (V, y, 1/prior_var,
        prior_mean), n, n/2 + shape, rate."""
        ipv = (1.0 / self.prior_var).contiguous()
        return ((self.V, self.y, ipv, self.prior_mean), self.n,
                0.5 * self.n + float(self.gamma_shape), float(self.gamma_rate))

    def shared_floats(self) -> int:
        return self.n * (self.d + 1) + 2 * self.d

    def potential_and_grad(self, q: torch.Tensor):
        """``U(q)`` of shape ``(...,)`` and ``grad U(q)`` of shape ``(..., d+1)``
        for positions ``q (..., d+1)``."""
        d = self.d
        c, t = q[..., :d], q[..., d]
        half_n_plus_a = 0.5 * self.n + self.gamma_shape
        ipv = 1.0 / self.prior_var
        resid = c @ self.V.T - self.y
        sumsq = (resid * resid).sum(-1)
        lam = torch.exp(t)
        qc = c - self.prior_mean
        U = (0.5 * lam * sumsq - half_n_plus_a * t + self.gamma_rate * lam
             + 0.5 * (qc * qc * ipv).sum(-1))
        grad_c = lam[..., None] * (resid @ self.V) + qc * ipv
        du_dt = 0.5 * lam * sumsq - half_n_plus_a + self.gamma_rate * lam
        return U, torch.cat([grad_c, du_dt[..., None]], dim=-1)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.potential_and_grad(q)[0]


def linreg_unconstrained_logdensity(V, y, prior_var, gamma_shape, gamma_rate,
                                    prior_mean=None):
    """``logdensity({"coefficients": c, "precision": t}) -> scalar``: the same
    density on a position dict, for one chain (``t`` is log precision)."""
    density = LinregDensity(V, y, prior_var, gamma_shape, gamma_rate, prior_mean)

    def logdensity(pos):
        q = torch.cat([torch.as_tensor(pos["coefficients"], dtype=torch.float32),
                       torch.as_tensor(pos["precision"], dtype=torch.float32).reshape(1)])
        return -density(q)

    return logdensity


def leapfrog_trajectory(density, q, z, eps, metric, n_leap):
    """One trajectory in plain PyTorch: half kick, L x (drift, kick),
    retract half a kick; the carry holds (q, p, U, grad U), so it costs
    L + 1 evaluations.  ``metric`` is a diagonal inverse mass broadcastable
    to ``q``, or ``(minv, W)`` of a dense one.  ``n_leap`` is an int, or an
    int tensor broadcastable to ``q.shape[:-1]`` (each chain stops after its
    own count).  Returns the endpoint, ``E0 - E1`` (no guard) and the end
    momentum, in the arithmetic of ``csrc/hmc.cuh``."""
    if isinstance(metric, tuple):
        minv, W = metric
        p = z @ W.T

        def kinetic2(p):
            return (p * (p @ minv.T)).sum(-1)

        def drift(q, p):
            return q + eps * (p @ minv.T)
    else:
        im = metric
        p = z / torch.sqrt(torch.clamp_min(im, 1e-20))

        def kinetic2(p):
            return (p * p * im).sum(-1)

        def drift(q, p):
            return q + eps * p * im

    U0, g = density.potential_and_grad(q)
    E0 = U0 + 0.5 * kinetic2(p)
    p = p - 0.5 * eps * g
    q_new, U1 = q, U0
    if isinstance(n_leap, int):
        for _ in range(n_leap):
            q_new = drift(q_new, p)
            U1, g = density.potential_and_grad(q_new)
            p = p - eps * g
    else:
        n_leap = torch.as_tensor(n_leap, device=q.device)
        for l in range(int(n_leap.max())):
            on = l < n_leap
            q_next = drift(q_new, p)
            U_next, g_next = density.potential_and_grad(q_next)
            p_next = p - eps * g_next
            q_new = torch.where(on[..., None], q_next, q_new)
            p = torch.where(on[..., None], p_next, p)
            g = torch.where(on[..., None], g_next, g)
            U1 = torch.where(on, U_next, U1)
    p = p + 0.5 * eps * g
    return q_new, E0 - (U1 + 0.5 * kinetic2(p)), p


class PlainRun(NamedTuple):
    """Output of :func:`linreg_hmc_plain`: draws ``(steps, C, d+1)``, accepted
    steps per chain ``(C,)`` int32, and ``log u - (E0 - E1)`` per step and
    chain (an MH decision flips under rounding only where this is near 0)."""

    draws: torch.Tensor
    accepts: torch.Tensor
    margin: torch.Tensor


def linreg_hmc_plain(density: LinregDensity, q0, step_size, inverse_mass, *,
                     num_steps: int, num_leapfrog: int, seed: int,
                     noise=None) -> PlainRun:
    """Plain PyTorch version of the K2 kernel on any device: the same
    arithmetic, the same Philox stream (or the staged ``noise``)."""
    C, D = q0.shape
    dev = q0.device
    chains = torch.arange(C, dtype=torch.int64, device=dev)
    q = q0.clone()
    draws = torch.empty((num_steps, C, D), dtype=torch.float32, device=dev)
    margin = torch.empty((num_steps, C), dtype=torch.float32, device=dev)
    accepts = torch.zeros(C, dtype=torch.int32, device=dev)
    for s in range(num_steps):
        if noise is not None:
            z, u = noise[0][s, :D].T, noise[1][s, 0]
        else:
            z, u = step_noise(seed, TAG_SAMPLE, chains, s, D)
        q_new, dE, _ = leapfrog_trajectory(density, q, z, step_size, inverse_mass,
                                           num_leapfrog)
        log_u = torch.log(torch.clamp_min(u, 1e-30))
        accept = log_u < dE
        q = torch.where(accept[:, None], q_new, q)
        draws[s] = q
        margin[s] = log_u - dE
        accepts += accept.to(torch.int32)
    return PlainRun(draws, accepts, margin)


class _K2Args(ctypes.Structure):
    """``csrc/fused_hmc.cu::K2Args``."""

    _fields_ = [("q0", ctypes.c_void_p), ("eps", ctypes.c_void_p), ("im", ctypes.c_void_p),
                ("n_chains", ctypes.c_int), ("num_steps", ctypes.c_int),
                ("num_leapfrog", ctypes.c_int), ("seed", ctypes.c_uint64),
                ("mom", ctypes.c_void_p), ("unif", ctypes.c_void_p), ("draws", ctypes.c_void_p),
                ("accepts", ctypes.c_void_p)]


# d, V, y, 1/prior variance, prior mean, n, n/2 + shape, rate, arguments,
# stream, launched grid
_K2_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]


def _check_cuda_operands(dev, **tensors):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")


def _linreg_hmc_cuda(density, q0, eps, im, *, num_steps, num_leapfrog, seed, noise):
    C, D = q0.shape
    d, n = density.d, density.n
    if not 1 <= d <= 7:
        raise ValueError(f"the CUDA kernel supports 1 <= d <= 7, got d={d}")
    if n * (d + 1) + 2 * d + _K2_SLOT_FLOATS > _SMEM_FLOATS:
        raise ValueError(f"{n} data points do not fit the kernel's shared memory")
    if num_steps <= 0 or num_leapfrog < 0:
        raise ValueError("num_steps must be positive and num_leapfrog not negative")
    dev = q0.device
    mom, unif = noise if noise is not None else (None, None)
    ipv = (1.0 / density.prior_var).contiguous()
    _check_cuda_operands(dev, q0=q0, V=density.V, y=density.y, ipv=ipv,
                         pm=density.prior_mean, eps=eps, im=im, mom=mom, unif=unif)
    draws = torch.empty((num_steps, C, D), dtype=torch.float32, device=dev)
    accepts = torch.empty(C, dtype=torch.int32, device=dev)
    half_n_plus_a = 0.5 * n + float(density.gamma_shape)
    args = _K2Args(_build.ptr(q0), _build.ptr(eps), _build.ptr(im), C, num_steps, num_leapfrog,
                   seed & ((1 << 64) - 1), _build.nullable_ptr(mom), _build.nullable_ptr(unif),
                   _build.ptr(draws), _build.ptr(accepts))
    grid = (ctypes.c_int * 3)()
    fn = _build.bind("fused_hmc", "binf_fused_linreg_hmc", _K2_ARGS)
    _build.count_launch("fused_linreg_hmc", *(() if noise is not None else ("philox",)))
    err = fn(d, _build.ptr(density.V), _build.ptr(density.y), _build.ptr(ipv),
             _build.ptr(density.prior_mean), n, half_n_plus_a, float(density.gamma_rate),
             ctypes.byref(args), _build.stream_ptr(dev), grid)
    _build.check("fused_hmc", err, "fused_linreg_hmc launch")
    _build.last_launch["fused_linreg_hmc"] = _build.LaunchRecord(
        1, grid[0], grid[1], False, 1, num_steps, 0, None, bool(grid[2]))
    return draws, accepts


def fused_linreg_hmc_run(
    q0,
    seed: int,
    V,
    y,
    prior_var,
    gamma_shape: float,
    gamma_rate: float,
    step_size,
    *,
    prior_mean=None,
    inverse_mass,
    num_steps: int,
    num_leapfrog: int = 10,
    d: int = 4,
    block_chains: int = 512,
    steps_per_block: int = 50,
    host_noise: bool = False,
    noise=None,
    device=None,
):
    """Run ``num_steps`` fixed-L HMC sweeps; returns ``(draws, accept_rate)``
    with draws ``(num_steps, C, d+1)`` in unconstrained space.

    Runs on the card (``device=None`` means ``"cuda"``) through one kernel,
    or with ``device="cpu"`` through the plain version.  Noise comes from
    Philox keyed by (seed, chain, step), from a ``torch.Generator`` with
    ``host_noise``, or as given by ``noise=(mom (steps, 8, C), unif
    (steps, 1, C))``, the JAX host-noise layout.  ``block_chains`` and
    ``steps_per_block`` keep the JAX package's divisibility contract; the
    result does not depend on them.
    """
    dev = resolve_device(device)
    q0 = _f32(q0, dev)
    C = q0.shape[0]
    if q0.shape != (C, d + 1):
        raise ValueError(f"q0 must be (C, {d + 1}); got {tuple(q0.shape)}")
    if C % block_chains or num_steps % steps_per_block:
        raise ValueError("C must divide by block_chains and num_steps by steps_per_block")
    density = LinregDensity(_f32(V, dev), y, prior_var, gamma_shape, gamma_rate,
                            prior_mean)
    if density.d != d:
        raise ValueError(f"V has {density.d} columns, d={d}")
    eps = _f32(step_size, dev).reshape(1)
    im = _f32(inverse_mass, dev).reshape(d + 1)
    staged = staged_noise(noise, host_noise, seed, num_steps, 8, C, dev)
    if dev.type == "cuda":
        draws, accepts = _linreg_hmc_cuda(density, q0, eps, im, num_steps=num_steps,
                                          num_leapfrog=num_leapfrog, seed=seed,
                                          noise=staged)
    else:
        draws, accepts, _ = linreg_hmc_plain(density, q0, eps, im, num_steps=num_steps,
                                             num_leapfrog=num_leapfrog, seed=seed,
                                             noise=staged)
    accept_rate = accepts.sum(dtype=torch.int64).to(torch.float32) / (num_steps * C)
    return draws, accept_rate
