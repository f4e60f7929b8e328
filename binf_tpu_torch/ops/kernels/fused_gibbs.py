"""Whole-run collapsed Gibbs for Bayesian linear regression (K5; port of
``binf_tpu/ops/pallas/fused_gibbs.py``).

Each sweep draws both conditionals of the model of ``fused_hmc.py`` exactly:

    lambda | c ~ Gamma(a + n/2, 1) / (b + ||Vc - y||^2 / 2)
    c | lambda ~ N(mean, P^-1),  P = lambda V^T V + diag(1/v0),
                                 P mean = lambda V^T y + mu0 / v0

the Gamma draw by Marsaglia-Tsang over four masked rounds (falling back to
the reference's value ``d = shape - 1/3`` when none accepts), the
coefficients through an unrolled d x d Cholesky factor ``P = L L^T``, two
triangular solves for the mean and ``c = mean + L^-T z``.

:func:`fused_linreg_gibbs_run` runs every sweep in one CUDA kernel
(``csrc/fused_gibbs.cu``) for a run on the card, or its plain version
:func:`fused_linreg_gibbs_plain` on the CPU.  Draws are ``(steps, C, d+1)``
with column ``d`` the precision in constrained space, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.fused_hmc import (
    _SMEM_FLOATS,
    LinregDensity,
    _check_cuda_operands,
    _f32,
)
from binf_tpu_torch.ops.kernels.prng import gibbs_noise

__all__ = ["GAMMA_ROUNDS", "GibbsPlainRun", "fused_linreg_gibbs_plain",
           "fused_linreg_gibbs_run"]

GAMMA_ROUNDS = 4


def gamma_constants(shape: float) -> tuple[float, float]:
    """Marsaglia-Tsang's ``d = shape - 1/3`` and ``c = 1 / sqrt(9 d)`` for
    Gamma(shape, 1), rounded as the JAX kernel rounds them (``d`` from a
    Python float, ``c`` by a float32 square root and division)."""
    d = shape - 1.0 / 3.0
    c = np.float32(1.0) / np.sqrt(np.float32(9.0 * d))
    return float(np.float32(d)), float(c)


def gamma_rounds(d: float, c: float, gz, gu):
    """Gamma(d + 1/3, 1) from the normals ``gz`` and uniforms ``gu``
    (``GAMMA_ROUNDS`` rows each): the first accepted round's ``d v``, else
    ``d``.  Also returns, per entry, the smallest ``|log u - threshold|``
    over the rounds that decided the draw (a decision flips under float32
    rounding only where that is near 0)."""
    out = torch.full_like(gz[0], d)
    done = torch.zeros_like(gz[0], dtype=torch.bool)
    margin = torch.full_like(gz[0], float("inf"))
    for r in range(GAMMA_ROUNDS):
        x = gz[r]
        t = 1.0 + c * x
        v = t * t * t
        logv = torch.log(torch.clamp_min(v, 1e-20))
        m = torch.log(torch.clamp_min(gu[r], 1e-30)) - (0.5 * x * x + d - d * v + d * logv)
        accept = (v > 0.0) & (m < 0.0)
        margin = torch.where(done, margin, torch.minimum(margin, m.abs()))
        out = torch.where(accept & ~done, d * v, out)
        done = done | accept
    return out, margin


def conditional_coefficients(lam, vtv, vty, ipv, pm, z):
    """``mean + L^-T z`` for ``P = lam V^T V + diag(ipv) = L L^T`` and
    ``P mean = lam V^T y + pm ipv``, unrolled in the order of
    ``fused_gibbs.py:130-170``: ``lam (C,)``, ``z`` a list of d ``(C,)``
    normals, the rest Python floats (``vtv`` a d x d nested list)."""
    d = len(vty)
    P = [[lam * vtv[i][k] for k in range(d)] for i in range(d)]
    for i in range(d):
        P[i][i] = P[i][i] + ipv[i]
    b = [lam * vty[i] + pm[i] * ipv[i] for i in range(d)]
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for k in range(i + 1):
            s = P[i][k]
            for m in range(k):
                s = s - L[i][m] * L[k][m]
            L[i][k] = torch.sqrt(torch.clamp_min(s, 1e-20)) if i == k else s / L[k][k]
    w = [None] * d
    for i in range(d):
        s = b[i]
        for m in range(i):
            s = s - L[i][m] * w[m]
        w[i] = s / L[i][i]

    def back(rhs):
        x = [None] * d
        for i in reversed(range(d)):
            s = rhs[i]
            for m in range(i + 1, d):
                s = s - L[m][i] * x[m]
            x[i] = s / L[i][i]
        return x

    mean, zsol = back(w), back(z)
    return [mean[i] + zsol[i] for i in range(d)]


def _operands(density: LinregDensity):
    """``V^T V``, ``V^T y``, ``1/v0`` and ``mu0`` (float32, on the density's
    device) and Marsaglia-Tsang's constants for ``a + n/2``."""
    vtv = (density.V.T @ density.V).contiguous()
    vty = (density.V.T @ density.y).contiguous()
    ipv = (1.0 / density.prior_var).contiguous()
    gd, gc = gamma_constants(float(density.gamma_shape) + 0.5 * density.n)
    return vtv, vty, ipv, density.prior_mean, gd, gc


class GibbsPlainRun(NamedTuple):
    """Output of :func:`fused_linreg_gibbs_plain`: draws ``(steps, C, d+1)``
    and the Gamma draws' decision margins ``(steps, C)``."""

    draws: torch.Tensor
    margin: torch.Tensor


def fused_linreg_gibbs_plain(density: LinregDensity, q0, *, num_steps: int, seed: int,
                             noise=None) -> GibbsPlainRun:
    """Plain PyTorch version of the K5 kernel on any device: the same
    arithmetic batched over chains, on the same Philox stream (or the staged
    ``noise = (gz, gu, cz)``, each ``(steps, 8, C)``)."""
    C = q0.shape[0]
    d, dev = density.d, q0.device
    vtv, vty, ipv, pm, gd, gc = _operands(density)
    vtv_l, vty_l, ipv_l, pm_l = (t.tolist() for t in (vtv, vty, ipv, pm))
    rate = float(density.gamma_rate)
    chains = torch.arange(C, dtype=torch.int64, device=dev)
    c = q0[:, :d].clone()
    draws = torch.empty((num_steps, C, d + 1), dtype=torch.float32, device=dev)
    margin = torch.empty((num_steps, C), dtype=torch.float32, device=dev)
    for s in range(num_steps):
        if noise is not None:
            gz, gu, cz = noise[0][s], noise[1][s], noise[2][s, :d]
        else:
            gz, gu, cz = gibbs_noise(seed, chains, s, d)
        resid = c @ density.V.T - density.y
        ss = (resid * resid).sum(-1)
        g, margin[s] = gamma_rounds(gd, gc, gz, gu)
        lam = g / (rate + 0.5 * ss)
        c = torch.stack(conditional_coefficients(lam, vtv_l, vty_l, ipv_l, pm_l, list(cz)),
                        dim=-1)
        draws[s, :, :d] = c
        draws[s, :, d] = lam
    return GibbsPlainRun(draws, margin)


_K5_ARGS = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _gibbs_cuda(density, q0, *, num_steps, seed, noise):
    C = q0.shape[0]
    d, n = density.d, density.n
    # the data, V^T V, three d-rows and one sweep's draws of a 128-chain block
    if n * (d + 1) + d * d + 3 * d + 128 * (d + 1) > _SMEM_FLOATS:
        raise ValueError(f"{n} data points do not fit the kernel's shared memory")
    dev = q0.device
    vtv, vty, ipv, pm, gd, gc = _operands(density)
    gz, gu, cz = noise if noise is not None else (None, None, None)
    _check_cuda_operands(dev, q0=q0, V=density.V, y=density.y, vtv=vtv, vty=vty, ipv=ipv,
                         pm=pm, gz=gz, gu=gu, cz=cz)
    draws = torch.empty((num_steps, C, d + 1), dtype=torch.float32, device=dev)
    fn = _build.bind("fused_gibbs", "binf_fused_linreg_gibbs", _K5_ARGS)
    _build.count_launch("fused_gibbs", *(() if noise is not None else ("philox",)))
    err = fn(d, _build.ptr(q0), _build.ptr(density.V), _build.ptr(density.y),
             _build.ptr(vtv), _build.ptr(vty), _build.ptr(ipv), _build.ptr(pm), n, gd, gc,
             float(density.gamma_rate), C, num_steps, seed & ((1 << 64) - 1),
             _build.nullable_ptr(gz), _build.nullable_ptr(gu), _build.nullable_ptr(cz),
             _build.ptr(draws), _build.stream_ptr(dev))
    _build.check("fused_gibbs", err, "fused_linreg_gibbs launch")
    return draws


def _staged_gibbs_noise(noise, num_steps, n_chains, device):
    """Noise in the JAX host-noise layout, ``(gz, gu, cz)`` each
    ``(steps, 8, C)``, as given, or ``None`` (Philox)."""
    if noise is None:
        return None
    shape = (num_steps, 8, n_chains)
    staged = tuple(_f32(a, device) for a in noise)
    if len(staged) != 3 or any(a.shape != shape for a in staged):
        raise ValueError(f"noise must be three arrays (gz, gu, cz) of shape {shape}")
    return staged


def fused_linreg_gibbs_run(
    q0,
    seed: int,
    V,
    y,
    prior_var,
    gamma_shape: float,
    gamma_rate: float,
    *,
    prior_mean=None,
    num_steps: int,
    d: int = 4,
    block_chains: int = 512,
    steps_per_block: int = 50,
    noise=None,
    device=None,
):
    """Run ``num_steps`` exact collapsed-Gibbs sweeps from ``q0 (C, d+1)``
    (coefficients, then the precision, constrained); returns the draws
    ``(num_steps, C, d+1)``.

    Runs on the card (``device=None`` means ``"cuda"``) through one kernel,
    or with ``device="cpu"`` through the plain version.  Noise comes from
    Philox keyed by (seed, chain, sweep), or as given by
    ``noise=(gz, gu, cz)``, the JAX host-noise layout (each
    ``(steps, 8, C)``; rows 0-3 of ``gz``/``gu`` are the Gamma rounds,
    rows 0..d-1 of ``cz`` the coefficient normals).
    ``block_chains`` and ``steps_per_block`` keep the JAX package's
    divisibility contract; the result does not depend on them.
    """
    dev = resolve_device(device)
    q0 = _f32(q0, dev)
    C = q0.shape[0]
    if not 1 <= d <= 7:
        raise ValueError(f"the layout supports 1 <= d <= 7 coefficients, got d={d}")
    if q0.shape != (C, d + 1):
        raise ValueError(f"q0 must be (C, {d + 1}); got {tuple(q0.shape)}")
    if C % block_chains or num_steps % steps_per_block:
        raise ValueError("C must divide by block_chains and num_steps by steps_per_block")
    density = LinregDensity(_f32(V, dev), y, prior_var, gamma_shape, gamma_rate, prior_mean)
    if density.d != d:
        raise ValueError(f"V has {density.d} columns, d={d}")
    staged = _staged_gibbs_noise(noise, num_steps, C, dev)
    if dev.type == "cuda":
        return _gibbs_cuda(density, q0, num_steps=num_steps, seed=seed, noise=staged)
    return fused_linreg_gibbs_plain(density, q0, num_steps=num_steps, seed=seed,
                                    noise=staged).draws
