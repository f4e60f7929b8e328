"""Stan-window warmup in one kernel (K3; port of the warmup half of
``binf_tpu/ops/pallas/fused_potential.py``), plus the position packing the
fused runs share.

:func:`fused_warmup_run` adapts a step size and a diagonal inverse mass
with fixed-length trajectories: an optional Hoffman-Gelman doubling search
for the first step size, dual averaging and a cross-chain Welford metric in
Stan's windows, all pooled over the chains of one ``block_chains`` tile.  A
run on the card is one CUDA kernel (``csrc/fused_warmup.cu``); on the CPU
the plain version :func:`fused_warmup_plain` does the same arithmetic,
batched over tiles.  The density is a :class:`LinregDensity`, the device
functor of ``csrc/linreg_density.cuh``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.fused_hmc import (
    _SMEM_FLOATS,
    LinregDensity,
    _check_cuda_operands,
    _f32,
    leapfrog_trajectory,
)
from binf_tpu_torch.ops.kernels.prng import (
    TAG_SEARCH,
    TAG_WARMUP,
    staged_noise,
    step_noise,
)
from binf_tpu_torch.ops.math import WelfordState, welford_variance
from binf_tpu_torch.samplers.adaptation import _stan_boundaries

__all__ = [
    "fused_warmup_plain",
    "fused_warmup_run",
    "pack_positions",
    "pack_template",
    "unpack_draws",
]

_SEARCH_TRIALS = 20  # doubling budget of the in-kernel step-size search
_MAX_RESETS = 64  # csrc/fused_warmup.cu::kMaxResets


# -- position packing ---------------------------------------------------------


def pack_template(template: dict) -> list[tuple[str, tuple, int]]:
    """Flattening spec for a position dict: sorted ``(name, shape, size)``."""
    spec = []
    for name in sorted(template):
        shape = tuple(torch.as_tensor(template[name]).shape)
        spec.append((name, shape, math.prod(shape)))
    return spec


def pack_positions(positions: dict, spec=None) -> torch.Tensor:
    """(chain-batched) position dict -> ``(C, D)`` flat matrix."""
    if spec is None:
        spec = pack_template({k: v[0] for k, v in positions.items()})
    return torch.cat(
        [torch.as_tensor(positions[name]).reshape(-1, size) for name, _, size in spec],
        dim=1,
    )


def unpack_draws(draws: torch.Tensor, spec) -> dict:
    """``(..., D)`` flat draws -> dict of ``(..., *shape)`` tensors."""
    out = {}
    offset = 0
    for name, shape, size in spec:
        out[name] = draws[..., offset: offset + size].reshape(draws.shape[:-1] + shape)
        offset += size
    return out


# -- fused warmup -------------------------------------------------------------


def _warmup_schedule(num_steps, initial_buffer=75, final_buffer=50, first_window=25):
    """Static Stan window schedule ``(initial_buffer, final_buffer, resets)``,
    shared with the eager warmup so both see the same windows."""
    return _stan_boundaries(num_steps, initial_buffer, final_buffer, first_window)


def _guarded_transition(density, q, z, u, eps, im, num_leapfrog):
    """MH-corrected trajectory with the divergence guard of
    ``_hmc_transition``: NaN or |dE| > 1000 rejects outright.  Returns the
    next positions, ``dE`` and ``log u``."""
    q_new, dE = leapfrog_trajectory(density, q, z, eps, im, num_leapfrog)
    dE = torch.where(torch.isnan(dE) | (dE.abs() > 1000.0), -math.inf, dE)
    log_u = torch.log(torch.clamp_min(u, 1e-30))
    return torch.where((log_u < dE)[..., None], q_new, q), dE, log_u


def _accept_prob(dE):
    a = torch.clamp_max(torch.exp(torch.clamp_max(dE, 0.0)), 1.0)
    return torch.where(torch.isnan(dE), 0.0, a)


def fused_warmup_plain(density: LinregDensity, q0: torch.Tensor, seed: int,
                       initial_step_size: float, *, num_warmup: int, num_leapfrog: int,
                       block_chains: int, target_accept: float, init_search: bool,
                       noise=None, margins: list | None = None):
    """Plain PyTorch version of the K3 kernel on any device: the same
    arithmetic and the same Philox stream (or the staged ``noise``), every
    tile's statistics kept as one row of a ``(tiles, ...)`` tensor.

    A list passed as ``margins`` receives, per warmup step, ``log u - dE``
    for every chain ``(C,)``: an MH decision can flip under rounding only
    where this is near 0."""
    C, D = q0.shape
    bc = block_chains
    T = C // bc
    dev = q0.device
    chains = torch.arange(C, dtype=torch.int64, device=dev).reshape(T, bc)
    q_start = q0.reshape(T, bc, D)
    ib, fb, resets = _warmup_schedule(num_warmup)

    def draw(tag, philox_step, staged_step):
        if noise is None:
            return step_noise(seed, tag, chains, philox_step, D)
        mom, unif = noise
        return (mom[staged_step, :D].T.reshape(T, bc, D),
                unif[staged_step, 0].reshape(T, bc))

    log_eps0 = torch.log(torch.full((T, 1), initial_step_size, dtype=torch.float32,
                                    device=dev))
    if init_search:
        identity = torch.ones(D, dtype=torch.float32, device=dev)

        def pooled_alpha(log_eps, trial):
            z, u = draw(TAG_SEARCH, trial, trial)
            _, dE, _ = _guarded_transition(density, q_start, z, u,
                                           torch.exp(log_eps)[..., None], identity,
                                           num_leapfrog)
            return _accept_prob(dE).mean(dim=1, keepdim=True)

        p = pooled_alpha(log_eps0, 0)
        direction = torch.where(p > 0.5, 1.0, -1.0)
        done = torch.zeros_like(p, dtype=torch.bool)
        for t in range(_SEARCH_TRIALS):
            done = done | (direction * (0.5 - p) >= 0.0)
            if bool(done.all()):
                break
            cand = log_eps0 + direction * math.log(2.0)
            p_cand = pooled_alpha(cand, t + 1)
            log_eps0 = torch.where(done, log_eps0, cand)
            p = torch.where(done, p, p_cand)

    zero = torch.zeros((T, 1), dtype=torch.float32, device=dev)
    log_step, log_step_avg, grad_avg, count = log_eps0, zero, zero, zero
    mu = math.log(10.0) + log_eps0
    wf = WelfordState(zero, torch.zeros((T, D), device=dev), torch.zeros((T, D), device=dev))
    im = torch.ones((T, D), dtype=torch.float32, device=dev)
    noise_off = _SEARCH_TRIALS + 1 if init_search else 0
    nb = float(bc)
    q = q_start
    for t in range(num_warmup):
        z, u = draw(TAG_WARMUP, t, noise_off + t)
        q, dE, log_u = _guarded_transition(density, q, z, u,
                                           torch.exp(log_step)[..., None],
                                           im[:, None, :], num_leapfrog)
        if margins is not None:
            margins.append((log_u - dE).reshape(C))

        # pooled dual averaging (Stan constants)
        a_mean = _accept_prob(dE).mean(dim=1, keepdim=True)
        count = count + 1.0
        w = 1.0 / (count + 10.0)
        grad_avg = (1.0 - w) * grad_avg + w * (target_accept - a_mean)
        log_step = mu - torch.sqrt(count) / 0.05 * grad_avg
        eta = count ** -0.75
        log_step_avg = eta * log_step + (1.0 - eta) * log_step_avg

        # cross-chain Welford fold (Chan combine) during slow windows
        if ib <= t < num_warmup - fb:
            bm = q.mean(dim=1)
            bm2 = ((q - bm[:, None, :]) ** 2).sum(dim=1)
            n_new = wf.count + nb
            delta = bm - wf.mean
            wf = WelfordState(
                n_new,
                wf.mean + delta * (nb / n_new),
                wf.m2 + bm2 + delta * delta * (wf.count * nb / n_new),
            )

        # window boundary: harvest the metric, restart Welford and dual
        # averaging at the current step size
        if t in resets:
            im = welford_variance(wf, regularize=True)
            wf = WelfordState(zero, torch.zeros_like(wf.mean), torch.zeros_like(wf.m2))
            mu = math.log(10.0) + log_step
            log_step_avg, grad_avg, count = zero, zero, zero

    eps = torch.exp(log_step_avg).expand(T, bc).reshape(C)
    return q.reshape(C, D), eps, im[:, None, :].expand(T, bc, D).reshape(C, D)


_K3_ARGS = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _fused_warmup_cuda(density, q0, seed, initial_step_size, *, num_warmup,
                       num_leapfrog, block_chains, target_accept, init_search, noise,
                       d_pad):
    C, D = q0.shape
    d, n = density.d, density.n
    if not 1 <= d <= 7:
        raise ValueError(f"the CUDA kernel supports 1 <= d <= 7, got d={d}")
    if n * (d + 1) + 2 * d > _SMEM_FLOATS:
        raise ValueError(f"{n} data points do not fit the kernel's shared memory")
    ib, fb, resets = _warmup_schedule(num_warmup)
    if len(resets) > _MAX_RESETS:
        raise ValueError(f"{len(resets)} window boundaries exceed {_MAX_RESETS}")
    dev = q0.device
    mom, unif = noise if noise is not None else (None, None)
    ipv = (1.0 / density.prior_var).contiguous()
    _check_cuda_operands(dev, q0=q0, V=density.V, y=density.y, ipv=ipv,
                         pm=density.prior_mean, mom=mom, unif=unif)
    resets_t = torch.tensor(resets if resets else [0], dtype=torch.int32, device=dev)
    q = torch.empty_like(q0)
    eps = torch.empty(C, dtype=torch.float32, device=dev)
    im = torch.empty_like(q0)
    half_n_plus_a = 0.5 * n + float(density.gamma_shape)
    fn = _build.bind("fused_warmup", "binf_fused_warmup", _K3_ARGS)
    _build.count_launch("fused_warmup", *(() if noise is not None else ("philox",)))
    err = fn(d, _build.ptr(q0), _build.ptr(density.V), _build.ptr(density.y),
             _build.ptr(ipv), _build.ptr(density.prior_mean), n, half_n_plus_a,
             float(density.gamma_rate), C, block_chains, num_warmup, num_leapfrog,
             float(initial_step_size), float(target_accept), int(init_search), ib, fb,
             _build.ptr(resets_t), len(resets), seed & ((1 << 64) - 1),
             _build.nullable_ptr(mom), _build.nullable_ptr(unif), d_pad, _build.ptr(q),
             _build.ptr(eps), _build.ptr(im), _build.stream_ptr(dev))
    _build.check("fused_warmup", err, "fused_warmup launch")
    return q, eps, im


def fused_warmup_run(
    density: LinregDensity,
    q0,
    seed: int,
    initial_step_size: float,
    *,
    num_warmup: int,
    num_leapfrog: int = 10,
    block_chains: int = 512,
    host_noise: bool = False,
    target_accept: float = 0.8,
    init_search: bool = False,
    trajectory: str = "fixed",
    noise=None,
    device=None,
):
    """Stan-style warmup executed inside one kernel.

    Runs ``num_warmup`` adaptation sweeps per chain tile with pooled dual
    averaging (step size driven to ``target_accept`` mean acceptance across
    the tile's chains) and windowed cross-chain Welford mass estimation;
    statistics pool over the ``block_chains`` chains of a tile.
    ``init_search=True`` seeds dual averaging with a Hoffman-Gelman
    doubling search from ``initial_step_size``.

    Returns ``(positions (C, D), step_size (C,), inverse_mass (C, D))``.
    Runs on the card unless ``device="cpu"``.  Noise: Philox by default;
    ``host_noise`` or ``noise=(mom (n, D_pad, C), unif (n, 1, C))`` stage
    it, with ``n = num_warmup`` plus ``21`` search trials first when
    ``init_search`` (the JAX host-noise layout).
    """
    if trajectory == "chees":
        raise NotImplementedError(
            "trajectory='chees' is not ported yet; only 'fixed' trajectories run"
        )
    if trajectory != "fixed":
        raise ValueError(f"unknown trajectory {trajectory!r}")
    dev = resolve_device(device)
    if density.V.device != dev:
        raise ValueError(f"density lives on {density.V.device}, the run on {dev}")
    q0 = _f32(q0, dev)
    C, D = q0.shape
    if D != density.d + 1:
        raise ValueError(f"q0 has {D} columns, the density {density.d + 1}")
    if C % block_chains:
        raise ValueError(f"C={C} must divide by block_chains={block_chains}")
    d_pad = (D + 7) // 8 * 8
    n_noise = num_warmup + (_SEARCH_TRIALS + 1 if init_search else 0)
    staged = staged_noise(noise, host_noise, seed, n_noise, d_pad, C, dev)
    kwargs = dict(num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                  block_chains=block_chains, target_accept=target_accept,
                  init_search=init_search, noise=staged)
    if dev.type == "cuda":
        return _fused_warmup_cuda(density, q0, seed, initial_step_size, d_pad=d_pad,
                                  **kwargs)
    return fused_warmup_plain(density, q0, seed, initial_step_size, **kwargs)
