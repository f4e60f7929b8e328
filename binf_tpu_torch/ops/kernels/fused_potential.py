"""Whole-run HMC for any device density (port of
``binf_tpu/ops/pallas/fused_potential.py``): the Stan-window warmup in one
kernel (K3) and the general sampling run in one kernel (K4), plus the
position packing the fused runs share.

:func:`fused_warmup_run` adapts a step size, a diagonal inverse mass and,
with ``trajectory="chees"``, a mean trajectory length: an optional
Hoffman-Gelman doubling search for the first step size, dual averaging,
a cross-chain Welford metric in Stan's windows and Adam on log T from the
ChEES surrogate gradient, all pooled over the chains of one
``block_chains`` tile.  :func:`fused_potential_hmc_run` then samples with
per-chain step sizes, a diagonal or dense metric, thinning or in-kernel
moments, fixed or ChEES-jittered trajectories and a divergence guard, and
resumes bit for bit from ``block_offset``.

A run on the card is one CUDA kernel (``csrc/fused_warmup.cu``,
``csrc/fused_potential.cu``) instantiated with the density's functor and a
lane-group width G (:func:`lanes_for`: G lanes of a warp share a chain;
past 32 coordinates of a traced density, G = 32 W, a group of W warps),
in the units of ``csrc`` or, for a shape none of them instantiates, in a
unit of its own built at first use (``_build.shape_libraries``);
:func:`kernel_refusal` says whether the kernels take a density at all;
K3 is a cooperative launch over the whole card (:func:`warmup_geometry`),
and each launch leaves its ``_build.LaunchRecord`` in
``_build.last_launch``; on the CPU the plain versions :func:`fused_warmup_plain` and
:func:`fused_potential_hmc_plain` do the same arithmetic in PyTorch.  The
density is a device density (``ops/kernels/densities.py``); on the CPU
any density with ``potential_and_grad`` runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.densities import (
    FAMILIES,
    FAMILY_DIMS,
    KERNEL_DIMS,
    is_device_density,
    operands,
)
from binf_tpu_torch.ops.kernels.fused_hmc import _SMEM_FLOATS, _f32, leapfrog_trajectory
from binf_tpu_torch.ops.kernels.prng import (
    TAG_RUN,
    TAG_SEARCH,
    TAG_WARMUP,
    staged_noise,
    step_noise,
)
from binf_tpu_torch.ops.math import WelfordState, welford_variance
from binf_tpu_torch.samplers.adaptation import _stan_boundaries
from binf_tpu_torch.samplers.chees import halton_sequence

__all__ = [
    "FusedRunResult",
    "PlainTrace",
    "chees_leapfrog_counts",
    "fused_potential_hmc_plain",
    "fused_potential_hmc_run",
    "fused_warmup_geometry",
    "fused_warmup_plain",
    "fused_warmup_run",
    "k4_occupancy",
    "kernel_refusal",
    "lanes_for",
    "pack_positions",
    "pack_template",
    "unpack_draws",
    "warmup_geometry",
]

_SEARCH_TRIALS = 20  # doubling budget of the in-kernel step-size search
_MAX_RESETS = 64  # csrc/fused_warmup.cuh::kMaxResets
_HALTON_LEN = 256  # jitter table of the ChEES trajectories
_TRAJECTORIES = ("fixed", "chees")
LANE_WIDTHS = (1, 2, 4, 8, 16, 32)  # the widths K3's geometry takes (G <= 32, a power of two)
# G of the logistic, AR(1) and mixture branches, from the sweep of G = 1,
# 4, 8, 16, 32 at the families path's shape, and of the hierarchical
# posterior's, from the sweep of G = 1, 2, 4, 8 at its path's
# (scripts/family_lanes.py, PERF.md section 6)
FAMILY_LANES = {"LogisticDensity": 8, "AR1Density": 4, "MixtureDensity": 8,
                "HierarchicalDensity": 4}
# the hierarchical posterior's lanes own whole groups: it takes the widest
# of these that divides its group count, capped at the sweep's choice at 8
# groups (at 16 groups 4 lanes ran K3 + K4 in 96.3 ms, 8 lanes in 110.9:
# chip_smoke.py's family_dims path, NVIDIA H100 80GB HBM3, 700.00 W)
HIER_WIDTHS = (1, 2, FAMILY_LANES["HierarchicalDensity"])
# the widths csrc/densities.cuh::with_density instantiates for each family:
# those four at one lane and at their FAMILY_LANES width
FAMILY_WIDTHS = {"LinregDensity": (1, 2, 4, 8), "DiagGaussianDensity": (1,),
                 **{functor: (1, G) for functor, G in FAMILY_LANES.items()}}
_LANE_FLOATS = 50  # csrc/lanes.cuh::kLaneFloats
K3_THREADS = 256  # csrc/fused_warmup.cuh::kK3Threads
K4_THREADS = 128  # csrc/fused_potential.cuh::kK4Threads
K3_MAX_CTA_TILES = 32  # csrc/fused_warmup.cuh::kMaxCtaTiles (tile states in shared memory)
# the wide branches (csrc/fused_wide.cuh), a traced density past 32
# coordinates: a group of W warps a chain (G = 32 W lanes), three shared
# buffers of D floats a chain and the group's 8 partials
WIDE_LANES = 32
WIDE_WIDTHS = (32, 64, 128, 256)  # W = 1, 2, 4, 8 (K3's CTA holds 8 warps)
WIDE_THREAD_COORDS = 8  # a thread's coordinates, past which a chain takes more warps
_WIDE_CHAIN_BUFFERS = 3
_GROUP_PARTIALS = 8  # csrc/chain_group.cuh::kGroupPartials
_BLOCK_SMEM_FLOATS = 232448 // 4  # a block's shared memory on the card (227 KB, opted into)


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


# -- ChEES and metric helpers ------------------------------------------------


def _halton(device) -> torch.Tensor:
    return torch.tensor(halton_sequence(_HALTON_LEN), dtype=torch.float32, device=device)


def _chees_leapfrog(x: torch.Tensor, max_leapfrog: int) -> torch.Tensor:
    """ceil(x) clipped to [1, max_leapfrog] as csrc/hmc.cuh::chees_leapfrog
    does it: in float32 first, so NaN goes to 1 and infinity to the cap."""
    return torch.clamp(torch.nan_to_num(torch.ceil(x), nan=1.0), 1.0,
                       float(max_leapfrog)).to(torch.int32)


def chees_leapfrog_counts(traj_length: torch.Tensor, eps: torch.Tensor, num_steps: int,
                          max_leapfrog: int):
    """The ChEES leapfrog counts of a sampling run, ``(num_steps, tiles)``
    int32, for per-tile ``traj_length`` and ``eps`` ``(tiles,)``: step t
    runs ``ceil(h[t % 256] * 2 * T / eps)`` clipped to ``[1, max_leapfrog]``
    (``fused_potential.py:409-417``), in float32 in that order.  Also
    returns the float argument of the ceil, whose distance from an integer
    is the margin of each count."""
    h = _halton(traj_length.device)[torch.arange(num_steps, device=traj_length.device)
                                    % _HALTON_LEN]
    x = h[:, None] * 2.0 * traj_length[None, :] / eps[None, :]
    return _chees_leapfrog(x, max_leapfrog), x


def _dense_factor(minv: torch.Tensor) -> torch.Tensor:
    """W with W W^T = M for M^-1 = ``minv``: W = chol(M^-1)^-T, as the JAX
    package computes it outside its kernel (``fused_potential.py:983-993``)."""
    chol = torch.linalg.cholesky(minv)
    eye = torch.eye(minv.shape[0], dtype=minv.dtype, device=minv.device)
    return torch.linalg.solve_triangular(chol.T, eye, upper=True)


def _guard(dE):
    """Divergence guard of ``_hmc_transition``: NaN or |dE| > 1000 rejects."""
    return torch.where(torch.isnan(dE) | (dE.abs() > 1000.0), -math.inf, dE)


def _accept_prob(dE):
    a = torch.clamp_max(torch.exp(torch.clamp_max(dE, 0.0)), 1.0)
    return torch.where(torch.isnan(dE), 0.0, a)


def _check_density(density, D: int, dev):
    if density.D != D:
        raise ValueError(f"positions have {D} coordinates, the density {density.D}")
    for buf in getattr(density, "buffers", lambda: ())():
        if buf.device != dev:
            raise ValueError(f"density lives on {buf.device}, the run on {dev}")


def _check_counts(counts, shape, dev):
    """The kernels write the ChEES leapfrog counts into ``counts`` as int32."""
    if counts is not None and (counts.device != dev or counts.dtype != torch.int32
                               or tuple(counts.shape) != shape or not counts.is_contiguous()):
        raise ValueError(f"leapfrog_counts must be a contiguous int32 tensor of shape "
                         f"{shape} (steps, tiles) on {dev}")


REFUSED = "device density refused by the kernels"


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _is_wide(density) -> bool:
    """Whether K3 and K4 run ``density`` in their wide branches: a traced
    density past 32 coordinates (its wide form, a group of warps a
    chain)."""
    return bool(getattr(density, "wide", False))


def wide_warps(D: int) -> int:
    """W, the warps a chain in the wide branches at D coordinates: the
    fewest (a power of two) that keep a thread's coordinates at
    ``WIDE_THREAD_COORDS``, so one up to D = 256, 2 at D = 261, 4 at 1,024
    and 8 from 1,025, at most the 8 warps of K3's CTA (16 coordinates a
    thread at 4,096)."""
    W = 1
    while W < WIDE_WIDTHS[-1] // WIDE_LANES and D > WIDE_THREAD_COORDS * WIDE_LANES * W:
        W *= 2
    return W


def _wide_chains(kernel: str, W: int) -> int:
    """Chains a CTA of ``kernel``'s wide branch holds at W warps a chain:
    K3's 8 warps, K4's 4 (a CTA of one group at W = 8)."""
    threads = K3_THREADS if kernel == "K3" else max(K4_THREADS, WIDE_LANES * W)
    return threads // (WIDE_LANES * W)


def _shared_need(density, kernel: str) -> int:
    """Floats of dynamic shared memory ``kernel`` ("K3" or "K4") stages for
    this density: its operands, and K4's Halton table and dense metric
    (minv and W, D^2 each, staged whatever the metric: ``csrc/
    fused_potential_kernel.cuh::launch``).  The wide branches
    (``csrc/fused_wide.cuh``) stage the operands (padded to 4), K4 the
    Halton table, and each of a CTA's chains (``_wide_chains``) three
    buffers of D floats (padded) and its group's partials; no dense metric
    (they read it from device memory)."""
    D = density.D
    if _is_wide(density):
        W = max(1, lanes_for(density) // WIDE_LANES)
        chain = _WIDE_CHAIN_BUFFERS * _pad4(D) + _GROUP_PARTIALS
        return (_pad4(density.shared_floats()) + _wide_chains(kernel, W) * chain
                + (_HALTON_LEN if kernel == "K4" else 0))
    return density.shared_floats() + (_HALTON_LEN + 2 * D * D if kernel == "K4" else 0)


def _static_floats(density, kernel: str) -> int:
    """Floats of static shared memory of ``kernel``'s wide branch (K3's
    reduction slots, its chains' acceptances, the window boundaries and
    the Halton table; K4 has none)."""
    if kernel != "K3":
        return 0
    W = max(1, lanes_for(density) // WIDE_LANES)
    return K3_THREADS // 32 + _wide_chains("K3", W) + _MAX_RESETS + _HALTON_LEN


def _refusal(density, kernels) -> tuple[type[Exception], str] | None:
    """The exception and reason of :func:`kernel_refusal`: the density has
    no unit (``NotImplementedError``) or its operands do not fit
    (``ValueError``)."""
    if not is_device_density(density):
        return NotImplementedError, f"{REFUSED}: {type(density).__name__} has no CUDA functor"
    functor, D = density.functor, density.D
    if D not in KERNEL_DIMS[functor]:
        dims = list(KERNEL_DIMS[functor])
        span = (f"{dims[0]}..{dims[-1]}" if dims == list(range(dims[0], dims[-1] + 1))
                else ", ".join(map(str, dims)))
        return NotImplementedError, (f"{REFUSED}: K3 and K4 run {functor} at D in {span}, "
                                     f"not D={D}")
    for kernel in kernels:
        need = _shared_need(density, kernel)
        if _is_wide(density):
            # the operands keep the narrow branches' limit; the chains'
            # buffers come on top, within the block's 227 KB
            ops = _pad4(density.shared_floats())
            if ops > _SMEM_FLOATS:
                return ValueError, (f"{REFUSED}: {kernel} needs {ops} floats of shared memory "
                                    f"for the density's operands, the kernels take "
                                    f"{_SMEM_FLOATS}")
            total = need + _static_floats(density, kernel)
            if total > _BLOCK_SMEM_FLOATS:
                return ValueError, (f"{REFUSED}: {kernel} needs {total} floats of shared "
                                    f"memory for the density's operands and its chains' "
                                    f"buffers, a block takes {_BLOCK_SMEM_FLOATS}")
        elif need > _SMEM_FLOATS:
            extra = (" with its 256 Halton floats and 2 D^2 of metric" if kernel == "K4"
                     else "")
            return ValueError, (f"{REFUSED}: {kernel} needs {need} floats of shared memory for "
                                f"the density's operands{extra}, the kernels take {_SMEM_FLOATS}")
    return None


def kernel_refusal(density, kernels=("K3", "K4")) -> str | None:
    """Why K3 and K4 (or those of ``kernels`` named) would refuse
    ``density`` on the card, or ``None`` when they take it: it is no device
    density; its family has no unit at its D (``densities.KERNEL_DIMS``);
    or its operands, with what the kernel stages beside them, pass the
    ``_SMEM_FLOATS`` floats of shared memory the kernels take (a wide form:
    its operands alone pass them, or with its chains' buffers the block's
    227 KB).  The reason
    starts with ``REFUSED``.  The kernels' wrappers raise with it
    (:func:`refuse`), and the router (``samplers/auto.py``) and the CLI's
    ``chees`` route send such a density to the eager path, so the two
    cannot drift apart."""
    found = _refusal(density, kernels)
    return None if found is None else found[1]


def refuse(density, kernels=("K3", "K4")) -> None:
    """Raise with :func:`kernel_refusal`'s reason if the kernels refuse
    ``density``: ``NotImplementedError`` when it has no functor or its
    family no unit at its D, ``ValueError`` when its operands do not fit.
    Nothing falls back."""
    found = _refusal(density, kernels)
    if found is None:
        return
    error, why = found
    if error is NotImplementedError:
        why += ("; on the card the fused kernels run the device densities of "
                "ops/kernels/densities.py")
    raise error(why)


def _libraries(density, G: int) -> tuple[str, str]:
    """K3's and K4's libraries for this density at width G: the package's,
    where a unit of csrc instantiates (functor, D, G) or where no kernel
    takes G (a lane group is a power of two up to 32 lanes, and the
    hierarchical posterior's lanes own whole groups): their launch refuses
    it with ``cudaErrorInvalidValue``, as they refuse a traced density at
    any width but 1 (a wide one at any but ``WIDE_WIDTHS``); else the
    shape's own, built at first use (a traced density's from its emitted
    header)."""
    functor, D = density.functor, density.D
    traced = density.compiled if functor == "TracedDensity" else None
    if D in FAMILY_DIMS[functor] and G in FAMILY_WIDTHS[functor]:
        return "fused_warmup", "fused_potential"
    if traced is not None and traced.wide:
        if G not in WIDE_WIDTHS:
            return "fused_warmup", "fused_potential"
    elif G not in LANE_WIDTHS or (functor == "HierarchicalDensity" and density.n_groups % G) or (
            traced is not None and G != 1):
        return "fused_warmup", "fused_potential"
    if traced is not None:
        return _build.shape_libraries(FAMILIES[functor], D, G, traced)
    return _build.shape_libraries(FAMILIES[functor], D, G)


# -- launch geometry of K3 and K4 ------------------------------------------------


def lanes_for(density) -> int:
    """G, the lanes of a warp that share one chain in K3 and K4: for the
    linear regression the narrowest of 1, 2, 4, 8 whose lanes hold all n
    data rows in registers (``_LANE_FLOATS`` floats of V and y a lane: G = 2
    at n = 20 and 4 coefficients), else 8; for the logistic regression,
    AR(1) and the mixture the width the card's sweep chose
    (``FAMILY_LANES``); for the hierarchical posterior of NG groups the
    widest of ``HIER_WIDTHS`` that divides NG (a lane owns whole groups: 4
    at 8 groups, the sweep's choice); ``32 * wide_warps(D)`` (a group of
    warps) for a traced density past 32 coordinates (its wide form); 1 for
    a density with no data axis (the diagonal Gaussian) and a traced one
    up to 32."""
    functor = getattr(density, "functor", None)
    if _is_wide(density):
        return WIDE_LANES * wide_warps(density.D)
    if functor == "HierarchicalDensity":
        NG = density.n_groups
        return max(g for g in HIER_WIDTHS if NG % g == 0)
    if functor in FAMILY_LANES:
        return FAMILY_LANES[functor]
    if functor != "LinregDensity":
        return 1
    rows = max(1, _LANE_FLOATS // (density.d + 1))
    widths = FAMILY_WIDTHS["LinregDensity"]
    return next((g for g in widths if -(-density.n // g) <= rows), widths[-1])


class WarmupGeometry(NamedTuple):
    """How K3 lays ``n_chains`` over the card: ``lanes`` G a chain,
    partials of ``slice_chains`` S chains (a CTA round's ``chains_per_cta``,
    halved until S divides the tile; ``slices_per_tile`` a tile),
    ``ctas`` cooperative CTAs of ``chains_per_cta`` chains a round and
    ``rounds`` rounds each (``resident``: one round, every chain in
    registers for the whole run), at most ``tiles_per_cta`` tiles a CTA
    (past ``K3_MAX_CTA_TILES`` their states live in device memory), and
    ``barriers_per_step`` grid barriers a warmup step."""

    lanes: int
    slice_chains: int
    slices_per_tile: int
    chains_per_cta: int
    ctas: int
    rounds: int
    tiles_per_cta: int
    barriers_per_step: int
    resident: bool


def warmup_geometry(n_chains: int, block_chains: int, lanes: int, max_ctas: int, *,
                    trajectory: str = "fixed", cta_cap: int | None = None) -> WarmupGeometry:
    """K3's launch geometry for a card that holds ``max_ctas`` CTAs at once
    (occupancy x SMs); ``cta_cap`` lowers that, for tests.  The grid takes
    as few CTAs as its rounds allow.  Raises ValueError for a
    ``block_chains`` that does not divide ``n_chains``, a width that was not
    instantiated, or a grid that does not fit (no CTA)."""
    if block_chains <= 0 or n_chains % block_chains:
        raise ValueError(f"C={n_chains} must divide by block_chains={block_chains}")
    if lanes not in LANE_WIDTHS + WIDE_WIDTHS[1:]:
        raise ValueError(f"lanes={lanes}: the kernels are instantiated for "
                         f"{LANE_WIDTHS + WIDE_WIDTHS[1:]}")
    limit = max_ctas if cta_cap is None else min(max_ctas, cta_cap)
    if limit < 1:
        raise ValueError(f"the warmup grid does not fit: the card holds {max_ctas} CTAs of "
                         f"the kernel at once (cap {cta_cap})")
    per_cta = K3_THREADS // lanes
    S = per_cta
    while block_chains % S:
        S //= 2
    chunks = -(-n_chains // per_cta)
    rounds = -(-chunks // min(limit, chunks))
    ctas = -(-chunks // rounds)
    span = rounds * per_cta
    lo = np.arange(ctas, dtype=np.int64) * span
    hi = np.minimum(lo + span, n_chains) - 1
    tiles = int((hi // block_chains - lo // block_chains).max()) + 1
    return WarmupGeometry(lanes, S, block_chains // S, per_cta, ctas, rounds, tiles,
                          2 if trajectory == "chees" else 1, rounds == 1)


# -- fused warmup -------------------------------------------------------------


def _warmup_schedule(num_steps, initial_buffer=75, final_buffer=50, first_window=25):
    """Static Stan window schedule ``(initial_buffer, final_buffer, resets)``,
    shared with the eager warmup so both see the same windows."""
    return _stan_boundaries(num_steps, initial_buffer, final_buffer, first_window)


class WarmupTiles(NamedTuple):
    """K3's state between two warmup steps, a row a tile: the positions
    ``q`` (tiles, bc, D); dual averaging's ``log_step``, ``log_step_avg``,
    ``grad_avg``, ``count`` and ``mu`` (tiles, 1); the window's Welford
    state ``wf``; the metric ``im`` (tiles, D); and ChEES's ``log_T``,
    Adam's ``adam_m`` and ``adam_v`` and its step count ``t_chees``
    (tiles, 1)."""

    q: torch.Tensor
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    count: torch.Tensor
    mu: torch.Tensor
    wf: WelfordState
    im: torch.Tensor
    log_T: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    t_chees: torch.Tensor


def fused_warmup_plain(density, q0: torch.Tensor, seed: int, initial_step_size: float, *,
                       num_warmup: int, num_leapfrog: int, block_chains: int,
                       target_accept: float, init_search: bool, trajectory: str = "fixed",
                       max_leapfrog: int = 256, noise=None, margins: list | None = None,
                       leap_args: list | None = None, leapfrog_counts=None, flip=None,
                       follow_counts=None, state: WarmupTiles | None = None,
                       steps: tuple[int, int] | None = None):
    """Plain PyTorch version of the K3 kernel on any device: the same
    arithmetic and the same Philox stream (or the staged ``noise``), every
    tile's statistics kept as one row of a ``(tiles, ...)`` tensor.

    A list passed as ``margins`` receives, per warmup step, ``log u - dE``
    for every chain ``(C,)``: an MH decision can flip under rounding only
    where this is near 0.  With ChEES, ``leap_args`` receives per step the
    argument of each tile's ceil ``(tiles,)`` (a leapfrog count can flip
    only where it is near an integer) and ``leapfrog_counts``, an int32
    tensor ``(num_warmup, tiles)``, the counts.

    So that a check can follow a kernel run through the decisions that
    rounding may take either way: ``flip``, a bool tensor ``(num_warmup,
    C)``, takes those warmup steps' MH decisions the other way, and
    ``follow_counts``, an int tensor ``(num_warmup, tiles)``, gives the
    ChEES leapfrog counts to take instead of the computed ones.  With
    ``steps=(a, b)`` it runs warmup steps a to b - 1 of the ``num_warmup``
    steps' schedule from ``state`` (the state before step a; None: the
    start, after the search) and returns the :class:`WarmupTiles` after
    them: a check restarts it so from a kernel's state step by step."""
    C, D = q0.shape
    bc = block_chains
    T = C // bc
    dev = q0.device
    chees = trajectory == "chees"
    chains = torch.arange(C, dtype=torch.int64, device=dev).reshape(T, bc)
    q_start = q0.reshape(T, bc, D)
    ib, fb, resets = _warmup_schedule(num_warmup)

    def draw(tag, philox_step, staged_step):
        if noise is None:
            return step_noise(seed, tag, chains, philox_step, D)
        mom, unif = noise
        return (mom[staged_step, :D].T.reshape(T, bc, D),
                unif[staged_step, 0].reshape(T, bc))

    def transition(q, eps, im, n_leap, tag, philox_step, staged_step, flip_t=None):
        """MH-corrected guarded trajectory: (next q, dE, log u, end, end
        momentum)."""
        z, u = draw(tag, philox_step, staged_step)
        q_new, dE, p_end = leapfrog_trajectory(density, q, z, eps, im, n_leap)
        dE = _guard(dE)
        log_u = torch.log(torch.clamp_min(u, 1e-30))
        accept = log_u < dE
        if flip_t is not None:
            accept = accept ^ flip_t.reshape(T, bc)
        return torch.where(accept[..., None], q_new, q), dE, log_u, q_new, p_end

    log_eps0 = torch.log(torch.full((T, 1), initial_step_size, dtype=torch.float32,
                                    device=dev))
    if init_search and state is None:
        identity = torch.ones(D, dtype=torch.float32, device=dev)

        def pooled_alpha(log_eps, trial):
            _, dE, *_ = transition(q_start, torch.exp(log_eps)[..., None], identity,
                                   num_leapfrog, TAG_SEARCH, trial, trial)
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
    if state is None:
        # ChEES: log T0 = log 10 + log eps0, and Adam's moments and step count
        state = WarmupTiles(
            q_start, log_eps0, zero, zero, zero, math.log(10.0) + log_eps0,
            WelfordState(zero, torch.zeros((T, D), device=dev), torch.zeros((T, D), device=dev)),
            torch.ones((T, D), dtype=torch.float32, device=dev), math.log(10.0) + log_eps0,
            zero, zero, zero)
    (q, log_step, log_step_avg, grad_avg, count, mu, wf, im, log_T, adam_m, adam_v,
     t_chees) = state
    log_max_leap = float(np.float32(math.log(max_leapfrog)))
    halton = _halton(dev)
    noise_off = _SEARCH_TRIALS + 1 if init_search else 0
    nb = float(bc)
    for t in range(*(steps or (0, num_warmup))):
        eps = torch.exp(log_step)
        n_leap, h = num_leapfrog, 1.0
        if chees:
            h = halton[t % _HALTON_LEN]
            x = (h * 2.0 * torch.exp(log_T) / eps)[:, 0]
            n_leap = _chees_leapfrog(x, max_leapfrog)[:, None]
            if follow_counts is not None:
                n_leap = follow_counts[t].to(n_leap)[:, None]
            if leap_args is not None:
                leap_args.append(x)
            if leapfrog_counts is not None:
                leapfrog_counts[t] = n_leap[:, 0]
        q_old = q
        q, dE, log_u, q_prop, p_end = transition(q, eps[..., None], im[:, None, :], n_leap,
                                                 TAG_WARMUP, t, noise_off + t,
                                                 None if flip is None else flip[t])
        if margins is not None:
            margins.append((log_u - dE).reshape(C))
        alpha = _accept_prob(dE)

        if chees:
            # ChEES surrogate gradient pooled over the tile's chains
            mu_old = q_old.mean(dim=1, keepdim=True)
            mu_new = q_prop.mean(dim=1, keepdim=True)
            qc_new = q_prop - mu_new
            sq_old = ((q_old - mu_old) ** 2).sum(-1)
            sq_new = (qc_new ** 2).sum(-1)
            dots = (qc_new * (p_end * im[:, None, :])).sum(-1)
            per_chain = alpha * (sq_new - sq_old) * dots * h
            per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
            g_T = (per_chain.sum(dim=1, keepdim=True)
                   / torch.clamp_min(alpha.sum(dim=1, keepdim=True), 1e-6))
            g_T = g_T / (g_T.abs() + 1e-10) * torch.tanh(g_T.abs())
            g_T = torch.where(torch.isfinite(g_T), g_T, 0.0)
            t_chees = t_chees + 1.0
            adam_m = 0.9 * adam_m + 0.1 * g_T
            adam_v = 0.999 * adam_v + 0.001 * g_T ** 2
            mhat = adam_m / (1.0 - 0.9 ** t_chees)
            vhat = adam_v / (1.0 - 0.999 ** t_chees)
            log_T = log_T + 0.025 * mhat / (torch.sqrt(vhat) + 1e-8)
            # keep T within [eps, max_leapfrog * eps]
            log_T = torch.minimum(torch.maximum(log_T, log_step), log_step + log_max_leap)

        # pooled dual averaging (Stan constants)
        a_mean = alpha.mean(dim=1, keepdim=True)
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

    if steps is not None:
        return WarmupTiles(q, log_step, log_step_avg, grad_avg, count, mu, wf, im, log_T,
                           adam_m, adam_v, t_chees)
    eps_tile = torch.exp(log_step_avg)
    out = (q.reshape(C, D), eps_tile.expand(T, bc).reshape(C),
           im[:, None, :].expand(T, bc, D).reshape(C, D))
    if not chees:
        return out
    # T clamped to the final averaged step size's band
    T_final = torch.minimum(torch.maximum(torch.exp(log_T), eps_tile),
                            eps_tile * float(max_leapfrog))
    return out + (T_final.expand(T, bc).reshape(C),)


class _WarmupArgs(ctypes.Structure):
    """``csrc/fused_warmup.cuh::WarmupArgs``."""

    _fields_ = [
        ("q0", ctypes.c_void_p), ("n_chains", ctypes.c_int), ("bc", ctypes.c_int),
        ("num_warmup", ctypes.c_int), ("num_leapfrog", ctypes.c_int),
        ("eps0", ctypes.c_float), ("target_accept", ctypes.c_float),
        ("init_search", ctypes.c_int), ("initial_buffer", ctypes.c_int),
        ("final_buffer", ctypes.c_int), ("resets", ctypes.c_void_p),
        ("n_resets", ctypes.c_int), ("seed", ctypes.c_uint64), ("mom", ctypes.c_void_p),
        ("unif", ctypes.c_void_p), ("d_pad", ctypes.c_int), ("chees", ctypes.c_int),
        ("max_leapfrog", ctypes.c_int), ("log_max_leapfrog", ctypes.c_float),
        ("halton", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
        ("leap_out", ctypes.c_void_p), ("q", ctypes.c_void_p), ("eps_out", ctypes.c_void_p),
        ("im_out", ctypes.c_void_p), ("T_out", ctypes.c_void_p), ("slice", ctypes.c_int),
        ("ctas", ctypes.c_int), ("rounds", ctypes.c_int), ("part", ctypes.c_void_p),
        ("bar", ctypes.c_void_p), ("tile_state", ctypes.c_void_p),
        ("tile_state_bytes", ctypes.c_int64),
    ]


# family, D, G, operands, arguments, stream, launched grid
_LAUNCH_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
_occupancy_cache: dict = {}




def _launch(lib: str, fn_name: str, family, D, G, ops, args, dev):
    """Launch through ``fn_name``; returns the reported (CTAs, threads,
    cooperative) or raises with the CUDA error's name."""
    grid = (ctypes.c_int * 3)()
    fn = _build.bind(lib, fn_name, _LAUNCH_ARGS)
    err = fn(family, D, G, ctypes.byref(ops), ctypes.byref(args), _build.stream_ptr(dev), grid)
    _build.check(lib, err, f"{fn_name} launch")
    return grid[0], grid[1], bool(grid[2])


def _occupancy(density, D: int, lanes: int, dev) -> tuple[int, int, int]:
    """CTAs of K3 the card holds at once for this density and width, the
    bytes of one tile's state in device memory, and the kernel's registers
    a thread."""
    refuse(density, ("K3",))
    ops, family, keep = operands(density, dev)
    key = (family, D, lanes, density.shared_floats(), dev.index)
    if key not in _occupancy_cache:
        lib = _libraries(density, lanes)[0]
        fn = _build.bind(lib, "binf_fused_warmup_max_ctas",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            _build.check(lib, fn(family, D, lanes, ctypes.byref(ops), out),
                         "fused_warmup occupancy")
        _occupancy_cache[key] = (out[0], out[1], out[2])
    del keep
    return _occupancy_cache[key]


def k4_occupancy(density, lanes: int, *, dense: bool = False, device=None) -> tuple[int, int]:
    """CTAs of K4 an SM holds at once for this density, width and metric,
    and the kernel's registers a thread (the card's occupancy calculator)."""
    dev = resolve_device(device)
    refuse(density, ("K4",))
    ops, family, keep = operands(density, dev)
    lib = _libraries(density, lanes)[1]
    fn = _build.bind(lib, "binf_fused_potential_occupancy",
                     [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        _build.check(lib, fn(family, density.D, lanes, ctypes.byref(ops), int(dense), out),
                     "fused_potential occupancy")
    del keep
    return out[0], out[1]


def _max_ctas(density, D: int, lanes: int, dev) -> int:
    """CTAs of K3 the card holds at once for this density and width."""
    return _occupancy(density, D, lanes, dev)[0]


def fused_warmup_geometry(density, n_chains: int, block_chains: int, *,
                          trajectory: str = "fixed", cta_cap: int | None = None,
                          device=None) -> WarmupGeometry:
    """The geometry K3 takes on the card for this density and shape."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the warmup kernel's geometry exists on the card only")
    G = lanes_for(density)
    return warmup_geometry(n_chains, block_chains, G, _max_ctas(density, density.D, G, dev),
                           trajectory=trajectory, cta_cap=cta_cap)


def _fused_warmup_cuda(density, q0, seed, initial_step_size, *, num_warmup, num_leapfrog,
                       block_chains, target_accept, init_search, trajectory, max_leapfrog,
                       noise, d_pad, leapfrog_counts=None, cta_cap=None, schedule_steps=None,
                       states_out: list | None = None):
    """``schedule_steps``: run the first ``num_warmup`` steps of a warmup of
    that many steps (its windows); ``states_out`` (the wide branch) receives
    the tiles' states after the last step as a :class:`WarmupTiles`."""
    C, D = q0.shape
    dev = q0.device
    refuse(density, ("K3",))
    ops, family, keep = operands(density, dev)
    geo = fused_warmup_geometry(density, C, block_chains, trajectory=trajectory,
                                cta_cap=cta_cap, device=dev)
    ib, fb, resets = _warmup_schedule(schedule_steps or num_warmup)
    # the kernel's slow windows end at num_warmup - final_buffer
    fb -= (schedule_steps or num_warmup) - num_warmup
    if len(resets) > _MAX_RESETS:
        raise ValueError(f"{len(resets)} window boundaries exceed {_MAX_RESETS}")
    chees = trajectory == "chees"
    mom, unif = noise if noise is not None else (None, None)
    if mom is not None:
        keep += [mom, unif]
    resets_t = torch.tensor(resets if resets else [0], dtype=torch.int32, device=dev)
    q = torch.empty_like(q0)
    eps = torch.empty(C, dtype=torch.float32, device=dev)
    im = torch.empty_like(q0)
    T_out = torch.empty(C, dtype=torch.float32, device=dev) if chees else None
    halton = _halton(dev) if chees else None
    # the wide branch keeps a chain's ChEES values and its tiles' states in
    # device memory whatever the geometry
    wide = _is_wide(density)
    if states_out is not None and not wide:
        raise ValueError("only the wide branch keeps its tiles' states in device memory")
    scratch = (torch.empty(C * (3 * D + 1), dtype=torch.float32, device=dev)
               if chees and (wide or not geo.resident) else None)
    part = torch.empty(2 * (4 * D + 1) * (C // geo.slice_chains), dtype=torch.float32,
                       device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    tile_state, state_bytes = None, 0
    if wide or geo.tiles_per_cta > K3_MAX_CTA_TILES:
        state_bytes = (C // block_chains + geo.ctas) * _occupancy(density, D, geo.lanes, dev)[1]
        tile_state = torch.empty(state_bytes // 4, dtype=torch.float32, device=dev)
    _check_counts(leapfrog_counts, (num_warmup, C // block_chains), dev)
    args = _WarmupArgs(
        _build.ptr(q0), C, block_chains, num_warmup, num_leapfrog, float(initial_step_size),
        float(target_accept), int(init_search), ib, fb, _build.ptr(resets_t), len(resets),
        seed & ((1 << 64) - 1), _build.nullable_ptr(mom), _build.nullable_ptr(unif), d_pad,
        int(chees), max_leapfrog, float(np.float32(math.log(max_leapfrog))),
        _build.nullable_ptr(halton), _build.nullable_ptr(scratch),
        _build.nullable_ptr(leapfrog_counts), _build.ptr(q), _build.ptr(eps), _build.ptr(im),
        _build.nullable_ptr(T_out), geo.slice_chains, geo.ctas, geo.rounds, _build.ptr(part),
        _build.ptr(bar), _build.nullable_ptr(tile_state), state_bytes)
    _build.count_launch("fused_warmup", *(() if noise is not None else ("philox",)))
    ctas, threads, coop = _launch(_libraries(density, geo.lanes)[0], "binf_fused_warmup",
                                  family, D, geo.lanes, ops, args, dev)
    _build.last_launch["fused_warmup"] = _build.LaunchRecord(
        geo.lanes, ctas, threads, coop, geo.rounds, num_warmup,
        _SEARCH_TRIALS + 1 if init_search else 0, bar)
    if states_out is not None:
        states_out.append(_wide_tile_states(tile_state, geo, q, block_chains))
    del keep
    return (q, eps, im) + ((T_out,) if chees else ())


def _wide_tile_states(buf, geo, q, bc) -> WarmupTiles:
    """The tiles' states the wide branch leaves in ``buf``
    (``csrc/fused_warmup_kernel.cuh::WideTile``: 24 scalars, then the
    Welford mean, M2 and metric, D floats each padded to 4): CTA b's copy
    of tile i is state i + b, read from the CTA that holds the tile's first
    chain."""
    C, D = q.shape
    pd = (D + 3) // 4 * 4
    tiles = C // bc
    first = torch.arange(tiles, device=buf.device) * bc
    st = buf.view(-1, 24 + 7 * pd)[torch.arange(tiles, device=buf.device)
                                   + first // (geo.rounds * geo.chains_per_cta)]

    def sc(k):
        return st[:, k:k + 1].clone()

    def vec(j):
        return st[:, 24 + j * pd:24 + j * pd + D].clone()

    return WarmupTiles(q.reshape(tiles, bc, D).clone(), sc(0), sc(1), sc(2), sc(3), sc(4),
                       WelfordState(sc(5), vec(0), vec(1)), vec(2), sc(6), sc(7), sc(8), sc(9))


def wide_warmup_stepwise(density, q0, seed: int, initial_step_size: float, *, num_warmup: int,
                         num_leapfrog: int, block_chains: int, target_accept: float = 0.8,
                         init_search: bool = False, trajectory: str = "fixed",
                         max_leapfrog: int = 256, noise=None, reach: float = 1e-3) -> list:
    """K3's wide branch held to its plain version one warmup step at a time,
    on the card.  The kernel run over the first t steps of the
    ``num_warmup`` steps' schedule, t = 0 to ``num_warmup``, leaves its
    tiles' states in device memory; before step t the plain version
    restarts from the kernel's state, and its state after the step is set
    beside the kernel's.  Rounding may take a plain MH decision within
    ``reach`` of its threshold (``log u - dE``), or a ChEES leapfrog count
    whose argument lies within ``reach`` (relative) of an integer, the
    other way: there the plain version follows the kernel (the decision
    whose position lies nearer the kernel's; the kernel's count).

    Returns a record a step (the first for the start, after the search):
    the largest difference of the positions (``q_abs``) and over the plain
    positions' scale max(1, |q|) (``q``), of the Welford mean likewise
    (``mean``), of the Welford M2 and the metric relative (``m2``,
    ``im``), of dual averaging's and ChEES's scalars over max(1, |plain|)
    (``scalars``; the counts are exact), the decisions and counts followed
    (``followed``) and the counts that differ beyond reach
    (``counts_off``).  The last record
    also holds ``out``: the full run's step size, metric and T against the
    plain version's ending on its final state."""
    dev = q0.device
    C, D = q0.shape
    chees = trajectory == "chees"
    tiles = C // block_chains
    n_noise = num_warmup + (_SEARCH_TRIALS + 1 if init_search else 0)
    staged = staged_noise(noise, False, seed, n_noise, (D + 7) // 8 * 8, C, dev)
    kw = dict(num_leapfrog=num_leapfrog, block_chains=block_chains,
              target_accept=target_accept, init_search=init_search, trajectory=trajectory,
              max_leapfrog=max_leapfrog, noise=staged)

    def kernel(t):
        out = []
        counts = (torch.zeros((t, tiles), dtype=torch.int32, device=dev)
                  if chees and t else None)
        res = _fused_warmup_cuda(density, q0, seed, initial_step_size, num_warmup=t,
                                 d_pad=(D + 7) // 8 * 8, leapfrog_counts=counts,
                                 schedule_steps=num_warmup, states_out=out, **kw)
        return out[0], counts, res

    def plain(state, t, flip=None, follow=None, margins=None, args=None):
        full = None
        if flip is not None:
            full = torch.zeros((num_warmup, C), dtype=torch.bool, device=dev)
            full[t] = flip
        return fused_warmup_plain(density, q0, seed, initial_step_size, num_warmup=num_warmup,
                                  state=state, steps=(t, t + 1), flip=full,
                                  follow_counts=follow, margins=margins, leap_args=args, **kw)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    def diff(k, p):
        scale = max(1.0, float(p.q.abs().max()))
        names = ("log_step", "log_step_avg", "grad_avg", "count", "mu", "log_T", "adam_m",
                 "adam_v", "t_chees")
        sc = max(float(((getattr(k, n) - getattr(p, n)).abs()
                        / getattr(p, n).abs().clamp_min(1.0)).max()) for n in names)
        return {"q_abs": float((k.q - p.q).abs().max()),
                "q": float((k.q - p.q).abs().max()) / scale,
                "mean": float((k.wf.mean - p.wf.mean).abs().max()) / scale,
                "m2": rel(k.wf.m2, p.wf.m2), "im": rel(k.im, p.im),
                "scalars": max(sc, float((k.wf.count - p.wf.count).abs().max()))}

    state, _, _ = kernel(0)
    start = fused_warmup_plain(density, q0, seed, initial_step_size, num_warmup=num_warmup,
                               steps=(0, 0), **kw)
    records = [dict(diff(state, start), followed=0, counts_off=0)]
    for t in range(num_warmup):
        after, counts, res = kernel(t + 1)
        follow = None
        off = followed = 0
        margins, args = [], []
        if chees:
            follow = torch.zeros((num_warmup, tiles), dtype=torch.int32, device=dev)
            follow[t] = counts[t]
        p = plain(state, t, follow=follow, margins=margins, args=args)
        if chees:
            x = args[0]
            near_int = (x - torch.round(x)).abs() <= reach * x.abs().clamp_min(1.0)
            other = _chees_leapfrog(x, max_leapfrog) != counts[t]
            off, followed = int((other & ~near_int).sum()), int((other & near_int).sum())
        near = margins[0].abs() < reach
        if bool(near.any()):
            # the near decisions the other way; each near chain takes the
            # outcome nearer the kernel's position
            q_k = after.q.reshape(C, D)
            p_other = plain(state, t, flip=near, follow=follow)
            d_same = (q_k - p.q.reshape(C, D)).abs().amax(1)
            d_other = (q_k - p_other.q.reshape(C, D)).abs().amax(1)
            flip = near & (d_other < d_same)
            if bool(flip.any()):
                p = p_other if bool((flip == near).all()) else plain(state, t, flip=flip,
                                                                      follow=follow)
            followed += int(flip.sum())
        records.append(dict(diff(after, p), followed=followed, counts_off=off))
        state = after
    # the epilogue: the kernel's outputs against the plain version's ending
    eps_p = torch.exp(state.log_step_avg)
    out = {"eps": float(((res[1].reshape(tiles, -1) - eps_p).abs() / eps_p).max()),
           "im": float(((res[2].reshape(tiles, block_chains, D) - state.im[:, None]).abs()
                        / state.im[:, None]).max())}
    if chees:
        T_p = torch.minimum(torch.maximum(torch.exp(state.log_T), eps_p), eps_p * max_leapfrog)
        out["T"] = float(((res[3].reshape(tiles, -1) - T_p).abs() / T_p).max())
    records[-1]["out"] = out
    return records


def fused_warmup_run(
    density,
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
    max_leapfrog: int = 256,
    noise=None,
    leapfrog_counts=None,
    device=None,
    cta_cap: int | None = None,
):
    """Stan-style warmup executed inside one kernel.

    Runs ``num_warmup`` adaptation sweeps per chain tile with pooled dual
    averaging (step size driven to ``target_accept`` mean acceptance across
    the tile's chains) and windowed cross-chain Welford mass estimation;
    statistics pool over the ``block_chains`` chains of a tile.
    ``init_search=True`` seeds dual averaging with a Hoffman-Gelman
    doubling search from ``initial_step_size``.  ``trajectory="chees"``
    jitters each step's trajectory around a mean length T, adapted by Adam
    on the tile-pooled ChEES criterion from T0 = 10 eps0 and clamped to the
    final step size's band [eps, max_leapfrog * eps] (callers pass
    ``target_accept=0.651``, the ChEES paper's).

    Returns ``(positions (C, D), step_size (C,), inverse_mass (C, D))``,
    and with ChEES also ``traj_length (C,)``.  Runs on the card unless
    ``device="cpu"``; the density is a device density there.  Noise:
    Philox by default; ``host_noise`` or ``noise=(mom (n, D_pad, C), unif
    (n, 1, C))`` stage it, with ``n = num_warmup`` plus ``21`` search
    trials first when ``init_search`` (the JAX host-noise layout).
    ``leapfrog_counts``, an int32 tensor ``(num_warmup, tiles)``, receives
    each step's ChEES leapfrog count per tile.  ``cta_cap`` lowers the
    kernel's grid below what the card holds (for tests: the result does
    not depend on the grid).
    """
    if trajectory not in _TRAJECTORIES:
        raise ValueError(f"unknown trajectory {trajectory!r}; use 'fixed' or 'chees'")
    dev = resolve_device(device)
    q0 = _f32(q0, dev)
    C, D = q0.shape
    _check_density(density, D, dev)
    if C % block_chains:
        raise ValueError(f"C={C} must divide by block_chains={block_chains}")
    d_pad = (D + 7) // 8 * 8
    n_noise = num_warmup + (_SEARCH_TRIALS + 1 if init_search else 0)
    staged = staged_noise(noise, host_noise, seed, n_noise, d_pad, C, dev)
    kwargs = dict(num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                  block_chains=block_chains, target_accept=target_accept,
                  init_search=init_search, trajectory=trajectory,
                  max_leapfrog=max_leapfrog, noise=staged, leapfrog_counts=leapfrog_counts)
    if dev.type == "cuda":
        return _fused_warmup_cuda(density, q0, seed, initial_step_size, d_pad=d_pad,
                                  cta_cap=cta_cap, **kwargs)
    return fused_warmup_plain(density, q0, seed, initial_step_size, **kwargs)


# -- fused sampling (K4) ---------------------------------------------------------


class FusedRunResult(NamedTuple):
    """Output of one fused sampling run.

    ``draws`` is ``(num_steps // thin, C, D)`` (``collect="draws"``) or
    ``None``; ``mean``/``variance`` are streaming Welford moments ``(C, D)``
    over the call's steps (``collect="moments"``) or ``None``;
    ``final_positions`` ``(C, D)`` feeds the next call's ``q0``.
    """

    draws: torch.Tensor | None
    mean: torch.Tensor | None
    variance: torch.Tensor | None
    accept_rate: torch.Tensor
    final_positions: torch.Tensor


class PlainTrace(NamedTuple):
    """Output of :func:`fused_potential_hmc_plain`: the run's result,
    accepted steps per chain ``(C,)`` int32, and ``log u - dE`` per step and
    chain (an MH decision flips under rounding only where this is near 0)."""

    result: FusedRunResult
    accepts: torch.Tensor
    margin: torch.Tensor


def _run_inputs(q0, step_size, inverse_mass, traj_length, *, dense_mass, trajectory,
                block_chains, dev):
    """Per-chain step sizes ``(C,)``, the metric (``(C, D)`` diagonal or
    ``(minv, W)`` dense) and, for ChEES, per-tile T and eps."""
    C, D = q0.shape
    eps = torch.broadcast_to(_f32(step_size, dev).reshape(-1), (C,)).contiguous()
    im = _f32(inverse_mass, dev)
    if dense_mass:
        if im.shape != (D, D):
            raise ValueError(f"dense_mass=True needs a ({D}, {D}) inverse mass, "
                             f"got {tuple(im.shape)}")
        metric = (im, _dense_factor(im).contiguous())
    else:
        if im.dim() == 1:
            im = im[None, :]
        if im.shape[-1] != D:
            raise ValueError(f"inverse_mass must be (D,) or (C, D) with D={D}")
        metric = torch.broadcast_to(im, (C, D)).contiguous()
    tile_T = tile_eps = None
    if trajectory == "chees":
        if traj_length is None:
            raise ValueError("trajectory='chees' needs traj_length=T")
        # per-tile T and eps: the representative first chain of each tile
        T_all = torch.broadcast_to(_f32(traj_length, dev).reshape(-1), (C,))
        tile_T = T_all[::block_chains].contiguous()
        tile_eps = eps[::block_chains].contiguous()
    return eps, metric, tile_T, tile_eps


def _finish(draws, mean, m2, qf, accepts, num_steps, C) -> FusedRunResult:
    accept_rate = accepts.sum(dtype=torch.int64).to(torch.float32) / (num_steps * C)
    variance = None if m2 is None else m2 / max(num_steps - 1.0, 1.0)
    return FusedRunResult(draws, mean, variance, accept_rate, qf)


def fused_potential_hmc_plain(density, q0: torch.Tensor, seed: int, step_size,
                              inverse_mass, *, num_steps: int, num_leapfrog: int = 10,
                              block_chains: int = 512, thin: int = 1,
                              collect: str = "draws", dense_mass: bool = False,
                              trajectory: str = "fixed", max_leapfrog: int = 256,
                              traj_length=None, step_offset: int = 0, noise=None,
                              leapfrog_counts=None) -> PlainTrace:
    """Plain PyTorch version of the K4 kernel on any device: the same
    arithmetic, the same Philox stream from absolute step ``step_offset``
    (or the staged ``noise``), all chains batched."""
    C, D = q0.shape
    dev = q0.device
    eps, metric, tile_T, tile_eps = _run_inputs(
        q0, step_size, inverse_mass, traj_length, dense_mass=dense_mass,
        trajectory=trajectory, block_chains=block_chains, dev=dev)
    counts = None
    if trajectory == "chees":
        counts, _ = chees_leapfrog_counts(tile_T, tile_eps, num_steps, max_leapfrog)
        if leapfrog_counts is not None:
            leapfrog_counts.copy_(counts)
        counts = counts.repeat_interleave(block_chains, dim=1)  # (steps, C)
    chains = torch.arange(C, dtype=torch.int64, device=dev)
    q = q0.clone()
    moments = collect == "moments"
    draws = None if moments else torch.empty((num_steps // thin, C, D), device=dev)
    mean = torch.zeros_like(q) if moments else None
    m2 = torch.zeros_like(q) if moments else None
    margin = torch.empty((num_steps, C), dtype=torch.float32, device=dev)
    accepts = torch.zeros(C, dtype=torch.int32, device=dev)
    for t in range(num_steps):
        if noise is not None:
            z, u = noise[0][t, :D].T, noise[1][t, 0]
        else:
            z, u = step_noise(seed, TAG_RUN, chains, step_offset + t, D)
        n_leap = num_leapfrog if counts is None else counts[t]
        q_new, dE, _ = leapfrog_trajectory(density, q, z, eps[:, None], metric, n_leap)
        dE = _guard(dE)
        log_u = torch.log(torch.clamp_min(u, 1e-30))
        accept = log_u < dE
        q = torch.where(accept[:, None], q_new, q)
        margin[t] = log_u - dE
        accepts += accept.to(torch.int32)
        if moments:
            delta = q - mean
            mean = mean + delta / float(t + 1)
            m2 = m2 + delta * (q - mean)
        elif t % thin == thin - 1:
            draws[t // thin] = q
    return PlainTrace(_finish(draws, mean, m2, q, accepts, num_steps, C), accepts, margin)


class _RunArgs(ctypes.Structure):
    """``csrc/fused_potential.cuh::RunArgs``."""

    _fields_ = [
        ("q0", ctypes.c_void_p), ("eps", ctypes.c_void_p), ("im", ctypes.c_void_p),
        ("W", ctypes.c_void_p), ("n_chains", ctypes.c_int), ("num_steps", ctypes.c_int),
        ("num_leapfrog", ctypes.c_int), ("thin", ctypes.c_int), ("moments", ctypes.c_int),
        ("dense", ctypes.c_int), ("chees", ctypes.c_int), ("bc", ctypes.c_int),
        ("max_leapfrog", ctypes.c_int), ("step_offset", ctypes.c_uint32),
        ("seed", ctypes.c_uint64), ("T_tile", ctypes.c_void_p),
        ("eps_tile", ctypes.c_void_p), ("halton", ctypes.c_void_p), ("mom", ctypes.c_void_p),
        ("unif", ctypes.c_void_p), ("d_pad", ctypes.c_int), ("draws", ctypes.c_void_p),
        ("mean", ctypes.c_void_p), ("m2", ctypes.c_void_p), ("qf", ctypes.c_void_p),
        ("accepts", ctypes.c_void_p), ("leap_out", ctypes.c_void_p),
    ]


def _fused_potential_cuda(density, q0, seed, eps, metric, tile_T, tile_eps, *, num_steps,
                          num_leapfrog, block_chains, thin, collect, trajectory,
                          max_leapfrog, step_offset, noise, d_pad, leapfrog_counts=None):
    C, D = q0.shape
    dev = q0.device
    refuse(density, ("K4",))
    ops, family, keep = operands(density, dev)
    dense = isinstance(metric, tuple)
    if not 0 <= step_offset + num_steps <= 0xFFFFFFFF:
        raise ValueError("the absolute step exceeds the Philox counter's 32 bits")
    mom, unif = noise if noise is not None else (None, None)
    im, W = metric if dense else (metric, None)
    moments = collect == "moments"
    chees = trajectory == "chees"
    halton = _halton(dev) if chees else None
    keep += [q0, eps, im, W, mom, unif, tile_T, tile_eps, halton]
    draws = None if moments else torch.empty((num_steps // thin, C, D), device=dev)
    mean = torch.empty_like(q0) if moments else None
    m2 = torch.empty_like(q0) if moments else None
    qf = torch.empty_like(q0)
    accepts = torch.empty(C, dtype=torch.int32, device=dev)
    _check_counts(leapfrog_counts, (num_steps, C // block_chains), dev)
    args = _RunArgs(
        _build.ptr(q0), _build.ptr(eps), _build.ptr(im), _build.nullable_ptr(W), C,
        num_steps, num_leapfrog, thin, int(moments), int(dense), int(chees), block_chains,
        max_leapfrog, step_offset, seed & ((1 << 64) - 1), _build.nullable_ptr(tile_T),
        _build.nullable_ptr(tile_eps), _build.nullable_ptr(halton), _build.nullable_ptr(mom),
        _build.nullable_ptr(unif), d_pad, _build.nullable_ptr(draws),
        _build.nullable_ptr(mean), _build.nullable_ptr(m2), _build.ptr(qf),
        _build.ptr(accepts), _build.nullable_ptr(leapfrog_counts))
    G = lanes_for(density)
    lib = _libraries(density, G)[1]
    _build.count_launch("fused_potential_hmc", *(() if noise is not None else ("philox",)))
    ctas, threads, coop = _launch(lib, "binf_fused_potential_hmc", family, D, G, ops, args, dev)
    _build.last_launch["fused_potential_hmc"] = _build.LaunchRecord(
        G, ctas, threads, coop, 1, num_steps, 0, None)
    del keep
    return _finish(draws, mean, m2, qf, accepts, num_steps, C)


def fused_potential_hmc_run(
    density,
    q0,
    seed: int,
    step_size,
    inverse_mass,
    *,
    num_steps: int,
    num_leapfrog: int = 10,
    block_chains: int = 512,
    steps_per_block: int = 50,
    host_noise: bool = False,
    thin: int = 1,
    collect: str = "draws",
    dense_mass: bool = False,
    trajectory: str = "fixed",
    max_leapfrog: int = 256,
    traj_length=None,
    block_offset: int = 0,
    noise=None,
    leapfrog_counts=None,
    device=None,
) -> FusedRunResult:
    """Run ``num_steps`` fused HMC sweeps of ``exp(-U)`` for a device
    density; returns a :class:`FusedRunResult`.

    ``step_size`` is a scalar or per chain ``(C,)``; ``inverse_mass`` a
    diagonal ``(D,)`` or ``(C, D)``, or with ``dense_mass`` a full
    ``(D, D)`` matrix shared by all chains (momenta ``p = W z`` with
    ``W = chol(M^-1)^-T``).  ``thin`` keeps every thin-th state;
    ``collect="moments"`` accumulates per-chain Welford mean and variance
    over the call's steps instead of storing draws.  Every step rejects on
    NaN or |dE| > 1000.  ``trajectory="chees"`` runs ``ceil(h_t * 2T /
    eps)`` leapfrog steps at step t, clipped to ``[1, max_leapfrog]``, with
    ``traj_length`` T (scalar or per chain) and eps read from the first
    chain of each ``block_chains`` tile.

    ``block_offset``: the Philox stream is indexed by the absolute step
    ``block_offset * steps_per_block + t``, so calls chained through
    ``final_positions`` -> ``q0`` with ``block_offset += num_steps //
    steps_per_block`` reproduce one uninterrupted call bit for bit;
    ``steps_per_block`` has no other role.  Noise: Philox by default;
    ``host_noise`` or ``noise=(mom (num_steps, D_pad, C), unif (num_steps,
    1, C))`` stage it (the JAX host-noise layout).  ``leapfrog_counts``, an
    int32 tensor ``(num_steps, tiles)``, receives the ChEES leapfrog counts.
    Runs on the card unless ``device="cpu"``.
    """
    if collect not in ("draws", "moments"):
        raise ValueError(f"unknown collect={collect!r}")
    if trajectory not in _TRAJECTORIES:
        raise ValueError(f"unknown trajectory={trajectory!r}; use 'fixed' or 'chees'")
    dev = resolve_device(device)
    q0 = _f32(q0, dev)
    C, D = q0.shape
    _check_density(density, D, dev)
    if C % block_chains or num_steps % steps_per_block or steps_per_block % thin:
        raise ValueError("C must divide by block_chains, num_steps by steps_per_block "
                         "and steps_per_block by thin")
    d_pad = (D + 7) // 8 * 8
    staged = staged_noise(noise, host_noise, seed, num_steps, d_pad, C, dev)
    step_offset = block_offset * steps_per_block
    kwargs = dict(num_steps=num_steps, num_leapfrog=num_leapfrog, block_chains=block_chains,
                  thin=thin, collect=collect, trajectory=trajectory,
                  max_leapfrog=max_leapfrog, step_offset=step_offset, noise=staged,
                  leapfrog_counts=leapfrog_counts)
    if dev.type == "cuda":
        eps, metric, tile_T, tile_eps = _run_inputs(
            q0, step_size, inverse_mass, traj_length, dense_mass=dense_mass,
            trajectory=trajectory, block_chains=block_chains, dev=dev)
        return _fused_potential_cuda(density, q0, seed, eps, metric, tile_T, tile_eps,
                                     d_pad=d_pad, **kwargs)
    return fused_potential_hmc_plain(density, q0, seed, step_size, inverse_mass,
                                     dense_mass=dense_mass, traj_length=traj_length,
                                     **kwargs).result
