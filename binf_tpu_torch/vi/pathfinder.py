"""Pathfinder variational inference (Zhang, Carpenter, Gelman & Vehtari,
JMLR 2022, arXiv:2108.03782; port of ``binf_tpu/vi/pathfinder.py``).

Follows an L-BFGS optimisation path toward the posterior mode, builds a
local Gaussian approximation N(theta_l, H_l) at every point of it (H_l the
inverse-Hessian estimate of the path's curvature pairs), scores each by a
Monte-Carlo ELBO and keeps the best one a path.  Several paths pool their
draws by truncated importance resampling against the path mixture.  Its
main use is to start HMC chains inside the typical set
(:func:`pathfinder_init`).

The reference takes the path from ``optax.lbfgs(memory_size=history)``:
the two-loop recursion with the first step's scale ``min(1, 1 / |g|)``
and then ``s.y / y.y``, and ``scale_by_zoom_linesearch`` (Nocedal and
Wright's Algorithms 3.5 and 3.6 with Hager and Zhang's approximate
sufficient decrease, at most 20 evaluations, first guess 1).  PyTorch has
no twin of either (``torch.optim.LBFGS`` searches differently), so both are
written here after optax's own, over all paths at once: each line-search
evaluation is one batched call of the log density, and a path whose search
has ended is held by masks while the others go on.  Positions flatten to
one ``(D,)`` vector (``samplers.dense.flatten_spec``'s order); the inverse
Hessian is materialised densely at every point of the path.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.diagnostics.model_comparison import _fit_pareto_k
from binf_tpu_torch.ops.math import log_sum_exp
from binf_tpu_torch.samplers.dense import flatten_spec
from binf_tpu_torch.vi._common import LOG_2PI, cholesky_or_nan, generator, value_and_grad

__all__ = ["PathfinderResult", "pathfinder", "pathfinder_init"]

# optax.lbfgs's line search: scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one") at its defaults
_LS_STEPS = 20
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE_FACTOR = 2.0


class PathfinderResult(NamedTuple):
    """``samples``: position-dict draws ``(num_draws, ...)`` resampled from
    the path mixture; ``elbo``: (num_paths,) best ELBO per path;
    ``mean``/``chol``: (num_paths, D[, D]) best Gaussian per path;
    ``pareto_k``: tail-shape diagnostic of the importance weights
    (< 0.7 good)."""

    samples: dict
    elbo: torch.Tensor
    mean: torch.Tensor
    chol: torch.Tensor
    pareto_k: torch.Tensor


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _bfgs_inverse_hessian(S, Y, valid, gamma, jitter=1e-6):
    """Dense inverse Hessian from a (..., J, D) history of update/gradient-
    difference pairs: H0 = gamma I, then for each valid pair (oldest first)
    H <- (I - rho s y^T) H (I - rho y s^T) + rho s s^T.

    Callers must pass the pairs in CHRONOLOGICAL order (oldest first): the
    recursion weights recent curvature pairs most strongly."""
    d = S.shape[-1]
    eye = torch.eye(d, dtype=S.dtype, device=S.device)
    gamma = torch.as_tensor(gamma, dtype=S.dtype, device=S.device)
    H = gamma[..., None, None] * eye
    for j in range(S.shape[-2]):
        s, y, v = S[..., j, :], Y[..., j, :], valid[..., j]
        rho = (1.0 / torch.clamp_min(_dot(s, y), 1e-12))[..., None, None]
        Hy = (H @ y[..., None])[..., 0]
        ss = s[..., :, None] * s[..., None, :]
        # (I - rho s y^T) H (I - rho y s^T) + rho s s^T, expanded:
        H_new = (H - rho * (s[..., :, None] * Hy[..., None, :] + Hy[..., :, None] * s[..., None, :])
                 + rho * rho * _dot(y, Hy)[..., None, None] * ss
                 + rho * ss)
        H = torch.where(v[..., None, None], H_new, H)
    return H + jitter * eye


def _gauss_logq(x, mu, chol):
    """log N(x; mu, chol chol^T) for x of shape (..., D)."""
    diff = x - mu
    d = diff.shape[-1]
    z = torch.linalg.solve_triangular(chol, diff.reshape(-1, d).T, upper=False).T
    return (-0.5 * _dot(z, z).reshape(diff.shape[:-1])
            - torch.sum(torch.log(torch.diagonal(chol)))
            - 0.5 * d * LOG_2PI)


def _lbfgs_direction(grad, mem_dw, mem_du, rho, scale, memory_idx: int):
    """The two-loop recursion (optax's ``_precondition_by_lbfgs``): the
    inverse-Hessian estimate of the memory (``(P, m, D)`` pairs, weights
    ``rho``, oldest at ``memory_idx``) times ``grad``."""
    m = rho.shape[-1]
    order = [(memory_idx + i) % m for i in range(m)]
    vec, alphas = grad, {}
    for i in reversed(order):
        alphas[i] = rho[:, i] * _dot(mem_dw[:, i], vec)
        vec = vec + (-alphas[i])[:, None] * mem_du[:, i]
    vec = scale[:, None] * vec
    for i in order:
        beta = rho[:, i] * _dot(mem_du[:, i], vec)
        vec = vec + (alphas[i] - beta)[:, None] * mem_dw[:, i]
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb = fb - fa - C * db
    rc = fc - fa - C * dc
    A = (dc ** 2 * rb + (-(db ** 2)) * rc) / denom
    B = ((-(dc ** 3)) * rb + db ** 3 * rc) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = torch.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                           value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init))
    err = torch.clamp_min(torch.minimum(approx, err), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _select(mask, a: dict, b: dict) -> dict:
    """``a`` where ``mask`` (one entry a path), else ``b``, key by key."""
    return {k: torch.where(mask.reshape(mask.shape + (1,) * (v.dim() - 1)), v, b[k])
            for k, v in a.items()}


def _zoom_linesearch(vg, params, updates, value, grad):
    """optax's zoom line search along ``updates`` from ``params`` for every
    path at once; returns ``(stepsize, value, grad)`` at the step taken."""
    zeros = torch.zeros_like(value)
    inf = torch.full_like(value, torch.inf)
    false = torch.zeros_like(value, dtype=torch.bool)
    slope = _dot(updates, grad)
    value_init, slope_init = value, slope
    st = dict(stepsize=zeros, value=value, grad=grad, slope=slope, decrease_error=inf,
              curvature_error=inf, interval_found=false, done=false, failed=false,
              low=zeros, value_low=value, slope_low=slope, high=zeros, value_high=value,
              slope_high=slope, cubic_ref=zeros, value_cubic_ref=value, safe_stepsize=zeros,
              safe_value=value, safe_grad=grad)
    for it in range(_LS_STEPS):
        active = ~(st["done"] | st["failed"])
        if not bool(active.any()):
            break
        # the search for an interval: the first guess, then doubling
        search_step = (torch.ones_like(zeros) if it == 0
                       else _INCREASE_FACTOR * st["stepsize"])
        # the zoom into it: cubic, else quadratic, else bisection
        low, high = st["low"], st["high"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        middle_cubic = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"],
                                 st["cubic_ref"], st["value_cubic_ref"])
        use_cubic = (middle_cubic > left + 0.2 * delta) & (middle_cubic < right - 0.2 * delta)
        middle_quad = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
        use_quad = ~use_cubic & (middle_quad > left + 0.1 * delta) & (
            middle_quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, middle_cubic, st["cubic_ref"])
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)

        step = torch.where(st["interval_found"], middle, search_step)
        v, g = vg(params + step[:, None] * updates)
        sl = _dot(g, updates)
        dec = _decrease_error(step, v, sl, value_init, slope_init)
        curv = _curvature_error(sl, slope_init)
        err = torch.maximum(dec, curv)
        done = err <= 0.0
        common = dict(stepsize=step, value=v, grad=g, slope=sl, decrease_error=dec,
                      curvature_error=curv, done=done)

        # Algorithm 3.5: the interval search
        safe = _select(dec <= 0.0, dict(safe_stepsize=step, safe_value=v, safe_grad=g),
                       {k: st[k] for k in ("safe_stepsize", "safe_value", "safe_grad")})
        high_to_new = (dec > 0.0) | ((v >= st["value"]) & (it > 0))
        low_to_new = (sl >= 0.0) & ~high_to_new
        prev = (st["stepsize"], st["value"], st["slope"])
        new = (step, v, sl)
        lows = [torch.where(low_to_new, n, p) for n, p in zip(new, prev)]
        highs = [torch.where(low_to_new, p, n) for n, p in zip(new, prev)]
        search = dict(common, **safe, interval_found=high_to_new | low_to_new | done,
                      failed=(it + 1 >= _LS_STEPS) & ~done,
                      low=lows[0], value_low=lows[1], slope_low=lows[2],
                      high=highs[0], value_high=highs[1], slope_high=highs[2],
                      cubic_ref=lows[0], value_cubic_ref=lows[1])

        # Algorithm 3.6: the zoom
        safe = _select((dec <= 0.0) & (v < st["safe_value"]),
                       dict(safe_stepsize=step, safe_value=v, safe_grad=g),
                       {k: st[k] for k in ("safe_stepsize", "safe_value", "safe_grad")})
        high_to_middle = (dec > 0.0) | (v >= st["value_low"])
        high_to_low = (sl * (high - low) >= 0.0) & ~high_to_middle
        cur_low = (low, st["value_low"], st["slope_low"])
        cur_high = (high, st["value_high"], st["slope_high"])
        highs = [torch.where(high_to_low, lo, torch.where(high_to_middle, n, h))
                 for n, lo, h in zip(new, cur_low, cur_high)]
        lows = [torch.where(~high_to_middle, n, lo) for n, lo in zip(new, cur_low)]
        moved_high = high_to_middle | high_to_low
        too_small = delta <= _INTERVAL_THRESHOLD
        zoom = dict(common, **safe, interval_found=st["interval_found"],
                    failed=((it + 1 >= _LS_STEPS) | (too_small & (safe["safe_stepsize"] > 0.0)))
                    & ~done,
                    low=lows[0], value_low=lows[1], slope_low=lows[2],
                    high=highs[0], value_high=highs[1], slope_high=highs[2],
                    cubic_ref=torch.where(moved_high, high, low),
                    value_cubic_ref=torch.where(moved_high, st["value_high"], st["value_low"]))

        new_st = _select(st["interval_found"], zoom, search)
        # a failed search falls back to the best step of sufficient decrease
        use_safe = new_st["failed"] & ((new_st["safe_stepsize"] > 0.0)
                                       | torch.isinf(new_st["decrease_error"]))
        new_st.update(_select(use_safe, dict(stepsize=new_st["safe_stepsize"],
                                             value=new_st["safe_value"],
                                             grad=new_st["safe_grad"]),
                              {k: new_st[k] for k in ("stepsize", "value", "grad")}))
        st = _select(active, new_st, st)
    return st["stepsize"], st["value"], st["grad"]


def _flat_value_and_grad(logdensity_fn: Callable, unpack):
    """``theta (N, D) -> -log p (N,)`` and ``theta -> (-log p, its gradient
    (N, D))``, ``logdensity_fn`` mapped over the rows."""
    mapped = torch.func.vmap(logdensity_fn)

    def nld(theta):
        return -mapped(unpack(theta))

    return nld, value_and_grad(nld)


def _paths(nld, vg, thetas0, noise, history: int):
    """Every path's L-BFGS trajectory from ``thetas0`` (P, D), the step-``l``
    ELBO's normals ``noise[:, l]`` (P, max_iters, S, D).  Returns each
    point's mean (P, T, D), Cholesky factor (P, T, D, D) and ELBO (P, T)."""
    P, d = thetas0.shape
    T = noise.shape[1]
    dev, f32 = thetas0.device, thetas0.dtype
    params = thetas0
    value, grad = vg(params)
    # the optimiser's state: its curvature memory and its last point
    mem_dw = torch.zeros((P, history, d), dtype=f32, device=dev)
    mem_du = torch.zeros_like(mem_dw)
    rho = torch.zeros((P, history), dtype=f32, device=dev)
    prev_params, prev_grad = torch.zeros_like(params), torch.zeros_like(params)
    # the path's history of accepted pairs, its write cursor t
    S = torch.zeros((P, history, d), dtype=f32, device=dev)
    Y = torch.zeros_like(S)
    valid = torch.zeros((P, history), dtype=torch.bool, device=dev)
    t = torch.zeros((P,), dtype=torch.long, device=dev)
    mus, chols, elbos = [], [], []
    for step in range(T):
        # value_and_grad_from_state: the line search's value where finite
        stale = ~torch.isfinite(value)
        if bool(stale.any()):
            fresh_v, fresh_g = vg(params)
            value = torch.where(stale, fresh_v, value)
            grad = torch.where(stale[:, None], fresh_g, grad)

        # scale_by_lbfgs: the memory pair of the last move, then the scale
        prev_idx = (step - 1) % history
        if step > 0:
            dw, du = params - prev_params, grad - prev_grad
            vd = _dot(du, dw)
            weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
            den = _dot(du, du)
            scale = torch.where(den > 0.0, vd / den, 1.0)
        else:
            dw, du = torch.zeros_like(params), torch.zeros_like(params)
            weight = torch.zeros_like(value)
            scale = torch.minimum(torch.ones_like(value),
                                  1.0 / torch.linalg.vector_norm(grad, dim=-1))
        mem_dw[:, prev_idx], mem_du[:, prev_idx], rho[:, prev_idx] = dw, du, weight
        direction = -_lbfgs_direction(grad, mem_dw, mem_du, rho, scale, step % history)
        prev_params, prev_grad = params, grad

        lr, new_value, new_grad = _zoom_linesearch(vg, params, direction, value, grad)
        new_params = params + lr[:, None] * direction

        # the history pair of this move (curvature condition s^T y > 0); the
        # cursor advances only on accepted pairs, so a rejected move leaves
        # no stale pair in the newest slot
        s = new_params - params
        y = new_grad - grad
        sy = _dot(s, y)
        ok = sy > 1e-12
        slot = t % history
        rows = torch.arange(P, device=dev)
        S[rows, slot] = torch.where(ok[:, None], s, S[rows, slot])
        Y[rows, slot] = torch.where(ok[:, None], y, Y[rows, slot])
        valid[rows, slot] = valid[rows, slot] | ok
        t = t + ok.long()
        gamma = torch.where(ok, sy / torch.clamp_min(_dot(y, y), 1e-12), 1.0)
        # the circular buffer in chronological order: t points one past the
        # newest accepted pair
        idx = (t[:, None] + torch.arange(history, device=dev)) % history
        H = _bfgs_inverse_hessian(S[rows[:, None], idx], Y[rows[:, None], idx],
                                  valid[rows[:, None], idx], gamma)
        chol = cholesky_or_nan(H)

        # MC ELBO of N(new_params, H)
        z = noise[:, step]
        xs = new_params[:, None, :] + z @ chol.transpose(-1, -2)
        logp = -nld(xs.reshape(-1, d)).reshape(z.shape[:2])
        logq = (-0.5 * _dot(z, z)
                - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)[:, None]
                - 0.5 * d * LOG_2PI)
        elbo = torch.mean(logp - logq, dim=-1)
        elbo = torch.where(torch.isfinite(elbo) & torch.isfinite(chol).all(dim=(-2, -1)),
                           elbo, -torch.inf)
        mus.append(new_params)
        chols.append(chol)
        elbos.append(elbo)
        params, value, grad = new_params, new_value, new_grad
    return torch.stack(mus, 1), torch.stack(chols, 1), torch.stack(elbos, 1)


def pathfinder(
    logdensity_fn: Callable,
    initial_positions: dict,
    key,
    num_draws: int = 1000,
    max_iters: int = 60,
    history: int = 6,
    elbo_samples: int = 16,
    draws_per_path: int | None = None,
    device=None,
) -> PathfinderResult:
    """Multi-path Pathfinder over a position dict.

    ``initial_positions`` is chain-batched: each row seeds one path
    (typically 4-16 overdispersed points).  ``logdensity_fn`` takes an
    UNBATCHED position dict in unconstrained space (it is mapped over the
    paths with ``torch.func.vmap``).  Draws are pooled with truncated
    importance resampling against the path mixture.  The truncation bound
    is S^{3/4} * mean(w), a deliberately looser bound than standard TIS
    (Ionides 2008 truncates at sqrt(S) * mean(w)), trading a little
    variance for less bias; ``pareto_k`` reports the untruncated tail shape
    (``+inf`` when every path failed and the draws were resampled
    uniformly).  ``key`` is an int seed or a ``torch.Generator`` on the
    fit's device.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = generator(key, dev)
    positions = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                 for k, v in initial_positions.items()}
    template = {k: v[0] for k, v in positions.items()}
    pack, unpack, d = flatten_spec(template)
    thetas0 = pack(positions)  # (P, D)
    num_paths = thetas0.shape[0]
    if draws_per_path is None:
        draws_per_path = max(num_draws // num_paths, 32)
    nld, vg = _flat_value_and_grad(logdensity_fn, unpack)

    noise = torch.randn((num_paths, max_iters, elbo_samples, d), generator=gen, device=dev)
    mus_path, chols_path, elbos_path = _paths(nld, vg, thetas0, noise, history)
    best = torch.argmax(elbos_path, dim=1)
    rows = torch.arange(num_paths, device=dev)
    mus, chols, elbos = mus_path[rows, best], chols_path[rows, best], elbos_path[rows, best]

    # pooled draws + truncated importance resampling against the mixture
    z = torch.randn((num_paths, draws_per_path, d), generator=gen, device=dev)
    xs = (mus[:, None, :] + torch.einsum("pkd,ped->pke", z, chols)).reshape(-1, d)
    logp = -nld(xs)
    # mixture log q, weighting paths equally (non-finite paths excluded)
    path_ok = torch.isfinite(elbos)
    lqs = torch.stack([_gauss_logq(xs, mus[p], chols[p]) for p in range(num_paths)], dim=1)
    lqs = torch.where(path_ok, lqs, -torch.inf)
    logq = log_sum_exp(lqs, axis=1) - math.log(max(int(path_ok.sum()), 1))
    log_w = logp - logq
    log_w = torch.where(torch.isfinite(log_w), log_w, -torch.inf)
    log_w = log_w - torch.max(log_w)
    w = torch.exp(log_w)
    s = w.shape[0]
    w_t = torch.minimum(w, (float(s) ** 0.75) * torch.mean(w))
    pareto_k = _fit_pareto_k(w)

    # degenerate guard: if every draw got weight 0 (all paths non-finite),
    # resample uniformly rather than from NaN probabilities; pareto_k is
    # then +inf so callers can detect it
    total = torch.sum(w_t)
    degenerate = ~torch.isfinite(total) | (total <= 0.0)
    p = torch.where(degenerate, torch.ones_like(w_t) / s,
                    w_t / torch.where(degenerate, 1.0, total))
    pareto_k = torch.where(degenerate, torch.inf, pareto_k)

    idx = torch.multinomial(p, num_draws, replacement=True, generator=gen)
    return PathfinderResult(samples=unpack(xs[idx]), elbo=elbos, mean=mus, chol=chols,
                            pareto_k=pareto_k)


def pathfinder_init(
    logdensity_fn: Callable,
    initial_positions: dict,
    key,
    n_chains: int,
    **kwargs,
) -> dict:
    """Draw ``n_chains`` HMC starting positions from a pathfinder fit: the
    standard warmup accelerator (chains start inside the typical set, so the
    sampler's initial buffer can be short)."""
    fit = pathfinder(logdensity_fn, initial_positions, key, num_draws=n_chains, **kwargs)
    return fit.samples
