"""Elliptical and random-direction slice sampling
(``binf_tpu_torch/samplers/slice.py``) against the JAX package's
``binf_tpu/samplers/slice.py``, on the CPU.

Deterministic: the test replays the JAX step's key splits, hands the port
the same normals and uniforms (``elliptical_slice_from_draws``,
``slice_from_draws``), and holds the whole step to the JAX kernel's: the
point on the ellipse, the bracket (its step-out count, its shrinks and
the final width), the new position and log density, at 1e-5 relative
(float32 rounding of the same formulas; atol 1e-5 near 0).  Statistical:
the JAX tests' bounds (``tests/test_slice.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.tree import tree_normal_like
from binf_tpu.samplers.slice import elliptical_slice as jax_elliptical
from binf_tpu.samplers.slice import slice_sampler as jax_slice
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.samplers.slice import (EllipticalSliceState, SliceState, elliptical_slice,
                                           elliptical_slice_from_draws, point_on_ellipse,
                                           slice_from_draws, slice_sampler)

RTOL = ATOL = 1e-5
C = 16
MAX_SHRINK = 32
RHO = 0.8
PREC = np.linalg.inv(np.array([[1.0, RHO], [RHO, 1.0]])).astype(np.float32)


def jax_correlated(pos):
    v = pos["v"]
    return -0.5 * v @ jnp.asarray(PREC) @ v


def correlated(pos):
    v = pos["v"]
    return -0.5 * ((v @ torch.tensor(PREC)) * v).sum(-1)


def _shrink_uniforms(key, n=MAX_SHRINK):
    """The standard uniforms of a JAX shrinkage loop's draws."""
    out = []
    for _ in range(n):
        key, k_draw = jax.random.split(key)
        out.append(jax.random.uniform(k_draw, ()))
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_elliptical_step_matches_jax(seed):
    y, s2 = 1.2, 0.5
    mean, scale = np.array([0.3, -0.2], np.float32), np.array([1.0, 0.5], np.float32)
    jk = jax_elliptical(lambda p: -0.5 * jnp.sum((p["x"] - y) ** 2) / s2,
                        {"x": jnp.asarray(mean)}, {"x": jnp.asarray(scale)})
    x0 = np.random.default_rng(seed).normal(size=(C, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), C)
    jstate = jax.vmap(jk.init)({"x": jnp.asarray(x0)})
    jnew, jinfo = jax.vmap(jk.step)(keys, jstate)

    nu, u_h, u_t, u_s = [], [], [], []
    for k in keys:
        k_nu, k_height, k_theta, k_loop = jax.random.split(k, 4)
        nu.append(np.asarray(tree_normal_like(k_nu, {"x": jnp.zeros(2)})["x"]) * scale)
        u_h.append(jax.random.uniform(k_height, (), minval=1e-38))
        u_t.append(jax.random.uniform(k_theta, ()))
        u_s.append(_shrink_uniforms(k_loop))
    loglik = lambda p: -0.5 * ((p["x"] - y) ** 2).sum(-1) / s2
    state = EllipticalSliceState({"x": torch.tensor(x0)}, loglik({"x": torch.tensor(x0)}))
    new, info = elliptical_slice_from_draws(
        loglik, state, {"x": torch.tensor(np.stack(nu))}, {"x": torch.tensor(mean)},
        torch.tensor(np.stack(u_h)), torch.tensor(np.stack(u_t)),
        torch.tensor(np.stack(u_s, axis=1)))
    assert info.num_shrinks.tolist() == np.asarray(jinfo.num_shrinks).tolist()
    np.testing.assert_allclose(info.theta.numpy(), np.asarray(jinfo.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new.position["x"].numpy(), np.asarray(jnew.position["x"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new.loglikelihood.numpy(), np.asarray(jnew.loglikelihood),
                               rtol=RTOL, atol=ATOL)
    # the point on the ellipse at the JAX step's own angle
    pt = point_on_ellipse({"x": torch.tensor(x0 - mean)}, {"x": torch.tensor(np.stack(nu))},
                          {"x": torch.tensor(mean)}, torch.tensor(np.asarray(jinfo.theta)))
    np.testing.assert_allclose(pt["x"].numpy(), np.asarray(jnew.position["x"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("width, seed", [(0.3, 0), (1.5, 1), (0.2, 2)])
def test_slice_step_matches_jax(width, seed):
    max_stepout = 8
    jk = jax_slice(jax_correlated, width=width, max_stepout=max_stepout)
    v0 = np.random.default_rng(seed).normal(size=(C, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.key(10 + seed), C)
    jstate = jax.vmap(jk.init)({"v": jnp.asarray(v0)})
    jnew, jinfo = jax.vmap(jk.step)(keys, jstate)

    raw, u_h, u_p, u_b, u_s = [], [], [], [], []
    for k in keys:
        k_dir, k_height, k_place, k_shrink = jax.random.split(k, 4)
        raw.append(np.asarray(tree_normal_like(k_dir, {"v": jnp.zeros(2)})["v"]))
        u_h.append(jax.random.uniform(k_height, (), minval=1e-38))
        k_place1, k_place2 = jax.random.split(k_place)
        u_p.append(jax.random.uniform(k_place1, ()))
        u_b.append(jax.random.uniform(k_place2, ()))
        u_s.append(_shrink_uniforms(k_shrink))
    state = SliceState({"v": torch.tensor(v0)}, correlated({"v": torch.tensor(v0)}))
    new, info = slice_from_draws(correlated, state, {"v": torch.tensor(np.stack(raw))}, width,
                                 max_stepout, *(torch.tensor(np.stack(u)) for u in
                                                (u_h, u_p, u_b)),
                                 torch.tensor(np.stack(u_s, axis=1)))
    assert info.num_stepout.tolist() == np.asarray(jinfo.num_stepout).tolist()
    assert info.num_shrinks.tolist() == np.asarray(jinfo.num_shrinks).tolist()
    if width < 1.0:
        assert int(info.num_stepout.sum()) > 0
    np.testing.assert_allclose(info.interval_width.numpy(), np.asarray(jinfo.interval_width),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new.position["v"].numpy(), np.asarray(jnew.position["v"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new.logdensity.numpy(), np.asarray(jnew.logdensity), rtol=RTOL,
                               atol=ATOL)


def test_elliptical_slice_conjugate_gaussian():
    """``tests/test_slice.py::test_elliptical_slice_conjugate_gaussian``: prior
    N(0, 1), likelihood N(y | x, 0.5) at y = 1.2, 256 chains, 600 steps, the
    first 100 dropped; the posterior's mean within 0.02, variance within 8%."""
    y, s2 = 1.2, 0.5
    kernel = elliptical_slice(lambda p: -0.5 * ((p["x"] - y) ** 2).sum(-1) / s2,
                              {"x": torch.zeros(2)}, {"x": torch.ones(2)})
    states = init_chains(kernel, {"x": torch.zeros((256, 2))})
    _, s = run_chains(kernel, torch.Generator().manual_seed(0), states, 600)
    x = s["x"][100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(x.mean(0), y / (1.0 + s2), atol=0.02)
    np.testing.assert_allclose(x.var(0), s2 / (1.0 + s2), rtol=0.08)


def test_elliptical_slice_nonzero_prior_mean():
    """A flat likelihood reproduces the prior N(2, 0.5^2): 128 chains, 500
    steps, means and standard deviations within 0.03; the first angle is
    always taken."""
    kernel = elliptical_slice(lambda p: torch.zeros(p["x"].shape[:-1]),
                              {"x": 2.0 * torch.ones(3)}, {"x": 0.5 * torch.ones(3)})
    states = init_chains(kernel, {"x": torch.zeros((128, 3))})
    _, s = run_chains(kernel, torch.Generator().manual_seed(1), states, 500,
                      collect=lambda st, info: (st.position["x"], info.num_shrinks))
    x = s[0][100:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(x.mean(0), 2.0, atol=0.03)
    np.testing.assert_allclose(x.std(0), 0.5, atol=0.03)
    assert bool((s[1] == 1).all())


def test_slice_sampler_correlated_gaussian():
    """``tests/test_slice.py::test_slice_sampler_correlated_gaussian``: 256
    chains, 500 steps, the first 100 dropped; mean within 0.05, covariance
    within 0.1."""
    kernel = slice_sampler(correlated, width=1.5)
    states = init_chains(kernel, {"v": torch.zeros((256, 2))})
    _, s = run_chains(kernel, torch.Generator().manual_seed(2), states, 500)
    v = s["v"][100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(v.mean(0), 0.0, atol=0.05)
    np.testing.assert_allclose(np.cov(v.T), [[1.0, RHO], [RHO, 1.0]], atol=0.1)


def test_slice_sampler_bounded_support():
    """``tests/test_slice.py::test_slice_sampler_bounded_support``: the
    Exp(1) target, non-smooth at 0; 256 chains, 600 steps, the first 150
    dropped; mean within 0.06, variance within 0.15."""
    kernel = slice_sampler(lambda p: torch.where(p["x"] > 0, -p["x"], -torch.inf).sum(-1),
                           width=2.0)
    states = init_chains(kernel, {"x": torch.ones((256, 1))})
    _, s = run_chains(kernel, torch.Generator().manual_seed(3), states, 600)
    x = s["x"][150:].numpy().ravel()
    assert abs(x.mean() - 1.0) < 0.06
    assert abs(x.var() - 1.0) < 0.15


def test_one_chain_and_the_caps():
    """A scalar log density is one chain; a shrink cap of 0 keeps the
    state, as the JAX kernel's capped loop does."""
    kernel = slice_sampler(lambda p: -0.5 * (p["x"] ** 2).sum(), width=1.0, max_shrink=0)
    state = kernel.init({"x": torch.zeros(2)})
    new, info = kernel.step(torch.Generator().manual_seed(0), state)
    assert info.num_shrinks.shape == () and int(info.num_shrinks) == 0
    assert torch.equal(new.position["x"], state.position["x"])
    kernel = elliptical_slice(lambda p: torch.zeros(()), {"x": torch.zeros(2)},
                              {"x": torch.ones(2)})
    new, info = kernel.step(torch.Generator().manual_seed(0), kernel.init({"x": torch.zeros(2)}))
    assert int(info.num_shrinks) == 1 and info.theta.shape == ()
