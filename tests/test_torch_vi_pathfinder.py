"""Pathfinder (``binf_tpu_torch/vi/pathfinder.py``) against the JAX package,
on the CPU.

``_bfgs_inverse_hessian`` and ``_gauss_logq`` agree to 1e-5 relative on
the same inputs.  The L-BFGS path, which the port writes by hand after
optax's ``lbfgs`` and zoom line search, is held to the JAX package's
iteration by iteration: the reference's ``_single_path`` loop is unrolled
here in Python (its output at the best ELBO is checked against the
package's own ``_single_path``), both take the same ELBO normals, and at
every iteration the port's means, and while a path still moves (its step
over 1e-3) its Cholesky factors and ELBOs, agree with it to 1e-4 (means)
and 2e-3 (factors, ELBOs), or, past that, within twice the distance the
JAX path itself moves when its start is moved by 1e-6 relative (four
ways): L-BFGS amplifies float32 rounding on the polynomial posterior's
curved valley.  Once a path has converged its curvature pairs are
rounding noise in both packages, and its factors are not compared.  The
fits and the behaviour cases are in ``test_torch_vi_pathfinder_fit.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from binf_tpu.example import polynomial as jpoly
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as j_transform_logdensity
from binf_tpu_torch.example import polynomial as poly
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers.dense import flatten_spec
from binf_tpu_torch.vi.pathfinder import (_bfgs_inverse_hessian, _flat_value_and_grad,
                                          _gauss_logq, _paths)

# the module (``binf_tpu.vi`` exports a function of the same name)
jpf = importlib.import_module("binf_tpu.vi.pathfinder")

HISTORY, ELBO_SAMPLES = 6, 16


def _correlated_gaussian(d=5, rho=0.8, seed=0):
    """The JAX tests' target, as a log density of each package."""
    rng = np.random.default_rng(seed)
    scales = np.exp(np.linspace(-0.5, 0.8, d))
    corr = np.full((d, d), rho) + (1 - rho) * np.eye(d)
    S = np.diag(scales) @ corr @ np.diag(scales)
    mu = rng.normal(size=d)
    P = np.linalg.inv(S)
    mu_j, P_j = jnp.asarray(mu, jnp.float32), jnp.asarray(P, jnp.float32)
    mu_t, P_t = torch.tensor(mu, dtype=torch.float32), torch.tensor(P, dtype=torch.float32)

    def jld(pos):
        x = pos["x"] - mu_j
        return -0.5 * x @ (P_j @ x)

    def tld(pos):
        x = pos["x"] - mu_t
        return -0.5 * x @ (P_t @ x)

    return jld, tld, mu, S


def _polynomial():
    xses, ys = jpoly.make_data(jax.random.key(1))
    jpost = jpoly.make_posterior(xses, ys)
    post = poly.make_posterior(torch.tensor(np.asarray(xses)), torch.tensor(np.asarray(ys)))
    jld = j_transform_logdensity(lambda p: jpost.log_prob(p), {"precision": JLogTransform})
    tld = transform_logdensity(post.log_prob, {"precision": LogTransform})
    return jld, tld


def jax_paths(nld, thetas0, path_keys, iters):
    """The JAX package's ``_single_path`` (``binf_tpu/vi/pathfinder.py:95``)
    one iteration at a time, over the rows of ``thetas0`` (``vmap``, as
    ``pathfinder`` maps it): every iteration's means, Cholesky factors,
    ELBOs and ELBO normals, ``(paths, iters, ...)``."""
    d = thetas0.shape[1]
    opt = optax.lbfgs(memory_size=HISTORY)
    value_and_grad = optax.value_and_grad_from_state(nld)

    def step(carry, k_l):
        params, opt_state, S, Y, valid, t = carry
        value, grad = value_and_grad(params, state=opt_state)
        updates, opt_state = opt.update(grad, opt_state, params, value=value, grad=grad,
                                        value_fn=nld)
        new_params = optax.apply_updates(params, updates)
        s = new_params - params
        _, new_grad = jax.value_and_grad(nld)(new_params)
        y = new_grad - grad
        ok = (s @ y) > 1e-12
        slot = t % HISTORY
        S = S.at[slot].set(jnp.where(ok, s, S[slot]))
        Y = Y.at[slot].set(jnp.where(ok, y, Y[slot]))
        valid = valid.at[slot].set(valid[slot] | ok)
        t = t + jnp.where(ok, 1, 0).astype(t.dtype)
        gamma = jnp.where(ok, (s @ y) / jnp.maximum(y @ y, 1e-12), jnp.ones(()))
        idx = (t + jnp.arange(HISTORY)) % HISTORY
        chol = jnp.linalg.cholesky(jpf._bfgs_inverse_hessian(S[idx], Y[idx], valid[idx], gamma))
        z = jax.random.normal(k_l, (ELBO_SAMPLES, d))
        xs = new_params[None, :] + z @ chol.T
        logp = -jax.vmap(nld)(xs)
        logq = (-0.5 * jnp.sum(z * z, axis=1) - jnp.sum(jnp.log(jnp.diagonal(chol)))
                - 0.5 * d * jpf._LOG_2PI)
        elbo = jnp.mean(logp - logq)
        elbo = jnp.where(jnp.isfinite(elbo) & jnp.all(jnp.isfinite(chol)), elbo, -jnp.inf)
        return (new_params, opt_state, S, Y, valid, t), (new_params, chol, elbo, z)

    def init(theta0):
        return (theta0, opt.init(theta0), jnp.zeros((HISTORY, d)), jnp.zeros((HISTORY, d)),
                jnp.zeros((HISTORY,), bool), jnp.int32(0))

    step = jax.jit(jax.vmap(step))
    carry = jax.vmap(init)(jnp.asarray(thetas0))
    keys = jax.vmap(lambda k: jax.random.split(k, iters))(path_keys)
    out = []
    for i in range(iters):
        carry, o = step(carry, keys[:, i])
        out.append(o)
    return [np.stack([np.asarray(o[j]) for o in out], axis=1) for j in range(4)]


@pytest.mark.parametrize("target", ["gaussian", "polynomial"])
def test_lbfgs_path_matches_jax_iteration_by_iteration(target):
    if target == "gaussian":
        jld, tld, _, _ = _correlated_gaussian()
        template = {"x": torch.zeros(5)}
        thetas0 = np.asarray(4.0 * jax.random.normal(jax.random.key(0), (4, 5)))
        iters = 30

        def junpack(th):
            return {"x": th}
    else:
        jld, tld = _polynomial()
        template = {"coefficients": torch.zeros(4), "precision": torch.zeros(())}
        coeffs = np.asarray(3.0 * jax.random.normal(jax.random.key(2), (4, 4)))
        thetas0 = np.concatenate([coeffs, np.zeros((4, 1), np.float32)], axis=1)
        iters = 40

        def junpack(th):
            return {"coefficients": th[:4], "precision": th[4]}

    def jnld(th):
        return -jld(junpack(th))

    path_keys = jax.random.split(jax.random.key(9), 4)
    # the reach of rounding: the JAX paths from starts moved by 1e-6
    # relative, four ways
    moves = [(1 + 1e-6, 1e-7), (1 - 1e-6, -1e-7), (1 + 1e-6, -1e-7), (1 - 1e-6, 1e-7)]
    starts = np.concatenate([thetas0] + [thetas0 * a + b for a, b in moves]).astype(np.float32)
    runs = jax_paths(jnld, starts, jnp.concatenate([path_keys] * (1 + len(moves))), iters)
    jm, jc, je, jz = (r[:4] for r in runs)
    moved = [r[4:].reshape((len(moves), 4) + r.shape[1:]) for r in runs[:3]]
    # the loop above is the package's _single_path (a scan, fused otherwise,
    # so the converged tail's factors and ELBOs round otherwise): the same
    # best point
    best_mu, _, _ = jax.jit(jax.vmap(lambda th, k: jpf._single_path(
        jnld, th, k, iters, HISTORY, ELBO_SAMPLES)))(jnp.asarray(thetas0), path_keys)
    for p in range(4):
        np.testing.assert_allclose(np.asarray(best_mu[p]), jm[p, int(np.argmax(je[p]))],
                                   atol=1e-3)

    _, unpack, _ = flatten_spec(template)
    nld, vg = _flat_value_and_grad(tld, unpack)
    m, c, e = (x.numpy() for x in _paths(nld, vg, torch.tensor(thetas0), torch.tensor(jz),
                                         HISTORY))
    assert m.shape == jm.shape and c.shape == jc.shape and e.shape == je.shape
    # a path moves while its step is over 1e-3; past that its curvature pairs
    # are rounding noise and only its means are compared
    steps = np.abs(np.diff(jm, axis=1, prepend=thetas0[:, None, :])).max(axis=-1)
    for t in range(iters):
        moving = steps[:, t] > 1e-3
        for name, port, ref, mv, tol in (("mean", m, jm, moved[0], 1e-4),
                                         ("chol", c, jc, moved[1], 2e-3),
                                         ("elbo", e, je, moved[2], 2e-3)):
            rows = slice(None) if name == "mean" else moving
            if not np.any(np.ones(4, bool)[rows]):
                continue
            reach = np.nan_to_num(np.abs(mv[:, rows, t] - ref[None, rows, t]), nan=np.inf).max()
            err = np.nan_to_num(np.abs(port[rows, t] - ref[rows, t]), nan=np.inf).max()
            assert err <= max(tol * max(1.0, np.abs(ref[rows, t]).max()), 2.0 * reach), (
                f"{target} iteration {t}: {name} off by {err} (JAX's own reach {reach})")
    assert steps[:, :10].min() > 1e-3  # the first ten iterations of every path compared in full


def test_bfgs_inverse_hessian_and_gauss_logq_match_jax():
    rng = np.random.default_rng(1)
    d, j = 6, 4
    S = rng.normal(size=(3, j, d)).astype(np.float32)
    A = rng.normal(size=(d, d))
    A = (A @ A.T + d * np.eye(d)).astype(np.float32)
    Y = (S @ A).astype(np.float32)
    valid = rng.random((3, j)) < 0.7
    gamma = rng.uniform(0.5, 2.0, size=3).astype(np.float32)
    H = _bfgs_inverse_hessian(torch.tensor(S), torch.tensor(Y), torch.tensor(valid),
                              torch.tensor(gamma)).numpy()
    for b in range(3):
        jH = jpf._bfgs_inverse_hessian(jnp.asarray(S[b]), jnp.asarray(Y[b]),
                                       jnp.asarray(valid[b]), jnp.float32(gamma[b]))
        np.testing.assert_allclose(H[b], np.asarray(jH), rtol=1e-5, atol=1e-6)
    chol = np.linalg.cholesky(H[0]).astype(np.float32)
    x = rng.normal(size=(7, d)).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    lq = _gauss_logq(torch.tensor(x), torch.tensor(mu), torch.tensor(chol)).numpy()
    jlq = [float(jpf._gauss_logq(jnp.asarray(xi), jnp.asarray(mu), jnp.asarray(chol)))
           for xi in x]
    np.testing.assert_allclose(lq, jlq, rtol=1e-5)
