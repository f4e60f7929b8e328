"""Pathfinder's fits (``binf_tpu_torch/vi/pathfinder.py``) against the JAX
package, on the CPU: the pooled draws of the same fit in both packages,
each on its own noise, held to each other's moments and Pareto k; then
the behaviour cases of ``tests/test_pathfinder.py`` (the L-BFGS path
itself is held to the reference's iteration by iteration in
``test_torch_vi_pathfinder.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import polynomial as jpoly
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as j_transform_logdensity
from binf_tpu_torch.example import polynomial as poly
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.vi import PathfinderResult, pathfinder, pathfinder_init
from binf_tpu_torch.vi.pathfinder import _bfgs_inverse_hessian

# the module (``binf_tpu.vi`` exports a function of the same name)
jpf = importlib.import_module("binf_tpu.vi.pathfinder")


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


@pytest.mark.parametrize("target", ["gaussian", "polynomial"])
def test_pooled_draws_match_the_jax_fit(target):
    """The same fit in both packages, each on its own noise: the pooled
    draws' means within 0.25 and their spreads within 30% of each other
    (the JAX test's gates against the truth), the Pareto k of both under
    0.7, the best ELBOs within 0.5."""
    if target == "gaussian":
        jld, tld, _, _ = _correlated_gaussian()
        jinit = {"x": 4.0 * jax.random.normal(jax.random.key(0), (4, 5))}
    else:
        jld, tld = _polynomial()
        jinit = {"coefficients": 3.0 * jax.random.normal(jax.random.key(2), (4, 4)),
                 "precision": jnp.zeros((4,))}
    jfit = jax.jit(lambda k: jpf.pathfinder(jld, jinit, k, num_draws=2000))(jax.random.key(1))
    fit = pathfinder(tld, {k: torch.tensor(np.asarray(v)) for k, v in jinit.items()}, 1,
                     num_draws=2000, device="cpu")
    assert isinstance(fit, PathfinderResult)
    assert fit.elbo.shape == (4,) and fit.mean.shape == jfit.mean.shape
    assert fit.chol.shape == jfit.chol.shape
    for k in jinit:
        x, jx = fit.samples[k].numpy(), np.asarray(jfit.samples[k])
        assert x.shape == jx.shape
        np.testing.assert_allclose(x.mean(0), jx.mean(0), atol=0.25)
        np.testing.assert_allclose(x.std(0), jx.std(0), rtol=0.3)
    assert float(fit.pareto_k) < 0.7 and float(jfit.pareto_k) < 0.7
    np.testing.assert_allclose(float(fit.elbo.max()), float(jfit.elbo.max()), atol=0.5)


def test_pathfinder_recovers_gaussian():
    """On an exactly Gaussian target the L-BFGS inverse Hessian is the
    covariance: the draws match its mean and marginal scales."""
    _, logdensity, mu, S = _correlated_gaussian()
    init = {"x": 4.0 * torch.randn((4, 5), generator=torch.Generator().manual_seed(0))}
    fit = pathfinder(logdensity, init, 1, num_draws=2000, device="cpu")
    assert bool(torch.isfinite(fit.elbo).any())
    X = fit.samples["x"].numpy()
    np.testing.assert_allclose(X.mean(0), mu, atol=0.25)
    np.testing.assert_allclose(X.std(0), np.sqrt(np.diag(S)), rtol=0.3)
    assert float(fit.elbo.max()) > -1.0
    assert float(fit.pareto_k) < 0.7


def test_pathfinder_multimodal_paths_disagree_gracefully():
    """Paths started in different basins give finite ELBOs and pooled draws
    near the modes."""
    mus = torch.tensor([-3.0, 3.0])

    def logdensity(pos):
        return torch.logsumexp(-0.5 * (pos["x"][..., None] - mus) ** 2, dim=-1).sum()

    init = {"x": torch.tensor([[-4.0], [4.0], [-2.5], [2.5]])}
    fit = pathfinder(logdensity, init, 0, num_draws=500, device="cpu")
    X = fit.samples["x"].numpy().ravel()
    dist = np.minimum(np.abs(X + 3.0), np.abs(X - 3.0))
    assert np.quantile(dist, 0.9) < 2.0


def test_bfgs_secant_condition_newest_pair():
    """BFGS gives H y = s exactly for the last pair applied, so a history
    in chronological order satisfies the secant condition for the newest
    pair, and not (generically) for the oldest."""
    rng = np.random.default_rng(0)
    d, j = 6, 4
    A = rng.normal(size=(d, d))
    A = A @ A.T + d * np.eye(d)
    S = torch.tensor(rng.normal(size=(j, d)), dtype=torch.float32)
    Y = S @ torch.tensor(A, dtype=torch.float32)
    H = _bfgs_inverse_hessian(S, Y, torch.ones(j, dtype=torch.bool), torch.tensor(1.0),
                              jitter=0.0)
    np.testing.assert_allclose((H @ Y[-1]).numpy(), S[-1].numpy(), rtol=1e-4, atol=1e-4)
    assert not np.allclose((H @ Y[0]).numpy(), S[0].numpy(), rtol=1e-3, atol=1e-3)


def test_pathfinder_wrapped_history_still_recovers():
    """A path longer than the history (the buffer wraps) still recovers
    the target covariance."""
    _, logdensity, mu, S = _correlated_gaussian()
    init = {"x": 4.0 * torch.randn((4, 5), generator=torch.Generator().manual_seed(5))}
    fit = pathfinder(logdensity, init, 6, num_draws=2000, max_iters=25, history=3,
                     device="cpu")
    X = fit.samples["x"].numpy()
    np.testing.assert_allclose(X.mean(0), mu, atol=0.3)
    np.testing.assert_allclose(X.std(0), np.sqrt(np.diag(S)), rtol=0.35)


def test_pathfinder_degenerate_weights_fallback():
    """If every path fails (a non-finite density), the draws are resampled
    uniformly and the failure shows as pareto_k = inf."""

    def bad_logdensity(pos):
        return torch.nan * torch.sum(pos["x"])

    init = {"x": torch.randn((4, 3), generator=torch.Generator().manual_seed(0))}
    fit = pathfinder(bad_logdensity, init, 1, num_draws=64, max_iters=5, device="cpu")
    assert bool(torch.isinf(fit.pareto_k))
    assert not bool(torch.isfinite(fit.elbo).any())
    assert fit.samples["x"].shape == (64, 3)


def test_pathfinder_init_accelerates_polynomial_hmc():
    """pathfinder_init on the reference posterior: the starts land in the
    typical set, far above the dispersed seeds' log density."""
    _, ld = _polynomial()
    g = torch.Generator().manual_seed(2)
    seeds = {"coefficients": 3.0 * torch.randn((4, 4), generator=g), "precision": torch.zeros(4)}
    starts = pathfinder_init(ld, seeds, 3, n_chains=64, device="cpu")
    assert starts["coefficients"].shape == (64, 4)
    lps = torch.func.vmap(ld)(starts)
    lp_seed = torch.func.vmap(ld)(seeds)
    assert float(torch.median(lps)) > float(lp_seed.max())
    assert float(torch.median(lps)) > -50.0
    coeffs = starts["coefficients"].numpy()
    assert np.abs(coeffs.mean(0) - np.array([2.0, -4.0, 1.0, 1.5])).max() < 1.5
