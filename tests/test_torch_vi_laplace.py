"""The Laplace approximation (``binf_tpu_torch/vi/laplace.py``) against the
JAX package, on the CPU.

On the JAX package's polynomial data (``make_data(key(1))``), the port's
fit is deterministic as the reference's is: the mode to 1e-4 relative,
the covariance to 1e-3 relative and the log evidence to 1e-3 absolute
(float32 over 1,500 Adam steps and the Newton polish, whose exact
Hessians differ in their last bits).  The behaviour cases of
``tests/test_laplace_waic.py`` follow: the mode and the draws against the
JAX package's collapsed Gibbs run on the same data, the evidence against
the port's SMC, WAIC and PSIS-LOO of the Laplace draws, and the exported
inverse mass."""

import jax
import numpy as np
import pytest
import torch

from binf_tpu.example import polynomial as jpoly
from binf_tpu.parallel.runner import init_chains as j_init_chains
from binf_tpu.parallel.runner import run_chains as j_run_chains
from binf_tpu.vi import laplace as jlap
from binf_tpu_torch.diagnostics import pointwise_log_likelihood, psis_loo, waic
from binf_tpu_torch.example import polynomial as poly
from binf_tpu_torch.vi import (LaplaceResult, inverse_mass_from_laplace, laplace_approximation,
                               laplace_sample)


@pytest.fixture(scope="module")
def setup():
    """The JAX package's data, its posterior in both packages, and the JAX
    collapsed Gibbs draws on it (32 chains, 300 sweeps, 100 burned)."""
    xses, ys = jpoly.make_data(jax.random.key(1))
    jpost = jpoly.make_posterior(xses, ys)
    kernel = jpoly.make_collapsed_gibbs_kernel(jpost)
    states = j_init_chains(kernel, jpoly.initial_positions(32))
    _, samples = jax.jit(lambda s, k: j_run_chains(kernel, k, s, 300))(
        states, jax.random.key(2))
    mcmc = {"coefficients": np.asarray(samples["coefficients"][100:]).reshape(-1, 4),
            "precision": np.asarray(samples["precision"][100:]).reshape(-1)}
    post = poly.make_posterior(torch.tensor(np.asarray(xses)), torch.tensor(np.asarray(ys)))
    return xses, ys, jpost, post, mcmc


@pytest.fixture(scope="module")
def fits(setup):
    _, _, jpost, post, _ = setup
    jres = jax.jit(lambda k: jlap.laplace_approximation(jpost, k, num_steps=1500))(
        jax.random.key(0))
    res = laplace_approximation(post, 0, num_steps=1500, device="cpu")
    return jres, res


def test_fit_matches_jax(fits):
    jres, res = fits
    assert isinstance(res, LaplaceResult)
    np.testing.assert_allclose(res.mode_unconstrained.numpy(),
                               np.asarray(jres.mode_unconstrained), rtol=1e-4, atol=1e-5)
    for k in ("coefficients", "precision"):
        np.testing.assert_allclose(res.mode[k].numpy(), np.asarray(jres.mode[k]), rtol=1e-4)
    np.testing.assert_allclose(res.cov.numpy(), np.asarray(jres.cov), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(res.chol_cov.numpy(), np.asarray(jres.chol_cov), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(float(res.log_prob_at_mode), float(jres.log_prob_at_mode),
                               atol=1e-3)
    np.testing.assert_allclose(float(res.log_evidence_laplace),
                               float(jres.log_evidence_laplace), atol=1e-3)
    assert bool(res.converged) == bool(jres.converged)


def test_draws_from_the_same_normals_match_jax(setup, fits, monkeypatch):
    """``laplace_sample`` maps standard normals through the fit's Cholesky
    factor as the reference does: given the reference's normals, the same
    draws."""
    from binf_tpu_torch.vi import laplace as lap_mod

    _, _, jpost, post, _ = setup
    jres, res = fits
    eps = np.asarray(jax.random.normal(jax.random.key(5), (200, 5)))
    monkeypatch.setattr(lap_mod, "_standard_normal",
                        lambda gen, shape, dev: torch.tensor(eps).reshape(shape))
    draws = laplace_sample(post, res, 0, 200)
    jdraws = jlap.laplace_sample(jpost, jres, jax.random.key(5), 200)
    for k in ("coefficients", "precision"):
        np.testing.assert_allclose(draws[k].numpy(), np.asarray(jdraws[k]), rtol=1e-3,
                                   atol=1e-4)


def test_mode_matches_posterior_mean(setup, fits):
    _, _, _, _, mcmc = setup
    _, res = fits
    assert bool(res.converged)
    # near-Gaussian posterior: MAP ~ posterior mean of coefficients
    np.testing.assert_allclose(res.mode["coefficients"].numpy(),
                               mcmc["coefficients"].mean(0), atol=0.05)


def test_laplace_samples_match_mcmc_spread(setup, fits):
    _, _, _, post, mcmc = setup
    _, res = fits
    draws = laplace_sample(post, res, 1, 4000)
    lc = draws["coefficients"].numpy()
    np.testing.assert_allclose(lc.mean(0), mcmc["coefficients"].mean(0), atol=0.06)
    np.testing.assert_allclose(lc.std(0), mcmc["coefficients"].std(0), rtol=0.25)
    assert (draws["precision"].numpy() > 0).all()


def test_evidence_matches_smc(setup):
    """Laplace evidence against the port's SMC evidence on the fully
    normalised posterior (the JAX test's 1.5 nats)."""
    from binf_tpu_torch.model import GaussianErrorModel, PolynomialForwardModel
    from binf_tpu_torch.pdf import Likelihood, Posterior
    from binf_tpu_torch.smc import tempered_smc

    xses, ys, _, _, _ = setup
    fwm = PolynomialForwardModel.create(torch.tensor(np.asarray(xses)), 4)
    em = GaussianErrorModel.create(torch.tensor(np.asarray(ys)), full_normalization=True)
    post = Posterior.create({"points": Likelihood.create("points", fwm, em)},
                            poly.make_priors(device="cpu"))
    lap = laplace_approximation(post, 0, num_steps=1500, device="cpu")
    smc = tempered_smc(post, 3, num_particles=2048, num_mutation_steps=8, device="cpu")
    assert abs(float(lap.log_evidence_laplace) - float(smc.log_evidence)) < 1.5


def test_inverse_mass_export(setup):
    _, _, jpost, post, _ = setup
    res = laplace_approximation(post, 0, num_steps=800, device="cpu")
    im = inverse_mass_from_laplace(post, res)
    assert set(im) == {"coefficients", "precision"}
    assert (im["coefficients"].numpy() > 0).all()
    jres = jax.jit(lambda k: jlap.laplace_approximation(jpost, k, num_steps=800))(
        jax.random.key(0))
    jim = jlap.inverse_mass_from_laplace(jpost, jres)
    for k in im:
        np.testing.assert_allclose(im[k].numpy(), np.asarray(jim[k]), rtol=1e-3)


def test_psis_loo_close_to_waic_on_the_laplace_draws(setup, fits):
    """The JAX test's gates on 1,000 Laplace draws: PSIS-LOO within 2 nats
    of WAIC, every point's Pareto k under 1, a positive WAIC p_eff."""
    _, _, _, post, _ = setup
    _, res = fits
    ll = pointwise_log_likelihood(post.likelihoods["points"], laplace_sample(post, res, 2, 1000))
    assert ll.shape == (1000, 20)
    w, loo = waic(ll), psis_loo(ll)
    assert abs(float(w.elpd) - float(loo.elpd)) < 2.0
    assert loo.pareto_k.shape == (20,)
    assert (loo.pareto_k.numpy() < 1.0).all()
    assert float(w.p_eff) > 0


def test_waic_of_the_laplace_fits_prefers_true_model(setup, fits):
    """WAIC on Laplace draws: the degree-3 polynomial (true) beats degree 1
    on the same data by more than 2 nats (the JAX test's gate)."""
    xses, ys, _, post, _ = setup
    _, res = fits
    post1 = poly.make_posterior(torch.tensor(np.asarray(xses)), torch.tensor(np.asarray(ys)),
                                n_coefficients=2)
    res1 = laplace_approximation(post1, 0, num_steps=1500, device="cpu")
    elpd = [float(waic(pointwise_log_likelihood(p.likelihoods["points"],
                                                laplace_sample(p, r, 3, 1000))).elpd)
            for p, r in ((post, res), (post1, res1))]
    assert elpd[0] > elpd[1] + 2.0
