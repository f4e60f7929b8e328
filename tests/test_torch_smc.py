"""SMC (``binf_tpu_torch/smc``) against the JAX package, on the CPU.

On the same numpy arrays: the effective sample size to 1e-5 relative,
``_resample_indices`` bit for bit from the same cumulative weights and
uniforms, the bisection for the next beta to 1e-6 and the particles'
scales to 1e-6 relative.  The resamplers draw from a ``torch.Generator``,
so they are held to the JAX tests' statistics (unbiased offspring
counts; systematic counts within 1 of N w_i).  ``tempered_smc``'s noise
streams differ from the JAX package's, so it is held to the statistics
of ``tests/test_smc.py``: the Gaussian target's posterior moments and
log evidence against their closed forms, and the polynomial posterior's
moments against the JAX package's collapsed Gibbs run on the same data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.smc import resampling as jres
from binf_tpu.smc import smc as jsmc
from binf_tpu_torch.core.density import VariableSpec
from binf_tpu_torch.model import GaussianErrorModel
from binf_tpu_torch.model.forward import ParametricCurveModel
from binf_tpu_torch.pdf import GaussianPrior, Likelihood, Posterior
from binf_tpu_torch.smc import (SMCResult, effective_sample_size, multinomial_resample,
                                stratified_resample, systematic_resample, tempered_smc)
from binf_tpu_torch.smc.resampling import _resample_indices
from binf_tpu_torch.smc.smc import _find_next_beta, _particle_scales

f32 = np.float32


@pytest.mark.parametrize("case", ["uniform", "degenerate", "random", "batched"])
def test_effective_sample_size_matches_jax(case):
    rng = np.random.default_rng(0)
    lw = {"uniform": np.zeros(100, f32),
          "degenerate": np.r_[0.0, np.full(99, -np.inf)].astype(f32),
          "random": (3.0 * rng.normal(size=500)).astype(f32),
          "batched": (2.0 * rng.normal(size=(4, 300))).astype(f32)}[case]
    got = effective_sample_size(torch.tensor(lw)).numpy()
    ref = np.asarray(jres.effective_sample_size(jnp.asarray(lw)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    if case == "uniform":
        assert float(got) == pytest.approx(100.0, rel=1e-5)
    if case == "degenerate":
        assert float(got) == pytest.approx(1.0, rel=1e-5)


def test_resample_indices_bit_for_bit():
    """From the same cumulative weights and grid points, the same
    ancestors, ties (a point on a cumulative weight) included."""
    rng = np.random.default_rng(1)
    for n in (7, 64, 4096):
        cum = np.cumsum(rng.dirichlet(np.ones(n))).astype(f32)
        for positions in ((np.arange(n) + rng.uniform()) / n,
                          (np.arange(n) + rng.uniform(size=n)) / n,
                          np.r_[0.0, cum[: n - 1]]):
            positions = positions.astype(f32)
            got = _resample_indices(torch.tensor(cum), torch.tensor(positions)).numpy()
            ref = np.asarray(jres._resample_indices(jnp.asarray(cum), jnp.asarray(positions)))
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("resampler", [systematic_resample, stratified_resample,
                                       multinomial_resample])
def test_resamplers_unbiased_counts(resampler):
    """The expected offspring of particle i is N w_i (tests/test_smc.py)."""
    n = 64
    lw = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    w = torch.softmax(lw, 0).numpy()
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([resampler(g, lw) for _ in range(500)])
    assert idx.shape == (500, n) and int(idx.min()) >= 0 and int(idx.max()) < n
    counts = np.bincount(idx.numpy().ravel(), minlength=n) / 500.0
    np.testing.assert_allclose(counts, n * w, atol=0.5)


def test_systematic_low_variance():
    n = 32
    lw = torch.randn(n, generator=torch.Generator().manual_seed(4))
    w = torch.softmax(lw, 0).numpy()
    g = torch.Generator().manual_seed(5)
    for _ in range(20):
        counts = np.bincount(systematic_resample(g, lw).numpy(), minlength=n)
        assert np.all(np.abs(counts - n * w) <= 1.0 + 1e-6)


@pytest.mark.parametrize("beta", [0.0, 0.2, 0.9, 0.99999])
def test_find_next_beta_matches_jax(beta):
    rng = np.random.default_rng(int(beta * 1e5))
    for scale in (1.0, 50.0, 2000.0):
        ll = (scale * rng.normal(size=2048) - scale).astype(f32)
        got = float(_find_next_beta(torch.tensor(ll), torch.tensor(beta, dtype=torch.float32),
                                    0.5))
        ref = float(jsmc._find_next_beta(jnp.asarray(ll), jnp.asarray(beta, jnp.float32), 0.5))
        assert got == pytest.approx(ref, abs=1e-6)
        assert beta < got <= 1.0


def test_particle_scales_match_jax():
    rng = np.random.default_rng(2)
    parts = {"a": rng.normal(size=(300, 4)).astype(f32) * [1, 2, 3, 1e-6],
             "b": (5.0 + rng.normal(size=300)).astype(f32)}
    got = _particle_scales({k: torch.tensor(v) for k, v in parts.items()})
    ref = jsmc._particle_scales({k: jnp.asarray(v) for k, v in parts.items()})
    for k in parts:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    assert float(got["a"][3]) == pytest.approx(1e-4)  # the floor


def _gaussian_posterior(data):
    n = data.shape[0]

    def const_fn(x, values):
        return torch.broadcast_to(values["mu"], (n,))

    fwm = ParametricCurveModel(x=torch.zeros(n), fn=const_fn, specs=(VariableSpec("mu", ()),))
    em = GaussianErrorModel.create(data, full_normalization=True).fix(precision=1.0)
    return Posterior.create({"obs": Likelihood.create("obs", fwm, em)},
                            {"mu_prior": GaussianPrior.create(torch.zeros(()), torch.ones(()),
                                                              variable="mu")})


def test_gaussian_evidence():
    """x_i ~ N(mu, 1), mu ~ N(0, 1) on the JAX test's data: the posterior
    moments and the log evidence against their closed forms, at the
    bounds of tests/test_smc.py."""
    n = 10
    data = np.asarray(jax.random.normal(jax.random.key(0), (n,))) + 1.5
    result = tempered_smc(_gaussian_posterior(data), 42, num_particles=2048,
                          num_mutation_steps=5, device="cpu")
    assert isinstance(result, SMCResult)
    post_mean, post_var = n * data.mean() / (n + 1), 1.0 / (n + 1)
    mu = result.particles["mu"].numpy()
    assert abs(mu.mean() - post_mean) < 0.05
    assert abs(mu.var() - post_var) < 0.03
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    log_z = -0.5 * (n * np.log(2 * np.pi) + logdet + data @ np.linalg.solve(cov, data))
    assert abs(float(result.log_evidence) - log_z) < 0.25
    assert float(result.final_beta) == 1.0


@pytest.fixture(scope="module")
def polynomial_data():
    from binf_tpu.example.polynomial import make_data

    xses, ys = make_data(jax.random.key(1))
    return np.asarray(xses, f32), np.asarray(ys, f32)


def test_polynomial_posterior_moments(polynomial_data):
    """RWM moves on the polynomial posterior agree with the JAX package's
    collapsed Gibbs run on the same data (tests/test_smc.py's bounds)."""
    from binf_tpu.example import polynomial as jpoly
    from binf_tpu.parallel.runner import init_chains, run_chains
    from binf_tpu_torch.example.polynomial import make_posterior

    x, y = polynomial_data
    result = tempered_smc(make_posterior(x, y), 2, num_particles=2048, mutation="rwm",
                          num_mutation_steps=10, device="cpu")
    jpost = jpoly.make_posterior(jnp.asarray(x), jnp.asarray(y))
    kernel = jpoly.make_collapsed_gibbs_kernel(jpost)
    states = init_chains(kernel, jpoly.initial_positions(64))
    _, samples = jax.jit(lambda s, k: run_chains(kernel, k, s, 300))(states, jax.random.key(3))
    gibbs_c = np.asarray(samples["coefficients"][100:]).reshape(-1, 4)
    gibbs_p = np.asarray(samples["precision"][100:]).ravel()
    np.testing.assert_allclose(result.particles["coefficients"].numpy().mean(0),
                               gibbs_c.mean(0), atol=0.1)
    np.testing.assert_allclose(result.particles["precision"].numpy().mean(), gibbs_p.mean(),
                               rtol=0.15)
    assert int(result.num_stages) < 50 and float(result.final_beta) == 1.0


@pytest.mark.parametrize("mutation", ["hmc", "mala"])
def test_gradient_mutations(polynomial_data, mutation):
    from binf_tpu_torch.example.polynomial import make_posterior

    x, y = polynomial_data
    result = tempered_smc(make_posterior(x, y), torch.Generator().manual_seed(4),
                          num_particles=512, mutation=mutation, num_mutation_steps=3,
                          initial_step_size=0.1 if mutation == "hmc" else 0.01)
    assert float(result.final_beta) == 1.0
    assert bool(torch.isfinite(result.particles["coefficients"]).all())
    assert 0.0 < float(result.mean_acceptance) <= 1.0


def test_initial_particles_and_refusals(polynomial_data):
    from binf_tpu_torch.example.polynomial import make_posterior

    x, y = polynomial_data
    post = make_posterior(x, y)
    start = {"coefficients": torch.zeros((256, 4)), "precision": torch.ones(256)}
    res = tempered_smc(post, 0, initial_particles=start, num_mutation_steps=2, device="cpu")
    assert res.particles["coefficients"].shape == (256, 4)
    # a mesh shards the particles (a group of one here; 4 ranks in
    # test_torch_mesh_smc.py)
    from torch_ranks import world_of_one

    from binf_tpu_torch.parallel.mesh import gather_chains

    with world_of_one() as mesh:
        sharded = tempered_smc(post, 0, initial_particles=start, num_mutation_steps=2,
                               mesh=mesh, device="cpu")
        particles = gather_chains(sharded.particles)
    assert particles["coefficients"].shape == (256, 4)
    assert int(sharded.num_stages) >= 1 and float(sharded.final_beta) == 1.0
    with pytest.raises(ValueError, match="mutation"):
        tempered_smc(post, 0, mutation="nuts", device="cpu")
