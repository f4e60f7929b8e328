"""ADVI (``binf_tpu_torch/vi/advi.py``) against the JAX package, on the CPU.

The port draws its ELBO normals from a ``torch.Generator``; its private
entry ``_advi`` takes them instead, so these tests rebuild the JAX
package's own normals from its keys (a key per step, per ELBO sample and,
mean-field, per variable, ``binf_tpu/vi/advi.py:165,182``) and hand them
over.  On the same normals the fit follows the reference step by step:
the ELBO trace to 1e-4 relative over the first 50 steps and the
parameters after 300 steps to 1e-4 relative (float32, the log density's
sums in another order).  The samplers of q given the same normals agree to
1e-5 relative.  The behaviour cases of ``tests/test_advi.py`` follow, on
the port's own noise."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.core.density import VariableSpec as JVariableSpec
from binf_tpu.example import polynomial as jpoly
from binf_tpu.parallel.runner import init_chains as j_init_chains
from binf_tpu.parallel.runner import run_chains as j_run_chains
from binf_tpu.pdf import FunctionPrior as JFunctionPrior
from binf_tpu.pdf import Posterior as JPosterior
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu_torch.core.density import VariableSpec
from binf_tpu_torch.example import polynomial as poly
from binf_tpu_torch.pdf import FunctionPrior, Posterior
from binf_tpu_torch.pdf.transforms import LogTransform
from binf_tpu_torch.vi import (ADVIResult, FullRankParams, MeanFieldParams, advi,
                               variational_sample)
from binf_tpu_torch.vi.advi import (_advi, _fullrank_sample, _meanfield_sample,
                                    _tril_unflatten)

CPU = torch.device("cpu")
# the module (``binf_tpu.vi`` exports a function of the same name)
jadvi = importlib.import_module("binf_tpu.vi.advi")


def make_gaussian_posterior(mean, var):
    mean = torch.tensor(mean, dtype=torch.float32)
    var = torch.tensor(var, dtype=torch.float32)

    def logp(values):
        return -0.5 * torch.sum((values["z"] - mean) ** 2 / var)

    prior = FunctionPrior.create(logp, (VariableSpec("z", shape=tuple(mean.shape)),),
                                 name="target")
    return Posterior.create({}, {"target": prior})


def jax_normals(key, num_steps, num_samples, shapes, method):
    """The normals the JAX package's ``advi`` draws at each step and ELBO
    sample, flat in sorted-name order: ``(num_steps, num_samples, d)``."""
    d = sum(int(np.prod(s)) for s in shapes)

    def one(kk):
        if method == "fullrank":
            return jax.random.normal(kk, (d,))
        ks = jax.random.split(kk, len(shapes))
        return jnp.concatenate([jax.random.normal(k, s).reshape(-1) for k, s in zip(ks, shapes)])

    def step(k):
        return jax.vmap(one)(jax.random.split(k, num_samples))

    return np.asarray(jax.vmap(step)(jax.random.split(key, num_steps)))


@pytest.fixture(scope="module")
def polynomial():
    xses, ys = jpoly.make_data(jax.random.key(1))
    return (jpoly.make_posterior(xses, ys),
            poly.make_posterior(torch.tensor(np.asarray(xses)), torch.tensor(np.asarray(ys))))


@pytest.mark.parametrize("method", ["meanfield", "fullrank"])
def test_fit_on_jax_normals_matches_jax_step_by_step(polynomial, method):
    jpost, post = polynomial
    steps, S = 300, 16
    jres = jax.jit(lambda k: jadvi.advi(jpost, k, num_steps=steps, method=method,
                                        transforms={"precision": JLogTransform}))(
        jax.random.key(4))
    normals = jax_normals(jax.random.key(4), steps, S, [(4,), ()], method)
    res = _advi(post, lambda t: torch.tensor(normals[t]), steps, 0.05, method,
                {"precision": LogTransform}, None, None, CPU)
    assert isinstance(res, ADVIResult)
    np.testing.assert_allclose(res.elbo_trace[:50].numpy(), np.asarray(jres.elbo_trace[:50]),
                               rtol=1e-4)
    np.testing.assert_allclose(res.elbo_trace.numpy(), np.asarray(jres.elbo_trace), rtol=1e-3)
    np.testing.assert_allclose(float(res.final_elbo), float(jres.final_elbo), rtol=1e-4)
    if method == "meanfield":
        assert isinstance(res.params, MeanFieldParams)
        for k in ("coefficients", "precision"):
            np.testing.assert_allclose(res.params.mu[k].numpy(), np.asarray(jres.params.mu[k]),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(res.params.log_sigma[k].numpy(),
                                       np.asarray(jres.params.log_sigma[k]), rtol=1e-4,
                                       atol=1e-5)
    else:
        assert isinstance(res.params, FullRankParams)
        np.testing.assert_allclose(res.params.mu.numpy(), np.asarray(jres.params.mu),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res.params.chol_flat.numpy(),
                                   np.asarray(jres.params.chol_flat), rtol=1e-4, atol=1e-5)


def test_samplers_of_q_match_jax_on_the_same_normals():
    rng = np.random.default_rng(0)
    mu = {"a": rng.normal(size=(3,)).astype(np.float32), "b": np.float32(rng.normal())}
    ls = {"a": (0.3 * rng.normal(size=(3,))).astype(np.float32),
          "b": np.float32(0.3 * rng.normal())}
    key = jax.random.key(11)
    ju, jlq = jadvi._meanfield_sample(
        jadvi.MeanFieldParams(mu={k: jnp.asarray(v) for k, v in mu.items()},
                              log_sigma={k: jnp.asarray(v) for k, v in ls.items()}), key)
    ks = jax.random.split(key, 2)
    eps = {"a": torch.tensor(np.asarray(jax.random.normal(ks[0], (3,)))),
           "b": torch.tensor(np.asarray(jax.random.normal(ks[1], ())))}
    u, lq = _meanfield_sample(MeanFieldParams(mu={k: torch.tensor(v) for k, v in mu.items()},
                                              log_sigma={k: torch.tensor(v)
                                                         for k, v in ls.items()}), eps)
    for k in mu:
        np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]), rtol=1e-5)
    np.testing.assert_allclose(float(lq), float(jlq), rtol=1e-5)

    d = 4
    flat = rng.normal(size=(d * (d + 1) // 2,)).astype(np.float32)
    np.testing.assert_array_equal(_tril_unflatten(torch.tensor(flat), d).numpy(),
                                  np.asarray(jadvi._tril_unflatten(jnp.asarray(flat), d)))
    m = rng.normal(size=(d,)).astype(np.float32)
    jp = jadvi.FullRankParams(mu=jnp.asarray(m), chol_flat=jnp.asarray(flat))
    ju, jlq = jadvi._fullrank_sample(jp, key, d)
    u, lq = _fullrank_sample(FullRankParams(torch.tensor(m), torch.tensor(flat)),
                             torch.tensor(np.asarray(jax.random.normal(key, (d,)))), d)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(lq), float(jlq), rtol=1e-5)


def test_gaussian_target_on_jax_normals_matches_jax():
    """A FunctionPrior target through the same entry: the fit on JAX's
    normals ends where the JAX package's does."""
    mean, var = [1.0, -2.0, 0.5], [0.5, 2.0, 1.0]
    jm, jv = jnp.asarray(mean), jnp.asarray(var)
    jprior = JFunctionPrior.create(lambda v: -0.5 * jnp.sum((v["z"] - jm) ** 2 / jv),
                                   (JVariableSpec("z", shape=(3,)),), name="target")
    jres = jax.jit(lambda k: jadvi.advi(JPosterior.create({}, {"target": jprior}), k,
                                        num_steps=200))(jax.random.key(0))
    normals = jax_normals(jax.random.key(0), 200, 16, [(3,)], "meanfield")
    res = _advi(make_gaussian_posterior(mean, var), lambda t: torch.tensor(normals[t]), 200,
                0.05, "meanfield", {}, None, None, CPU)
    np.testing.assert_allclose(res.elbo_trace.numpy(), np.asarray(jres.elbo_trace), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.params.mu["z"].numpy(), np.asarray(jres.params.mu["z"]),
                               rtol=1e-4, atol=1e-5)


def test_meanfield_recovers_diagonal_gaussian():
    post = make_gaussian_posterior([1.0, -2.0, 0.5], [0.5, 2.0, 1.0])
    result = advi(post, 0, num_steps=1500, learning_rate=0.05, device="cpu")
    mu = result.params.mu["z"].numpy()
    sigma = np.exp(result.params.log_sigma["z"].numpy())
    np.testing.assert_allclose(mu, [1.0, -2.0, 0.5], atol=0.1)
    np.testing.assert_allclose(sigma, np.sqrt([0.5, 2.0, 1.0]), rtol=0.15)
    samples = variational_sample(post, result, 1, 2000)
    np.testing.assert_allclose(samples["z"].numpy().mean(0), [1.0, -2.0, 0.5], atol=0.12)


def test_fullrank_recovers_correlation():
    """Correlated 2-D Gaussian: full-rank must capture rho."""
    rho = 0.8

    def logp(values):
        x = values["z"]
        return -(x[0] ** 2 - 2 * rho * x[0] * x[1] + x[1] ** 2) / (2 * (1 - rho ** 2))

    prior = FunctionPrior.create(logp, (VariableSpec("z", shape=(2,)),), name="t")
    post = Posterior.create({}, {"t": prior})
    result = advi(post, 0, num_steps=3000, learning_rate=0.03, method="fullrank", device="cpu")
    samples = variational_sample(post, result, 1, 4000)["z"].numpy()
    assert abs(np.corrcoef(samples[:, 0], samples[:, 1])[0, 1] - rho) < 0.1
    np.testing.assert_allclose(samples.mean(0), [0.0, 0.0], atol=0.1)
    np.testing.assert_allclose(samples.std(0), [1.0, 1.0], rtol=0.15)


def test_polynomial_posterior_advi_matches_gibbs(polynomial):
    """Mean-field ADVI on the reference workload: marginal means match the
    JAX package's collapsed Gibbs sampler on the same data (1,000 steps at
    the default rate, where the JAX test, marked slow, takes 3,000 at
    0.02)."""
    jpost, post = polynomial
    result = advi(post, 2, num_steps=1000, device="cpu")
    vi = variational_sample(post, result, 3, 2000)
    kernel = jpoly.make_collapsed_gibbs_kernel(jpost)
    states = j_init_chains(kernel, jpoly.initial_positions(64))
    _, samples = jax.jit(lambda s, k: j_run_chains(kernel, k, s, 300))(
        states, jax.random.key(4))
    gibbs_c = np.asarray(samples["coefficients"][100:]).reshape(-1, 4)
    gibbs_p = np.asarray(samples["precision"][100:]).ravel()
    np.testing.assert_allclose(vi["coefficients"].numpy().mean(0), gibbs_c.mean(0), atol=0.1)
    np.testing.assert_allclose(vi["precision"].numpy().mean(), gibbs_p.mean(), rtol=0.15)
    assert (vi["precision"].numpy() > 0).all()


@pytest.mark.parametrize("optimizer", [None, "torch.optim.Adam"])
def test_elbo_increases(optimizer):
    """The ELBO rises over 500 steps, with the default Adam and with a
    PyTorch optimizer factory in its place."""
    post = make_gaussian_posterior([0.0], [1.0])
    factory = None if optimizer is None else (lambda ps: torch.optim.Adam(ps, lr=0.05))
    result = advi(post, 0, num_steps=500, optimizer=factory, device="cpu")
    trace = result.elbo_trace.numpy()
    assert trace.shape == (500,)
    assert trace[-50:].mean() > trace[:50].mean()
