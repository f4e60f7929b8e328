"""SVGD (``binf_tpu_torch/vi/svgd.py``) against the JAX package, on the CPU.

``_rbf_and_grad`` agrees to 1e-5 relative on the same particles (the
median of an even count as ``jnp.median`` takes it).  From the same
``initial_particles`` the run is deterministic in both packages: the
transport's gradient norm agrees to 1e-4 relative over the first 50
steps and the particles after 200 steps to 1e-4 relative (float32).  The
behaviour cases of ``tests/test_svgd.py``, which the JAX package marks
slow, run at 128 particles (256 in the JAX tests) and 1,000 steps
(Gaussian; 1,500 there) or 3,000 (polynomial)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import polynomial as jpoly
from binf_tpu.parallel.runner import init_chains as j_init_chains
from binf_tpu.parallel.runner import run_chains as j_run_chains
from binf_tpu_torch.example import polynomial as poly
from binf_tpu_torch.pdf import GaussianPrior, Posterior
from binf_tpu_torch.vi import SVGDResult, svgd
from binf_tpu_torch.vi.svgd import _rbf_and_grad

# the module (``binf_tpu.vi`` exports a function of the same name)
jsvgd = importlib.import_module("binf_tpu.vi.svgd")


@pytest.mark.parametrize("n", [7, 64])
def test_rbf_and_grad_matches_jax(n):
    X = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    jK, jG = jsvgd._rbf_and_grad(jnp.asarray(X))
    K, G = _rbf_and_grad(torch.tensor(X))
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def polynomial():
    xses, ys = jpoly.make_data(jax.random.key(1))
    return (xses, ys, jpoly.make_posterior(xses, ys),
            poly.make_posterior(torch.tensor(np.asarray(xses)), torch.tensor(np.asarray(ys))))


def test_run_from_given_particles_matches_jax(polynomial):
    _, _, jpost, post = polynomial
    rng = np.random.default_rng(3)
    init = {"coefficients": rng.normal(0.0, 2.0, size=(64, 4)).astype(np.float32),
            "precision": rng.gamma(2.0, 1.0, size=(64,)).astype(np.float32)}
    jres = jax.jit(lambda k: jsvgd.svgd(
        jpost, k, num_particles=64, num_steps=200, learning_rate=0.1,
        initial_particles={k2: jnp.asarray(v) for k2, v in init.items()}))(jax.random.key(0))
    res = svgd(post, 0, num_particles=64, num_steps=200, learning_rate=0.1,
               initial_particles={k: torch.tensor(v) for k, v in init.items()}, device="cpu")
    assert isinstance(res, SVGDResult)
    np.testing.assert_allclose(res.grad_norm_trace[:50].numpy(),
                               np.asarray(jres.grad_norm_trace[:50]), rtol=1e-4)
    for k in init:
        np.testing.assert_allclose(res.particles[k].numpy(), np.asarray(jres.particles[k]),
                                   rtol=1e-4, atol=1e-4)


def test_svgd_matches_gaussian_target():
    prior = GaussianPrior.create(torch.tensor([1.0, -2.0]), torch.tensor([0.25, 4.0]),
                                 variable="z")
    post = Posterior.create({}, {"t": prior})
    result = svgd(post, 0, num_particles=128, num_steps=1000, learning_rate=0.1, device="cpu")
    z = result.particles["z"].numpy()
    np.testing.assert_allclose(z.mean(0), [1.0, -2.0], atol=0.1)
    np.testing.assert_allclose(z.std(0), [0.5, 2.0], rtol=0.2)
    # transport converged
    trace = result.grad_norm_trace.numpy()
    assert trace[-50:].mean() < trace[:50].mean()


def test_svgd_polynomial_posterior(polynomial):
    _, _, jpost, post = polynomial
    result = svgd(post, 2, num_particles=128, num_steps=3000, learning_rate=0.1, device="cpu")
    kernel = jpoly.make_collapsed_gibbs_kernel(jpost)
    states = j_init_chains(kernel, jpoly.initial_positions(64))
    _, gs = jax.jit(lambda s, k: j_run_chains(kernel, k, s, 300))(states, jax.random.key(3))
    gc = np.asarray(gs["coefficients"][100:]).reshape(-1, 4)
    np.testing.assert_allclose(result.particles["coefficients"].numpy().mean(0), gc.mean(0),
                               atol=0.15)
    assert (result.particles["precision"].numpy() > 0).all()
