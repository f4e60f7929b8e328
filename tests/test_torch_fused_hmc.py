"""K2's counterpart: ``LinregDensity`` and the plain ``fused_linreg_hmc_run``
against the JAX package (``linreg_unconstrained_logdensity`` with
``jax.grad``, and ``fused_linreg_hmc_run`` in interpret mode).

The JAX kernel runs with ``host_noise=True``; the test rebuilds its
``jax.random`` stream (``fused_hmc.py:237-241``) and hands the same noise
to the port through ``noise=``.  With a fixed step size and metric, HMC
started near the mode contracts two nearby states, so float32 rounding
differences stay at the 1e-5 level over the run as long as no MH decision
flips; the seed is chosen so none is within 1e-4 of its threshold, and the
test asserts that margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.fused_hmc import (
    fused_linreg_hmc_run as jax_fused_linreg_hmc_run,
    linreg_unconstrained_logdensity as jax_logdensity,
)
from binf_tpu_torch.ops.kernels.fused_hmc import (
    LinregDensity,
    fused_linreg_hmc_run,
    linreg_hmc_plain,
    linreg_unconstrained_logdensity,
)

C = 64
NUM_STEPS = 100
INVERSE_MASS = np.array([0.05, 0.1, 0.02, 0.02, 0.1], np.float32)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(x, 4, increasing=True).astype(np.float32)
    truth = np.array([2.0, -4.0, 1.0, 1.5])
    y = (V @ truth + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    prior_var = np.full(4, 5.0, np.float32)
    q0 = np.concatenate(
        [truth + 0.1 * rng.normal(size=(C, 4)),
         np.log(2.5) + 0.1 * rng.normal(size=(C, 1))], axis=1).astype(np.float32)
    return V, y, prior_var, q0


@pytest.mark.parametrize("prior_mean", [None, (0.5, -1.0, 0.0, 2.0)])
def test_density_value_and_grad_match_jax(problem, prior_mean):
    V, y, prior_var, _ = problem
    rng = np.random.default_rng(1)
    q = (np.array([2.0, -4.0, 1.0, 1.5, 0.9])
         + rng.normal(scale=0.5, size=(16, 5))).astype(np.float32)
    pm = None if prior_mean is None else np.asarray(prior_mean, np.float32)
    ld = jax_logdensity(jnp.asarray(V), jnp.asarray(y), jnp.asarray(prior_var), 1.0, 0.2,
                        prior_mean=None if pm is None else jnp.asarray(pm))

    def neg(qq):
        return -ld({"coefficients": qq[:4], "precision": qq[4]})

    ju = np.asarray(jax.vmap(neg)(jnp.asarray(q)))
    jg = np.asarray(jax.vmap(jax.grad(neg))(jnp.asarray(q)))
    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2, prior_mean=pm)
    tu, tg = density.potential_and_grad(torch.tensor(q))
    # sums of 20 residual terms of magnitude up to ~1e3 in float32
    np.testing.assert_allclose(tu.numpy(), ju, rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=2e-5, atol=1e-2)
    tl = linreg_unconstrained_logdensity(V, y, prior_var, 1.0, 0.2, prior_mean=pm)
    pos = {"coefficients": q[0, :4], "precision": q[0, 4]}
    assert float(tl(pos)) == pytest.approx(float(ld(pos)), rel=2e-5)


def _jax_host_noise(seed):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    mom = jax.random.normal(k1, (NUM_STEPS, 8, C), jnp.float32)
    unif = jax.random.uniform(k2, (NUM_STEPS, 1, C), jnp.float32)
    return np.asarray(mom), np.asarray(unif)


def test_plain_run_matches_jax(problem):
    V, y, prior_var, q0 = problem
    seed = 7
    kwargs = dict(inverse_mass=INVERSE_MASS, num_steps=NUM_STEPS, num_leapfrog=10,
                  block_chains=32, steps_per_block=50)
    jd, ja = jax_fused_linreg_hmc_run(
        jnp.asarray(q0), seed, jnp.asarray(V), jnp.asarray(y), jnp.asarray(prior_var),
        1.0, 0.2, 0.2, interpret=True, host_noise=True,
        **dict(kwargs, inverse_mass=jnp.asarray(INVERSE_MASS)))
    noise = _jax_host_noise(seed)
    td, ta = fused_linreg_hmc_run(q0, seed, V, y, prior_var, 1.0, 0.2, 0.2,
                                  noise=noise, device="cpu", **kwargs)
    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2)
    margin = linreg_hmc_plain(
        density, torch.tensor(q0), torch.tensor([0.2]), torch.tensor(INVERSE_MASS),
        num_steps=NUM_STEPS, num_leapfrog=10, seed=seed,
        noise=tuple(torch.tensor(a) for a in noise)).margin
    assert float(margin.abs().min()) > 1e-4
    assert td.shape == (NUM_STEPS, C, 5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-4)
    # the same decisions: JAX averages per-tile means, the port counts
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    assert 0.5 < float(ta) < 1.0


def test_philox_run_is_deterministic_and_independent_of_tiling(problem):
    V, y, prior_var, q0 = problem
    kwargs = dict(inverse_mass=INVERSE_MASS, num_steps=40, num_leapfrog=10,
                  device="cpu")
    d1, a1 = fused_linreg_hmc_run(q0, 3, V, y, prior_var, 1.0, 0.2, 0.2,
                                  block_chains=32, steps_per_block=20, **kwargs)
    d2, a2 = fused_linreg_hmc_run(q0, 3, V, y, prior_var, 1.0, 0.2, 0.2,
                                  block_chains=64, steps_per_block=40, **kwargs)
    assert torch.equal(d1, d2) and float(a1) == float(a2)
    d3, _ = fused_linreg_hmc_run(q0, 4, V, y, prior_var, 1.0, 0.2, 0.2,
                                 block_chains=32, steps_per_block=20, **kwargs)
    assert not torch.equal(d1, d3)
    assert torch.isfinite(d1).all()


def test_host_noise_matches_its_staged_stream(problem):
    """``host_noise`` draws the staged layout from a torch.Generator(seed)."""
    V, y, prior_var, q0 = problem
    kwargs = dict(inverse_mass=INVERSE_MASS, num_steps=10, block_chains=32,
                  steps_per_block=10, device="cpu")
    d1, _ = fused_linreg_hmc_run(q0, 5, V, y, prior_var, 1.0, 0.2, 0.2,
                                 host_noise=True, **kwargs)
    g = torch.Generator().manual_seed(5)
    mom = torch.randn((10, 8, C), generator=g)
    unif = torch.rand((10, 1, C), generator=g)
    d2, _ = fused_linreg_hmc_run(q0, 5, V, y, prior_var, 1.0, 0.2, 0.2,
                                 noise=(mom, unif), **kwargs)
    assert torch.equal(d1, d2)


def test_bad_shapes_raise(problem):
    V, y, prior_var, q0 = problem
    with pytest.raises(ValueError):
        fused_linreg_hmc_run(q0[:, :4], 0, V, y, prior_var, 1.0, 0.2, 0.2,
                             inverse_mass=INVERSE_MASS, num_steps=10,
                             steps_per_block=10, block_chains=32, device="cpu")
    with pytest.raises(ValueError):
        fused_linreg_hmc_run(q0, 0, V, y, prior_var, 1.0, 0.2, 0.2,
                             inverse_mass=INVERSE_MASS, num_steps=10,
                             steps_per_block=10, block_chains=48, device="cpu")
