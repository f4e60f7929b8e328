"""K5's counterpart: the plain ``fused_linreg_gibbs_run`` against the JAX
package's ``fused_linreg_gibbs_run`` in interpret mode.

The JAX kernel runs with ``host_noise=True``; the test rebuilds its
``jax.random`` stream (``fused_gibbs.py:228-233``) and hands the same noise
to the port through ``noise=``, so the two agree sweep for sweep.  A Gamma
round's accept decision could flip between two float32 implementations
only within rounding of its threshold: the test asserts that no decision
lies within 1e-4 of it.  The port's own Philox stream is held to the exact
posterior moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.fused_gibbs import fused_linreg_gibbs_run as jax_gibbs_run
from binf_tpu_torch.diagnostics import ess
from binf_tpu_torch.ops.kernels import prng
from binf_tpu_torch.ops.kernels.fused_gibbs import (
    fused_linreg_gibbs_plain,
    fused_linreg_gibbs_run,
    gamma_constants,
)
from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity

C = 32
SEED = 7


def _problem(d, chains=C):
    rng = np.random.default_rng(0)
    x = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(x, d, increasing=True).astype(np.float32)
    truth = rng.normal(size=d)
    y = (V @ truth + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    prior_var = np.full(d, 5.0, np.float32)
    q0 = np.concatenate([truth + 0.1 * rng.normal(size=(chains, d)), np.ones((chains, 1))],
                        axis=1).astype(np.float32)
    return V, y, prior_var, q0


def _jax_host_noise(seed, steps):
    k1, k2, k3 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)), 3)
    shape = (steps, 8, C)
    return (np.asarray(jax.random.normal(k1, shape, jnp.float32)),
            np.asarray(jax.random.uniform(k2, shape, jnp.float32)),
            np.asarray(jax.random.normal(k3, shape, jnp.float32)))


# d = 2 and 4: the sweeps agree to float32 rounding of sums of 20 terms.
# d = 7: V^T V of the degree-6 polynomial basis on [-2, 2] has a condition
# number near 1e7, so the rounding of V^T V itself (XLA's order of summation
# against PyTorch's) moves the Cholesky solves by up to ~2e-3.
@pytest.mark.parametrize("d, steps, tol", [(2, 50, 1e-5), (4, 100, 1e-5), (7, 50, 5e-3)])
def test_plain_matches_jax_sweep_for_sweep(d, steps, tol):
    V, y, prior_var, q0 = _problem(d)
    jd = np.asarray(jax_gibbs_run(
        jnp.asarray(q0), SEED, jnp.asarray(V), jnp.asarray(y), jnp.asarray(prior_var), 1.0,
        0.2, num_steps=steps, d=d, block_chains=32, steps_per_block=50, interpret=True,
        host_noise=True))
    noise = _jax_host_noise(SEED, steps)
    td = fused_linreg_gibbs_run(q0, SEED, V, y, prior_var, 1.0, 0.2, num_steps=steps, d=d,
                                block_chains=32, noise=noise, device="cpu")
    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2)
    plain = fused_linreg_gibbs_plain(density, torch.tensor(q0), num_steps=steps, seed=SEED,
                                     noise=tuple(torch.tensor(a) for a in noise))
    assert float(plain.margin.min()) > 1e-4
    assert torch.equal(plain.draws, td)
    assert td.shape == (steps, C, d + 1)
    np.testing.assert_allclose(td.numpy(), jd, rtol=tol, atol=tol)


def test_gamma_constants_follow_jax():
    """d from a Python float, c by a float32 sqrt and division, as the JAX
    kernel rounds them (a0 = 1 + 20/2)."""
    d, c = gamma_constants(11.0)
    assert d == float(np.float32(11.0 - 1.0 / 3.0))
    assert c == float(np.float32(1.0) / np.sqrt(np.float32(9.0 * (11.0 - 1.0 / 3.0))))


def _exact_moments(V, y, prec):
    Vd = V.astype(np.float64)
    cov = np.linalg.inv(prec * Vd.T @ Vd + np.eye(V.shape[1]) / 5.0)
    return cov @ (prec * Vd.T @ y), cov


@pytest.mark.parametrize("d", [2, 4, 7])
def test_philox_run_recovers_the_exact_posterior(d):
    """The Philox stream at 256 chains over 300 sweeps (100 burned): the
    coefficient mean within 0.05 (d <= 4; 0.3 at d = 7, where the
    posterior sd of the top coefficients is ~1) of the exact conditional
    mean at the mean precision, the precision within 5% of its Gamma
    self-consistency point, and the coefficient variances within 15% of
    the exact conditional's."""
    V, y, prior_var, q0 = _problem(d, chains=256)
    draws = fused_linreg_gibbs_run(q0, 3, V, y, prior_var, 1.0, 0.2, num_steps=300, d=d,
                                   block_chains=256, steps_per_block=50, device="cpu")
    kept = draws[100:].double().numpy()
    coeffs, prec = kept[..., :d].reshape(-1, d), kept[..., d].reshape(-1)
    assert (prec > 0).all()
    mean, cov = _exact_moments(V, y, prec.mean())
    np.testing.assert_allclose(coeffs.mean(0), mean, atol=0.05 if d <= 4 else 0.3)
    np.testing.assert_allclose(coeffs.var(0), np.diag(cov), rtol=0.15)
    ss = ((y[:, None] - V.astype(np.float64) @ coeffs.T) ** 2).sum(0)
    np.testing.assert_allclose(prec.mean(), np.mean(11.0 / (0.2 + ss / 2.0)), rtol=0.05)


def test_near_iid_mixing():
    """Collapsed Gibbs draws are nearly independent: bulk ESS of every
    coefficient and of the precision above half the draws."""
    V, y, prior_var, q0 = _problem(4, chains=64)
    draws = fused_linreg_gibbs_run(q0, 5, V, y, prior_var, 1.0, 0.2, num_steps=400,
                                   block_chains=64, steps_per_block=50, device="cpu")[50:]
    e = ess(draws)
    assert float(e.min()) > 0.5 * draws.shape[0] * draws.shape[1]


def test_philox_stream_is_deterministic_and_independent_of_tiling():
    V, y, prior_var, q0 = _problem(4, chains=64)
    kw = dict(num_steps=40, device="cpu")
    d1 = fused_linreg_gibbs_run(q0, 3, V, y, prior_var, 1.0, 0.2, block_chains=32,
                                steps_per_block=20, **kw)
    d2 = fused_linreg_gibbs_run(q0, 3, V, y, prior_var, 1.0, 0.2, block_chains=64,
                                steps_per_block=40, **kw)
    assert torch.equal(d1, d2)
    d3 = fused_linreg_gibbs_run(q0, 4, V, y, prior_var, 1.0, 0.2, block_chains=32,
                                steps_per_block=20, **kw)
    assert not torch.equal(d1, d3) and bool(torch.isfinite(d1).all())


def test_gibbs_noise_slots():
    """``TAG_GIBBS`` counters: Gamma normals in slots 0-1, Gamma uniforms in
    slot 2, coefficient normals from slot 3, as ``csrc/philox.cuh``."""
    chains = torch.arange(5, dtype=torch.int64)
    gz, gu, cz = prng.gibbs_noise(11, chains, 9, 5)
    ctr = torch.tensor([[c, 9, s, prng.TAG_GIBBS] for c in range(5) for s in range(6)])
    b = prng.philox4x32_10(ctr, prng._key(11)).reshape(5, 6, 4)
    assert torch.equal(gz[1], prng.bits_to_normal(b[:, 0, 2], b[:, 0, 3]))
    assert torch.equal(gz[2], prng.bits_to_normal(b[:, 1, 0], b[:, 1, 1]))
    assert torch.equal(gu[3], prng.bits_to_uniform(b[:, 2, 3]))
    assert torch.equal(cz[4], prng.bits_to_normal(b[:, 5, 0], b[:, 5, 1]))
    assert gz.shape == gu.shape == (4, 5) and cz.shape == (5, 5)


def test_host_noise_matches_its_staged_stream():
    """Noise staged in the JAX host-noise layout drives the run whatever
    the seed, and gives the plain version's draws on the same noise."""
    V, y, prior_var, q0 = _problem(4)
    kw = dict(num_steps=10, block_chains=32, steps_per_block=10, device="cpu")
    g = torch.Generator().manual_seed(5)
    noise = (torch.randn((10, 8, C), generator=g), torch.rand((10, 8, C), generator=g),
             torch.randn((10, 8, C), generator=g))
    d1 = fused_linreg_gibbs_run(q0, 5, V, y, prior_var, 1.0, 0.2, noise=noise, **kw)
    d2 = fused_linreg_gibbs_run(q0, 6, V, y, prior_var, 1.0, 0.2, noise=noise, **kw)
    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2)
    plain = fused_linreg_gibbs_plain(density, torch.tensor(q0), num_steps=10, seed=0,
                                     noise=noise)
    assert torch.equal(d1, d2) and torch.equal(d1, plain.draws)
    with pytest.raises(ValueError, match="noise must be"):
        fused_linreg_gibbs_run(q0, 5, V, y, prior_var, 1.0, 0.2, noise=noise[:2], **kw)


def test_gamma_fallback_is_the_references():
    """No round accepts (uniforms of 1 against normals far in the tail):
    the draw is the reference's fallback ``d = shape - 1/3``."""
    V, y, prior_var, q0 = _problem(2)
    noise = (np.full((1, 8, C), 6.0, np.float32), np.ones((1, 8, C), np.float32),
             np.zeros((1, 8, C), np.float32))
    draws = fused_linreg_gibbs_run(q0, 0, V, y, prior_var, 1.0, 0.2, num_steps=1, d=2,
                                   block_chains=32, steps_per_block=1, noise=noise,
                                   device="cpu")
    resid = q0[:, :2] @ V.T - y
    rate = 0.2 + 0.5 * (resid * resid).sum(1)
    np.testing.assert_allclose(draws[0, :, 2].numpy(), gamma_constants(11.0)[0] / rate,
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(d=3), dict(block_chains=48), dict(steps_per_block=30),
                                dict(d=8)])
def test_bad_shapes_raise(kw):
    V, y, prior_var, q0 = _problem(4)
    args = dict(num_steps=10, steps_per_block=10, block_chains=32, device="cpu")
    args.update(kw)
    with pytest.raises(ValueError):
        fused_linreg_gibbs_run(q0, 0, V, y, prior_var, 1.0, 0.2, **args)
