"""``fused_regression_hmc`` of the port against the JAX package's, on the
CPU at a small size (64 chains, 50 warmup and 50 sampling steps).

The polynomial posterior is built by both packages' ``make_posterior``
from the same numpy data.  The K2 stage gets the same adapted state and
the JAX host-noise stream (``fused_hmc.py:237-241``) on both sides; the
end-to-end runs draw their randomness from different generators, so they
are held to Monte Carlo error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.ops.pallas.fused_hmc import fused_linreg_hmc_run as jax_fused_linreg_hmc_run
from binf_tpu.samplers.fused import _introspect as jax_introspect
from binf_tpu.samplers.fused import fused_regression_hmc as jax_fused_regression_hmc
from binf_tpu_torch.example.polynomial import make_posterior
from binf_tpu_torch.ops.kernels.fused_hmc import linreg_hmc_plain
from binf_tpu_torch.samplers.fused import (
    FusedRegressionResult,
    _introspect,
    _regression_density,
    _regression_sample,
    eager_density,
    fused_regression_hmc,
)

C, WARMUP, SAMPLES, LEAP = 64, 50, 50, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    xs = np.linspace(-2.0, 2.0, 20).astype(np.float32)
    ys = (np.polyval([1.5, 1.0, -4.0, 2.0], xs) + rng.normal(size=20) / np.sqrt(2.5))
    return xs, ys.astype(np.float32)


def test_introspect_matches_jax(data):
    xs, ys = data
    jV, jy, jg, jn = jax_introspect(jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys)))
    V, y, gamma, gauss = _introspect(make_posterior(torch.tensor(xs), torch.tensor(ys)))
    # the Vandermonde columns are powers of x up to 3: float32 products
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), rtol=1e-6)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert float(gamma.shape_param) == float(jg.shape_param)
    assert float(gamma.rate) == pytest.approx(float(jg.rate), rel=1e-7)
    np.testing.assert_array_equal(gauss.means.cpu().numpy(), np.asarray(jn.means))
    np.testing.assert_array_equal(gauss.variances.cpu().numpy(), np.asarray(jn.variances))
    assert gauss.variable == jn.variable == "coefficients"


def _adapted(density):
    """An adapted state as fused_regression_hmc's warmup leaves it, on the CPU."""
    from binf_tpu_torch.samplers.adaptation import window_adaptation
    from binf_tpu_torch.samplers.hmc import hmc

    ld = eager_density(density, [("coefficients", (4,), 4), ("precision", (), 1)])

    def builder(eps, im):
        return hmc(ld, eps, LEAP, im)

    z = torch.randn((C, 4), generator=torch.Generator().manual_seed(3))
    pos = {"coefficients": density.prior_mean + 0.1 * z, "precision": torch.zeros(C)}
    return window_adaptation(builder, builder(0.05, None).init(pos),
                             torch.Generator().manual_seed(4), num_steps=WARMUP,
                             initial_step_size=0.05)


def test_k2_stage_matches_jax_on_the_same_state_and_noise(data):
    """fused_regression_hmc's sampling stage and JAX's ``fused_linreg_hmc_run`` (interpret
    mode, ``host_noise=True``) from one adapted state on one noise stream.
    On chains whose every MH decision lies more than 1e-4 from its threshold
    in the plain run (at least 90% of them), the draws agree within ten
    times the spread that a 1e-6 relative change of the start gives the
    plain version on the same noise, plus 1e-5: the adapted step carries
    float32 rounding further than the hand-set one of
    ``test_torch_fused_hmc.py``."""
    xs, ys = data
    V, y, gamma, gauss = _introspect(make_posterior(torch.tensor(xs), torch.tensor(ys)))
    density = _regression_density(V, y, gamma, gauss, torch.device("cpu"))
    adapt = _adapted(density)
    pos, im = adapt.final_states.position, adapt.inverse_mass
    seed = 12
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    mom = np.asarray(jax.random.normal(k1, (SAMPLES, 8, C), jnp.float32))
    unif = np.asarray(jax.random.uniform(k2, (SAMPLES, 1, C), jnp.float32))
    res = _regression_sample(density, pos, im, adapt.step_size, seed, num_samples=SAMPLES,
                             num_leapfrog=LEAP, noise=(torch.tensor(mom), torch.tensor(unif)))
    assert isinstance(res, FusedRegressionResult)
    q0 = torch.cat([pos["coefficients"], pos["precision"][:, None]], 1)
    jd, ja = jax_fused_linreg_hmc_run(
        jnp.asarray(q0.numpy()), seed, jnp.asarray(V.numpy()), jnp.asarray(y.numpy()),
        jnp.asarray(gauss.variances.numpy()), float(gamma.shape_param), float(gamma.rate),
        float(adapt.step_size), prior_mean=jnp.asarray(gauss.means.numpy()),
        inverse_mass=jnp.asarray(res.inverse_mass.numpy()), num_steps=SAMPLES,
        num_leapfrog=LEAP, block_chains=32, steps_per_block=SAMPLES, interpret=True,
        host_noise=True)
    jd = np.asarray(jd)
    noise = (torch.tensor(mom), torch.tensor(unif))
    kw = dict(num_steps=SAMPLES, num_leapfrog=LEAP, seed=seed, noise=noise)
    plain = linreg_hmc_plain(density, q0, adapt.step_size.reshape(1), res.inverse_mass, **kw)
    moved = q0 * (1.0 + 1e-6 * torch.randn(q0.shape, generator=torch.Generator().manual_seed(5)))
    pert = linreg_hmc_plain(density, moved, adapt.step_size.reshape(1), res.inverse_mass, **kw)
    margin = plain.margin
    calm = ((margin.abs() > 1e-4).all(dim=0) & ((margin < 0) == (pert.margin < 0)).all(dim=0))
    assert float(calm.float().mean()) >= 0.9
    spread = float((pert.draws - plain.draws)[:, calm].abs().max())
    got = torch.cat([res.samples["coefficients"], torch.log(res.samples["precision"])[..., None]],
                    -1)
    err = float((got[:, calm] - torch.tensor(jd)[:, calm]).abs().max())
    assert err <= 10 * spread + 1e-5, (err, spread)
    near = int((margin.abs() <= 1e-4).sum())
    assert abs(float(res.accept_rate) - float(ja)) * SAMPLES * C <= near + 0.5


def test_end_to_end_means_agree_with_jax_within_monte_carlo_error(data):
    """Both drivers on the same posterior, each from its own generator: the
    posterior means over the second half of the draws agree within four
    standard errors of the difference (the spread of the chains' means),
    and both accept in (0.5, 1)."""
    xs, ys = data
    jr = jax_fused_regression_hmc(jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys)),
                                  jax.random.key(0), n_chains=C, num_warmup=WARMUP,
                                  num_samples=SAMPLES, block_chains=32, interpret=True,
                                  host_noise=True)
    tr = fused_regression_hmc(make_posterior(torch.tensor(xs), torch.tensor(ys)), 0,
                              n_chains=C, num_warmup=WARMUP, num_samples=SAMPLES, device="cpu")
    assert tr.samples["coefficients"].shape == (SAMPLES, C, 4)
    assert tr.samples["precision"].shape == (SAMPLES, C)
    assert bool((tr.samples["precision"] > 0).all())
    for acc in (float(jr.accept_rate), float(tr.accept_rate)):
        assert 0.5 < acc < 1.0
    for name in ("coefficients", "precision"):
        j = np.asarray(jr.samples[name][SAMPLES // 2:], np.float64).reshape(SAMPLES // 2, C, -1)
        t = tr.samples[name][SAMPLES // 2:].double().numpy().reshape(SAMPLES // 2, C, -1)
        jm, tm = j.mean(0), t.mean(0)  # per chain
        se = np.sqrt(jm.var(0, ddof=1) / C + tm.var(0, ddof=1) / C)
        assert (np.abs(jm.mean(0) - tm.mean(0)) <= 4 * se).all(), (name, jm.mean(0), tm.mean(0), se)


def test_rejects_a_posterior_that_is_not_a_linear_regression():
    from binf_tpu_torch.example.chromatin import make_chromatin_posterior, synthetic_restraints

    _, log_target, W = synthetic_restraints(torch.Generator().manual_seed(0), 16,
                                            device="cpu")
    post = make_chromatin_posterior(log_target, W, use_pallas=False)
    with pytest.raises(ValueError, match="linear/polynomial"):
        fused_regression_hmc(post, 0, n_chains=8, device="cpu")
