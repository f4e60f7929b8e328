"""Dense-metric HMC (``samplers/dense.py``, ``hmc.DenseMetric``) and
``fused_model_hmc(warmup="dense")`` against the JAX package, on the CPU.

The deterministic pieces (the flattening, the momentum factor W, the
batched covariance update and its harvest, the window bookkeeping, the
kinetic energies) take the same numpy inputs in both packages and agree to
1e-5 relative: float32 rounding in sums taken in other orders.  The
adaptation and the fused run draw other noise in each package, so they are
held to the JAX tests' statistical bounds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.samplers import dense as jdense
from binf_tpu.samplers.adaptation import _stan_window_schedule as jax_schedule
from binf_tpu.samplers.fused import fused_model_hmc as jax_fused_model_hmc
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.samplers import dense as tdense
from binf_tpu_torch.samplers import hmc as thmc
from binf_tpu_torch.samplers.adaptation import _stan_window_schedule
from binf_tpu_torch.samplers.fused import fused_model_hmc

# the JAX package's samplers/__init__ re-exports the function hmc over the module
jhmc = importlib.import_module("binf_tpu.samplers.hmc")
RTOL = 1e-5


def _correlated_gaussian(d=6, rho=0.95, seed=0):
    """``tests/test_dense.py::_correlated_gaussian`` for a chain batch:
    N(mu, S) with equicorrelation rho and scales exp(linspace(-1, 1.5))."""
    rng = np.random.default_rng(seed)
    scales = np.exp(np.linspace(-1.0, 1.5, d))
    corr = np.full((d, d), rho) + (1 - rho) * np.eye(d)
    S = np.diag(scales) @ corr @ np.diag(scales)
    mu = rng.normal(size=d)
    P = torch.tensor(np.linalg.inv(S), dtype=torch.float32)
    mu_t = torch.tensor(mu, dtype=torch.float32)

    def logdensity(pos):
        x = pos["x"] - mu_t
        return -0.5 * torch.sum((x @ P) * x, dim=-1)

    return logdensity, mu, S


def _corr(m):
    m = np.asarray(m, np.float64)
    return m / np.sqrt(np.outer(np.diag(m), np.diag(m)))


def _spd(d, seed):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)


def test_flatten_spec_round_trip_matches_jax():
    template = {"a": np.zeros((2, 3)), "b": np.zeros(()), "c": np.zeros((4,))}
    pos = {"a": np.arange(24.0).reshape(4, 2, 3), "b": np.arange(4.0),
           "c": np.arange(16.0).reshape(4, 4)}
    tpack, tunpack, d = tdense.flatten_spec({k: torch.tensor(v) for k, v in template.items()})
    jpack, _, jd = jdense.flatten_spec({k: jnp.asarray(v) for k, v in template.items()})
    assert d == jd == 11
    q = tpack({k: torch.tensor(v) for k, v in pos.items()})
    assert q.shape == (4, 11)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jpack({k: jnp.asarray(v)
                                                              for k, v in pos.items()})))
    back = tunpack(q)
    for k, v in pos.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    assert tunpack(q[0])["b"].shape == ()


def test_metric_ops_matches_jax():
    minv = _spd(5, 1)
    W = tdense._metric_ops(torch.tensor(minv))
    np.testing.assert_allclose(W.numpy(), np.asarray(jdense._metric_ops(jnp.asarray(minv))),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose((W @ W.T).numpy(), np.linalg.inv(minv), rtol=1e-4, atol=1e-4)


def test_batch_cov_update_and_harvest_match_jax():
    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(32, 4)) * [1.0, 2.0, 0.5, 3.0] + 1.0).astype(np.float32)
               for _ in range(6)]
    tn, tm, t2 = 0.0, torch.zeros(4), torch.zeros((4, 4))
    jn, jm, j2 = jnp.zeros(()), jnp.zeros(4), jnp.zeros((4, 4))
    for Q in batches:
        tn, tm, t2 = tdense._batch_cov_update(tn, tm, t2, torch.tensor(Q))
        jn, jm, j2 = jdense._batch_cov_update(jn, jm, j2, jnp.asarray(Q))
        assert tn == float(jn)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(tdense._harvest_cov(tn, t2).numpy(),
                               np.asarray(jdense._harvest_cov(jn, j2)), rtol=RTOL, atol=1e-7)


def test_window_bookkeeping_matches_jax():
    """One seeded stream of position batches through the Stan schedule, the
    batched covariance update and the harvest in both packages: the metric
    harvested at every window end agrees at 1e-5 relative."""
    num_steps, C, D = 300, 16, 3
    slow, reset = _stan_window_schedule(num_steps)
    j_slow, j_reset = jax_schedule(num_steps)
    assert list(slow) == [bool(x) for x in j_slow] and list(reset) == [bool(x) for x in j_reset]
    rng = np.random.default_rng(3)
    stream = (rng.normal(size=(num_steps, C, D)) * [0.5, 1.0, 2.0]).astype(np.float32)
    stream[:, :, 1] += 0.8 * stream[:, :, 0]
    t_state = (0.0, torch.zeros(D), torch.zeros((D, D)))
    j_state = (jnp.zeros(()), jnp.zeros(D), jnp.zeros((D, D)))
    harvested = 0
    for Q, is_slow, is_reset in zip(stream, slow, reset):
        if is_slow:
            t_state = tdense._batch_cov_update(*t_state, torch.tensor(Q))
            j_state = jdense._batch_cov_update(*j_state, jnp.asarray(Q))
        if is_reset:
            t_minv = tdense._harvest_cov(t_state[0], t_state[2])
            j_minv = jdense._harvest_cov(j_state[0], j_state[2])
            np.testing.assert_allclose(t_minv.numpy(), np.asarray(j_minv), rtol=RTOL,
                                       atol=1e-7)
            harvested += 1
            t_state = (0.0, torch.zeros(D), torch.zeros((D, D)))
            j_state = (jnp.zeros(()), jnp.zeros(D), jnp.zeros((D, D)))
    assert harvested == sum(reset) >= 3


def test_kinetic_energy_and_velocity_match_jax():
    """Dense (``DenseMetric``) and diagonal metrics on the same momenta:
    the port's batched kinetic energies and velocities against the JAX
    package's, chain by chain."""
    rng = np.random.default_rng(4)
    p = {"a": rng.normal(size=(8, 2)).astype(np.float32),
         "b": rng.normal(size=8).astype(np.float32)}
    template = {"a": np.zeros(2, np.float32), "b": np.zeros((), np.float32)}
    minv = _spd(3, 5)
    t_dense = thmc.DenseMetric(torch.tensor(minv),
                               {k: torch.tensor(v) for k, v in template.items()})
    j_dense = jhmc.DenseMetric(jnp.asarray(minv),
                               {k: jnp.asarray(v) for k, v in template.items()})
    diag = {"a": np.array([0.5, 2.0], np.float32), "b": np.float32(3.0)}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for t_im, j_im in ((t_dense, j_dense),
                       ({k: torch.tensor(v) for k, v in diag.items()},
                        {k: jnp.asarray(v) for k, v in diag.items()})):
        k_t = thmc.kinetic_energy(tp, t_im, 1)
        k_j = jax.vmap(lambda q: jhmc.kinetic_energy(q, j_im))(jp)
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=RTOL)
        v_t = thmc.metric_velocity(tp, t_im)
        v_j = jax.vmap(lambda q: jhmc.metric_velocity(q, j_im))(jp)
        for k in p:
            np.testing.assert_allclose(v_t[k].numpy(), np.asarray(v_j[k]), rtol=RTOL,
                                       atol=1e-6)


def test_dense_metric_momenta_have_covariance_m():
    """``DenseMetric.sample`` draws a batch of momenta with covariance M."""
    minv = _spd(3, 6)
    metric = thmc.DenseMetric(torch.tensor(minv), {"x": torch.zeros(3)})
    p = thmc.sample_momentum(torch.Generator().manual_seed(0), {"x": torch.zeros((40000, 3))},
                             metric)["x"]
    np.testing.assert_allclose(np.cov(p.numpy().T), np.linalg.inv(minv), atol=0.05)


def test_dense_adaptation_recovers_metric_and_moments():
    """The JAX test's criterion (``tests/test_dense.py``): the adapted
    metric's correlation within 0.25 of the target's, acceptance in (0.6,
    1], and the adapted kernel's moments within 0.25 (means) and 25%
    (standard deviations)."""
    logdensity, mu, S = _correlated_gaussian(d=6, rho=0.95)
    pos = {"x": 0.5 * torch.randn((256, 6), generator=torch.Generator().manual_seed(0))}
    adapt = tdense.dense_window_adaptation(logdensity, pos, torch.Generator().manual_seed(1),
                                           num_steps=600, num_integration_steps=8)
    assert np.abs(_corr(adapt.inverse_mass_matrix.numpy()) - _corr(S)).max() < 0.25
    assert 0.6 < float(adapt.accept_rate) <= 1.0
    kernel = tdense.dense_hmc(logdensity, {"x": torch.zeros(6)}, adapt.step_size, 8,
                              inverse_mass_matrix=adapt.inverse_mass_matrix)
    _, samples = run_chains(kernel, torch.Generator().manual_seed(2),
                            init_chains(kernel, adapt.final_positions), 400)
    X = samples["x"][100:].reshape(-1, 6).numpy()
    np.testing.assert_allclose(X.mean(0), mu, atol=0.25)
    np.testing.assert_allclose(X.std(0), np.sqrt(np.diag(S)), rtol=0.25)


def test_hmc_with_a_dense_metric_samples_the_target():
    """``hmc`` takes a ``DenseMetric`` through the shared metric helpers."""
    logdensity, mu, S = _correlated_gaussian(d=4, rho=0.9, seed=5)
    metric = thmc.DenseMetric(torch.tensor(S, dtype=torch.float32), {"x": torch.zeros(4)})
    kernel = thmc.hmc(logdensity, 0.3, 8, metric)
    start = {"x": torch.tensor(mu, dtype=torch.float32).expand(128, 4).clone()}
    _, samples = run_chains(kernel, torch.Generator().manual_seed(3), init_chains(kernel, start),
                            300)
    X = samples["x"][50:].reshape(-1, 4).numpy()
    np.testing.assert_allclose(X.mean(0), mu, atol=0.25)
    np.testing.assert_allclose(X.std(0), np.sqrt(np.diag(S)), rtol=0.25)


def test_fused_dense_matches_jax():
    """``fused_model_hmc(warmup="dense")``: the port (the eager dense
    warmup, then K4's plain version with the (D, D) metric) against the JAX
    package (interpret mode, as ``tests/test_fused_dense.py`` runs it) on
    its correlated target; other noise, so each is held to the JAX test's
    bounds and the two to 0.3 of each other."""
    rng = np.random.default_rng(0)
    d, rho = 4, 0.9
    scales = np.exp(np.linspace(-0.5, 1.0, d))
    S = np.diag(scales) @ (np.full((d, d), rho) + (1 - rho) * np.eye(d)) @ np.diag(scales)
    mu = rng.normal(size=d) * 0.5
    P = np.linalg.inv(S)
    pos = (0.3 * np.random.default_rng(1).normal(size=(64, d))).astype(np.float32)
    kw = dict(num_warmup=400, num_samples=500, block_chains=32, warmup="dense")
    mu_j, P_j = jnp.asarray(mu, jnp.float32), jnp.asarray(P, jnp.float32)
    j = jax_fused_model_hmc(lambda q: -0.5 * (q["x"] - mu_j) @ (P_j @ (q["x"] - mu_j)),
                            {"x": jnp.asarray(pos)}, jax.random.key(1), **kw)
    mu_t, P_t = torch.tensor(mu, dtype=torch.float32), torch.tensor(P, dtype=torch.float32)
    t = fused_model_hmc(lambda q: -0.5 * (q["x"] - mu_t) @ (P_t @ (q["x"] - mu_t)),
                        {"x": torch.tensor(pos)}, 1, device="cpu", **kw)
    assert t.inverse_mass.shape == (4, 4) and t.step_size.dim() == 0
    stats = []
    for r in (t, j):
        assert 0.5 < float(r.accept_rate) <= 1.0
        assert np.abs(_corr(np.asarray(r.inverse_mass)) - _corr(S)).max() < 0.3
        X = np.asarray(r.samples["x"][150:]).reshape(-1, 4)
        np.testing.assert_allclose(X.mean(0), mu, atol=0.3)
        np.testing.assert_allclose(X.std(0), np.sqrt(np.diag(S)), rtol=0.3)
        stats.append((X.mean(0), X.std(0)))
    np.testing.assert_allclose(stats[0][0], stats[1][0], atol=0.3)
    np.testing.assert_allclose(stats[0][1], stats[1][1], rtol=0.3)
    assert float(t.step_size) == pytest.approx(float(j.step_size), rel=0.5)
