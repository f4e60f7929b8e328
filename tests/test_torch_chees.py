"""ChEES-HMC (``samplers/chees.py``) and ``fused_model_hmc(warmup="xla",
trajectory="chees")`` against the JAX package, on the CPU.

``leapfrog_dynamic`` takes the same inputs in both packages and agrees to
1e-5 relative.  The adaptation and the samplers draw other noise in each
package, so they are held to the JAX tests' criteria
(``tests/test_chees.py``) and, where both run the same posterior, to each
other within five Monte Carlo standard errors."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers import chees as jchees
from binf_tpu.samplers.fused import fused_model_hmc as jax_fused_model_hmc
from binf_tpu_torch.example.polynomial import make_posterior
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import chees as tchees
from binf_tpu_torch.samplers.fused import fused_model_hmc
from binf_tpu_torch.samplers.hmc import DenseMetric, value_and_grad

# the JAX package's samplers/__init__ re-exports the function hmc over the module
JDenseMetric = importlib.import_module("binf_tpu.samplers.hmc").DenseMetric
RTOL = 1e-5
SCALES = (10.0, 1.0, 0.1)


def test_halton_matches_jax():
    np.testing.assert_array_equal(tchees.halton_sequence(300), jchees.halton_sequence(300))


@pytest.mark.parametrize("metric", ["identity", "diagonal", "dense"])
def test_leapfrog_dynamic_matches_jax(metric):
    """Seven steps on a Gaussian from the same (q, p, eps) in both packages,
    with no metric, a diagonal one, or a dense one; the port steps a batch
    of 4 chains, the JAX package each chain alone."""
    rng = np.random.default_rng(0)
    q = {"x": rng.normal(size=4).astype(np.float32),
         "y": rng.normal(size=(4, 2)).astype(np.float32)}
    p = {"x": rng.normal(size=4).astype(np.float32),
         "y": rng.normal(size=(4, 2)).astype(np.float32)}
    diag = {"x": np.float32(0.5), "y": np.array([2.0, 0.3], np.float32)}
    minv = np.array([[0.5, 0.1, 0.0], [0.1, 2.0, 0.2], [0.0, 0.2, 0.3]], np.float32)

    def j_logp(pos):
        return -0.5 * (pos["x"] ** 2 + jnp.sum((pos["y"] - 1.0) ** 2 / jnp.array([1.0, 4.0])))

    def t_logp(pos):
        return -0.5 * (pos["x"] ** 2 + torch.sum((pos["y"] - 1.0) ** 2 / torch.tensor([1.0, 4.0]),
                                                 dim=-1))

    if metric == "identity":
        j_im = t_im = None
    elif metric == "diagonal":
        j_im = {k: jnp.asarray(v) for k, v in diag.items()}
        t_im = {k: torch.tensor(v) for k, v in diag.items()}
    else:
        j_im = JDenseMetric(jnp.asarray(minv), {"x": jnp.zeros(()), "y": jnp.zeros(2)})
        t_im = DenseMetric(torch.tensor(minv), {"x": torch.zeros(()), "y": torch.zeros(2)})
    j_vg = jax.value_and_grad(j_logp)

    def j_run(qc, pc):
        _, g = j_vg(qc)
        return jchees.leapfrog_dynamic(j_vg, qc, pc, g, jnp.asarray(0.1), jnp.asarray(7), j_im)

    jq, jp, jld, _ = jax.vmap(j_run)({k: jnp.asarray(v) for k, v in q.items()},
                                     {k: jnp.asarray(v) for k, v in p.items()})
    t_vg = value_and_grad(t_logp)
    tq0 = {k: torch.tensor(v) for k, v in q.items()}
    _, g0 = t_vg(tq0)
    tq, tp, tld, _ = tchees.leapfrog_dynamic(t_vg, tq0, {k: torch.tensor(v) for k, v in p.items()},
                                             g0, torch.tensor(0.1), torch.tensor(7), t_im)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), rtol=RTOL)
    for k in q:
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]), rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=1e-6)


def test_leapfrog_counts_round_as_jax():
    """``clip(ceil(h 2T / eps), 1, max_leapfrog)`` in float32, as the JAX
    warmup computes it, across the Halton table and a range of T / eps."""
    h = tchees.halton_sequence(256).astype(np.float32)
    T = np.float32(0.7)
    for eps in (np.float32(0.003), np.float32(0.0123), np.float32(0.5)):
        t = tchees._leapfrog_count(torch.tensor(h), torch.tensor(T), torch.tensor(eps), 128)
        j = jnp.clip(jnp.ceil(jnp.asarray(h) * 2.0 * T / eps).astype(jnp.int32), 1, 128)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _anisotropic(pos):
    return -0.5 * torch.sum((pos["z"] / torch.tensor(SCALES)) ** 2, dim=-1)


@pytest.fixture(scope="module")
def adapted():
    """``tests/test_chees.py``'s target: scales (10, 1, 0.1), 128 chains
    from 0.1 N(0, 1), warmup from a step of 0.1; 400 steps where the JAX
    test takes 600, since each eager step here runs its whole trajectory
    as PyTorch calls (9 s on the CPU at 600)."""
    positions = {"z": 0.1 * torch.randn((128, 3), generator=torch.Generator().manual_seed(0))}
    return tchees.chees_adaptation(_anisotropic, positions, torch.Generator().manual_seed(1),
                                   num_steps=400, initial_step_size=0.1)


def test_adaptation_finds_long_trajectories(adapted):
    """The JAX test's criterion: acceptance in (0.3, 1), a trajectory of
    more than two steps, finite positions; the metric learns the scales."""
    eps, T = float(adapted.step_size), float(adapted.trajectory_length)
    assert 0.3 < float(adapted.mean_accept) < 1.0
    assert T / eps > 2.0
    assert bool(torch.isfinite(adapted.final_positions["z"]).all())
    np.testing.assert_allclose(adapted.inverse_mass["z"].sqrt().numpy(), SCALES, rtol=0.5)


def test_chees_hmc_moments(adapted):
    kernel = tchees.chees_hmc(_anisotropic, adapted.step_size, adapted.trajectory_length,
                              adapted.inverse_mass)
    states = init_chains(kernel, adapted.final_positions)
    final, info = run_chains(kernel, torch.Generator().manual_seed(2), states, 300,
                             collect=lambda s, i: (s.position["z"], i.num_integration_steps))
    z, L = info
    assert int(final.counter) == 300
    assert bool((L >= 1).all()) and int(L.max()) <= 1000
    x = z[50:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(x.std(0), SCALES, rtol=0.2)
    assert bool((np.abs(x.mean(0)) < 0.25 * np.asarray(SCALES)).all())


def _polynomial(n_chains=64):
    rng = np.random.default_rng(3)
    xs = np.linspace(-2, 2, 20).astype(np.float32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    init = {"coefficients": (0.1 * rng.normal(size=(n_chains, 4))).astype(np.float32),
            "precision": np.zeros(n_chains, np.float32)}
    return xs, ys, init


def test_fused_model_hmc_xla_chees_matches_jax():
    """``fused_model_hmc(warmup="xla", trajectory="chees")``: the eager
    ChEES warmup over all chains, then K4's plain version jittering its
    trajectories around the adapted T, against the JAX package's run
    (interpret mode) on the polynomial posterior.  Other noise: the
    coefficient means agree within five Monte Carlo standard errors of the
    difference (ESS taken as a quarter of the kept draws), the precision
    within 10%; T is one scalar within [eps, max_leapfrog eps]."""
    xs, ys, init = _polynomial()
    kw = dict(num_warmup=150, num_samples=200, block_chains=32, warmup="xla",
              trajectory="chees", max_leapfrog=64)
    jld = jax_transform(jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys)).log_prob,
                        {"precision": JLogTransform})
    j = jax_fused_model_hmc(jld, {k: jnp.asarray(v) for k, v in init.items()},
                            jax.random.key(0), **kw)
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    t = fused_model_hmc(tld, init, 0, device="cpu", **kw)
    assert t.trajectory_length.dim() == 0 and t.step_size.dim() == 0
    assert t.inverse_mass.shape == (5,)
    eps, T = float(t.step_size), float(t.trajectory_length)
    assert eps * (1 - 1e-6) <= T <= 64 * eps * (1 + 1e-6)
    assert 0.45 < float(t.accept_rate) < 0.99

    def kept(s):
        return np.asarray(s["coefficients"])[50:].reshape(-1, 4)

    a, b = kept(t.samples), kept(j.samples)
    se = np.sqrt(a.var(0) / (len(a) / 4) + b.var(0) / (len(b) / 4))
    assert bool((np.abs(a.mean(0) - b.mean(0)) < 5 * se).all())
    prec = [np.exp(np.asarray(r.samples["precision"])[50:]).mean() for r in (t, j)]
    assert prec[0] == pytest.approx(prec[1], rel=0.1)
