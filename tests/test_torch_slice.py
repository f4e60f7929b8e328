"""The slice as a whole: warmup, pooling, sampling and ESS, as ``bench.py``
composes them (one warmup tile over all chains, step size and metric
pooled across chains), in the port and in the JAX package at C=64.

The JAX side runs in interpret mode with host noise; the port gets the same
noise through ``noise=``.  The pooled warmup is chaotic in float32 (see
``test_torch_fused_warmup.py``), so the two whole compositions agree as two
independent adaptive runs do; given the same warmup output, the rest of the
composition (pooling, sampling, ESS) agrees to float32 rounding.

Also here: the port imports neither JAX nor the JAX package, and its entry
points refuse to run without a card unless asked for the CPU.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.diagnostics import ess as jax_ess
from binf_tpu.ops.pallas.fused_hmc import (
    fused_linreg_hmc_run as jax_sample,
    linreg_unconstrained_logdensity,
)
from binf_tpu.ops.pallas.fused_potential import (
    fused_warmup_run as jax_warmup,
    tile_potential_from_scalar,
)
from binf_tpu_torch.diagnostics import ess
from binf_tpu_torch.example.polynomial import initial_positions, make_data
from binf_tpu_torch.ops.kernels.fused_hmc import (
    LinregDensity,
    fused_linreg_hmc_run,
    linreg_hmc_plain,
)
from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity
from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_run, fused_warmup_run
from binf_tpu_torch.ops.kernels.prng import philox_noise
from binf_tpu_torch.ops.math import vandermonde
from binf_tpu_torch.samplers.fused import fused_model_hmc

C = 64
N_WARMUP = 150
N_SAMPLES = 100
SEED = 4


def _jax_noise(seed, steps, d_pad=8):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    return (np.asarray(jax.random.normal(k1, (steps, d_pad, C), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32)))


def _min_ess(draws, ess_fn, exp):
    return min(float(ess_fn(draws[:, :, :4]).min()), float(ess_fn(exp(draws[:, :, 4]))))


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    x = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(x, 4, increasing=True).astype(np.float32)
    y = (V @ np.array([2.0, -4.0, 1.0, 1.5]) + rng.normal(size=20) / np.sqrt(2.5)
         ).astype(np.float32)
    prior_var = np.full(4, 5.0, np.float32)
    q0 = np.concatenate([1.0 + 0.1 * rng.normal(size=(C, 4)), np.zeros((C, 1))],
                        axis=1).astype(np.float32)

    logdensity = linreg_unconstrained_logdensity(
        jnp.asarray(V), jnp.asarray(y), jnp.asarray(prior_var), 1.0, 0.2)
    template = {"coefficients": jnp.zeros((4,), jnp.float32),
                "precision": jnp.zeros((), jnp.float32)}
    potential, consts, _ = tile_potential_from_scalar(logdensity, template)
    jq, jeps_c, jim_c = jax_warmup(potential, jnp.asarray(q0), SEED, 0.1, consts,
                                   num_warmup=N_WARMUP, block_chains=C, interpret=True,
                                   host_noise=True)
    jeps, jim = jnp.mean(jeps_c), jnp.mean(jim_c, axis=0)
    jd, ja = jax_sample(jq, SEED + 1, jnp.asarray(V), jnp.asarray(y),
                        jnp.asarray(prior_var), 1.0, 0.2, jeps, inverse_mass=jim,
                        num_steps=N_SAMPLES, steps_per_block=50, block_chains=C,
                        interpret=True, host_noise=True)
    jax_run = dict(q=np.asarray(jq), eps=float(jeps), im=np.asarray(jim),
                   draws=np.asarray(jd), accept=float(ja),
                   ess=_min_ess(jd, jax_ess, jnp.exp))

    density = LinregDensity.from_numpy(V, y, prior_var, 1.0, 0.2)
    sample_noise = _jax_noise(SEED + 1, N_SAMPLES)

    def port_sample(q, eps, im):
        draws, acc = fused_linreg_hmc_run(q, SEED + 1, V, y, prior_var, 1.0, 0.2, eps,
                                          inverse_mass=im, num_steps=N_SAMPLES,
                                          steps_per_block=50, block_chains=C,
                                          noise=sample_noise, device="cpu")
        return dict(draws=draws.numpy(), accept=float(acc),
                    ess=_min_ess(draws, ess, torch.exp))

    tq, teps_c, tim_c = fused_warmup_run(density, q0, SEED, 0.1, num_warmup=N_WARMUP,
                                         block_chains=C, noise=_jax_noise(SEED, N_WARMUP),
                                         device="cpu")
    teps, tim = teps_c.mean(), tim_c.mean(dim=0)
    port_run = dict(q=tq.numpy(), eps=float(teps), im=tim.numpy(),
                    **port_sample(tq, teps, tim))
    # the port's pooling, sampling and ESS, started from JAX's warmup output
    port_from_jax_warmup = port_sample(jax_run["q"], jax_run["eps"], jax_run["im"])
    margin = linreg_hmc_plain(
        density, torch.tensor(jax_run["q"]), torch.tensor([jax_run["eps"]]),
        torch.tensor(jax_run["im"]), num_steps=N_SAMPLES, num_leapfrog=10, seed=SEED + 1,
        noise=tuple(torch.tensor(a) for a in sample_noise)).margin
    return dict(V=V, y=y, jax=jax_run, port=port_run,
                port_from_jax_warmup=port_from_jax_warmup,
                min_margin=float(margin.abs().min()))


def test_composition_after_warmup_matches_jax(runs):
    """Same warmup output in: pooled sampling and ESS agree to rounding
    (no MH decision within 2e-5 of its threshold; the two sides' E0 - E1
    differ by ~1e-6 here)."""
    assert runs["min_margin"] > 2e-5
    got, ref = runs["port_from_jax_warmup"], runs["jax"]
    np.testing.assert_allclose(got["draws"], ref["draws"], atol=2e-4)
    assert got["accept"] == pytest.approx(ref["accept"], rel=1e-6)
    assert got["ess"] == pytest.approx(ref["ess"], rel=1e-3)


def _exact_posterior(V, y, precision):
    prec_mat = precision * V.T @ V + np.eye(4) / 5.0
    cov = np.linalg.inv(prec_mat)
    return cov @ (precision * V.T @ y)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_whole_slice_recovers_posterior(runs, side):
    """Each side's own adaptive run: calibrated acceptance, coefficient mean
    at the exact conditional Gaussian, precision at its Gamma
    self-consistency point (the checks of test_fused_hmc.py)."""
    run, V, y = runs[side], runs["V"], runs["y"]
    assert 0.6 < run["accept"] < 0.95
    draws = run["draws"][N_SAMPLES // 4:]
    coeffs = draws[..., :4].reshape(-1, 4)
    prec = np.exp(draws[..., 4]).reshape(-1)
    np.testing.assert_allclose(coeffs.mean(0), _exact_posterior(V, y, prec.mean()),
                               atol=0.1)
    ss = ((y[:, None] - V @ coeffs.T) ** 2).sum(0)
    np.testing.assert_allclose(prec.mean(), np.mean(11.0 / (0.2 + ss / 2)), rtol=0.1)


def test_whole_slice_matches_jax_adaptation(runs):
    """The two adaptive runs agree as two independent runs do: step size
    and metric within the tolerances of test_torch_fused_warmup.py,
    acceptance within 0.1, ESS within a factor 2."""
    port, ref = runs["port"], runs["jax"]
    assert port["eps"] == pytest.approx(ref["eps"], rel=0.3)
    np.testing.assert_allclose(port["im"], ref["im"], rtol=0.4)
    assert abs(port["accept"] - ref["accept"]) < 0.1
    assert 0.5 < port["ess"] / ref["ess"] < 2.0


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, binf_tpu_torch\n"
        "for m in pkgutil.walk_packages(binf_tpu_torch.__path__, 'binf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'binf_tpu' or k.startswith('binf_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('binf_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module of both slices was imported


def _density():
    V = vandermonde(torch.linspace(-2, 2, 20), 4)
    return LinregDensity(V, torch.zeros(20), torch.full((4,), 5.0), 1.0, 0.2)


@pytest.mark.parametrize("entry", [
    lambda: fused_linreg_hmc_run(torch.zeros((32, 5)), 0, torch.ones((20, 4)),
                                 torch.zeros(20), torch.ones(4), 1.0, 0.2, 0.1,
                                 inverse_mass=torch.ones(5), num_steps=10,
                                 steps_per_block=10, block_chains=32),
    lambda: fused_warmup_run(_density(), torch.zeros((32, 5)), 0, 0.1, num_warmup=10,
                             block_chains=32),
    lambda: make_data(torch.Generator().manual_seed(1)),
    lambda: initial_positions(8),
    lambda: philox_noise(0, 1, 8, 2, 5),
    lambda: fused_potential_hmc_run(DiagGaussianDensity([0.0], [1.0]), torch.zeros((32, 1)),
                                    0, 0.1, torch.ones(1), num_steps=10, steps_per_block=10,
                                    block_chains=32),
    lambda: fused_model_hmc(DiagGaussianDensity([0.0], [1.0]), {"x": torch.zeros((32, 1))},
                            0, warmup="fused"),
], ids=["fused_linreg_hmc_run", "fused_warmup_run", "make_data", "initial_positions",
        "philox_noise", "fused_potential_hmc_run", "fused_model_hmc"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without ``device``, an entry point runs on the card; with no
    card present it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
