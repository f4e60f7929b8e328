"""The polynomial workload's run summaries (``example/polynomial.py``:
``MAPResult``, ``get_map``, ``predict``) and the package's top-level
exports, against the JAX package on the CPU.

Both summaries take the same numpy draws: ``get_map`` must pick the same
draw and return its values bit for bit, ``predict`` agree to 1e-5
relative (a float32 ``log_sum_exp`` over the draws).  The cases of
``tests/test_example.py`` run on the port's own collapsed Gibbs draws."""

import math

import binf_tpu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binf_tpu_torch
from binf_tpu.example import polynomial as jpoly
from binf_tpu_torch.example import get_map, predict
from binf_tpu_torch.example.polynomial import (
    MAPResult,
    initial_positions,
    make_collapsed_gibbs_kernel,
    make_data,
    make_posterior,
)
from binf_tpu_torch.parallel.runner import init_chains, run_chains


def _draws(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    coefficients = (np.array([2.0, -4.0, 1.0, 1.5]) + 0.1 * rng.normal(size=(n, 4)))
    precision = 2.5 * np.exp(0.2 * rng.normal(size=n))
    return {"coefficients": coefficients.astype(np.float32),
            "precision": precision.astype(np.float32)}


def test_get_map_matches_jax():
    draws = _draws(0)
    lps = np.random.default_rng(1).normal(size=400).astype(np.float32)
    mine = get_map({k: torch.tensor(v) for k, v in draws.items()}, torch.tensor(lps))
    ref = jpoly.get_map({k: jnp.asarray(v) for k, v in draws.items()}, jnp.asarray(lps))
    assert isinstance(mine, MAPResult)
    idx = int(np.argmax(lps))
    assert np.array_equal(mine.coefficients.numpy(), draws["coefficients"][idx])
    for a, b in zip(mine, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5)])
def test_predict_matches_jax(shape):
    draws = _draws(2)
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, size=shape).astype(np.float32)
    y = rng.normal(0.5, 2.0, size=shape).astype(np.float32)
    mine = predict(torch.tensor(x), torch.tensor(y),
                   {k: torch.tensor(v) for k, v in draws.items()}).numpy()
    ref = np.asarray(jpoly.predict(jnp.asarray(x), jnp.asarray(y),
                                   {k: jnp.asarray(v) for k, v in draws.items()}))
    assert mine.shape == ref.shape == shape
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def flat():
    """200 collapsed Gibbs sweeps of 64 chains on the CPU, the first 50
    dropped, flattened over draws (``tests/test_example.py``'s fixture)."""
    xses, ys = make_data(torch.Generator().manual_seed(1), device="cpu")
    posterior = make_posterior(xses, ys)
    kernel = make_collapsed_gibbs_kernel(posterior)
    states = init_chains(kernel, initial_positions(64, device="cpu"))
    _, samples = run_chains(kernel, torch.Generator().manual_seed(2), states, 200)
    return posterior, {"coefficients": samples["coefficients"][50:].reshape(-1, 4),
                       "precision": samples["precision"][50:].reshape(-1)}


def test_predict_matches_direct_computation(flat):
    """predict is the mean over draws of the pointwise Gaussian likelihood."""
    _, draws = flat
    sub = {k: v[:500] for k, v in draws.items()}
    x0, y0 = 0.5, 1.0
    dens = float(predict(torch.tensor([x0]), torch.tensor([y0]), sub)[0])
    c = sub["coefficients"].double().numpy()
    p = sub["precision"].double().numpy()
    mock = np.polynomial.polynomial.polyval(x0, c.T)
    lik = np.exp(-0.5 * (mock - y0) ** 2 * p) * np.sqrt(p / (2 * math.pi))
    assert dens == pytest.approx(float(lik.mean()), rel=1e-4)


def test_predict_integrates_to_one(flat):
    _, draws = flat
    sub = {k: v[:300] for k, v in draws.items()}
    ygrid = torch.linspace(-10.0, 15.0, 801)
    dens = predict(torch.full_like(ygrid, 1.0), ygrid, sub)
    assert float(torch.trapezoid(dens, ygrid)) == pytest.approx(1.0, abs=0.02)


def test_get_map(flat):
    posterior, draws = flat
    sub = {k: v[:1000] for k, v in draws.items()}
    lps = torch.func.vmap(lambda c, p: posterior.log_prob(coefficients=c, precision=p))(
        sub["coefficients"], sub["precision"])
    m = get_map(sub, lps)
    assert float(m.log_prob) == float(lps.max())
    assert float(m.log_prob) >= float(lps.median())


def test_top_level_exports_match_the_reference():
    """``binf_tpu_torch`` exports the reference's DSL names, one for one,
    ``frozen_dataclass`` standing for ``pytree_dataclass``."""
    mapped = ["frozen_dataclass" if n == "pytree_dataclass" else n for n in binf_tpu.__all__]
    assert binf_tpu_torch.__all__ == mapped
    for name in mapped:
        assert getattr(binf_tpu_torch, name) is not None
    from binf_tpu_torch import GaussianPrior, Posterior  # noqa: F401
    from binf_tpu_torch.core import frozen_dataclass
    from binf_tpu_torch.pdf import Posterior as P

    assert binf_tpu_torch.Posterior is P and binf_tpu_torch.frozen_dataclass is frozen_dataclass
