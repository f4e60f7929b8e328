"""Port of ``diagnostics/rhat.py`` against the JAX package on seeded numpy
draws.  Both sides work in float32; the FFTs and reductions differ in
order, so values agree to ~1e-5 relative (1e-4 asserted).  Shapes with an
even and an odd pooled count cover the median trap (``torch.median``
returns the lower middle value, ``jnp.median`` averages the two)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages export a function named ``rhat`` beside the module
jrhat = importlib.import_module("binf_tpu.diagnostics.rhat")
trhat = importlib.import_module("binf_tpu_torch.diagnostics.rhat")

SHAPES = [(200, 8, 3), (201, 5)]


def _draws(shape, seed=0):
    """AR(1) chains with per-chain offsets: autocorrelated, not yet mixed."""
    rng = np.random.default_rng(seed)
    x = np.empty(shape, np.float32)
    x[0] = rng.normal(size=shape[1:])
    for t in range(1, shape[0]):
        x[t] = 0.7 * x[t - 1] + rng.normal(size=shape[1:])
    offsets = 0.1 * rng.normal(size=shape[1:])
    return (x + offsets + 2.0).astype(np.float32)


@pytest.mark.parametrize("name", ["split_rhat", "ess", "rhat", "ess_bulk", "ess_tail"])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax(name, shape):
    x = _draws(shape)
    expected = np.asarray(getattr(jrhat, name)(jnp.asarray(x)))
    got = getattr(trhat, name)(torch.tensor(x)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_summary_matches_jax(shape):
    x = _draws(shape, seed=1)
    expected = jrhat.summary({"v": jnp.asarray(x)})["v"]
    got = trhat.summary({"v": torch.tensor(x)})["v"]
    assert set(got) == set(expected)
    for key in expected:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(expected[key]),
                                   rtol=1e-4, err_msg=key)


def test_fold_uses_the_midpoint_median():
    x = np.array([[1.0, 2.0], [4.0, 10.0]], np.float32)  # pooled: 1, 2, 4, 10
    np.testing.assert_array_equal(trhat._fold(torch.tensor(x)).numpy(),
                                  np.asarray(jrhat._fold(jnp.asarray(x))))
    assert float(trhat._fold(torch.tensor(x))[0, 0]) == 2.0  # |1 - 3|


def test_quantile_beyond_torch_quantile_limit():
    """``torch.quantile`` refuses inputs above 2^24 values; the sort-based
    quantile takes them and interpolates linearly like ``jnp.quantile``."""
    n = (1 << 24) + 8
    x = torch.arange(n, dtype=torch.float32).flip(0)
    got = trhat._sorted_quantile(torch.sort(x).values, 0.25)
    assert float(got) == float(np.float32(0.25) * np.float32(n - 1))
