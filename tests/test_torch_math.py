"""Port of ``ops/math.py`` and the warmup schedule against the JAX package.

Float32 on both sides; tolerances allow a few ulps of reordering.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops import math as jmath
from binf_tpu.samplers.adaptation import _stan_boundaries as jax_boundaries
from binf_tpu_torch.ops import math as tmath
from binf_tpu_torch.samplers.adaptation import _stan_boundaries


def test_vandermonde_and_polyval_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=17).astype(np.float32)
    c = rng.normal(size=5).astype(np.float32)
    np.testing.assert_allclose(
        tmath.vandermonde(torch.tensor(x), 5).numpy(),
        np.asarray(jmath.vandermonde(jnp.asarray(x), 5)), rtol=1e-6)
    # a 5-term sum of values up to ~16 * |c|: a few ulps of the largest term
    np.testing.assert_allclose(
        tmath.polyval(torch.tensor(x), torch.tensor(c)).numpy(),
        np.asarray(jmath.polyval(jnp.asarray(x), jnp.asarray(c))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("regularize", [True, False])
def test_welford_variance_matches_jax(regularize):
    rng = np.random.default_rng(1)
    xs = rng.normal(loc=3.0, scale=[0.1, 1.0, 4.0], size=(40, 3)).astype(np.float32)
    js = jmath.welford_init(jnp.zeros(3))
    ts = tmath.welford_init(torch.zeros(3))
    for x in xs:
        js = jmath.welford_update(js, jnp.asarray(x))
        ts = tmath.welford_update(ts, torch.tensor(x))
    np.testing.assert_allclose(tmath.welford_mean(ts).numpy(),
                               np.asarray(jmath.welford_mean(js)), rtol=1e-6)
    # the same update sequence in float32: equal up to rounding of 40 steps
    np.testing.assert_allclose(
        tmath.welford_variance(ts, regularize=regularize).numpy(),
        np.asarray(jmath.welford_variance(js, regularize=regularize)), rtol=1e-5)
    np.testing.assert_allclose(tmath.welford_variance(ts, regularize=False).numpy(),
                               xs.var(axis=0, ddof=1), rtol=1e-4)


@pytest.mark.parametrize("num_steps", [6, 20, 100, 149, 150, 151, 200, 500, 1000, 4000])
def test_stan_boundaries_match_jax(num_steps):
    assert _stan_boundaries(num_steps) == jax_boundaries(num_steps)
