"""Multinomial NUTS (``binf_tpu_torch/samplers/nuts.py``) against the JAX
package's ``binf_tpu/samplers/nuts.py``, on the CPU.

Deterministic: ``_trailing_zeros`` exactly, and a subtree built from the
same (q, p, grad, depth, signed eps, h0) by both packages: the JAX
package's ``build_subtree`` is taken from the closure of its kernel's
step and mapped over the chains.  End states, log-weight, momentum sum,
summed acceptance statistic and leaf count agree to 1e-5 relative (atol
1e-5: float32 rounding of up to 32 leapfrog steps in other orders), and
the turning and divergent flags exactly.  The proposal draws other
uniforms in each package and is not compared.  Statistical: the JAX
tests' bounds (``tests/test_nuts.py``), at fewer steps where the port's
eager loop would take longer than ~20 s for the file, and a Gibbs sweep
with ``nuts_block`` against the collapsed sampler at
``tests/test_gibbs.py``'s bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.samplers.nuts import _trailing_zeros as jax_trailing_zeros
from binf_tpu.samplers.nuts import nuts as jax_nuts
from binf_tpu_torch.example import polynomial as tpoly
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.samplers import conjugate, gibbs
from binf_tpu_torch.samplers.nuts import _trailing_zeros, build_subtree, nuts

RTOL = ATOL = 1e-5
C = 16
RHO = 0.9


def closure(fn) -> dict:
    """The free variables of a JAX kernel's closure, by name."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def gaussian_2d(pos):
    """x ~ N(1, 2^2), y ~ N(-1, 0.5^2), one value per chain."""
    return -0.5 * ((pos["x"] - 1.0) / 2.0) ** 2 - 0.5 * ((pos["y"] + 1.0) / 0.5) ** 2


def correlated(pos):
    x, y = pos["x"], pos["y"]
    return -(x ** 2 - 2 * RHO * x * y + y ** 2) / (2 * (1 - RHO ** 2))


def test_trailing_zeros_matches_jax():
    i = np.arange(1, 2049, dtype=np.int32)
    ref = np.asarray(jax.vmap(jax_trailing_zeros)(jnp.asarray(i)))
    assert [_trailing_zeros(int(k)) for k in i] == ref.tolist()


def _jax_side(fn, eps, im, max_doublings):
    jk = jax_nuts(fn, step_size=eps, max_doublings=max_doublings,
                  inverse_mass=None if im is None else {k: jnp.asarray(v) for k, v in im.items()})
    return closure(jk.step)["build_subtree"]


SUBTREES = [
    # depth, signed eps, metric, step scale of the start
    (0, 0.3, None, 1.0),
    (2, -0.25, None, 1.0),
    (3, 0.2, {"x": 2.0, "y": 0.5}, 1.0),
    (5, 0.1, None, 1.0),
    (5, -0.15, {"x": 0.7, "y": 1.3}, 1.0),
    (4, 3.0, None, 1.0),  # diverges on the way
]


@pytest.mark.parametrize("depth, eps, im, scale", SUBTREES)
@pytest.mark.parametrize("target", ["gaussian_2d", "correlated"])
def test_subtree_matches_jax(target, depth, eps, im, scale):
    fn = gaussian_2d if target == "gaussian_2d" else correlated
    rng = np.random.default_rng(depth)
    q = {k: (scale * rng.normal(size=C)).astype(np.float32) for k in ("x", "y")}
    p = {k: rng.normal(size=C).astype(np.float32) for k in ("x", "y")}
    if im is not None:
        p = {k: (v / np.sqrt(im[k])).astype(np.float32) for k, v in p.items()}
    jq, jp = ({k: jnp.asarray(v) for k, v in t.items()} for t in (q, p))
    ld, g = jax.vmap(jax.value_and_grad(fn))(jq)
    kin = 0.5 * sum(jp[k] ** 2 * (1.0 if im is None else im[k]) for k in jp)
    h0 = -ld + kin
    build = _jax_side(fn, abs(eps), im, 8)
    key = jax.random.key(7)
    (jend, _, jlw, jS, jalpha, jn, jturn, jdiv) = jax.vmap(
        lambda q_, p_, g_, h_: build(key, q_, p_, g_, depth, jnp.asarray(eps), h_))(jq, jp, g, h0)

    tq, tp, tg = ({k: torch.tensor(np.asarray(v)) for k, v in t.items()} for t in (q, p, g))
    t = build_subtree(fn, tq, tp, tg, depth, eps, torch.tensor(np.asarray(h0)),
                      torch.Generator().manual_seed(0),
                      inverse_mass=None if im is None else {k: torch.tensor(v) for k, v in
                                                            im.items()})
    assert t.num_leaves.tolist() == np.asarray(jn).tolist()
    assert t.turning.tolist() == np.asarray(jturn).tolist()
    assert t.divergent.tolist() == np.asarray(jdiv).tolist()
    for k in ("x", "y"):
        for got, ref in ((t.end[0][k], jend[0][k]), (t.end[1][k], jend[1][k]),
                         (t.end[3][k], jend[3][k]), (t.momentum_sum[k], jS[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    ok = np.isfinite(np.asarray(jlw))
    np.testing.assert_allclose(t.log_weight.numpy()[ok], np.asarray(jlw)[ok], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t.end[2].numpy(), np.asarray(jend[2]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.sum_alpha.numpy(), np.asarray(jalpha), rtol=RTOL, atol=ATOL)
    if eps == 3.0:
        assert t.divergent.any()


def test_moments_isotropic():
    """``tests/test_nuts.py::test_moments_isotropic``'s bounds, 256 chains,
    200 steps (500 there), the first 50 dropped (200 there)."""
    kernel = nuts(gaussian_2d, step_size=0.5, max_doublings=6)
    states = init_chains(kernel, {"x": torch.zeros(256), "y": torch.zeros(256)})
    _, s = run_chains(kernel, torch.Generator().manual_seed(0), states, 200)
    x, y = s["x"][50:].numpy().ravel(), s["y"][50:].numpy().ravel()
    assert abs(x.mean() - 1.0) < 0.15
    assert abs(x.std() - 2.0) < 0.25
    assert abs(y.mean() + 1.0) < 0.05
    assert abs(y.std() - 0.5) < 0.06


def test_moments_correlated():
    """``tests/test_nuts.py::test_moments_correlated``'s bounds, 128 chains,
    250 steps (600 there), the first 50 dropped (200 there)."""
    kernel = nuts(correlated, step_size=0.3, max_doublings=8)
    states = init_chains(kernel, {"x": torch.zeros(128), "y": torch.zeros(128)})
    _, s = run_chains(kernel, torch.Generator().manual_seed(1), states, 250)
    x, y = s["x"][50:].numpy().ravel(), s["y"][50:].numpy().ravel()
    assert abs(x.mean()) < 0.12
    assert abs(x.std() - 1.0) < 0.12
    assert abs(np.corrcoef(x, y)[0, 1] - 0.9) < 0.05


def test_divergence_detection():
    """``tests/test_nuts.py::test_divergence_detection``: a step of 100 on
    the 2-D Gaussian diverges in the first doubling and keeps the start."""
    kernel = nuts(gaussian_2d, step_size=100.0, max_doublings=5)
    state = kernel.init({"x": torch.tensor(0.0), "y": torch.tensor(0.0)})
    new, info = kernel.step(torch.Generator().manual_seed(0), state)
    assert bool(info.is_divergent)
    assert int(info.num_doublings) <= 5
    assert float(new.position["x"]) == 0.0 and float(new.position["y"]) == 0.0


def test_no_uturn_before_half_period():
    """``tests/test_nuts.py::test_no_uturn_before_half_period``: 64 steps
    of the same state terminate by U-turn, well short of 2^10 leaves; the
    lockstep count is 2^(deepest) - 1."""
    kernel = nuts(gaussian_2d, step_size=0.25, max_doublings=10)
    state = kernel.init({"x": torch.ones(64), "y": -torch.ones(64)})
    _, info = kernel.step(torch.Generator().manual_seed(0), state)
    assert float(info.is_turning.float().mean()) > 0.9
    assert int(info.num_integration_steps.max()) < 1024
    assert int(info.num_integration_steps.max()) <= 2 ** int(info.num_doublings.max()) - 1


def test_energy_mean_accept_high_for_small_step():
    kernel = nuts(gaussian_2d, step_size=0.05, max_doublings=8)
    state = kernel.init({"x": torch.tensor(0.5), "y": torch.tensor(-0.8)})
    _, info = kernel.step(torch.Generator().manual_seed(0), state)
    assert float(info.acceptance_prob) > 0.95


def test_nuts_block_in_a_gibbs_sweep():
    """``nuts_block`` on the coefficients and the conjugate precision block
    against the collapsed sampler on the polynomial posterior, at
    ``tests/test_gibbs.py::test_rwm_gibbs_agrees_with_collapsed``'s bounds
    (coefficient means within 0.12, the precision's mean within 12%)."""
    rng = np.random.default_rng(42)
    xses = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(xses, 4, increasing=True)
    ys = (V @ np.array([2.0, -4.0, 1.0, 1.5]) + rng.normal(size=20) / np.sqrt(2.5))
    post = tpoly.make_posterior(xses, ys.astype(np.float32))
    kernel = gibbs.gibbs({"coefficients": gibbs.nuts_block(post, "coefficients", 0.08,
                                                           max_doublings=6),
                          "precision": conjugate.gamma_precision_block(post, "precision")})
    start = tpoly.initial_positions(64, device="cpu")
    _, s = run_chains(kernel, torch.Generator().manual_seed(3), init_chains(kernel, start), 120)
    col = tpoly.make_collapsed_gibbs_kernel(post)
    _, r = run_chains(col, torch.Generator().manual_seed(4), init_chains(col, start), 300)
    np.testing.assert_allclose(s["coefficients"][40:].reshape(-1, 4).mean(0).numpy(),
                               r["coefficients"][100:].reshape(-1, 4).mean(0).numpy(), atol=0.12)
    np.testing.assert_allclose(float(s["precision"][40:].mean()),
                               float(r["precision"][100:].mean()), rtol=0.12)
