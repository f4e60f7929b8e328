"""MALA (``binf_tpu_torch/samplers/mala.py``) against the JAX package's
``binf_tpu/samplers/mala.py``, on the CPU.

The deterministic piece takes the JAX step's own noise: the test replays
its key split, hands the port the same normals, and holds the port's
proposal to the JAX kernel's at 1e-5 relative, and its Metropolis-Hastings
log ratio (the reverse-proposal correction included) at 1e-5 relative to
the log densities it is the difference of (~90 here: float32 rounding of
those sums, taken in other orders, is ~1e-5 absolute).  The port's log ratio is also
evaluated with the JAX kernel's own ``transition_logdensity`` and
gradient, taken from its closure.  The statistical tests keep the JAX
tests' bounds (``tests/test_samplers.py::TestMALA``), and a Gibbs sweep
with ``mala_block`` against the collapsed sampler at
``tests/test_gibbs.py``'s bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.logistic import make_logistic_posterior as jax_logistic
from binf_tpu.example.logistic import synthetic_logistic_data
from binf_tpu.ops.tree import tree_normal_like
from binf_tpu.samplers.mala import mala as jax_mala
from binf_tpu_torch.example import polynomial as tpoly
from binf_tpu_torch.example.logistic import make_logistic_posterior
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.samplers import conjugate, gibbs
from binf_tpu_torch.samplers.fused import eager_density
from binf_tpu_torch.samplers.mala import MALAState, mala, mala_log_ratio, mala_proposal

RTOL = 1e-5
C = 16


def closure(fn) -> dict:
    """The free variables of a JAX kernel's closure, by name."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.fixture(scope="module")
def logistic():
    X, y = synthetic_logistic_data(jax.random.key(0))
    jpost = jax_logistic(X, y)
    tpost = make_logistic_posterior(np.asarray(X), np.asarray(y), device="cpu")
    rng = np.random.default_rng(0)
    w = (np.asarray([1.5, -2.0, 0.75, 0.0, 1.0]) + 0.3 * rng.normal(size=(C, 5))).astype(
        np.float32)
    return jpost, tpost, w


@pytest.mark.parametrize("eps", [0.05, 0.2])
def test_proposal_and_log_ratio_match_jax(logistic, eps):
    jpost, tpost, w = logistic
    jk = jax_mala(lambda p: jpost.log_prob(p), eps)
    keys = jax.random.split(jax.random.key(3), C)
    jstate = jax.vmap(jk.init)({"weights": jnp.asarray(w)})
    jnew, jinfo = jax.vmap(jk.step)(keys, jstate)
    # the step's noise: key_prop of its split, through tree_normal_like
    noise = np.stack([np.asarray(tree_normal_like(jax.random.split(k)[0],
                                                  {"weights": jnp.zeros(5)})["weights"])
                      for k in keys])

    tk = mala(eager_density(tpost.log_prob, [("weights", (5,), 5)]), eps)
    state = tk.init({"weights": torch.tensor(w)})
    np.testing.assert_allclose(state.logdensity.numpy(), np.asarray(jstate.logdensity),
                               rtol=RTOL)
    prop = mala_proposal(state.position, state.logdensity_grad,
                         {"weights": torch.tensor(noise)}, eps)
    p_ld = tpost.log_prob
    prop_ld, prop_g = torch.func.vmap(torch.func.grad_and_value(
        lambda p: p_ld(p), argnums=0))(prop)[::-1]
    log_ratio = mala_log_ratio(state, prop, prop_ld, prop_g, eps)
    scale = RTOL * float(state.logdensity.abs().max())
    p_accept = torch.clamp_max(torch.exp(log_ratio), 1.0).numpy()
    np.testing.assert_allclose(p_accept, np.asarray(jinfo.acceptance_prob), rtol=0,
                               atol=scale)
    acc = np.asarray(jinfo.accepted)
    assert acc.any()
    np.testing.assert_allclose(prop["weights"].numpy()[acc],
                               np.asarray(jnew.position["weights"])[acc], rtol=RTOL,
                               atol=1e-6)

    # the port's log ratio from the JAX kernel's own pieces
    cl = closure(jk.step)
    tl, vg = cl["transition_logdensity"], cl["value_and_grad_fn"]

    def jax_ratio(q, g, ld, p):
        p_ld_j, p_g_j = vg(p)
        return (p_ld_j - ld + tl(q, p, p_g_j, jnp.asarray(eps))
                - tl(p, q, g, jnp.asarray(eps)))

    ref = jax.vmap(jax_ratio)(jstate.position, jstate.logdensity_grad, jstate.logdensity,
                              {"weights": jnp.asarray(prop["weights"].numpy())})
    np.testing.assert_allclose(log_ratio.numpy(), np.asarray(ref), rtol=0, atol=scale)


def gaussian_2d(pos):
    """x ~ N(1, 2^2), y ~ N(-1, 0.5^2), one value per chain."""
    return -0.5 * ((pos["x"] - 1.0) / 2.0) ** 2 - 0.5 * ((pos["y"] + 1.0) / 0.5) ** 2


def test_moments():
    """``tests/test_samplers.py::TestMALA::test_moments``: 256 chains, 1,000
    steps, the last 500 kept; means within 0.2 and 0.1, standard deviations
    within 0.6 and 0.15."""
    kernel = mala(gaussian_2d, step_size=0.5)
    states = init_chains(kernel, {"x": torch.zeros(256), "y": torch.zeros(256)})
    _, s = run_chains(kernel, torch.Generator().manual_seed(0), states, 1000)
    x, y = s["x"][500:].numpy(), s["y"][500:].numpy()
    assert abs(x.mean() - 1.0) < 0.2
    assert abs(y.mean() + 1.0) < 0.1
    assert abs(x.std() - 2.0) < 0.6
    assert abs(y.std() - 0.5) < 0.15


def test_one_chain_and_per_chain_step_sizes():
    """A scalar log density steps one chain; a step size per chain steps
    each chain with its own."""
    kernel = mala(gaussian_2d, step_size=0.3)
    state = kernel.init({"x": torch.tensor(0.0), "y": torch.tensor(0.0)})
    new, info = kernel.step(torch.Generator().manual_seed(1), state)
    assert new.logdensity.shape == () and info.accepted.shape == ()
    eps = torch.tensor([0.1, 0.3, 0.6])
    start = {"x": torch.zeros(3), "y": torch.zeros(3)}
    per_chain = mala(gaussian_2d, step_size=eps)
    new, _ = per_chain.step(torch.Generator().manual_seed(1), per_chain.init(start))
    for k in range(3):
        one = mala(gaussian_2d, step_size=float(eps[k]))
        ref, _ = one.step(torch.Generator().manual_seed(1), one.init(start))
        assert float(new.position["x"][k]) == float(ref.position["x"][k])
        assert float(new.position["y"][k]) == float(ref.position["y"][k])


def test_generator_on_another_device_raises():
    kernel = mala(gaussian_2d, 0.3)
    state = kernel.init({"x": torch.zeros(2), "y": torch.zeros(2)})
    with pytest.raises(RuntimeError):
        kernel.step(torch.Generator(device="meta"), state)


def test_mala_block_in_a_gibbs_sweep():
    """``mala_block`` on the coefficients and the conjugate precision block
    against the collapsed sampler on the polynomial posterior, at
    ``tests/test_gibbs.py::test_rwm_gibbs_agrees_with_collapsed``'s bounds
    (coefficient means within 0.12, the precision's mean within 12%).  The
    conditional is ill-conditioned (the cubic column's scale), so MALA's
    step is small and its 64 chains start from the collapsed sampler's
    final draws, 600 sweeps, the first 100 dropped: a kernel that did not
    keep the posterior would drift from it."""
    rng = np.random.default_rng(42)
    xses = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(xses, 4, increasing=True)
    ys = (V @ np.array([2.0, -4.0, 1.0, 1.5]) + rng.normal(size=20) / np.sqrt(2.5))
    post = tpoly.make_posterior(xses, ys.astype(np.float32))
    start = tpoly.initial_positions(64, device="cpu")
    col = tpoly.make_collapsed_gibbs_kernel(post)
    final, r = run_chains(col, torch.Generator().manual_seed(4), init_chains(col, start), 300)
    kernel = gibbs.gibbs({"coefficients": gibbs.mala_block(post, "coefficients", 0.03),
                          "precision": conjugate.gamma_precision_block(post, "precision")})
    _, s = run_chains(kernel, torch.Generator().manual_seed(3),
                      init_chains(kernel, final.position), 600)
    np.testing.assert_allclose(s["coefficients"][100:].reshape(-1, 4).mean(0).numpy(),
                               r["coefficients"][100:].reshape(-1, 4).mean(0).numpy(), atol=0.12)
    np.testing.assert_allclose(float(s["precision"][100:].mean()),
                               float(r["precision"][100:].mean()), rtol=0.12)
