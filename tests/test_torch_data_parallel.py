"""``parallel/data_parallel.py`` and ``example/chromatin.py::
make_sharded_restraint_loss`` under 4 gloo ranks, held to the JAX
package's versions on its 8-device CPU mesh (``tests/test_data_parallel.py``,
``tests/test_sharded_restraints.py``) and to the unsharded port.

64 data points and 64 beads, which 4 and 8 divide.  The log prob and the
restraint loss agree within 1e-5 relative; so does the gradient on every
rank, the check that catches a gradient multiplied by the world size; both
also under ``torch.func.vmap`` over 8 chains (and 2 structures), and an
eager HMC run on the sharded posterior gives the unsharded run's draws
within 1e-5.  The ranks run once for the file (``torch_ranks.py``'s
``data`` battery), each under its own deadline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from binf_tpu.example.chromatin import make_sharded_restraint_loss as jax_sharded_loss
from binf_tpu.example.chromatin import synthetic_restraints
from binf_tpu.example.polynomial import make_likelihood as jax_make_likelihood
from binf_tpu.parallel.data_parallel import DataShardedLikelihood as JaxSharded
from torch_ranks import _poly_posterior, eager_hmc_draws, restraint_hmc, spawn_ranks

WORLD = 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    f32 = np.float32
    xs = np.linspace(-2, 2, 64).astype(f32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + 0.1 * rng.normal(size=64)).astype(f32)
    X, logD, W = (np.asarray(a, f32) for a in
                  synthetic_restraints(jax.random.key(0), 64, observe_frac=0.5))
    return {"xs": torch.tensor(xs), "ys": torch.tensor(ys),
            "c": torch.tensor([1.0, -2.0, 0.5, 1.0]), "prec": torch.tensor(1.7),
            "chain_c": torch.tensor((rng.normal(size=(8, 4)) + [2, -4, 1, 1.5]).astype(f32)),
            "chain_p": torch.tensor(rng.uniform(0.5, 3.0, size=8).astype(f32)),
            "X": torch.tensor(X), "logD": torch.tensor(logD), "W": torch.tensor(W)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks("data", tmp_path_factory.mktemp("data"), inputs, WORLD)


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()), ("data",))


def test_sharded_sum_primitive(ranks):
    for r in ranks:
        assert float(r["sum"]) == pytest.approx(2.0 * 64 * 63 / 2)
        assert float(r["sum_sharded"]) == pytest.approx(2.0 * 64 * 63 / 2)


def test_log_prob_and_gradient_match_jax_and_unsharded(inputs, ranks, jax_mesh):
    jlik = jax_make_likelihood(jnp.asarray(inputs["xs"].numpy()),
                               jnp.asarray(inputs["ys"].numpy()))
    jsh = JaxSharded.create(jlik, jax_mesh, fwm_data_fields=("vandermonde",))
    c, prec = jnp.asarray(inputs["c"].numpy()), 1.7
    jlp = float(jsh.log_prob(coefficients=c, precision=jnp.asarray(prec)))
    jg = jsh.gradient(coefficients=c, precision=prec)
    lik, _ = _poly_posterior(inputs)
    lp = float(lik.log_prob(coefficients=inputs["c"], precision=inputs["prec"]))
    g = lik.gradient(coefficients=inputs["c"], precision=inputs["prec"])
    np.testing.assert_allclose(lp, jlp, rtol=1e-5)
    for r in ranks:
        assert r["variables"] == list(lik.variables)
        np.testing.assert_allclose(float(r["lp"]), jlp, rtol=1e-5)
        np.testing.assert_allclose(float(r["lp"]), lp, rtol=1e-5)
        for k in ("coefficients", "precision"):
            np.testing.assert_allclose(r["grad"][k].numpy(), np.asarray(jg[k]), rtol=1e-5)
            np.testing.assert_allclose(r["grad"][k].numpy(), g[k].numpy(), rtol=1e-5)


def test_vmapped_log_prob_and_gradient(inputs, ranks):
    lik, _ = _poly_posterior(inputs)
    chains = {"coefficients": inputs["chain_c"], "precision": inputs["chain_p"]}
    lp = torch.func.vmap(lik.log_prob)(chains)
    g = torch.func.vmap(torch.func.grad(lik.log_prob))(chains)
    for r in ranks:
        np.testing.assert_allclose(r["lp_vmap"].numpy(), lp.numpy(), rtol=1e-5)
        for k in ("coefficients", "precision"):
            np.testing.assert_allclose(r["grad_vmap"][k].numpy(), g[k].numpy(), rtol=1e-5)
            np.testing.assert_allclose(r["grad_of_vmap"][k].numpy(), g[k].numpy(), rtol=1e-5)


def test_eager_hmc_on_the_sharded_posterior(inputs, ranks):
    _, post = _poly_posterior(inputs)
    ref = eager_hmc_draws(post, {"coefficients": inputs["chain_c"],
                                 "precision": torch.log(inputs["chain_p"])})
    for r in ranks:
        for k in ref:
            np.testing.assert_allclose(r["hmc"][k].numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_sharded_restraint_loss_matches_jax(inputs, ranks, jax_mesh):
    X, logD, W = (jnp.asarray(inputs[k].numpy()) for k in ("X", "logD", "W"))
    shard = NamedSharding(jax_mesh, P("data", None))
    loss_fn = jax_sharded_loss(jax_mesh)
    args = (X, jax.device_put(logD, shard), jax.device_put(W, shard))
    jloss = float(jax.jit(loss_fn)(*args))
    jgrad = np.asarray(jax.jit(jax.grad(loss_fn))(*args))
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), jloss, rtol=1e-5)
        np.testing.assert_allclose(r["loss_grad"].numpy(), jgrad, rtol=1e-5, atol=1e-5)


def test_sharded_restraint_loss_under_vmap(inputs, ranks):
    from binf_tpu_torch.ops.kernels.pairwise import pairwise_restraint_loss_reference

    X, logD, W = inputs["X"], inputs["logD"], inputs["W"]
    Xs = torch.stack([X, 1.1 * X])
    ref = torch.stack([pairwise_restraint_loss_reference(x, logD, W) for x in Xs])
    gref = torch.stack([torch.func.grad(pairwise_restraint_loss_reference)(x, logD, W)
                        for x in Xs])
    for r in ranks:
        np.testing.assert_allclose(r["loss_vmap"].numpy(), ref.numpy(), rtol=1e-5)
        np.testing.assert_allclose(r["loss_vmap_grad"].numpy(), gref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_hmc_on_the_structure(inputs, ranks):
    """The JAX package's ``test_sharded_hmc_on_structure`` on the port: 30
    steps accept above 0.5, and follow the unsharded run's trajectory."""
    from binf_tpu_torch.ops.kernels.pairwise import pairwise_restraint_loss_reference

    logD, W = inputs["logD"], inputs["W"]
    ld, X, accs = restraint_hmc(lambda x: pairwise_restraint_loss_reference(x, logD, W),
                                inputs["X"], float(W.sum()))
    for r in ranks:
        r_ld, r_X, r_accs = r["restraint_hmc"]
        assert np.isfinite(float(r_ld)) and float(r_accs.mean()) > 0.5
        np.testing.assert_allclose(r_X.numpy(), X.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(r_ld), float(ld), rtol=1e-4)
