"""``parallel/collectives.py`` and ``parallel/mesh.py`` under 4 gloo ranks,
held to the JAX package's collectives on its 8-device CPU mesh
(``tests/test_collectives.py``): the distributed systematic indices are
the same integers for the same weights and offset, ``pmean_over_chains``
agrees within 1e-6, ``take_along_chain`` is exact.  Also the chain
reductions of the eager adaptation, the gathers, and the f/g pair whose
gradient is the gradient of the whole sum on every rank (no factor of the
world size), under ``torch.func.grad`` and ``torch.func.vmap``.

The ranks run once for the file (``torch_ranks.py``'s ``collectives``
battery), each under its own deadline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.parallel.collectives import (
    distributed_systematic_indices as jax_indices,
    pmean_over_chains as jax_pmean,
    take_along_chain as jax_take,
)
from binf_tpu.parallel.mesh import make_chain_mesh as jax_mesh
from binf_tpu.parallel.mesh import shard_chains as jax_shard
from torch_ranks import spawn_ranks, world_of_one

WORLD = 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    take = np.concatenate([np.full(32, 5), np.full(32, 60)]).astype(np.int64)
    return {
        "lw": torch.tensor(rng.normal(size=128).astype(f32)),
        "u": float(jax.random.uniform(jax.random.key(3), ())),
        "x": torch.tensor(rng.normal(size=(64, 4)).astype(f32)),
        "particles": {"a": torch.arange(64, dtype=torch.float32),
                      "b": torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)},
        "take": torch.tensor(take),
        "data": torch.tensor(rng.normal(size=64).astype(f32)),
        "lw64": torch.tensor(rng.normal(size=64).astype(f32)),
        "theta": torch.tensor(rng.normal(size=(64, 2)).astype(f32)),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks("collectives", tmp_path_factory.mktemp("collectives"), inputs, WORLD)


def test_indices_match_jax(inputs, ranks):
    mesh = jax_mesh()
    lw = jnp.asarray(inputs["lw"].numpy())
    ref = np.asarray(jax_indices(jax.random.key(3), jax_shard(lw, mesh), mesh))
    for r in ranks:
        np.testing.assert_array_equal(r["indices"].numpy(), ref)
        np.testing.assert_array_equal(r["indices_full_tensor"].numpy(), ref)


def test_indices_equal_the_unsharded_resampler(inputs, ranks):
    from binf_tpu_torch.smc.resampling import systematic_resample

    ref = systematic_resample(torch.Generator().manual_seed(3), inputs["lw"])
    for r in ranks:
        assert torch.equal(r["indices_generator"], ref)


def test_pmean_matches_jax(inputs, ranks):
    mesh = jax_mesh()
    ref = np.asarray(jax_pmean({"x": jax_shard(jnp.asarray(inputs["x"].numpy()), mesh)},
                               mesh)["x"])
    for r in ranks:
        np.testing.assert_allclose(r["pmean"].numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["pmean_sharded"].numpy(), ref, rtol=0, atol=1e-6)


def test_take_along_chain_is_exact(inputs, ranks):
    mesh = jax_mesh()
    jp = {k: jax_shard(jnp.asarray(v.numpy()), mesh) for k, v in inputs["particles"].items()}
    ref = jax_take(jp, jnp.asarray(inputs["take"].numpy()))
    for r in ranks:
        for k in ("a", "b"):
            np.testing.assert_array_equal(r["taken"][k].numpy(), np.asarray(ref[k]))
    assert float(ranks[0]["taken"]["a"][0]) == 5.0 and float(ranks[0]["taken"]["a"][-1]) == 60.0


def test_chain_reductions_and_gathers(inputs, ranks):
    x = inputs["x"]
    for r in ranks:
        np.testing.assert_allclose(r["chain_sum"], x.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["chain_mean"], x.mean(0), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["chain_m2"], ((x - x.mean(0)) ** 2).sum(0), rtol=1e-5)
        np.testing.assert_allclose(r["pooled_mean"], x.mean(), rtol=1e-5, atol=1e-7)
        assert torch.equal(r["row_37"], x[37])
        assert torch.equal(r["gathered_dim1"], x.T)


def test_sum_of_shards_gradient_has_no_world_factor(inputs, ranks):
    """d/dp sum_i p data_i = sum_i data_i on every rank, under grad, vmap
    of grad and grad of vmap; the deprecated differentiable all-reduce
    gives WORLD times that."""
    total = float(inputs["data"].sum())
    for r in ranks:
        np.testing.assert_allclose(float(r["fg_value"]), 2.0 * total, rtol=1e-5)
        np.testing.assert_allclose(float(r["fg_grad"]), total, rtol=1e-5)
        np.testing.assert_allclose(r["fg_vmap_grad"].numpy(), np.full(8, total), rtol=1e-5)
        np.testing.assert_allclose(r["fg_grad_vmap"].numpy(), np.full(8, total), rtol=1e-5)


def test_resample_step_moves_existing_particles(inputs, ranks):
    from binf_tpu_torch.smc.resampling import _cdf, _resample_indices

    n = 64
    pos = (torch.arange(n, dtype=torch.float32) + inputs["u"]) / n
    ref = inputs["theta"][_resample_indices(_cdf(inputs["lw64"]), pos)]
    for r in ranks:
        assert torch.equal(r["resampled"], ref)


def test_world_of_one_collectives_are_the_plain_calls(inputs):
    """In a group of one every collective returns what the plain call
    returns, and the mesh helpers round-trip."""
    from binf_tpu_torch.parallel import collectives as C
    from binf_tpu_torch.parallel.mesh import gather_chains, local_rows, row_range, shard_chains
    from binf_tpu_torch.smc.resampling import _cdf, _resample_indices

    x = inputs["x"]
    with world_of_one() as mesh:
        assert row_range(64, mesh) == (0, 64)
        assert torch.equal(local_rows(x, mesh), x)
        sharded = shard_chains({"x": x}, mesh)
        assert torch.equal(gather_chains(sharded)["x"], x)
        assert torch.equal(C.chain_sum(x, mesh), x.sum(0))
        assert torch.equal(C.pmean_over_chains(sharded, mesh)["x"], x.mean(0))
        idx = C.distributed_systematic_indices(inputs["u"], inputs["lw"], mesh)
        pos = (torch.arange(128, dtype=torch.float32) + inputs["u"]) / 128
        ref = _resample_indices(_cdf(inputs["lw"]), pos)
        assert torch.equal(idx.to_local(), ref)
