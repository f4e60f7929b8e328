"""The production driver (``parallel/production.py``) on the CPU:
streaming moments, divergence accounting, metrics lines, and resume from a
checkpoint taken mid-run, bit for bit, for ``run_blocks`` and for
``run_fused_blocks`` with each warmup.

The JAX package's own resume tests checkpoint after the last block
(``tests/test_production.py:40-57``, ``:196-223``), so the resumed run
runs no block; here every resume starts at block 2 of 4."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.parallel.production import _welford_merge as jax_welford_merge
from binf_tpu_torch.io.metrics import MetricsLogger
from binf_tpu_torch.parallel.production import _welford_merge, run_blocks, run_fused_blocks
from binf_tpu_torch.parallel.runner import init_chains
from binf_tpu_torch.samplers.hmc import hmc
from binf_tpu_torch.samplers.rwm import rwm


def logp(pos):
    """``tests/test_production.py::logp`` for a chain batch: N(2, 1) x
    N(-1, 1)^2."""
    return -0.5 * ((pos["x"] - 2.0) ** 2 + torch.sum((pos["y"] + 1.0) ** 2, dim=-1))


def _states(kernel, n):
    return init_chains(kernel, {"x": torch.zeros(n), "y": torch.zeros((n, 2))})


def _fused_positions(n=16):
    return {"x": torch.zeros(n), "y": torch.zeros((n, 2))}


def test_welford_merge_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(2, 8, 3)).astype(np.float32) for _ in range(2))
    m2a, m2b = (np.abs(x[0]) * 10 for x in (a, b))
    t = _welford_merge(torch.tensor(a[1]), torch.tensor(m2a), torch.tensor(150.0),
                       torch.tensor(b[1]), torch.tensor(m2b), 100.0)
    j = jax_welford_merge(jnp.asarray(a[1]), jnp.asarray(m2a), jnp.float32(150.0),
                          jnp.asarray(b[1]), jnp.asarray(m2b), jnp.float32(100.0))
    for x, y in zip(t, j):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5)


def test_streaming_moments_match_draws():
    kernel = rwm(logp, 0.8, proposal="normal")
    res = run_blocks(kernel, _states(kernel, 64), torch.Generator().manual_seed(0),
                     num_steps=600, block_size=100, collect_draws=True)
    x = res.draws["x"].double()
    assert x.shape == (600, 64)
    np.testing.assert_allclose(float(res.mean["x"]), float(x.mean()), rtol=1e-4)
    np.testing.assert_allclose(float(res.variance["x"]), float(x.reshape(-1).var()), rtol=1e-3)
    assert abs(float(res.mean["x"]) - 2.0) < 0.2
    thinned = run_blocks(kernel, _states(kernel, 64), torch.Generator().manual_seed(0),
                         num_steps=600, block_size=100, thin=4, collect_draws=True)
    assert torch.equal(thinned.draws["y"], res.draws["y"][3::4])


def test_divergence_accounting():
    """An absurd step: nearly every chain diverges, none crashes."""
    kernel = hmc(logp, step_size=100.0, num_integration_steps=5)
    res = run_blocks(kernel, _states(kernel, 32), torch.Generator().manual_seed(0),
                     num_steps=100, block_size=50)
    assert res.divergence_fraction > 0.9
    assert bool(torch.isfinite(res.carry.states.position["x"]).all())
    assert res.carry.n_divergences.dtype == torch.int32


def test_run_blocks_resumes_mid_run_bitwise(tmp_path):
    """Blocks 1-2, a checkpoint, then a second call resumed to block 4:
    the state, the generator, the moments and the divergence counts end
    where one uninterrupted 4-block run ends."""
    kernel = hmc(logp, step_size=0.4, num_integration_steps=5)
    path = str(tmp_path / "blocks.pt")
    full = run_blocks(kernel, _states(kernel, 16), torch.Generator().manual_seed(7),
                      num_steps=400, block_size=100)
    run_blocks(kernel, _states(kernel, 16), torch.Generator().manual_seed(7), num_steps=200,
               block_size=100, checkpoint_path=path, checkpoint_every_blocks=2)
    resumed = run_blocks(kernel, _states(kernel, 16), torch.Generator().manual_seed(99),
                         num_steps=400, block_size=100, checkpoint_path=path, resume=True)
    assert int(resumed.carry.step) == 400
    for k in ("x", "y"):
        assert torch.equal(full.carry.states.position[k], resumed.carry.states.position[k])
        assert torch.equal(full.carry.moments.mean[k], resumed.carry.moments.mean[k])
        assert torch.equal(full.carry.moments.m2[k], resumed.carry.moments.m2[k])
    assert torch.equal(full.carry.moments.count, resumed.carry.moments.count)
    assert torch.equal(full.carry.n_divergences, resumed.carry.n_divergences)
    assert torch.equal(full.carry.generator.get_state(), resumed.carry.generator.get_state())


def test_metrics_logging():
    kernel = rwm(logp, 0.8)
    buf = io.StringIO()
    run_blocks(kernel, _states(kernel, 8), torch.Generator().manual_seed(0), num_steps=200,
               block_size=100, logger=MetricsLogger(stream=buf))
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line]
    assert len(lines) == 2
    assert lines[1]["binf_tpu_torch"]["step"] == 200
    assert {"ts", "divergence_frac", "steps_per_sec", "chain_steps_per_sec"} <= set(
        lines[0]["binf_tpu_torch"])


_FUSED = dict(num_warmup=100, block_size=50, block_chains=16, num_leapfrog=5, device="cpu")


@pytest.mark.parametrize("warmup", ["xla", "fused", "dense"])
def test_fused_blocks_resume_mid_run_bitwise(tmp_path, warmup):
    """Blocks 1-2 with a checkpoint after block 2, then a second call
    resumed to block 4: positions, Welford mean, M2 and count, and the
    block counter equal the uninterrupted 4-block run's bit for bit; and
    the 4 blocks end where one K4 call of all 200 steps ends."""
    path = str(tmp_path / f"fused_{warmup}.pt")
    kw = dict(_FUSED, warmup=warmup)
    full = run_fused_blocks(logp, _fused_positions(), 5, num_steps=200, **kw)
    first = run_fused_blocks(logp, _fused_positions(), 5, num_steps=100, checkpoint_path=path,
                             checkpoint_every_blocks=2, **kw)
    assert int(first.carry.block) == 2
    resumed = run_fused_blocks(logp, _fused_positions(), 5, num_steps=200,
                               checkpoint_path=path, resume=True, **kw)
    assert int(resumed.carry.block) == 4
    for field in ("positions", "mean", "m2", "count", "step_size", "inverse_mass"):
        assert torch.equal(getattr(full.carry, field), getattr(resumed.carry, field)), field
    one = run_fused_blocks(logp, _fused_positions(), 5, num_steps=200, **dict(kw, block_size=200))
    assert torch.equal(one.carry.positions, full.carry.positions)
    shape = {"xla": (3,), "fused": (16, 3), "dense": (3, 3)}[warmup]
    assert full.carry.inverse_mass.shape == shape
    assert 0.5 < full.accept_rate <= 1.0


def test_fused_blocks_moments_match_draws():
    """The merged in-kernel moments equal the moments of the same blocks'
    draws (one noise stream in both)."""
    kw = dict(_FUSED, num_steps=150, warmup="fused")
    res_m = run_fused_blocks(logp, _fused_positions(32), 2, **kw)
    res_d = run_fused_blocks(logp, _fused_positions(32), 2, collect_draws=True, **kw)
    assert res_d.draws["x"].shape == (150, 32)
    np.testing.assert_allclose(res_m.mean["x"].numpy(), res_d.mean["x"].numpy(), rtol=1e-4)
    np.testing.assert_allclose(res_m.variance["y"].numpy(), res_d.variance["y"].numpy(),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(res_d.mean["x"].numpy(), res_d.draws["x"].mean(0).numpy(),
                               rtol=1e-4)
    assert abs(float(res_m.mean["x"].mean()) - 2.0) < 0.3
    assert abs(float(res_m.mean["y"].mean()) + 1.0) < 0.3


def test_missing_checkpoint_starts_fresh(tmp_path):
    path = str(tmp_path / "absent.pt")
    fresh = run_fused_blocks(logp, _fused_positions(), 4, num_steps=100, **_FUSED)
    resumed = run_fused_blocks(logp, _fused_positions(), 4, num_steps=100,
                               checkpoint_path=path, resume=True, **_FUSED)
    assert torch.equal(fresh.carry.positions, resumed.carry.positions)
    kernel = rwm(logp, 0.8)
    a = run_blocks(kernel, _states(kernel, 8), torch.Generator().manual_seed(1), 100, 50)
    b = run_blocks(kernel, _states(kernel, 8), torch.Generator().manual_seed(1), 100, 50,
                   checkpoint_path=path, resume=True)
    assert torch.equal(a.carry.states.position["y"], b.carry.states.position["y"])


def test_fused_blocks_logging_and_refusals():
    buf = io.StringIO()
    run_fused_blocks(logp, _fused_positions(), 0, num_steps=100,
                     logger=MetricsLogger(stream=buf), **_FUSED)
    lines = [json.loads(line)["binf_tpu_torch"] for line in buf.getvalue().splitlines()]
    assert [r["step"] for r in lines] == [50, 100] and "accept_rate" in lines[0]
    # a mesh shards the chains (a group of one here; 4 ranks in
    # test_torch_mesh_kernels.py): the same blocks, the same log lines
    from torch_ranks import world_of_one

    from binf_tpu_torch.parallel.mesh import gather_chains

    ref = run_fused_blocks(logp, _fused_positions(), 0, num_steps=100, **_FUSED)
    with world_of_one() as mesh:
        res = run_fused_blocks(logp, _fused_positions(), 0, num_steps=100, mesh=mesh,
                               logger=MetricsLogger(stream=io.StringIO()), **_FUSED)
        carry = gather_chains(res.carry)
    assert res.accept_rate == pytest.approx(ref.accept_rate, rel=1e-4)
    np.testing.assert_allclose(carry.positions.numpy(), ref.carry.positions.numpy(),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="interpret"):
        run_fused_blocks(logp, _fused_positions(), 0, num_steps=100, interpret=True, **_FUSED)
    with pytest.raises(ValueError, match="block_size"):
        run_fused_blocks(logp, _fused_positions(), 0, num_steps=120, **_FUSED)
