"""The kernel paths under 4 gloo ranks: ``fused_model_hmc(mesh=...)``
with the ``xla``, ``dense`` and ``fused`` warmups (fixed and ChEES),
``chain_grid_model_hmc(mesh=...)`` and ``run_fused_blocks(mesh=...)``, by
their plain versions on the CPU.

Rank ``r``'s shard is held bit for bit to a single-process run of the
kernels on those chains with seed ``seed + r`` (the JAX package's
``seed + axis_index("chain")``): K3 and K4 for the fused warmup, K4 (or K7)
from the pooled warmup's state for the eager ones.  The pooled eager
warmups give the unsharded run's step size and metric within 1e-5 over
10 steps (the float32 warmup is chaotic past ~20).  The production driver
resumed from block 2 of 4 under the mesh ends bit for bit where the
uninterrupted run ends, its checkpoint is one file that loads in one
process, and each shard's blocks equal the single-process blocks with
``seed + r``.  The ranks run once for the file (``torch_ranks.py``'s
``kernels`` battery), each under its own deadline."""

import os

import jax
import numpy as np
import pytest
import torch

from binf_tpu.example.chromatin import synthetic_restraints
from torch_ranks import (
    BLOCKS_KW,
    FUSED_CONFIGS,
    FUSED_KW,
    GRID_KW,
    adapted_rows,
    gram_problem,
    poly_logdensity,
    spawn_ranks,
)

WORLD = 4
C = 32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    f32 = np.float32
    xs = np.linspace(-2, 2, 20).astype(f32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(f32)
    X, logD, W = (np.asarray(a, f32) for a in synthetic_restraints(
        jax.random.key(0), 8, observe_frac=0.5, noise_prec=25.0))
    return {"xs": torch.tensor(xs), "ys": torch.tensor(ys),
            "init_c": torch.tensor((0.1 * rng.normal(size=(C, 4))).astype(f32)),
            "init_p": torch.zeros(C),
            "gram_logD": torch.tensor(logD), "gram_W": torch.tensor(W),
            "gram_X": torch.tensor((X[None] + 0.1 * rng.normal(size=(16, 8, 3))).astype(f32)),
            "gram_u": torch.full((16,), float(np.log(20.0)))}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks("kernels", tmp_path_factory.mktemp("kernels"), inputs, WORLD,
                       timeout=240)


def _rows(tree, r, n):
    m = n // WORLD
    return {k: v[r * m:(r + 1) * m] for k, v in tree.items()}


def _k4(tld, rows, adapted, seed, warmup, trajectory, num_steps, block_chains, **kw):
    from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_run
    from binf_tpu_torch.samplers.fused import _prepare, _steps_per_block

    density, spec, _ = _prepare(tld, rows, CPU)
    return fused_potential_hmc_run(
        density, adapted["positions"], seed, adapted["step_size"], adapted["inverse_mass"],
        num_steps=num_steps, num_leapfrog=FUSED_KW["num_leapfrog"], block_chains=block_chains,
        steps_per_block=_steps_per_block(num_steps, 1), host_noise=False,
        dense_mass=warmup == "dense", trajectory=trajectory, max_leapfrog=256,
        traj_length=adapted["trajectory_length"], device=CPU, **kw), spec


def _k3(tld, rows, trajectory, seed, block_chains):
    """K3 alone on ``rows`` with ``seed``, as ``fused_model_hmc`` runs it."""
    from binf_tpu_torch.samplers.fused import _adapt, _prepare

    density, spec, q0 = _prepare(tld, rows, CPU)
    return _adapt("fused", tld, density, spec, q0, seed, num_warmup=FUSED_KW["num_warmup"],
                  num_leapfrog=FUSED_KW["num_leapfrog"], initial_step_size=0.05,
                  per_chain_step_size=False, block_chains=block_chains, host_noise=False,
                  trajectory=trajectory, max_leapfrog=256, dev=CPU)._asdict()


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k])
        return
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("warmup, trajectory", FUSED_CONFIGS,
                         ids=[f"{w}-{t}" for w, t in FUSED_CONFIGS])
def test_fused_model_hmc_shards_are_the_kernel_with_seed_plus_rank(inputs, ranks, warmup,
                                                                   trajectory):
    from binf_tpu_torch.ops.kernels.fused_potential import unpack_draws
    from binf_tpu_torch.samplers.fused import _block_chains, _draw_seed, _generator

    tld = poly_logdensity(inputs)
    init = {"coefficients": inputs["init_c"], "precision": inputs["init_p"]}
    g = _generator(0)
    seed_w, seed_r = _draw_seed(g), _draw_seed(g)
    bc = _block_chains("auto", C // WORLD)
    accepts = []
    for r, out in enumerate(rank[(warmup, trajectory)] for rank in ranks):
        rows = _rows(init, r, C)
        adapted = out["adapted"]
        if warmup == "fused":  # K3 on the shard with seed_w + r
            _equal(_k3(tld, rows, trajectory, seed_w + r, bc), adapted)
        res, spec = _k4(tld, rows, adapted, seed_r + r, warmup, trajectory,
                        FUSED_KW["num_samples"], bc)
        assert out["seed_r"] == seed_r
        _equal(out["local"].samples, unpack_draws(res.draws, spec))
        _equal(out["local"].final_positions, unpack_draws(res.final_positions, spec))
        accepts.append(float(res.accept_rate))
        # the whole result, gathered, is the ranks' shards in order
        m = C // WORLD
        _equal({k: v[:, r * m:(r + 1) * m] for k, v in out["whole"].samples.items()},
               out["local"].samples)
    for out in (rank[(warmup, trajectory)] for rank in ranks):
        np.testing.assert_allclose(float(out["local"].accept_rate), np.mean(accepts),
                                   rtol=1e-6)


@pytest.mark.parametrize("warmup, trajectory", [c for c in FUSED_CONFIGS if c[0] != "fused"],
                         ids=[f"{w}-{t}" for w, t in FUSED_CONFIGS if w != "fused"])
def test_pooled_eager_warmup_equals_the_unsharded_one(inputs, ranks, warmup, trajectory):
    tld = poly_logdensity(inputs)
    init = {"coefficients": inputs["init_c"], "precision": inputs["init_p"]}
    ref, _ = adapted_rows(tld, init, warmup, trajectory, None)
    for rank in ranks:
        a = rank[(warmup, trajectory)]["adapted"]
        for k in ("step_size", "inverse_mass", "trajectory_length"):
            if ref._asdict()[k] is not None:
                np.testing.assert_allclose(a[k].numpy(), getattr(ref, k).numpy(), rtol=1e-5)
    # the warmed chains follow the unsharded ones until the step sizes'
    # last bits part them (~2e-4 after 10 steps)
    np.testing.assert_allclose(torch.cat([rk[(warmup, trajectory)]["adapted"]["positions"]
                                          for rk in ranks]).numpy(),
                               ref.positions.numpy(), rtol=1e-3, atol=1e-3)


def test_chain_grid_shards_are_k7_with_seed_plus_rank(inputs, ranks):
    from binf_tpu_torch.ops.kernels.chain_grid import (
        chain_grid_hmc_run,
        chain_grid_potential_from_scalar,
    )
    from binf_tpu_torch.samplers.chain_grid import _warmup
    from binf_tpu_torch.samplers.fused import _generator

    density = gram_problem(inputs)
    pos = {"structure": inputs["gram_X"], "precision": inputs["gram_u"]}
    template = {k: v[0] for k, v in pos.items()}
    potential, consts, spec = chain_grid_potential_from_scalar(density, template)
    accepts = []
    for r, out in enumerate(rank["chain_grid"] for rank in ranks):
        res = chain_grid_hmc_run(
            potential, out["positions"], out["seed_r"] + r, out["step_size"],
            out["inverse_mass"], consts, num_steps=GRID_KW["num_samples"],
            num_leapfrog=GRID_KW["num_leapfrog"], block_chains=GRID_KW["block_chains"],
            steps_per_block=GRID_KW["num_samples"], device=CPU)
        _equal(out["local"].samples, res.draws)
        _equal(out["local"].final_positions, res.final_positions)
        accepts.append(float(res.accept_rate))
    ref = _warmup(density, potential, spec, pos, _generator(0), CPU, None,
                  num_warmup=GRID_KW["num_warmup"], num_leapfrog=GRID_KW["num_leapfrog"],
                  initial_step_size=0.05, target_accept=0.8)
    for rank in ranks:
        out = rank["chain_grid"]
        np.testing.assert_allclose(float(out["local"].accept_rate), np.mean(accepts), rtol=1e-6)
        np.testing.assert_allclose(float(out["step_size"]), float(ref.step_size), rtol=1e-5)
        for k, v in ref.inverse_mass.items():
            np.testing.assert_allclose(out["inverse_mass"][k].numpy(), v.numpy(), rtol=1e-5)


@pytest.mark.parametrize("warmup", ["xla", "fused"])
def test_fused_blocks_resume_and_shards(inputs, ranks, warmup):
    from binf_tpu_torch.io.checkpoint import load_checkpoint
    from binf_tpu_torch.parallel.production import _welford_merge
    from binf_tpu_torch.samplers.fused import _draw_seed, _generator

    tld = poly_logdensity(inputs)
    init = {"coefficients": inputs["init_c"], "precision": inputs["init_p"]}
    g = _generator(0)
    seed_w, seed_r = _draw_seed(g), _draw_seed(g)
    m, bs = C // WORLD, BLOCKS_KW["block_size"]
    files = ranks[0][("blocks", warmup)]
    for r, rank in enumerate(ranks):
        out = rank[("blocks", warmup)]
        whole, resumed = out["whole"].carry, out["resumed"].carry
        for f in whole._fields:
            assert torch.equal(whole._asdict()[f], resumed._asdict()[f]), f
        # the shard's four blocks, run alone with the run seed plus r
        if warmup == "fused":
            a = _k3(tld, _rows(init, r, C), "fixed", seed_w + r, BLOCKS_KW["block_chains"])
        else:
            a = dict(ranks[r][("xla", "fixed")]["adapted"])
        a["step_size"] = torch.broadcast_to(a["step_size"].reshape(-1), (m,)).contiguous()
        q, n = a["positions"], torch.zeros(())
        mean, m2 = torch.zeros_like(q), torch.zeros_like(q)
        for b in range(4):
            res, _ = _k4(tld, _rows(init, r, C), dict(a, positions=q), seed_r + r, warmup,
                         "fixed", bs, BLOCKS_KW["block_chains"], collect="moments",
                         block_offset=b)
            mean, m2, n = _welford_merge(mean, m2, n, res.mean, res.variance * (bs - 1.0),
                                         float(bs))
            q = res.final_positions
        assert torch.equal(whole.positions, q) and torch.equal(whole.mean, mean)
        assert torch.equal(whole.m2, m2)
    # the checkpoint of block 2 is one file in the single-process format
    path = os.path.join(ranks[0]["dir"], f"blocks_{warmup}.pt")
    template = files["gathered"].carry
    saved = load_checkpoint(path, template)
    assert saved.positions.shape == (C, 5) and int(saved.block) == 2
    for f in saved._fields:
        assert torch.equal(saved._asdict()[f], files["saved"]._asdict()[f])
