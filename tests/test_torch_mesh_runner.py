"""The runner, the router and the CLI under 4 gloo ranks.

``route_algorithm`` with the mesh makes the JAX package's decision at the
same per-device chain count (the JAX side on 8 virtual devices with twice
the chains); ``init_chains``/``run_chains``, ``warmup_and_run`` (HMC and
NUTS, pooled and per-chain step sizes) and the collapsed Gibbs sweep
under the mesh equal the unsharded runs (every rank draws every chain's
noise and keeps its rows; the warmups' pooled step size and metric within
1e-5 over 6 steps); ``python
-m binf_tpu_torch ... --mesh --device cpu`` runs its routes on every rank
and only rank 0 prints, the summary of the gathered draws.  The ranks run
once for the file (``torch_ranks.py``'s ``runner`` battery), each under
its own deadline."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import CLI_RUNS, RUNNER_CHAINS, runner_cases, spawn_ranks

WORLD = 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    xs = np.linspace(-2, 2, 20).astype(f32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(f32)
    return {"xs": torch.tensor(xs), "ys": torch.tensor(ys),
            "init_c": torch.tensor((0.1 * rng.normal(size=(32, 4))).astype(f32)),
            "init_p": torch.zeros(32)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks("runner", tmp_path_factory.mktemp("runner"), inputs, WORLD,
                       timeout=240)


@pytest.fixture(scope="module")
def unsharded(inputs):
    return runner_cases(inputs)


def test_route_matches_jax_per_device(inputs, ranks, unsharded):
    from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
    from binf_tpu.parallel.mesh import make_chain_mesh
    from binf_tpu.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu.samplers.auto import route_algorithm as jax_route

    jpost = jax_make_posterior(jnp.asarray(inputs["xs"].numpy()),
                               jnp.asarray(inputs["ys"].numpy()))
    jtld = transform_logdensity(lambda p: jpost.log_prob(p), {"precision": LogTransform})
    n_dev = len(jax.devices())
    per_device = RUNNER_CHAINS // WORLD
    jinit = {"coefficients": jnp.zeros((per_device * n_dev, 4)),
             "precision": jnp.zeros(per_device * n_dev)}
    jd = jax_route(jtld, jinit, make_chain_mesh())
    assert jd.n_local_chains == per_device
    for r in ranks:
        d = r["route"]
        assert d["path"] == jd.path and d["n_local_chains"] == per_device
        assert d["block_chains"] == per_device
    assert unsharded["route"]["n_local_chains"] == RUNNER_CHAINS


def _close(a, b, rtol=1e-5, atol=1e-5):
    if isinstance(a, dict):
        for k in a:
            _close(a[k], b[k], rtol, atol)
        return
    np.testing.assert_allclose(torch.as_tensor(a).numpy(), torch.as_tensor(b).numpy(),
                               rtol=rtol, atol=atol)


def test_run_chains_equals_unsharded(ranks, unsharded):
    for r in ranks:
        final, draws = r["run_chains"]
        _close(draws, unsharded["run_chains"][1], rtol=1e-6, atol=1e-6)
        _close(final.position, unsharded["run_chains"][0].position, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["hmc", "nuts", "per_chain"])
def test_warmup_and_run_equals_unsharded(ranks, unsharded, name):
    """The pooled step size and metric within 1e-5; the draws follow the
    unsharded ones until the pooled sums' last bits part them (the float32
    warmup is chaotic: ~1e-4 after 6 + 4 steps)."""
    for r in ranks:
        _close(r[name]["step_size"], unsharded[name]["step_size"])
        if "inverse_mass" in unsharded[name]:
            _close(r[name]["inverse_mass"], unsharded[name]["inverse_mass"])
        _close(r[name]["samples"], unsharded[name]["samples"], rtol=1e-3, atol=1e-3)


def test_collapsed_gibbs_equals_unsharded(ranks, unsharded):
    """The conjugate Gamma draw loops until every chain accepts: every
    rank loops as long as any rank's chain has not.  The batched Cholesky
    solves round by the batch's size (~1e-6)."""
    for r in ranks:
        _close(r["gibbs"], unsharded["gibbs"])


def test_cli_mesh_only_rank_zero_prints(ranks):
    from binf_tpu_torch import cli

    for i, argv in enumerate(CLI_RUNS):
        printed = [r["cli"][i]["printed"] for r in ranks]
        assert printed[0] and not any(printed[1:]), argv
        summary = json.loads(printed[0])
        assert summary == ranks[0]["cli"][i]["summary"]
        algorithm = argv[argv.index("--algorithm") + 1]
        if algorithm == "gibbs":  # no pooled statistic: the unsharded run's draws
            ref = cli.run(cli.parse_args(argv + ["--device", "cpu"]),
                          cli.build_model("polynomial", torch.Generator().manual_seed(
                              cli._seeds(0)["model"]), device="cpu"))
            for k, v in ref["summary"].items():
                np.testing.assert_allclose(summary["summary"][k]["mean"], v["mean"],
                                           rtol=1e-5, atol=1e-5)
        elif algorithm == "smc":  # 5 HMC moves a stage over ~10 stages: chaotic
            assert np.isfinite(summary["log_evidence"]) and summary["num_stages"] < 100
            assert np.isfinite(summary["posterior_means"]["coefficients"]).all()
        else:
            assert summary["chains"] == int(argv[argv.index("--chains") + 1])
            assert all(np.isfinite(s["mean"]).all() for s in summary["summary"].values())
