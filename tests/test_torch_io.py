"""The port's ``io`` package on the CPU: checkpoint and npz round trips
(structure, dtypes, devices, generator streams), the run configuration's
JSON against the JAX package's, ``aggregate_info`` against the JAX
package's (exact), the logger, the profiler hook, and the debug guards."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.polynomial import make_data as jax_make_data
from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.io import RunConfig as JRunConfig
from binf_tpu.io import aggregate_info as jax_aggregate_info
from binf_tpu.io.config import AdaptationConfig as JAdaptationConfig
from binf_tpu.io.config import KernelConfig as JKernelConfig
from binf_tpu.io.debug import validate_density as jax_validate_density
from binf_tpu.samplers.hmc import HMCInfo as JHMCInfo
from binf_tpu_torch.example.polynomial import make_posterior
from binf_tpu_torch.io import (
    AdaptationConfig,
    KernelConfig,
    RunConfig,
    aggregate_info,
    check_determinism,
    finite_or_neginf,
    load_checkpoint,
    load_npz,
    named_scope,
    save_checkpoint,
    save_npz,
    trace,
    validate_density,
)
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.samplers.hmc import HMCInfo, hmc
from binf_tpu_torch.samplers.rwm import rwm


def _state(generator):
    """A sampler-like state: positions, an adaptation scalar, a step
    counter, a boolean, a generator mid-stream and a Python setting."""
    return {
        "position": {"coefficients": torch.arange(8.0).reshape(2, 4),
                     "precision": torch.tensor([1.5, 2.5], dtype=torch.float64)},
        "step_size": torch.tensor(0.123),
        "iteration": torch.tensor(42, dtype=torch.int32),
        "accepted": torch.tensor([True, False]),
        "generator": generator,
        "tag": "warm",
    }


def _template():
    return {"position": {"coefficients": torch.zeros((2, 4)),
                         "precision": torch.zeros(2, dtype=torch.float64)},
            "step_size": torch.zeros(()), "iteration": torch.zeros((), dtype=torch.int32),
            "accepted": torch.zeros(2, dtype=torch.bool), "generator": torch.Generator(),
            "tag": ""}


@pytest.mark.parametrize("fmt", ["torch", "npz"])
def test_round_trip_restores_values_dtypes_devices_and_streams(tmp_path, fmt):
    g = torch.Generator().manual_seed(5)
    torch.rand(7, generator=g)  # mid-stream
    state = _state(g)
    if fmt == "torch":
        path = str(tmp_path / "state.pt")
        save_checkpoint(path, state)
        back = load_checkpoint(path, _template())
    else:
        path = str(tmp_path / "state.npz")
        save_npz(path, state)
        back = load_npz(path, _template())
    for k in ("step_size", "iteration", "accepted"):
        assert back[k].dtype == state[k].dtype and back[k].device == state[k].device
        assert torch.equal(back[k], state[k])
    for k, v in state["position"].items():
        assert back["position"][k].dtype == v.dtype and torch.equal(back["position"][k], v)
    assert back["tag"] == "warm"
    # the restored generator continues the saved stream
    assert back["generator"] is not g
    assert torch.equal(torch.rand(5, generator=back["generator"]), torch.rand(5, generator=g))


def test_checkpoint_refusals(tmp_path):
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, {"x": torch.ones(3)})
    with pytest.raises(FileExistsError):
        save_checkpoint(path, {"x": torch.ones(3)}, force=False)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"x": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing.pt"), {"x": torch.zeros(3)})
    assert not os.path.exists(path + ".tmp")


def test_resume_reproduces_exact_chain(tmp_path):
    """Checkpoint chains and their generator after 50 steps, restore, and
    continue: the same draws as 100 uninterrupted steps."""
    kernel = rwm(lambda p: -0.5 * p["x"] ** 2, 0.7)
    states = init_chains(kernel, {"x": torch.zeros(4)})
    g = torch.Generator().manual_seed(0)
    mid, _ = run_chains(kernel, g, states, 50)
    path = str(tmp_path / "resume.pt")
    save_checkpoint(path, {"states": mid, "generator": g})
    _, draws_a = run_chains(kernel, g, mid, 50)
    back = load_checkpoint(path, {"states": mid, "generator": torch.Generator()})
    _, draws_b = run_chains(kernel, back["generator"], back["states"], 50)
    assert torch.equal(draws_a["x"], draws_b["x"])


def test_run_config_json_matches_jax():
    for t, j in ((RunConfig(), JRunConfig()),
                 (RunConfig(n_chains=64, seed=3,
                            kernel=KernelConfig(algorithm="rwm", step_size=0.5),
                            adaptation=AdaptationConfig(num_warmup=200, adapt_mass=False),
                            checkpoint_path="run.pt", checkpoint_every=5),
                  JRunConfig(n_chains=64, seed=3,
                             kernel=JKernelConfig(algorithm="rwm", step_size=0.5),
                             adaptation=JAdaptationConfig(num_warmup=200, adapt_mass=False),
                             checkpoint_path="run.pt", checkpoint_every=5))):
        assert t.to_json() == j.to_json()
        assert RunConfig.from_json(j.to_json()) == t
    with pytest.raises(dataclasses.FrozenInstanceError):
        RunConfig().seed = 1


def test_aggregate_info_matches_jax():
    """The same (steps, chains) info in both packages: the same keys and
    the same values, exactly (dyadic values over 64 entries, so every sum
    and mean is exact in float32)."""
    rng = np.random.default_rng(0)
    acc = rng.random((8, 8)) < 0.7
    prob = (rng.integers(0, 16, (8, 8)) / 16).astype(np.float32)
    err = (rng.integers(-8, 8, (8, 8)) / 4).astype(np.float32)
    div = rng.random((8, 8)) < 0.1
    ld = (rng.integers(-64, 0, (8, 8)) / 8).astype(np.float32)
    steps = rng.integers(1, 9, 8).astype(np.int32)
    t = aggregate_info({"hmc": HMCInfo(*(torch.tensor(x) for x in (acc, prob, err, div, ld))),
                        "steps": torch.tensor(steps)})
    j = jax_aggregate_info({"hmc": JHMCInfo(*(jnp.asarray(x) for x in (acc, prob, err, div, ld))),
                            "steps": jnp.asarray(steps)})
    assert t == j
    assert set(t) >= {"hmc.accepted_rate", "hmc.accepted_count", "hmc.is_divergent_count"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        with named_scope("leapfrog"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    doc = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any(e.get("name") == "leapfrog" for e in doc["traceEvents"])
    with trace(None):
        pass


def test_check_determinism():
    kernel = hmc(lambda p: -0.5 * torch.sum(p["x"] ** 2, dim=-1), 0.3, 5)
    state = kernel.init({"x": torch.randn((8, 3), generator=torch.Generator().manual_seed(0))})
    assert check_determinism(kernel, 3, state)

    def unseeded(generator, s):  # ignores the generator: draws differ run to run
        x = s.position["x"]
        return s._replace(position={"x": x + torch.randn(x.shape)}), None

    assert not check_determinism(kernel._replace(step=unseeded), 3, state)


def test_finite_or_neginf():
    kernel = rwm(finite_or_neginf(lambda p: torch.log(p["x"])), 0.5, proposal="normal")
    states = init_chains(kernel, {"x": torch.ones(16)})
    final, _ = run_chains(kernel, torch.Generator().manual_seed(0), states, 200)
    assert bool((final.position["x"] > 0).all())
    assert bool(torch.isfinite(final.logdensity).all())


def test_validate_density_matches_jax_report():
    """The polynomial posterior at a healthy point and at a negative
    precision: the same report keys and verdicts as the JAX package's, and
    the same log densities to 1e-5 relative."""
    xses, ys = jax_make_data(jax.random.key(1))
    jpost = jax_make_posterior(xses, ys)
    tpost = make_posterior(np.asarray(xses), np.asarray(ys))
    for prec, ok in ((2.0, True), (-1.0, False)):
        t = validate_density(tpost, coefficients=torch.ones(4), precision=torch.tensor(prec))
        j = jax_validate_density(jpost, coefficients=jnp.ones(4), precision=jnp.asarray(prec))
        assert t["ok"] is ok and j["ok"] is ok
        assert set(t) == set(j)
        for k in t:
            if isinstance(t[k], dict) and "finite" in t[k]:
                assert t[k]["finite"] == j[k]["finite"], k
        if ok:
            assert t["log_prob"]["value"] == pytest.approx(j["log_prob"]["value"], rel=1e-5)
            assert t["log_prob[points]"]["finite"]
