"""``tempered_smc(mesh=...)`` under 4 gloo ranks against the unsharded
port: the chromatin posterior at 16 beads with RWM moves and systematic
resampling (``tests/test_chromatin_smc.py::
test_distributed_matches_single_device``'s settings, whose bound is rtol
1e-4), the polynomial posterior with HMC moves, and with stratified
resampling, from 64 particles, which 4 and 8 divide; and the polynomial
posterior from 4,096 prior draws with 10 RWM moves a stage to beta = 1,
``chip_smoke.py``'s smc settings, where a pooled statistic's last-bit
difference would have become another realisation.  Every stage of a
sharded run is the unsharded run's arithmetic, so on the CPU the RWM runs
are equal bit for bit; the HMC run's gradients are a batched product that
rounds by the rows batched, and it holds at the JAX test's bound.  The ranks run once for the file (``torch_ranks.py``'s
``smc`` battery), each under its own deadline."""

import jax
import numpy as np
import pytest
import torch

from binf_tpu.example.chromatin import synthetic_restraints
from torch_ranks import SMC_CASES, smc_case, spawn_ranks, world_of_one

WORLD = 4
N = 64


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    f32 = np.float32
    _, logD, W = (np.asarray(a, f32) for a in
                  synthetic_restraints(jax.random.key(0), 16, observe_frac=0.6))
    xs = np.linspace(-2, 2, 20).astype(f32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(f32)
    return {"logD16": torch.tensor(logD), "W16": torch.tensor(W),
            "smc_X": torch.tensor(np.cumsum(rng.normal(size=(N, 16, 3)), axis=1).astype(f32)),
            "smc_prec": torch.tensor(rng.gamma(2.0, 10.0, size=N).astype(f32)),
            "xs": torch.tensor(xs), "ys": torch.tensor(ys),
            "smc_c": torch.tensor((np.sqrt(5.0) * rng.normal(size=(N, 4))).astype(f32)),
            "smc_p": torch.tensor(rng.gamma(1.0, 5.0, size=N).astype(f32))}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks("smc", tmp_path_factory.mktemp("smc"), inputs, WORLD, timeout=240)


@pytest.mark.parametrize("name", list(SMC_CASES))
def test_sharded_smc_equals_unsharded(inputs, ranks, name):
    ref = smc_case(name, inputs)
    assert float(ref.final_beta) == 1.0 or int(ref.num_stages) == SMC_CASES[name]["max_stages"]
    for r in ranks:
        out = r[name]
        assert int(out["num_stages"]) == int(ref.num_stages)
        if SMC_CASES[name]["mutation"] == "hmc":
            # the gradient's batched product rounds by the number of rows
            # batched (16 a rank, 64 unsharded): the JAX test's bound
            np.testing.assert_allclose(float(out["final_beta"]), float(ref.final_beta),
                                       rtol=1e-6)
            np.testing.assert_allclose(float(out["log_evidence"]), float(ref.log_evidence),
                                       rtol=1e-4)
            for k, v in ref.particles.items():
                np.testing.assert_allclose(out["particles"][k].numpy(), v.numpy(), rtol=1e-4,
                                           atol=1e-5)
            continue
        assert torch.equal(out["final_beta"], ref.final_beta)
        assert torch.equal(out["log_evidence"], ref.log_evidence)
        assert torch.equal(out["mean_acceptance"], ref.mean_acceptance)
        for k, v in ref.particles.items():
            assert torch.equal(out["particles"][k], v), k


def test_world_of_one_smc_is_the_unsharded_run(inputs):
    """``tempered_smc`` in a group of one gives the run without a mesh bit
    for bit (the particles as ``DTensor``\\ s)."""
    from binf_tpu_torch.parallel.mesh import gather_chains

    ref = smc_case("poly_hmc", inputs)
    with world_of_one() as mesh:
        res = smc_case("poly_hmc", inputs, mesh)
        particles = gather_chains(res.particles)
    assert torch.equal(res.log_evidence, ref.log_evidence)
    for k, v in ref.particles.items():
        assert torch.equal(particles[k], v), k
