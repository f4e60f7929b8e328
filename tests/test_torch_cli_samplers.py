"""The command line's Gibbs, HMC, NUTS and chain-grid routes and the
pathfinder start on the CPU (``--device cpu``): the counterparts of
``tests/test_cli.py``'s cases with the same output keys and gates, at the
JAX tests' sizes or, where the JAX package marks a case slow, fewer
steps.  ``--algorithm nuts`` on the polynomial posterior is rerouted to
HMC as in the JAX package, with the port's reason: its density has a CUDA
functor (the JAX package's reason cites NUTS's lockstep overhead).  The
eager ChEES route runs on the chromatin model, which has no functor."""

import numpy as np
import pytest

from binf_tpu_torch.cli import main


def cli(*argv):
    return main([*argv, "--device", "cpu"])


def test_cli_polynomial_gibbs(tmp_path):
    out = cli("--model", "polynomial", "--algorithm", "gibbs", "--chains", "64", "--samples",
              "200", "--summary-out", str(tmp_path / "s.json"))
    assert out["algorithm"] == "gibbs"
    stats = out["summary"]
    assert abs(stats["precision"]["mean"] - 2.5) < 1.5
    assert stats["precision"]["rhat"] < 1.1
    assert '"chains": 64' in (tmp_path / "s.json").read_text()


def test_cli_gibbs_needs_the_polynomial_model():
    with pytest.raises(SystemExit):
        cli("--model", "logistic", "--algorithm", "gibbs", "--chains", "8")


def test_cli_hmc():
    """The JAX test's HMC run (``test_cli_hmc_with_mesh``) without its
    ``--mesh``, which runs in a group of one in ``test_torch_cli.py`` and
    under 4 ranks in ``test_torch_mesh_runner.py``; 100 + 100 steps (200 +
    200 there)."""
    out = cli("--model", "polynomial", "--algorithm", "hmc", "--chains", "64", "--warmup",
              "100", "--samples", "100")
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.6  # coefficient 1 truth is -4
    assert out["summary"]["precision"]["mean"] > 0


def test_cli_hmc_dense_metric():
    out = cli("--model", "polynomial", "--algorithm", "hmc", "--metric", "dense", "--chains",
              "64", "--warmup", "200", "--samples", "100")
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.6
    assert out["summary"]["precision"]["mean"] > 0


def test_cli_nuts_rerouted_with_reason():
    """--algorithm nuts on a density with a CUDA functor is rerouted to
    fixed-L HMC with the reason recorded."""
    out = cli("--model", "polynomial", "--algorithm", "nuts", "--chains", "32", "--warmup",
              "100", "--samples", "100")
    assert out["sampler"] == "hmc"
    assert out["reroute_reason"].startswith("nuts rerouted to fixed-L HMC: device density")
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.8


def test_cli_chain_grid_algorithm():
    """--algorithm chain-grid: the chain-grid route end to end (on the CPU
    its plain version runs the polynomial density)."""
    out = cli("--model", "polynomial", "--algorithm", "chain-grid", "--chains", "32",
              "--warmup", "100", "--samples", "100")
    assert out["algorithm"] == "chain-grid"
    assert 0.5 < out["accept_rate"] <= 1.0
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.8


def test_cli_pathfinder_init():
    """--init pathfinder: a short warmup suffices from typical-set starts."""
    out = cli("--model", "polynomial", "--algorithm", "hmc", "--init", "pathfinder", "--chains",
              "64", "--warmup", "100", "--samples", "100")
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.8


def test_cli_chees_without_a_functor_runs_eagerly():
    """The chromatin posterior has no CUDA functor: ``--algorithm chees``
    takes the eager ChEES warmup and sampler ("chees (xla)", as the JAX
    CLI names that route)."""
    out = cli("--model", "chromatin", "--algorithm", "chees", "--chains", "4", "--warmup", "10",
              "--samples", "10")
    assert out["sampler"] == "chees (xla)"
    assert out["draws"] == 40
    assert np.isfinite(out["summary"]["precision"]["mean"])
