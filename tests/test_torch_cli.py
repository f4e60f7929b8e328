"""The command line (``binf_tpu_torch/cli.py``, ``python -m
binf_tpu_torch``) on the CPU: the counterparts of ``tests/test_cli.py``'s
routing and fused-route cases, with ``--device cpu`` (the kernels' plain
versions), the same output keys and the same gates; the cases the JAX
package marks slow run at fewer chains or steps.  Two counterparts differ
on purpose: the hierarchical posterior routes to the fused kernels at
every chain count (the JAX package sends large batches to XLA), so the
case of fused-only flags on the eager route runs the chromatin model,
which has no CUDA functor.  ``--mesh`` runs in a group of one here (4
gloo ranks in ``test_torch_mesh_runner.py``).  Also: ``--checkpoint`` writes
nothing (the reference's no-op), with no card and no ``--device cpu``
``main`` raises, and ``python -m binf_tpu_torch --help`` runs.  The
samplers' and the VI cases are in ``test_torch_cli_samplers.py``,
``test_torch_cli_eager.py`` and ``test_torch_cli_vi.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from binf_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli(*argv):
    return main([*argv, "--device", "cpu"])


def test_cli_default_auto_routes_and_reports():
    """--algorithm auto is the default: the run reports the path the router
    chose and recovers the reference posterior."""
    out = cli("--model", "polynomial", "--chains", "64", "--warmup", "150", "--samples", "150")
    assert out["algorithm"] == "auto"
    assert out["routed_to"] == "fused"
    assert "routing_reason" in out
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.8


def test_cli_auto_forwards_fused_flags():
    """--algorithm auto honours fused-only flags: --warmup-mode fused runs
    the in-kernel warmup."""
    out = cli("--model", "polynomial", "--algorithm", "auto", "--chains", "64", "--warmup",
              "100", "--samples", "100", "--warmup-mode", "fused", "--block-chains", "64")
    assert out["routed_to"] == "fused"
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.8


def test_cli_auto_rejects_fused_flags_on_eager_route():
    """Fused-only flags on a run that routes to the eager path raise.  The
    JAX test routes the hierarchical model at 4,096 chains to XLA; the
    port routes it to the fused kernels, so the chromatin model, which has
    no CUDA functor, takes the eager route here."""
    with pytest.raises(ValueError, match="fused path only"):
        cli("--model", "chromatin", "--algorithm", "auto", "--chains", "8", "--warmup", "20",
            "--samples", "20", "--per-chain-step")


def test_cli_auto_routes_hierarchical_to_fused():
    """The JAX package routes the hierarchical model at 4,096 chains to XLA
    (``tests/test_cli.py:105``); the port's router sends it to the fused
    kernels at every chain count (measured on the card,
    ``samplers/auto.py::route_algorithm``).  256 chains here, 4,096 there."""
    out = cli("--model", "hierarchical", "--algorithm", "auto", "--chains", "256", "--warmup",
              "30", "--samples", "30")
    assert out["routed_to"] == "fused"
    assert out["routing_reason"].startswith("device density: HierarchicalDensity")
    assert out["accept_rate"] > 0.2


def test_cli_fused_polynomial():
    out = cli("--model", "polynomial", "--algorithm", "fused", "--chains", "64", "--warmup",
              "200", "--samples", "200")
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.6
    assert out["summary"]["precision"]["mean"] > 0
    assert 0.3 < out["accept_rate"] <= 1.0


def test_cli_fused_hierarchical():
    out = cli("--model", "hierarchical", "--algorithm", "fused", "--chains", "32", "--warmup",
              "200", "--samples", "150")
    assert out["summary"]["mu"]["rhat"][0] < 1.3
    assert 0.3 < out["accept_rate"] <= 1.0


def test_cli_statespace_fused():
    out = cli("--model", "statespace", "--algorithm", "fused", "--chains", "32", "--warmup",
              "200", "--samples", "150")
    assert 0.3 < out["accept_rate"] <= 1.0
    assert out["summary"]["dynamics"]["rhat"][0] < 1.35


def test_cli_fused_warmup_mode_and_moments():
    """--warmup-mode fused + --collect moments: the in-kernel warmup and
    streaming moments, in unconstrained space."""
    out = cli("--model", "polynomial", "--algorithm", "fused", "--chains", "64", "--warmup",
              "300", "--samples", "300", "--warmup-mode", "fused", "--collect", "moments")
    assert out["space"] == "unconstrained"
    assert 0.3 < out["accept_rate"] <= 1.0
    means = out["posterior_means"]["coefficients"]
    assert abs(means[1] + 4.0) < 0.6


def test_cli_fused_dense_warmup():
    """--warmup-mode dense: a full-covariance metric and fused sampling."""
    out = cli("--model", "polynomial", "--algorithm", "fused", "--warmup-mode", "dense",
              "--chains", "64", "--warmup", "300", "--samples", "200", "--block-chains", "32")
    assert out["accept_rate"] > 0.5
    means = out["summary"]["coefficients"]["mean"]
    assert abs(means[1] + 4.0) < 0.8


def test_cli_unknown_model():
    with pytest.raises(SystemExit):
        cli("--model", "nope")


def test_cli_mesh_raises():
    """``--mesh`` joins a group of one (no ``torchrun`` environment) and
    shards the chains over it: the run prints the summary of every chain,
    as the run without it does.  (The name is the one the test had while
    ``--mesh`` raised.)"""
    import torch.distributed as dist

    args = ("--model", "polynomial", "--algorithm", "hmc", "--chains", "8", "--warmup", "20",
            "--samples", "20")
    try:
        out = cli(*args, "--mesh")
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ref = cli(*args)
    assert out["draws"] == ref["draws"] == 8 * 20
    assert out["summary"].keys() == ref["summary"].keys()
    for k, v in ref["summary"].items():
        assert np.shape(out["summary"][k]["mean"]) == np.shape(v["mean"])


def test_cli_checkpoint_is_a_no_op(tmp_path, capsys):
    """``--checkpoint`` is parsed and never read, in the JAX package's CLI
    and here (kept for parity): the run writes nothing there.
    ``--persistent-cache`` names the kernel build directory."""
    path = tmp_path / "ckpt"
    out = cli("--model", "polynomial", "--algorithm", "gibbs", "--chains", "8", "--samples",
              "20", "--checkpoint", str(path), "--persistent-cache")
    assert out["algorithm"] == "gibbs"
    assert not path.exists() and list(tmp_path.iterdir()) == []
    assert "kernel builds are cached in" in capsys.readouterr().err


def test_cli_without_a_card_raises(monkeypatch):
    """With no card and no ``--device cpu``, ``main`` raises: no fallback
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "polynomial", "--algorithm", "gibbs", "--chains", "8"])


def test_python_m_help_runs():
    res = subprocess.run([sys.executable, "-m", "binf_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr
    assert "--algorithm" in res.stdout and "--device" in res.stdout


def test_cli_summary_out(tmp_path):
    """``--summary-out`` writes the printed summary."""
    out = cli("--model", "polynomial", "--algorithm", "gibbs", "--chains", "16", "--samples",
              "40", "--summary-out", str(tmp_path / "s.json"))
    assert json.loads((tmp_path / "s.json").read_text()) == out
