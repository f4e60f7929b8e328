"""The command line's SMC and VI routes on the CPU (``--device cpu``): the
counterparts of ``tests/test_cli.py``'s ``smc``, ``advi`` and
``pathfinder`` cases with their gates, an ``svgd`` run, and a parity case:
the JAX CLI's own polynomial data (``make_data`` of the first of its three
keys), handed as numpy to the port's ``run`` under ``--algorithm
laplace``, with the JAX CLI's normals for the 1,000 draws (its second
key), gives the JAX CLI's posterior means to 1e-4 relative, its log
evidence to 1e-3 and its convergence flag: the fit is deterministic in
both packages."""

import jax
import numpy as np
import torch

from binf_tpu import cli as jcli
from binf_tpu.example import polynomial as jpoly
from binf_tpu_torch.cli import Model, main, parse_args, run
from binf_tpu_torch.example import polynomial as poly
from binf_tpu_torch.pdf.transforms import LogTransform
from binf_tpu_torch.vi import laplace as lap_mod


def cli(*argv):
    return main([*argv, "--device", "cpu"])


def test_cli_smc():
    out = cli("--model", "polynomial", "--algorithm", "smc", "--chains", "512")
    assert out["num_stages"] > 2
    assert abs(out["posterior_means"]["coefficients"][1] + 4.0) < 0.6


def test_cli_advi():
    out = cli("--model", "polynomial", "--algorithm", "advi", "--samples", "400")
    assert np.isfinite(out["final_elbo"])
    assert abs(out["posterior_means"]["coefficients"][1] + 4.0) < 0.6


def test_cli_pathfinder():
    out = cli("--model", "polynomial", "--algorithm", "pathfinder", "--chains", "8")
    assert out["pareto_k"] < 0.7
    assert abs(out["posterior_means"]["coefficients"][1] + 4.0) < 1.0


def test_cli_svgd():
    out = cli("--model", "polynomial", "--algorithm", "svgd", "--chains", "64", "--samples",
              "100")
    assert set(out) == {"model", "algorithm", "elapsed_sec", "posterior_means"}
    assert out["posterior_means"]["precision"] > 0


def test_cli_laplace_on_the_jax_clis_data_matches_it(monkeypatch):
    argv = ["--model", "polynomial", "--algorithm", "laplace"]
    jout = jcli.main(argv)
    k_model, k_init, _ = jax.random.split(jax.random.key(0), 3)
    xses, ys = jpoly.make_data(k_model)
    post = poly.make_posterior(torch.tensor(np.asarray(xses)), torch.tensor(np.asarray(ys)))
    model = Model(post, lambda n, generator=None: poly.initial_positions(
        n, generator=generator, device="cpu"), {"precision": LogTransform})
    # the JAX CLI's laplace_sample normals: jax.random.normal(k_init, (1000, d))
    eps = torch.tensor(np.asarray(jax.random.normal(k_init, (1000, 5))))
    monkeypatch.setattr(lap_mod, "_standard_normal", lambda gen, shape, dev: eps.reshape(shape))
    out = run(parse_args([*argv, "--device", "cpu"]), model)
    assert set(out) == set(jout)
    assert out["converged"] == jout["converged"]
    np.testing.assert_allclose(out["log_evidence_laplace"], jout["log_evidence_laplace"],
                               atol=1e-3)
    for k in ("coefficients", "precision"):
        np.testing.assert_allclose(out["posterior_means"][k], jout["posterior_means"][k],
                                   rtol=1e-4, atol=1e-5)
