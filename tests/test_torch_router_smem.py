"""The router's shared-memory rule (``ops/kernels/fused_potential.py::
kernel_refusal``), on the CPU, each case beside the JAX package's router
on the same model built from the same numpy data.

K3 stages a density's operands in the kernels' 12,288 floats of shared
memory, K4 its operands, the 256-float ChEES Halton table and the dense
metric's 2 D^2 floats.  The polynomial posterior at 5,000 points needs
25,008 floats in K3; at 2,394 points K4 needs 12,284, and at 2,395
points 12,289, one past the limit.  The logistic posterior of the example's design at
3,000 rows needs 21,010 floats in K3; at 1,710 rows K4 needs 12,286.
``route_algorithm``, ``route_trajectory_sampler`` and the CLI's ``chees``
route send a density past the limit to the eager path with the
predicate's reason, and the kernels' raise is the same predicate's.  The
JAX package routes all of these to XLA: its VMEM cost model
(``binf_tpu/samplers/auto.py::_data_heavy``) calls each data-heavy; the
port routes on the limits its own kernels check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import logistic as jl
from binf_tpu.example import polynomial as jp
from binf_tpu.pdf.transforms import LogTransform as JaxLog
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers import auto as jauto
from binf_tpu_torch import cli
from binf_tpu_torch.example import logistic, polynomial
from binf_tpu_torch.ops.kernels import fused_potential as fp
from binf_tpu_torch.ops.kernels.densities import device_density
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import auto
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CHAINS = 8


def _polynomial(n):
    """(JAX log density, port log density, JAX and port starts): the
    reference's polynomial posterior at n points of x in [-2, 2]."""
    rng = np.random.default_rng(n)
    x = np.linspace(-2.0, 2.0, n).astype(np.float32)
    y = (2.0 - 4.0 * x + x ** 2 + 1.5 * x ** 3 + rng.normal(size=n) / np.sqrt(2.5)
         ).astype(np.float32)
    jfn = jax_transform(jp.make_posterior(jnp.asarray(x), jnp.asarray(y)).log_prob,
                        {"precision": JaxLog})
    tfn = transform_logdensity(polynomial.make_posterior(x, y).log_prob,
                               {"precision": LogTransform})
    start = {"coefficients": np.ones((CHAINS, 4), np.float32),
             "precision": np.zeros(CHAINS, np.float32)}
    return jfn, tfn, start


def _logistic(n):
    rng = np.random.default_rng(n)
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 4))], 1).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-X @ np.array([1.5, -2.0, 0.75, 0.0, 1.0])))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    start = {"weights": np.zeros((CHAINS, 5), np.float32)}
    return (jl.make_logistic_posterior(jnp.asarray(X), jnp.asarray(y)).log_prob,
            logistic.make_logistic_posterior(X, y, device="cpu").log_prob, start)


def _t(start):
    return {k: torch.tensor(v) for k, v in start.items()}


def _j(start):
    return {k: jnp.asarray(v) for k, v in start.items()}


# (model, size, floats K3 or K4 needs past the limit, or None under it)
CASES = [("polynomial", 5000, "K3 needs 25008 floats"), ("polynomial", 2395, "K4 needs 12289 floats"),
         ("polynomial", 2394, None), ("logistic", 3000, "K3 needs 21010 floats"),
         ("logistic", 1710, None)]


@pytest.mark.parametrize("model, n, need", CASES)
def test_route_algorithm_and_the_nuts_rule(model, n, need):
    jfn, tfn, start = (_polynomial if model == "polynomial" else _logistic)(n)
    density = device_density(tfn, {k: torch.tensor(v[0]) for k, v in start.items()})
    dec = auto.route_algorithm(tfn, _t(start))
    jdec = jauto.route_algorithm(jfn, _j(start))
    assert jdec.path == "xla" and jdec.reason.startswith("data-heavy density"), jdec.reason
    sampler, reason = auto.route_trajectory_sampler("nuts", tfn, _t(start))
    jsampler, jreason = jauto.route_trajectory_sampler("nuts", jfn, _j(start))
    assert jsampler == "nuts" and jreason.startswith("nuts honored: data-heavy")
    if need is None:
        assert fp.kernel_refusal(density) is None
        assert dec.path == "fused" and dec.reason.startswith("device density: ")
        assert sampler == "hmc" and "device density: " in reason
        return
    why = fp.kernel_refusal(density)
    assert why.startswith(fp.REFUSED) and need in why and "the kernels take 12288" in why
    assert dec.path == "xla" and dec.reason.startswith(why) and dec.block_chains is None
    # the NUTS rule weighs it as a density with no functor: the card's
    # measurement put eager fixed-L HMC ahead of eager NUTS
    assert sampler == "hmc" and reason.startswith(f"nuts rerouted to fixed-L HMC: {why}")
    # the kernels' own raise is the same predicate's, K3's before any launch
    kernel = need.split()[0]
    with pytest.raises(ValueError) as e:
        fp.refuse(density, (kernel,))
    assert str(e.value) == fp.kernel_refusal(density, (kernel,))


def test_adaptive_hmc_runs_the_refused_density_eagerly():
    """``adaptive_hmc(algorithm="auto")`` on the 5,000-point posterior runs
    the eager path (no fused option may be passed) and recovers the
    coefficients; a fused option raises, naming the refusal."""
    _, tfn, start = _polynomial(5000)
    res, dec = auto.adaptive_hmc(tfn, _t(start), 0, num_warmup=60, num_samples=40,
                                 initial_step_size=0.1, device="cpu")
    assert dec.path == "xla" and dec.reason.startswith(fp.REFUSED)
    assert res.samples["coefficients"].shape == (40, CHAINS, 4)
    mean = res.samples["coefficients"][10:].reshape(-1, 4).mean(0)
    assert torch.allclose(mean, torch.tensor([2.0, -4.0, 1.0, 1.5]), atol=0.1), mean
    with pytest.raises(ValueError, match="device density refused by the kernels"):
        auto.adaptive_hmc(tfn, _t(start), 0, num_warmup=4, num_samples=4, warmup="fused",
                          device="cpu")


@pytest.mark.parametrize("n, route", [(5000, "chees (xla)"), (2394, "chees (fused in-kernel)")])
def test_cli_chees_route(n, route):
    """``--algorithm chees`` takes the fused kernels only for a density they
    take: the 5,000-point posterior runs the eager ChEES route."""
    _, tfn, _ = _polynomial(n)
    post = tfn.logdensity_fn.__self__
    model = cli.Model(post, lambda m, generator=None: polynomial.initial_positions(
        m, generator=generator, device="cpu"), {"precision": LogTransform})
    args = cli.parse_args(["--model", "polynomial", "--algorithm", "chees", "--chains", "8",
                           "--warmup", "10", "--samples", "10", "--device", "cpu"])
    out = cli.run(args, model)
    assert out["sampler"] == route
