"""The eager warmup: dual averaging, the batched Welford fold, the
step-size search and ``window_adaptation`` against the JAX package's, then
``warmup_and_run`` and ``fused_model_hmc(warmup="xla")`` end to end on the
CPU.

``window_adaptation`` is compared step for step with a deterministic stub
kernel: its move and its acceptance probability are fixed functions of the
position, the step size and the metric, and it ignores its key or
generator, so both packages follow one trajectory.  They differ only by
float32 rounding in sums taken in other orders: the step size, metric and
positions agree to 1e-5 relative (the stub contracts, so rounding does not
grow).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.ops.math import WelfordState as JWelford
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers import adaptation as jad
from binf_tpu.samplers.base import SamplerKernel as JKernel
from binf_tpu.samplers.fused import fused_model_hmc as jax_fused_model_hmc
from binf_tpu_torch.example.polynomial import make_posterior
from binf_tpu_torch.ops.math import WelfordState, welford_init
from binf_tpu_torch.parallel.runner import warmup_and_run
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import adaptation as tad
from binf_tpu_torch.samplers.base import SamplerKernel
from binf_tpu_torch.samplers.fused import fused_model_hmc
from binf_tpu_torch.samplers.hmc import hmc

C = 16


class StubState(NamedTuple):
    position: dict


class StubInfo(NamedTuple):
    acceptance_prob: object


def _stub(xp, eps, im):
    """A deterministic kernel written once for both packages (``xp`` is
    ``jnp`` or ``torch``): positions ``{"s": (), "x": (2,)}`` per chain, with
    or without a leading chain axis; ``eps`` a scalar or one per chain."""

    def step(_key, state):
        x, s = state.position["x"], state.position["s"]
        e = eps if getattr(eps, "ndim", 0) == 0 else eps.reshape(s.shape)
        mx = 1.0 if im is None else im["x"]
        ms = 1.0 if im is None else im["s"]
        x_new = 0.9 * x + xp.tanh(e)[..., None] * xp.cos(x + s[..., None]) * mx
        s_new = 0.9 * s + xp.tanh(e) * xp.sin(s + 1.0) * ms
        a = 1.0 / (1.0 + e * (1.0 + 0.1 * (x * x).sum(-1) + 0.1 * s * s))
        return StubState({"s": s_new, "x": x_new}), StubInfo(a)

    return step


def _start():
    rng = np.random.default_rng(0)
    return {"s": rng.normal(size=C).astype(np.float32),
            "x": rng.normal(size=(C, 2)).astype(np.float32)}


def _jax_builder(eps, im):
    return JKernel(init=lambda p: StubState(p), step=_stub(jnp, jnp.asarray(eps), im))


def _torch_builder(eps, im):
    return SamplerKernel(init=lambda p: StubState(p),
                         step=_stub(torch, torch.as_tensor(eps, dtype=torch.float32), im))


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(1)
    accepts = rng.random((30, C)).astype(np.float32)
    for per_chain in (False, True):
        eps0 = np.float32(0.3) if not per_chain else (0.1 + rng.random(C)).astype(np.float32)
        js, ts = jad.dual_averaging_init(jnp.asarray(eps0)), tad.dual_averaging_init(
            torch.tensor(eps0))
        for a in accepts:
            stat = a if per_chain else a.mean()
            js = jad.dual_averaging_update(js, jnp.asarray(stat), target=0.75)
            ts = tad.dual_averaging_update(ts, torch.tensor(stat), target=0.75)
        for final in (False, True):
            np.testing.assert_allclose(tad.dual_averaging_step_size(ts, final).numpy(),
                                       np.asarray(jad.dual_averaging_step_size(js, final)),
                                       rtol=1e-6)


def test_welford_batch_update_matches_jax():
    rng = np.random.default_rng(2)
    batches = [{"a": rng.normal(size=(C, 3)).astype(np.float32),
                "b": rng.normal(size=C).astype(np.float32)} for _ in range(5)]
    tw = welford_init({"a": torch.zeros(3), "b": torch.zeros(())})
    jw = JWelford(jnp.zeros(()), {"a": jnp.zeros(3), "b": jnp.zeros(())},
                  {"a": jnp.zeros(3), "b": jnp.zeros(())})
    for bt in batches:
        tw = tad.welford_batch_update(tw, {k: torch.tensor(v) for k, v in bt.items()})
        jw = jad.welford_batch_update(jw, {k: jnp.asarray(v) for k, v in bt.items()})
    assert float(tw.count) == float(jw.count) == 5 * C
    for k in ("a", "b"):
        np.testing.assert_allclose(tw.mean[k].numpy(), np.asarray(jw.mean[k]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tw.m2[k].numpy(), np.asarray(jw.m2[k]), rtol=1e-5)
    assert isinstance(tw, WelfordState)


@pytest.mark.parametrize("initial_step_size", [1.0, 0.01], ids=["halve", "double"])
def test_find_reasonable_step_size_matches_jax(initial_step_size):
    p0 = {k: v[0] for k, v in _start().items()}
    j = jad.find_reasonable_step_size(lambda e: _jax_builder(e, None), jax.random.key(0),
                                      StubState({k: jnp.asarray(v) for k, v in p0.items()}),
                                      initial_step_size)
    t = tad.find_reasonable_step_size(lambda e: _torch_builder(e, None),
                                      torch.Generator().manual_seed(0),
                                      StubState({k: torch.tensor(v) for k, v in p0.items()}),
                                      initial_step_size)
    assert float(t) == float(j)
    assert float(t) != initial_step_size


@pytest.mark.parametrize("per_chain, initial_step_size, num_steps",
                         [(False, 0.1, 200), (True, 0.1, 200), (False, None, 60),
                          (True, None, 30)],
                         ids=["pooled", "per_chain", "search", "per_chain_short"])
def test_window_adaptation_matches_jax_step_for_step(per_chain, initial_step_size, num_steps):
    start = _start()
    j = jad.window_adaptation(_jax_builder, StubState({k: jnp.asarray(v) for k, v in start.items()}),
                              jax.random.key(1), num_steps=num_steps,
                              initial_step_size=initial_step_size, target_accept=0.7,
                              per_chain=per_chain)
    t = tad.window_adaptation(_torch_builder,
                              StubState({k: torch.tensor(v) for k, v in start.items()}),
                              torch.Generator().manual_seed(1), num_steps=num_steps,
                              initial_step_size=initial_step_size, target_accept=0.7,
                              per_chain=per_chain)
    assert tuple(t.step_size.shape) == tuple(np.shape(j.step_size))
    np.testing.assert_allclose(t.step_size.numpy(), np.asarray(j.step_size), rtol=1e-5)
    for k in ("s", "x"):
        np.testing.assert_allclose(t.inverse_mass[k].numpy(), np.asarray(j.inverse_mass[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.final_states.position[k].numpy(),
                                   np.asarray(j.final_states.position[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.da_state.count.numpy(), np.asarray(j.da_state.count))
    # the metric was harvested from the windows, not left at its start
    assert not np.allclose(t.inverse_mass["x"].numpy(), 1.0)


SCALES = torch.tensor([0.5, 1.0, 2.0, 4.0])


def _gauss_logdensity(p):
    return -0.5 * torch.sum((p["x"] / SCALES) ** 2, dim=-1)


def test_window_adaptation_learns_the_metric():
    """Over the port's HMC on a diagonal Gaussian, the harvested metric is
    the target's variances within 20%, and the adapted step size accepts
    near the target."""
    q0 = {"x": torch.randn((128, 4), generator=torch.Generator().manual_seed(3))}

    def builder(eps, im):
        return hmc(_gauss_logdensity, eps, 8, im)

    states = builder(0.1, None).init(q0)
    res = tad.window_adaptation(builder, states, torch.Generator().manual_seed(4), num_steps=300)
    np.testing.assert_allclose(res.inverse_mass["x"].numpy(), (SCALES ** 2).numpy(), rtol=0.2)
    assert 0.05 < float(res.step_size) < 3.0


@pytest.mark.parametrize("per_chain", [False, True], ids=["pooled", "per_chain"])
def test_warmup_and_run_end_to_end(per_chain):
    q0 = {"x": torch.zeros((64, 4))}

    def builder(eps, im):
        return hmc(_gauss_logdensity, eps, 8, im)

    samples, final, adapt = warmup_and_run(builder, q0, torch.Generator().manual_seed(5),
                                           num_warmup=200, num_samples=300, thin=2,
                                           per_chain_step_size=per_chain)
    assert samples["x"].shape == (150, 64, 4)
    assert final.position["x"].shape == (64, 4)
    assert adapt.step_size.shape == ((64,) if per_chain else ())
    x = samples["x"][25:].reshape(-1, 4)
    # 64 chains x 125 autocorrelated draws: means within ~4 standard errors
    assert bool((x.mean(0).abs() < 0.25 * SCALES).all())
    np.testing.assert_allclose(x.std(0).numpy(), SCALES.numpy(), rtol=0.15)


def test_fused_model_hmc_xla_warmup_matches_jax_moments():
    """``fused_model_hmc(warmup="xla")``, the JAX package's default: the
    eager window warmup over all chains, then K4's plain version, on the
    polynomial posterior, against the JAX package's own run (interpret
    mode); different noise, so the posterior moments are held to five times
    their Monte Carlo error at 64 chains x 150 kept draws."""
    rng = np.random.default_rng(3)
    xs = np.linspace(-2, 2, 20).astype(np.float32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    init = {"coefficients": (0.1 * rng.normal(size=(64, 4))).astype(np.float32),
            "precision": np.zeros(64, np.float32)}
    kw = dict(num_warmup=150, num_samples=200, block_chains=32, warmup="xla")
    jld = jax_transform(jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys)).log_prob,
                        {"precision": JLogTransform})
    j = jax_fused_model_hmc(jld, {k: jnp.asarray(v) for k, v in init.items()},
                            jax.random.key(0), **kw)
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    t = fused_model_hmc(tld, init, 0, device="cpu", **kw)
    assert t.step_size.dim() == 0 and t.inverse_mass.shape == (5,)

    def summary(s):
        c = np.asarray(s["coefficients"])[50:].reshape(-1, 4)
        return c.mean(0), c.std(0), np.exp(np.asarray(s["precision"])[50:]).mean()

    (jm, js, jp), (tm, ts, tp) = summary(j.samples), summary(t.samples)
    np.testing.assert_allclose(tm, jm, atol=0.05)
    np.testing.assert_allclose(ts, js, rtol=0.15)
    assert tp == pytest.approx(jp, rel=0.1)
    assert 0.6 < float(t.accept_rate) < 0.95
    assert abs(float(t.accept_rate) - float(j.accept_rate)) < 0.1
    np.testing.assert_allclose(float(t.step_size), float(j.step_size), rtol=0.3)
    per = fused_model_hmc(tld, init, 1, device="cpu", per_chain_step_size=True,
                          **dict(kw, num_warmup=60, num_samples=50))
    assert per.step_size.shape == (64,) and bool((per.step_size > 0).all())


def _gauss_through_eigvalsh(p):
    """The same Gaussian through ``linalg.eigvalsh`` of a diagonal, an op
    the density compiler has no lowering rule for."""
    z = p["x"] / SCALES
    return -0.5 * torch.linalg.eigvalsh(torch.diag_embed(z * z)).sum(-1)


def test_refusal_names_the_eager_route_that_runs_the_model():
    """A model the density compiler refuses (so no CUDA functor runs it) is
    refused on the card with a message naming the eager route; that route
    runs it (here on the CPU, as it would on the card).  The plain Gaussian
    itself compiles."""
    from binf_tpu_torch.ops.kernels.densities import TracedDensity, device_density

    assert isinstance(device_density(_gauss_logdensity, {"x": torch.zeros(4)}), TracedDensity)
    with pytest.raises(NotImplementedError, match="warmup_and_run"):
        device_density(_gauss_through_eigvalsh, {"x": torch.zeros(4)})

    def builder(eps, im):
        return hmc(_gauss_through_eigvalsh, eps, 8, im)

    samples, _, _ = warmup_and_run(builder, {"x": torch.zeros((16, 4))},
                                   torch.Generator().manual_seed(6), num_warmup=60,
                                   num_samples=20)
    assert samples["x"].shape == (20, 16, 4) and bool(torch.isfinite(samples["x"]).all())
