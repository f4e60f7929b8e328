"""The slice as a user calls it: ``fused_model_hmc(warmup="fused")`` on the
DSL-built polynomial posterior, fixed and ChEES trajectories, in the port
and in the JAX package (interpret mode), held to the same posterior
moments.  Also the result layout, the options that are not ported yet,
the refusal of a density with no CUDA functor on the card, and adaptation
state carried from the JAX package's warmup into the port's sampler.

The two packages draw different noise (Philox against ``jax.random``), so
their runs are compared as two independent runs: 64 chains x 150 kept
draws give posterior means to about 0.01 and standard deviations to a few
percent; the bounds are five times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.ops.pallas.fused_potential import (
    fused_warmup_run as jax_warmup,
    tile_potential_from_scalar,
)
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers.fused import fused_model_hmc as jax_fused_model_hmc
from binf_tpu_torch.example.polynomial import make_posterior
from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity, device_density
from binf_tpu_torch.ops.kernels.fused_potential import fused_potential_hmc_run
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers.fused import FusedModelResult, auto_block_chains, fused_model_hmc

C = 64
BC = 32
N_WARMUP = 150
N_SAMPLES = 200
BURN = 50


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    xs = np.linspace(-2, 2, 20).astype(np.float32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    init = {"coefficients": (0.1 * rng.normal(size=(C, 4))).astype(np.float32),
            "precision": np.zeros(C, np.float32)}
    return xs, ys, init


def _summary(samples):
    c = np.asarray(samples["coefficients"])[BURN:].reshape(-1, 4)
    p = np.exp(np.asarray(samples["precision"])[BURN:]).reshape(-1)
    return c.mean(0), c.std(0), p.mean()


@pytest.fixture(scope="module")
def runs(data):
    xs, ys, init = data
    jpost = jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys))
    jld = jax_transform(jpost.log_prob, {"precision": JLogTransform})
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    out = {}
    for traj in ("fixed", "chees"):
        kw = dict(num_warmup=N_WARMUP, num_samples=N_SAMPLES, block_chains=BC,
                  warmup="fused", trajectory=traj, max_leapfrog=32)
        out["jax", traj] = jax_fused_model_hmc(
            jld, {k: jnp.asarray(v) for k, v in init.items()}, jax.random.key(0), **kw)
        out["port", traj] = fused_model_hmc(tld, init, 0, device="cpu", **kw)
    return out


@pytest.mark.parametrize("traj", ["fixed", "chees"])
def test_model_path_matches_jax_moments(runs, traj):
    j, t = runs["jax", traj], runs["port", traj]
    jm, js, jp = _summary(j.samples)
    tm, ts, tp = _summary(t.samples)
    np.testing.assert_allclose(tm, jm, atol=0.05)
    np.testing.assert_allclose(ts, js, rtol=0.15)
    assert tp == pytest.approx(jp, rel=0.1)
    target = (0.45, 0.9) if traj == "chees" else (0.6, 0.95)
    assert target[0] < float(t.accept_rate) < target[1]
    assert abs(float(t.accept_rate) - float(j.accept_rate)) < 0.1
    np.testing.assert_allclose(t.step_size.numpy().mean(), np.asarray(j.step_size).mean(),
                               rtol=0.3)


@pytest.mark.parametrize("traj", ["fixed", "chees"])
def test_result_layout_matches_jax(runs, traj):
    """FusedModelResult carries the JAX fields, shapes and pack order
    (sorted names), field by field."""
    j, t = runs["jax", traj], runs["port", traj]
    assert FusedModelResult._fields == type(j)._fields
    for field in FusedModelResult._fields:
        a, b = getattr(j, field), getattr(t, field)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                assert tuple(np.shape(a[k])) == tuple(b[k].shape)
        elif a is None:
            assert b is None
        else:
            assert tuple(np.shape(a)) == tuple(b.shape)
    if traj == "chees":
        T, eps = t.trajectory_length.numpy(), t.step_size.numpy()
        assert np.all(T >= eps * (1 - 1e-6)) and np.all(T <= 32 * eps * (1 + 1e-6))
        assert np.ptp(T[:BC]) == 0.0


def test_collect_thin_search_and_determinism(data):
    xs, ys, init = data
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    kw = dict(num_warmup=60, num_samples=60, block_chains=BC, warmup="fused", device="cpu")
    a = fused_model_hmc(tld, init, 5, thin=3, **kw)
    b = fused_model_hmc(tld, init, torch.Generator().manual_seed(5), thin=3, **kw)
    assert a.samples["coefficients"].shape == (20, C, 4)
    assert torch.equal(a.samples["coefficients"], b.samples["coefficients"])
    m = fused_model_hmc(tld, init, 5, collect="moments", **kw)
    assert m.samples is None and m.mean["coefficients"].shape == (C, 4)
    assert m.variance["precision"].shape == (C,)
    s = fused_model_hmc(tld, init, 5, initial_step_size=None, **kw)
    assert torch.isfinite(s.samples["coefficients"]).all() and bool((s.step_size > 0).all())


def test_device_density_and_callable_on_cpu():
    """A device density runs as it is; any callable runs on the CPU through
    torch.func; both sample the same Gaussian."""
    scales = torch.tensor([0.5, 1.0, 2.0])
    g = DiagGaussianDensity(torch.tensor([1.0, -1.0, 0.0]), scales)
    init = {"x": torch.zeros((32, 3))}
    kw = dict(num_warmup=100, num_samples=100, block_chains=32, warmup="fused", device="cpu")
    for fn in (g, lambda p: -g(p["x"])):
        r = fused_model_hmc(fn, init, 1, **kw)
        x = r.samples["x"][30:].reshape(-1, 3)
        np.testing.assert_allclose(x.mean(0).numpy(), [1.0, -1.0, 0.0], atol=0.25)
        np.testing.assert_allclose(x.std(0).numpy(), scales.numpy(), rtol=0.25)


def test_plain_callable_raises_on_the_card(data, monkeypatch):
    """On the card a log density the density compiler refuses (here one
    that branches on a traced value) raises before anything runs, with the
    compiler's reason; it is not run on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    xs, ys, init = data
    post = make_posterior(xs, ys)

    def branching(p):
        lp = post.log_prob(p)
        return lp if p["precision"] > 0 else -lp

    with pytest.raises(NotImplementedError,
                       match="not tile-compilable: data-dependent control flow"):
        fused_model_hmc(branching, init, 0, warmup="fused")


@pytest.mark.parametrize("kw, error, match", [
    (dict(warmup="xla", mesh="world of one"), None, None),
    (dict(warmup="dense", per_chain_step_size=True), ValueError, "per_chain_step_size"),
    (dict(warmup="dense", trajectory="chees"), ValueError, "trajectory='fixed'"),
    (dict(warmup="fused", mesh="world of one"), None, None),
    (dict(warmup="bogus"), ValueError, "warmup"),
    (dict(warmup="fused", per_chain_step_size=True), ValueError, "per_chain_step_size"),
    (dict(warmup="fused", trajectory="bogus"), ValueError, "trajectory"),
    (dict(warmup="fused", collect="bogus"), ValueError, "collect"),
    (dict(warmup="fused", num_samples=100, thin=3), ValueError, "thin"),
], ids=["xla", "dense", "dense_chees", "mesh", "bogus_warmup", "per_chain", "trajectory", "collect", "thin"])
def test_options_not_ported_raise(data, kw, error, match):
    """The refused options raise; ``mesh=`` (which raised until the mesh
    was ported) runs, in a group of one the same kernels on the same
    chains with the same seeds as without it, and gives the same bits but
    where the eager warmup's pooled sums round in another order."""
    xs, ys, init = data
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    if error is not None:
        with pytest.raises(error, match=match):
            fused_model_hmc(tld, init, 0, device="cpu", **kw)
        return
    from torch_ranks import world_of_one

    from binf_tpu_torch.parallel.mesh import gather_chains

    kw = dict(kw, num_warmup=6, num_samples=10)
    ref = fused_model_hmc(tld, init, 0, device="cpu", **dict(kw, mesh=None))
    with world_of_one() as mesh:
        res = gather_chains(fused_model_hmc(tld, init, 0, device="cpu", **dict(kw, mesh=mesh)))
    tol = dict(rtol=0, atol=0) if kw["warmup"] == "fused" else dict(rtol=1e-4, atol=1e-4)
    for k in ref.samples:
        np.testing.assert_allclose(res.samples[k].numpy(), ref.samples[k].numpy(), **tol)
    np.testing.assert_allclose(res.step_size.numpy(), ref.step_size.numpy(), **tol)


@pytest.mark.parametrize("n_chains, expected", [(64, 64), (1000, 1000), (16384, 16384),
                                                (135168, 12288), (1 << 20, 16384)])
def test_auto_block_chains_rule(n_chains, expected):
    bc = auto_block_chains(n_chains)
    assert bc == expected and n_chains % bc == 0


def test_jax_warmup_state_continues_in_the_port(data, runs):
    """The JAX package's ChEES warmup output (q, eps, im, T), as numpy, is
    the port's K4 input: the continued run samples the same posterior."""
    xs, ys, init = data
    jpost = jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys))
    jld = jax_transform(jpost.log_prob, {"precision": JLogTransform})
    template = {"coefficients": jnp.zeros(4), "precision": jnp.zeros(())}
    potential, consts, _ = tile_potential_from_scalar(jld, template)
    q0 = np.concatenate([init["coefficients"], init["precision"][:, None]], axis=1)
    q, eps, im, T = (np.asarray(a) for a in jax_warmup(
        potential, jnp.asarray(q0), 3, 0.1, consts, num_warmup=N_WARMUP, block_chains=BC,
        interpret=True, host_noise=True, trajectory="chees", max_leapfrog=32,
        target_accept=0.651))
    density = device_density(
        transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform}),
        {"coefficients": torch.zeros(4), "precision": torch.zeros(())})
    res = fused_potential_hmc_run(density, q, 4, eps, im, num_steps=N_SAMPLES, block_chains=BC,
                                  trajectory="chees", traj_length=T, max_leapfrog=32,
                                  device="cpu")
    assert 0.45 < float(res.accept_rate) < 0.95
    draws = res.draws.numpy()
    got = {"coefficients": draws[..., :4], "precision": draws[..., 4]}
    (gm, gs, gp), (rm, rs, rp) = _summary(got), _summary(runs["jax", "chees"].samples)
    np.testing.assert_allclose(gm, rm, atol=0.05)
    np.testing.assert_allclose(gs, rs, rtol=0.15)
    assert gp == pytest.approx(rp, rel=0.1)
