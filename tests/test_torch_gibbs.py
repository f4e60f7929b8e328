"""The eager sampler contract and the Gibbs machinery against the JAX
package: ``samplers/{base,hmc,rwm,gibbs,conjugate}.py``,
``parallel/runner.py`` and the polynomial Gibbs kernels.

Deterministic pieces (leapfrog, kinetic energy, conditional densities, the
conjugate Gaussian draw given its normals) agree step for step at float32
tolerance; the random ones (Gamma block, RWM, HMC, collapsed Gibbs) agree by
moments, since a ``torch.Generator`` and a JAX key give different numbers.
Also here: the two repaired port faults (``make_priors`` on the card by
default, the Gamma draw on its concentration's device).
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.core.density import VariableSpec as JVariableSpec
from binf_tpu.example import polynomial as jpoly
from binf_tpu.model import GaussianErrorModel as JGaussianErrorModel
from binf_tpu.model import PolynomialForwardModel as JPolynomialForwardModel
from binf_tpu.parallel import runner as jrunner
from binf_tpu.pdf import FunctionPrior as JFunctionPrior
from binf_tpu.pdf import GammaPrior as JGammaPrior
from binf_tpu.pdf import Likelihood as JLikelihood
from binf_tpu.pdf import Posterior as JPosterior
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as jtransform
from binf_tpu_torch.core.density import VariableSpec
from binf_tpu_torch.example import polynomial as tpoly
from binf_tpu_torch.model import GaussianErrorModel, PolynomialForwardModel
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.pdf import FunctionPrior, GammaPrior, Likelihood, Posterior
from binf_tpu_torch.pdf import distributions as dist
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import conjugate, gibbs, hmc, rwm
from binf_tpu_torch.samplers.base import run_kernel, sample_chain

# binf_tpu.samplers re-exports functions under these modules' names
jconj, jgibbs, jhmc, jrwm = (importlib.import_module(f"binf_tpu.samplers.{m}")
                             for m in ("conjugate", "gibbs", "hmc", "rwm"))

RHO = 0.5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    xses = np.linspace(-2, 2, 20).astype(np.float32)
    V = np.vander(xses, 4, increasing=True)
    ys = (V @ np.array([2.0, -4.0, 1.0, 1.5]) + rng.normal(size=20) / np.sqrt(2.5))
    return xses, ys.astype(np.float32)


@pytest.fixture(scope="module")
def posteriors(data):
    xses, ys = data
    return (jpoly.make_posterior(jnp.asarray(xses), jnp.asarray(ys)),
            tpoly.make_posterior(xses, ys))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


POS = {"coefficients": np.array([1.9, -3.8, 1.1, 1.4], np.float32),
       "precision": np.float32(0.8)}
IM = {"coefficients": np.array([0.05, 0.1, 0.02, 0.02], np.float32),
      "precision": np.float32(0.1)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_leapfrog_matches_jax(posteriors):
    """Ten leapfrog steps on the unconstrained polynomial posterior from the
    same position, momentum and step size: positions and momenta within
    1e-4 (gradients of magnitude up to ~1e3 in float32), log density within
    1e-5 relative."""
    jpost, tpost = posteriors
    jld = jtransform(jpost.log_prob, {"precision": JLogTransform})
    tld = transform_logdensity(tpost.log_prob, {"precision": LogTransform})
    mom = {"coefficients": np.array([0.3, -0.2, 0.1, 0.5], np.float32),
           "precision": np.float32(-0.4)}
    jvg = jax.value_and_grad(jld)
    _, jg0 = jvg(_j(POS))
    jq, jp, jl, jgr = jhmc.leapfrog(jvg, _j(POS), _j(mom), jg0, 0.01, 10, _j(IM))
    tvg = hmc.value_and_grad(tld)
    tl0, tg0 = tvg(_t(POS))
    for k in POS:
        np.testing.assert_allclose(_np(tg0[k]), np.asarray(jg0[k]), rtol=1e-5, atol=1e-3)
    tq, tp, tl, tgr = hmc.leapfrog(tvg, _t(POS), _t(mom), tg0, 0.01, 10, _t(IM))
    for k in POS:
        np.testing.assert_allclose(_np(tq[k]), np.asarray(jq[k]), atol=1e-4)
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-4)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("im", [None, IM])
def test_kinetic_energy_and_velocity_match_jax(im):
    mom = {"coefficients": np.array([0.3, -0.2, 0.1, 0.5], np.float32),
           "precision": np.float32(-0.4)}
    jim = None if im is None else _j(im)
    tim = None if im is None else _t(im)
    assert float(hmc.kinetic_energy(_t(mom), tim)) == pytest.approx(
        float(jhmc.kinetic_energy(_j(mom), jim)), rel=1e-6)
    tv, jv = hmc.metric_velocity(_t(mom), tim), jhmc.metric_velocity(_j(mom), jim)
    for k in mom:
        np.testing.assert_allclose(_np(tv[k]), np.asarray(jv[k]), rtol=1e-6)


def test_kinetic_energy_per_chain():
    """A chain-batched momentum gives one kinetic energy per chain."""
    mom = {"a": torch.tensor([[1.0, 2.0], [3.0, 4.0]]), "b": torch.tensor([1.0, 0.5])}
    ke = hmc.kinetic_energy(mom, {"a": torch.tensor([1.0, 0.5]), "b": torch.tensor(2.0)}, 1)
    np.testing.assert_allclose(ke.numpy(), [0.5 * (1 + 2 + 2), 0.5 * (9 + 8 + 0.5)])


@pytest.mark.parametrize("block", ["coefficients", "precision"])
def test_conditional_fn_matches_jax(posteriors, block):
    jpost, tpost = posteriors
    others = [k for k in POS if k != block]
    jf = jgibbs._conditional_fn(jpost, {k: jnp.asarray(POS[k]) for k in others})
    tf = gibbs._conditional_fn(tpost, {k: torch.tensor(POS[k]) for k in others})
    x = {block: POS[block]}
    assert float(tf(_t(x))) == pytest.approx(float(jf(_j(x))), rel=1e-6)
    jg = jax.grad(jf)(_j(x))[block]
    tg = torch.func.grad(tf)(_t(x))[block]
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-5, atol=1e-3)


def test_conditional_fn_over_chains(posteriors):
    """Vmapped over a chain axis, the conditional of each chain is the
    single-chain conditional at that chain's values."""
    _, tpost = posteriors
    g = torch.Generator().manual_seed(0)
    coeffs = torch.tensor(POS["coefficients"]) + 0.1 * torch.randn((5, 4), generator=g)
    prec = 0.5 + torch.rand(5, generator=g)
    batched = gibbs._conditional_fn(tpost, {"precision": prec}, 1)({"coefficients": coeffs})
    single = [gibbs._conditional_fn(tpost, {"precision": prec[i]})({"coefficients": coeffs[i]})
              for i in range(5)]
    np.testing.assert_allclose(batched.numpy(), torch.stack(single).numpy(), rtol=1e-6)


def test_gaussian_linear_block_given_the_same_z(posteriors, data):
    """The JAX block draws its normals from its key; the same normals make
    the port's draw equal within float32 rounding of the Cholesky solves."""
    jpost, tpost = posteriors
    key = jax.random.key(5)
    jblock = jconj.gaussian_linear_block(jpost)
    jdraw = jblock(key, _j(POS))[0]["coefficients"]
    z = np.asarray(jax.random.normal(key, (4,), jnp.float32))
    lik = tpost.likelihoods["points"]
    prior = tpost.priors["coefficients_prior"]
    tdraw = conjugate.gaussian_linear_draw(
        torch.tensor(POS["precision"]), lik.forward_model.vandermonde, lik.error_model.data,
        prior.means, 1.0 / prior.variances, torch.tensor(z))
    np.testing.assert_allclose(tdraw.numpy(), np.asarray(jdraw), rtol=1e-4, atol=1e-4)
    # the block itself, over a chain axis: shapes and the always-accept info
    pos = {"coefficients": torch.zeros((7, 4)), "precision": torch.ones(7)}
    new, info = conjugate.gaussian_linear_block(tpost)(torch.Generator().manual_seed(0), pos)
    assert new["coefficients"].shape == (7, 4) and bool(info.accepted.all())


def _zero_model(data, lib):
    n = data.shape[0]
    fwm = (JPolynomialForwardModel if lib == "jax" else PolynomialForwardModel).create(
        jnp.zeros(n) if lib == "jax" else torch.zeros(n), 1)
    em = (JGaussianErrorModel if lib == "jax" else GaussianErrorModel).create(data)
    lik = (JLikelihood if lib == "jax" else Likelihood).create("pts", fwm, em)
    prior = (JGammaPrior if lib == "jax" else GammaPrior).create(2.0, 1.0, variable="precision")
    return (JPosterior if lib == "jax" else Posterior).create({"pts": lik}, {"p": prior})


def test_gamma_precision_block_shape_convention():
    """Shape alpha + n/2: moments of 4,000 draws, each chain of a batch, on
    a known-mean normal model, against the analytic Gamma posterior (mean
    within 5%, variance within 15%) and against the JAX block's draws
    (means within 5%)."""
    rng = np.random.default_rng(0)
    data = (rng.normal(size=50) / 2.0).astype(np.float32)
    tpost = _zero_model(torch.tensor(data), "torch")
    block = conjugate.gamma_precision_block(tpost, "precision")
    pos = {"coefficients": torch.zeros((4000, 1)), "precision": torch.ones(4000)}
    new, info = block(torch.Generator().manual_seed(1), pos)
    draws = new["precision"].double().numpy()
    a, b = 2.0 + 25.0, 1.0 + float((data.astype(np.float64) ** 2).sum()) / 2.0
    np.testing.assert_allclose(draws.mean(), a / b, rtol=0.05)
    np.testing.assert_allclose(draws.var(), a / b ** 2, rtol=0.15)
    assert bool(info.accepted.all())
    jpost = _zero_model(jnp.asarray(data), "jax")
    jblock = jconj.gamma_precision_block(jpost, "precision")
    jpos = {"coefficients": jnp.zeros(1), "precision": jnp.ones(())}
    jdraws = jax.vmap(lambda k: jblock(k, jpos)[0]["precision"])(
        jax.random.split(jax.random.key(1), 4000))
    np.testing.assert_allclose(draws.mean(), float(jdraws.mean()), rtol=0.05)


def _corr_posterior(lib):
    def logp(values):
        x, y = values["x"], values["y"]
        return -(x ** 2 - 2 * RHO * x * y + y ** 2) / (2 * (1 - RHO ** 2))

    if lib == "jax":
        prior = JFunctionPrior.create(logp, (JVariableSpec("x"), JVariableSpec("y")),
                                      name="corr")
        return JPosterior.create({}, {"corr": prior})
    prior = FunctionPrior.create(logp, (VariableSpec("x"), VariableSpec("y")), name="corr")
    return Posterior.create({}, {"corr": prior})


def _moments(x, y):
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    return np.array([x.mean(), y.mean(), x.std(), y.std(), np.corrcoef(x, y)[0, 1]])


def test_mh_blocks_match_jax_by_moments():
    """Gibbs over a correlated 2-D Gaussian with two scalar MH blocks (256
    chains, 600 sweeps, 300 burned): means within 0.1 of 0, sd within 0.1
    of 1, correlation within 0.1 of 0.5, for the port and the JAX package
    alike, and within 0.1 of each other."""
    n, steps = 256, 600
    tk = gibbs.gibbs({"x": gibbs.mh_block(_corr_posterior("torch"), "x", 1.5),
                      "y": gibbs.mh_block(_corr_posterior("torch"), "y", 1.5)})
    _, ts = run_chains(tk, torch.Generator().manual_seed(0),
                       init_chains(tk, {"x": torch.zeros(n), "y": torch.zeros(n)}), steps)
    jpost = _corr_posterior("jax")
    jk = jgibbs.gibbs({"x": jgibbs.mh_block(jpost, "x", 1.5),
                       "y": jgibbs.mh_block(jpost, "y", 1.5)})
    states = jrunner.init_chains(jk, {"x": jnp.zeros(n), "y": jnp.zeros(n)})
    _, js = jax.jit(lambda s, k: jrunner.run_chains(jk, k, s, steps))(states,
                                                                        jax.random.key(0))
    expect = np.array([0.0, 0.0, 1.0, 1.0, RHO])
    tm = _moments(ts["x"][300:], ts["y"][300:])
    jm = _moments(js["x"][300:], js["y"][300:])
    np.testing.assert_allclose(tm, expect, atol=0.1)
    np.testing.assert_allclose(jm, expect, atol=0.1)
    np.testing.assert_allclose(tm, jm, atol=0.1)


def _corr_logdensity(pos):
    x, y = pos["x"], pos["y"]
    return -(x ** 2 - 2 * RHO * x * y + y ** 2) / (2 * (1 - RHO ** 2))


@pytest.mark.parametrize("kind", ["hmc", "rwm"])
def test_kernels_match_jax_by_moments(kind):
    """A kernel over 512 chains of the correlated Gaussian (the port steps a
    chain-batched log density; JAX vmaps a single-chain one), 400 steps
    with 100 burned: moments within 0.1 of the truth and of each other."""
    n, steps = 512, 400
    if kind == "hmc":
        tk = hmc.hmc(_corr_logdensity, step_size=0.3, num_integration_steps=5, jitter=0.2)
        jk = jhmc.hmc(_corr_logdensity, step_size=0.3, num_integration_steps=5, jitter=0.2)
    else:
        tk = rwm.rwm(_corr_logdensity, 1.0, proposal="normal")
        jk = jrwm.rwm(_corr_logdensity, 1.0, proposal="normal")
    g = torch.Generator().manual_seed(3)
    start = {"x": torch.randn(n, generator=g), "y": torch.randn(n, generator=g)}
    _, ts = run_chains(tk, g, init_chains(tk, start), steps)
    jstart = {k: jnp.asarray(v.numpy()) for k, v in start.items()}
    _, js = jax.jit(lambda s, k: jrunner.run_chains(jk, k, s, steps))(
        jrunner.init_chains(jk, jstart), jax.random.key(3))
    expect = np.array([0.0, 0.0, 1.0, 1.0, RHO])
    tm = _moments(ts["x"][100:], ts["y"][100:])
    jm = _moments(js["x"][100:], js["y"][100:])
    np.testing.assert_allclose(tm, expect, atol=0.1)
    np.testing.assert_allclose(jm, expect, atol=0.1)
    np.testing.assert_allclose(tm, jm, atol=0.1)


def test_hmc_divergence_guard():
    """A step size far past the stability limit: |dE| > 1000 is marked
    divergent and never accepted; a NaN energy error counts as +inf."""
    k = hmc.hmc(lambda p: -0.5 * (p["x"] ** 2).sum(-1), step_size=50.0,
                num_integration_steps=3)
    st = k.init({"x": torch.ones((64, 2))})
    new, info = k.step(torch.Generator().manual_seed(0), st)
    assert bool(info.is_divergent.all()) and not bool(info.accepted.any())
    assert torch.equal(new.position["x"], st.position["x"])
    nan = hmc.hmc(lambda p: torch.where(p["x"].abs() > 1.5, torch.nan, -p["x"] ** 2).sum(),
                  step_size=1.0, num_integration_steps=2)
    _, info = nan.step(torch.Generator().manual_seed(0), nan.init({"x": torch.ones(1)}))
    assert float(info.energy_error) == float("inf") and not bool(info.accepted)


def test_collapsed_gibbs_matches_jax_and_exact(posteriors, data):
    """``make_collapsed_gibbs_kernel`` through ``init_chains`` and
    ``run_chains`` (128 chains, 400 sweeps, 100 burned): the coefficient
    mean within 0.05 of the exact conditional mean at the mean precision,
    the precision within 5% of its Gamma self-consistency point, and the
    moments within the tolerances of ``tests/test_fused_gibbs.py:90-93`` of
    the JAX package's own run."""
    jpost, tpost = posteriors
    xses, ys = data
    kernel = tpoly.make_collapsed_gibbs_kernel(tpost)
    states = init_chains(kernel, tpoly.initial_positions(128, device="cpu"))
    _, ts = run_chains(kernel, torch.Generator().manual_seed(7), states, 400)
    tc = ts["coefficients"][100:].double().reshape(-1, 4).numpy()
    tp = ts["precision"][100:].double().reshape(-1).numpy()
    V = np.vander(xses, 4, increasing=True).astype(np.float64)
    cov = np.linalg.inv(tp.mean() * V.T @ V + np.eye(4) / 5.0)
    np.testing.assert_allclose(tc.mean(0), cov @ (tp.mean() * V.T @ ys), atol=0.05)
    ss = ((ys[:, None] - V @ tc.T) ** 2).sum(0)
    np.testing.assert_allclose(tp.mean(), np.mean(11.0 / (0.2 + ss / 2.0)), rtol=0.05)
    jk = jpoly.make_collapsed_gibbs_kernel(jpost)
    jstates = jrunner.init_chains(jk, jpoly.initial_positions(128))
    _, js = jax.jit(lambda s, k: jrunner.run_chains(jk, k, s, 400))(jstates,
                                                                      jax.random.key(7))
    jc = np.asarray(js["coefficients"][100:]).reshape(-1, 4)
    jp = np.asarray(js["precision"][100:]).reshape(-1)
    np.testing.assert_allclose(tc.mean(0), jc.mean(0), atol=0.06)
    np.testing.assert_allclose(tc.std(0), jc.std(0), rtol=0.15)
    np.testing.assert_allclose(tp.mean(), jp.mean(), rtol=0.06)
    np.testing.assert_allclose(tp.std(), jp.std(), rtol=0.25)


@pytest.mark.parametrize("sampler", ["rwm", "hmc"])
def test_reference_gibbs_kernel_sweeps(posteriors, sampler):
    """``make_gibbs_kernel``: one sweep of [coefficients, precision] over a
    chain batch; the conjugate block always accepts."""
    _, tpost = posteriors
    kernel = tpoly.make_gibbs_kernel(tpost, rwmc_stepsize=0.02, coefficients_sampler=sampler)
    state = kernel.init(tpoly.initial_positions(16, device="cpu"))
    state, infos = kernel.step(torch.Generator().manual_seed(0), state)
    assert set(infos) == {"coefficients", "precision"}
    assert state.position["coefficients"].shape == (16, 4)
    assert bool(infos["precision"].accepted.all())
    assert bool(torch.isfinite(state.position["precision"]).all())
    with pytest.raises(ValueError):
        tpoly.make_gibbs_kernel(tpost, coefficients_sampler="nuts")


def test_run_chains_thin_and_collect(posteriors):
    """``thin`` keeps every thin-th sweep of the same run, bit for bit;
    ``collect`` picks what is stored; ``sample_chain`` is init + run."""
    _, tpost = posteriors
    kernel = tpoly.make_collapsed_gibbs_kernel(tpost)
    start = tpoly.initial_positions(8, device="cpu")
    f1, all_ = run_chains(kernel, torch.Generator().manual_seed(2), init_chains(kernel, start), 12)
    f3, thin = run_chains(kernel, torch.Generator().manual_seed(2), init_chains(kernel, start),
                          12, thin=3)
    assert thin["coefficients"].shape == (4, 8, 4)
    for k in ("coefficients", "precision"):
        assert torch.equal(thin[k], all_[k][2::3])
        assert torch.equal(f1.position[k], f3.position[k])
    _, infos = run_kernel(kernel, torch.Generator().manual_seed(2), init_chains(kernel, start),
                          4, collect=lambda s, info: info)
    acc = infos["precision"].accepted  # the blocks' info tuples, stacked leaf by leaf
    assert acc.shape == (4, 8) and bool(acc.all())
    _, same = sample_chain(kernel, torch.Generator().manual_seed(2), start, 12)
    assert torch.equal(same["precision"], all_["precision"])
    with pytest.raises(ValueError):
        run_chains(kernel, torch.Generator(), init_chains(kernel, start), 10, thin=3)


def test_not_ported_yet_raise(posteriors):
    _, tpost = posteriors
    # the MALA and NUTS blocks are ported: they build and step a chain batch
    start = tpoly.initial_positions(4, device="cpu")
    for block in (gibbs.mala_block(tpost, "coefficients", 0.05),
                  gibbs.nuts_block(tpost, "coefficients", 0.05, max_doublings=3)):
        new, info = block(torch.Generator().manual_seed(0), start)
        assert new["coefficients"].shape == (4, 4) and torch.equal(new["precision"],
                                                                    start["precision"])
        assert info.acceptance_prob.shape == (4,)
    # a mesh shards the chains (a group of one here; 4 ranks in
    # test_torch_mesh_runner.py): the same sweeps as without it
    from torch_ranks import world_of_one

    from binf_tpu_torch.parallel.mesh import gather_chains

    kernel = tpoly.make_collapsed_gibbs_kernel(tpost)
    start = tpoly.initial_positions(4, device="cpu")
    _, ref = run_chains(kernel, torch.Generator().manual_seed(1), init_chains(kernel, start), 2)
    with world_of_one() as mesh:
        states = init_chains(kernel, start, mesh=mesh)
        _, draws = run_chains(kernel, torch.Generator().manual_seed(1), states, 2, mesh=mesh)
        draws = gather_chains(draws)
    for k in ref:
        assert torch.equal(draws[k], ref[k])


# -- the two repaired port faults ----------------------------------------------------


def test_make_priors_default_to_the_card(monkeypatch):
    """Without ``device`` the priors are built on the card: with no card
    present ``make_priors()`` raises instead of building them on the CPU,
    and ``device="cpu"`` builds them there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpoly.make_priors()
    priors = tpoly.make_priors(device="cpu")
    assert priors["precision_prior"].shape_param.device.type == "cpu"


def test_gamma_draw_stays_on_its_concentrations_device():
    """The Gamma draw happens on alpha's device: a generator of another
    device raises instead of moving the draw to the generator's device."""
    alpha = torch.full((3,), 11.0)
    other = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cannot draw on cpu"):
        dist._standard_gamma(other, alpha)
    with pytest.raises(ValueError, match="cannot draw on cpu"):
        dist.gamma_sample(other, alpha, 2.0)
    draw = dist.gamma_sample(torch.Generator().manual_seed(0), alpha, 2.0)
    assert draw.device == alpha.device and draw.shape == (3,)
    # a Python concentration lies on the generator's device
    assert dist.gamma_sample(torch.Generator().manual_seed(0), 3.0, shape=(5,)).shape == (5,)
