"""K7's counterpart and the chain-grid route: the Gram chromatin density
against the JAX package's, the plain ``chain_grid_hmc_run`` against the JAX
interpret-mode kernel draw for draw, and ``chain_grid_model_hmc`` on the
CPU.

Both sides of a step-for-step comparison get the same host noise: the test
rebuilds the JAX kernel's ``jax.random`` stream (``chain_grid.py:536-547``)
and hands it to the port through ``noise=``.  The two float32 trajectories
then part only by rounding; the seed is chosen so that no MH decision lies
within 1e-3 of its threshold (asserted), and the draws are held to 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.chromatin import make_gram_logdensity as jax_gram
from binf_tpu.example.chromatin import synthetic_restraints as jax_restraints
from binf_tpu.ops.pallas.chain_grid import chain_grid_hmc_run as jax_run
from binf_tpu.ops.pallas.chain_grid import chain_grid_potential_from_scalar as jax_potential
from binf_tpu_torch.example.chromatin import GramChromatinDensity, make_gram_logdensity
from binf_tpu_torch.ops.kernels.chain_grid import (
    ScalarPotential,
    chain_grid_hmc_plain,
    chain_grid_hmc_run,
    chain_grid_potential_from_scalar,
    group_value_and_grad,
)
from binf_tpu_torch.samplers.chain_grid import chain_grid_model_hmc

C = 8
N = 8
STEPS = 10
LEAP = 5


def _problem(n, seed=0, observe=0.5):
    X, logD, W = jax_restraints(jax.random.key(seed), n, observe_frac=observe, noise_prec=25.0)
    return np.asarray(X), np.asarray(logD), np.asarray(W)


@pytest.fixture(scope="module")
def chrom():
    X, logD, W = _problem(N)
    rng = np.random.default_rng(3)
    q0 = {"structure": (X[None] + 0.1 * rng.normal(size=(C, N, 3))).astype(np.float32),
          "precision": np.full(C, np.log(20.0), np.float32)}
    im = {"structure": np.full((N, 3), 0.5, np.float32), "precision": np.float32(0.3)}
    return dict(X=X, logD=logD, W=W, q0=q0, im=im,
                gram=make_gram_logdensity(logD, W, device="cpu"))


def _jax_noise(seed, steps, shapes):
    kn = jax.random.key(jnp.asarray(seed, jnp.uint32))
    keys = jax.random.split(kn, len(shapes) + 1)
    mom = [np.asarray(jax.random.normal(keys[v], (steps, C) + s, jnp.float32))
           for v, s in enumerate(shapes)]
    return mom, np.asarray(jax.random.uniform(keys[-1], (steps, C, 1), jnp.float32))


@pytest.mark.parametrize("n, batch, symmetric", [(8, None, True), (16, None, False),
                                                 (8, 5, False), (16, 3, True)],
                         ids=["8", "16_nonsym", "8_batch", "16_batch"])
def test_gram_density_matches_jax(n, batch, symmetric):
    """Value and gradient of the Gram density against ``jax.value_and_grad``
    of the JAX package's, one chain and a batch; a non-symmetric W and logD
    included (every ordered pair counts; the diagonal stays zero, as the
    self-pair's gradient in the Gram form is rounding of a 1/d2 ~ 1e12
    term that cancels in exact arithmetic).  The port's gradient is the
    closed form its kernel computes, JAX's the autodiff of the Gram form:
    they agree to 1e-4 of the largest component (float32 sums of up to N^2
    terms in other orders)."""
    _, logD, W = _problem(n, seed=n)
    rng = np.random.default_rng(n)
    if not symmetric:
        W = ((rng.random((n, n)) < 0.5) * (1 - np.eye(n))).astype(np.float32)
        logD = (logD + 0.2 * rng.normal(size=(n, n))).astype(np.float32)
    shape = () if batch is None else (batch,)
    X = (2.0 * rng.normal(size=shape + (n, 3))).astype(np.float32)
    u = rng.normal(size=shape).astype(np.float32) * 0.5 + 1.0
    jfn = jax_gram(jnp.asarray(logD), jnp.asarray(W))
    vg = jax.value_and_grad(lambda p: -jfn(p))
    if batch is not None:
        vg = jax.vmap(vg)
    jU, jg = vg({"structure": jnp.asarray(X), "precision": jnp.asarray(u)})
    gram = make_gram_logdensity(logD, W, device="cpu")
    pos = {"structure": torch.tensor(X), "precision": torch.tensor(u)}
    U, g = gram.potential_and_grad(pos)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=1e-5)
    np.testing.assert_allclose(-gram(pos).numpy(), np.asarray(jU), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg["structure"])).max())
    np.testing.assert_allclose(g["structure"].numpy(), np.asarray(jg["structure"]),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(g["precision"].numpy(), np.asarray(jg["precision"]), rtol=1e-4,
                               atol=1e-3)


def test_gram_functor_entry_on_the_cpu(chrom):
    """The functor's batch entry runs the plain version for a tensor on the
    CPU, on flat positions (log precision first)."""
    gram = chrom["gram"]
    q = {k: torch.tensor(v) for k, v in chrom["q0"].items()}
    flat = torch.cat([q["precision"][:, None], q["structure"].reshape(C, -1)], 1)
    U, g = group_value_and_grad(gram, flat)
    U_ref, g_ref = gram.potential_and_grad(q)
    assert torch.equal(U, U_ref)
    assert torch.equal(g[:, 1:].reshape(C, N, 3), g_ref["structure"])
    assert torch.equal(g[:, 0], g_ref["precision"])


@pytest.mark.parametrize("collect", ["draws", "moments"])
def test_plain_run_matches_jax_interpret(chrom, collect):
    seed = 2
    jpot, jconsts, _ = jax_potential(
        jax_gram(jnp.asarray(chrom["logD"]), jnp.asarray(chrom["W"])),
        {"structure": jnp.zeros((N, 3)), "precision": jnp.zeros(())})
    eps = np.linspace(0.04, 0.08, C).astype(np.float32)
    jq0 = {k: jnp.asarray(v) for k, v in chrom["q0"].items()}
    jim = {k: jnp.asarray(v) for k, v in chrom["im"].items()}
    jr = jax_run(jpot, jq0, seed, jnp.asarray(eps), jim, jconsts, num_steps=STEPS,
                 num_leapfrog=LEAP, block_chains=C, steps_per_block=5, interpret=True,
                 host_noise=True, collect=collect)
    noise = _jax_noise(seed, STEPS, [(1, 1), (N, 3)])
    trace = chain_grid_hmc_plain(chrom["gram"], {k: torch.tensor(v) for k, v in chrom["q0"].items()},
                                 seed, torch.tensor(eps), chrom["im"], num_steps=STEPS,
                                 num_leapfrog=LEAP, collect=collect,
                                 noise=([torch.tensor(m) for m in noise[0]],
                                        torch.tensor(noise[1])))
    assert float(trace.margin.abs().min()) > 1e-3
    got = trace.result
    assert 0.3 < float(got.accept_rate) < 1.0
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    for k in ("structure", "precision"):
        np.testing.assert_allclose(got.final_positions[k].numpy(),
                                   np.asarray(jr.final_positions[k]), atol=2e-4)
        if collect == "draws":
            assert got.draws[k].shape == jr.draws[k].shape
            np.testing.assert_allclose(got.draws[k].numpy(), np.asarray(jr.draws[k]), atol=2e-4)
        else:
            np.testing.assert_allclose(got.mean[k].numpy(), np.asarray(jr.mean[k]), atol=2e-4)
            np.testing.assert_allclose(got.variance[k].numpy(), np.asarray(jr.variance[k]),
                                       rtol=1e-2, atol=1e-7)
    # the run wrapper on the CPU is the plain version
    again = chain_grid_hmc_run(chrom["gram"], chrom["q0"], seed, eps, chrom["im"], {},
                               num_steps=STEPS, num_leapfrog=LEAP, block_chains=C,
                               steps_per_block=5, collect=collect, noise=noise, device="cpu")
    assert torch.equal(again.final_positions["structure"], got.final_positions["structure"])


def test_moments_match_draws_and_thin(chrom):
    """Welford moments equal the same run's draw moments to float32
    accuracy; thin keeps every thin-th state of the same run."""
    kw = dict(num_steps=20, num_leapfrog=LEAP, block_chains=4, steps_per_block=10,
              device="cpu")
    args = (chrom["gram"], chrom["q0"], 5, 0.006, chrom["im"], {})
    rd = chain_grid_hmc_run(*args, **kw)
    rm = chain_grid_hmc_run(*args, collect="moments", **kw)
    rt = chain_grid_hmc_run(*args, thin=2, **kw)
    for k in ("structure", "precision"):
        torch.testing.assert_close(rm.mean[k], rd.draws[k].mean(0), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rm.variance[k], rd.draws[k].var(0), rtol=1e-3, atol=1e-8)
        assert torch.equal(rm.final_positions[k], rd.final_positions[k])
        assert torch.equal(rt.draws[k], rd.draws[k][1::2])
    assert rd.draws["precision"].shape == (20, C) and rd.draws["structure"].shape == (20, C, N, 3)


def test_host_noise_is_a_seeded_generator_stream(chrom):
    """``host_noise=True`` stages the JAX layout's noise from a generator
    seeded with ``seed``: the same run as that noise passed in."""
    kw = dict(num_steps=10, num_leapfrog=LEAP, block_chains=C, steps_per_block=5, device="cpu")
    g = torch.Generator().manual_seed(6)
    noise = ([torch.randn((10, C, 1, 1), generator=g), torch.randn((10, C, N, 3), generator=g)],
             torch.rand((10, C, 1), generator=g))
    a = chain_grid_hmc_run(chrom["gram"], chrom["q0"], 6, 0.006, chrom["im"], {},
                           host_noise=True, **kw)
    b = chain_grid_hmc_run(chrom["gram"], chrom["q0"], 6, 0.006, chrom["im"], {}, noise=noise,
                           **kw)
    assert torch.equal(a.draws["structure"], b.draws["structure"])


def test_resume_is_bitwise_on_philox(chrom):
    """Two chained calls with block_offset advanced replay one call bit for
    bit (Philox indexes the absolute step); another offset does not."""
    kw = dict(num_leapfrog=LEAP, block_chains=C, steps_per_block=5, device="cpu")
    args = (chrom["gram"],)
    one = chain_grid_hmc_run(*args, chrom["q0"], 9, 0.006, chrom["im"], {}, num_steps=20, **kw)
    a = chain_grid_hmc_run(*args, chrom["q0"], 9, 0.006, chrom["im"], {}, num_steps=10, **kw)
    b = chain_grid_hmc_run(*args, a.final_positions, 9, 0.006, chrom["im"], {}, num_steps=10,
                           block_offset=2, **kw)
    c = chain_grid_hmc_run(*args, a.final_positions, 9, 0.006, chrom["im"], {}, num_steps=10,
                           **kw)
    for k in ("structure", "precision"):
        assert torch.equal(torch.cat([a.draws[k], b.draws[k]]), one.draws[k])
    assert not torch.equal(c.final_positions["structure"], one.final_positions["structure"])
    assert 0.3 < float(one.accept_rate) <= 1.0


def test_1d_variable_metric_applied():
    """``tests/test_chain_grid.py:111-136`` on the plain version: with a
    strongly anisotropic 1-D metric, the wide coordinate (scale 10) mixes
    only if its own metric entry is applied."""
    s = torch.tensor([0.1, 10.0, 1.0, 2.0])
    pot, consts, _ = chain_grid_potential_from_scalar(lambda p: -0.5 * torch.sum((p["x"] / s) ** 2),
                                                      {"x": torch.zeros(4)})
    assert isinstance(pot, ScalarPotential) and consts == {}
    res = chain_grid_hmc_run(pot, {"x": torch.zeros((16, 4))}, 5, 0.9, {"x": s ** 2}, consts,
                             num_steps=400, num_leapfrog=5, block_chains=8, steps_per_block=50,
                             device="cpu")
    assert 0.5 < float(res.accept_rate) <= 1.0
    draws = res.draws["x"][200:].reshape(-1, 4)
    np.testing.assert_allclose(draws.std(0).numpy(), s.numpy(), rtol=0.25)


def test_divergence_guard_rejects(chrom):
    res = chain_grid_hmc_run(chrom["gram"], chrom["q0"], 0, 5.0, chrom["im"], {}, num_steps=5,
                             num_leapfrog=LEAP, block_chains=C, steps_per_block=5, device="cpu")
    assert float(res.accept_rate) == 0.0
    assert torch.equal(res.final_positions["structure"], torch.tensor(chrom["q0"]["structure"]))


def test_chain_grid_model_hmc_matches_the_eager_route():
    """``tests/test_chain_grid.py:258-307`` on the port: the adaptive run
    with K7's plain version accepts healthily, recovers the restraint
    precision, and agrees with the eager HMC route on the same density and
    settings (acceptance within 0.15, precision mean within three standard
    errors of 8 chains plus 0.05)."""
    from binf_tpu_torch.parallel.runner import init_chains, run_chains
    from binf_tpu_torch.samplers.hmc import hmc

    n = 16
    X, logD, W = _problem(n, observe=0.5)
    gram = make_gram_logdensity(logD, W, device="cpu")
    rng = np.random.default_rng(3)
    q0 = {"structure": torch.tensor(X[None] + 0.1 * rng.normal(size=(C, n, 3)),
                                    dtype=torch.float32),
          "precision": torch.full((C,), float(np.log(20.0)))}
    res = chain_grid_model_hmc(gram, q0, 4, num_warmup=150, num_samples=200, num_leapfrog=10,
                               initial_step_size=0.008, block_chains=4, device="cpu")
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert res.samples["structure"].shape == (200, C, n, 3)
    assert res.step_size.dim() == 0 and res.inverse_mass.shape == (1 + 3 * n,)
    draws = res.samples["precision"][100:].numpy()
    assert np.all(np.isfinite(res.samples["structure"].numpy()))
    im = {"structure": res.inverse_mass[1:].reshape(n, 3), "precision": res.inverse_mass[0]}
    kernel = hmc(gram, res.step_size, 10, im)
    _, (samples, acc) = run_chains(
        kernel, torch.Generator().manual_seed(5), init_chains(kernel, res.final_positions), 200,
        collect=lambda state, info: (state.position["precision"], info.accepted))
    ref = samples[100:].numpy()
    assert abs(float(acc.float().mean()) - float(res.accept_rate)) < 0.15
    assert abs(ref.mean() - draws.mean()) < 3.0 * (ref.std() + draws.std()) / np.sqrt(8.0) + 0.05


def _cholesky_density(p):
    x = p["x"]
    L = torch.linalg.cholesky(torch.eye(3) + torch.outer(x, x))
    return -torch.sum(torch.diagonal(L) ** 2)


def _data_heavy_density():
    """A logistic regression over 12,000 rows of 5 features: 72,000 constant
    floats, more than a CTA's shared memory holds."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn((12000, 5), generator=g)
    y = (torch.rand(12000, generator=g) < 0.5).float()

    def ld(p):
        s = X @ p["x"]
        return torch.sum(y * s - torch.nn.functional.softplus(s)) - 0.5 * torch.sum(p["x"] ** 2)
    return ld, 5


@pytest.mark.parametrize("case", ["compiled", "data_heavy", "cholesky", "d33"])
def test_card_only_callable_raises_on_the_card(chrom, monkeypatch, case):
    """On the card K7 runs a callable the density compiler lowers: its
    potential reaches the launch of its own unit (``_build`` monkeypatched:
    no card here) with its constants and the run's arguments, whatever the
    size of its constants (the launch stages them in shared memory or reads
    them from device memory, and the record says which).  A callable the
    compiler refuses (an op it has no rule for, a position past MAX_D_WIDE)
    raises NotImplementedError naming the compiler's reason, before
    anything runs."""
    from binf_tpu_torch.ops.kernels import _build
    from binf_tpu_torch.ops.kernels import chain_grid as cg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if case in ("compiled", "data_heavy"):
        fn, D = ((lambda p: -torch.sum(p["x"] ** 2)), 3) if case == "compiled" else \
            _data_heavy_density()
        pot, consts, spec = chain_grid_potential_from_scalar(fn, {"x": torch.zeros(D)})
        assert isinstance(pot, cg.TracedPotential) and pot.compiled.D == D
        resident = int(case == "compiled")
        assert (pot.compiled.operands.numel() > 232448 // 4) == (not resident)
        calls = []

        def fake_bind(lib, fn, argtypes):
            def launch(ops, args, stream, grid):
                a = args._obj
                calls.append((lib, fn, ops.value, a.n_chains, a.D, a.num_steps, a.num_leapfrog))
                for k, v in enumerate((1, 256, resident, 1, 8)):
                    grid[k] = v
                return 0
            return launch

        monkeypatch.setattr(_build, "chain_grid_library", lambda t: f"chain_grid_shape.{t.key}")
        monkeypatch.setattr(_build, "bind", fake_bind)
        monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
        q0 = torch.zeros((8, D))
        res = cg._chain_grid_cuda(pot, q0, 0, torch.full((8,), 0.1), torch.ones(D),
                                  num_steps=10, num_leapfrog=4, thin=1, collect="draws",
                                  step_offset=0, noise=None, spec=spec)
        assert calls == [(f"chain_grid_shape.{pot.compiled.key}", "binf_chain_grid_traced_hmc",
                          pot.device_operands(q0.device).data_ptr(), 8, D, 10, 4)]
        assert res.draws["x"].shape == (10, 8, D)
        rec = _build.last_launch["chain_grid_hmc"]
        assert rec.lanes == 256 and rec.route == ("staged" if resident else "streamed")
        return
    from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE

    fn, shape, why = {"cholesky": (_cholesky_density, (3,), "linalg"),
                      # past the wide form's cap (the id names the one-lane cap)
                      "d33": (lambda p: -torch.sum(p["x"] ** 2), (MAX_D_WIDE + 1,),
                              f"at most {MAX_D_WIDE}")}[case]
    pot, consts, _ = chain_grid_potential_from_scalar(fn, {"x": torch.zeros(shape)})
    assert type(pot) is ScalarPotential and why in pot.refusal
    with pytest.raises(NotImplementedError, match=why):
        chain_grid_hmc_run(pot, {"x": np.zeros((8,) + shape, np.float32)}, 0, 0.1,
                           {"x": np.ones(shape, np.float32)}, consts, num_steps=10,
                           steps_per_block=10, device="cuda")


@pytest.mark.parametrize("bad", [dict(collect="bogus"), dict(num_steps=45), dict(thin=3),
                                 dict(block_chains=3)],
                         ids=["collect", "steps_per_block", "thin", "block_chains"])
def test_bad_options_raise(chrom, bad):
    kw = dict(num_steps=20, block_chains=4, steps_per_block=10, device="cpu")
    kw.update(bad)
    with pytest.raises(ValueError):
        chain_grid_hmc_run(chrom["gram"], chrom["q0"], 0, 0.006, chrom["im"], {}, **kw)


def test_potential_front_end_checks():
    with pytest.raises(ValueError, match="up to 2-D"):
        chain_grid_potential_from_scalar(lambda p: p["x"].sum(), {"x": torch.zeros((2, 2, 2))})
    gram = GramChromatinDensity(np.zeros((4, 4)), np.ones((4, 4)), device="cpu")
    pot, consts, spec = chain_grid_potential_from_scalar(
        gram, {"structure": torch.zeros((4, 3)), "precision": torch.zeros(())})
    assert pot is gram and consts == {} and [s[0] for s in spec] == ["precision", "structure"]
    with pytest.raises(ValueError, match="Gram"):
        chain_grid_potential_from_scalar(gram, {"structure": torch.zeros((5, 3)),
                                                "precision": torch.zeros(())})
