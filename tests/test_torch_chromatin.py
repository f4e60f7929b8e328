"""The chromatin restraint posterior against the JAX package, at 32 beads:
the counterparts of ``tests/test_chromatin.py`` on one problem, carried
across as numpy arrays of the JAX package's ``synthetic_restraints``
(``chromatin_problem_from_numpy``).

The JAX posterior runs its XLA reference (``use_pallas=False``); the port's
runs the plain versions of its restraint kernels on the CPU.  The two floor
the squared distances differently (``max(d2, eps)`` against ``d2 + eps``),
which no pair of these beads comes near, so they agree to float32
rounding.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import chromatin as jchrom
from binf_tpu_torch.example.chromatin import (
    BackbonePrior,
    chromatin_problem_from_numpy,
    make_chromatin_posterior,
    restraint_precision_block,
    synthetic_restraints,
)
from binf_tpu_torch.ops.kernels.pairwise import pairwise_loss_plain
from binf_tpu_torch.samplers.gibbs import gibbs, hmc_block

jgibbs = importlib.import_module("binf_tpu.samplers.gibbs")

N_BEADS = 32


@pytest.fixture(scope="module")
def problem():
    X_true, log_target, W = jchrom.synthetic_restraints(jax.random.key(0), N_BEADS,
                                                        observe_frac=0.5)
    jpost = jchrom.make_chromatin_posterior(log_target, W, use_pallas=False)
    arrays = tuple(np.asarray(a) for a in (X_true, log_target, W))
    tX, tD, tW = chromatin_problem_from_numpy(*arrays, device="cpu")
    return arrays, jpost, (tX, tD, tW), make_chromatin_posterior(tD, tW)


def _perturbed(X, seed, scale=0.3):
    return (X + scale * np.random.default_rng(seed).normal(size=X.shape)).astype(np.float32)


def test_posterior_structure_and_log_prob(problem):
    (X, _, _), jpost, (tX, _, _), post = problem
    assert post.variables == jpost.variables == ("precision", "structure")
    for Xs, prec in ((X, 25.0), (_perturbed(X, 3), 7.5)):
        want = float(jpost.log_prob(structure=jnp.asarray(Xs), precision=prec))
        got = float(post.log_prob(structure=torch.tensor(Xs), precision=torch.tensor(prec)))
        assert got == pytest.approx(want, rel=1e-5)


def test_gradient_matches_jax(problem):
    """Gradients through the restraint Function's backward against
    ``jax.grad`` of the reference: 1e-3 absolute on components up to
    ~1e3."""
    (X, _, _), jpost, _, post = problem
    X0 = _perturbed(X, 3)
    jg = jpost.gradient(structure=jnp.asarray(X0), precision=25.0)
    tg = post.gradient(structure=torch.tensor(X0), precision=torch.tensor(25.0))
    np.testing.assert_allclose(tg["structure"].numpy(), np.asarray(jg["structure"]),
                               rtol=1e-4, atol=1e-3)
    assert float(tg["precision"]) == pytest.approx(float(jg["precision"]), rel=1e-4)
    # ascent on the log density lowers the restraint loss
    lp0 = post.log_prob(structure=torch.tensor(X0), precision=torch.tensor(25.0))
    lp1 = post.log_prob(structure=torch.tensor(X0) + 1e-3 * tg["structure"],
                        precision=torch.tensor(25.0))
    assert float(lp1) > float(lp0)


def test_map_recovers_structure(problem):
    """Gradient ascent at a fixed precision recovers the restrained
    distances of the truth: median relative error < 0.15, as
    ``tests/test_chromatin.py:72``."""
    (X, _, W), _, _, post = problem
    cond = post.conditional_factory(precision=torch.tensor(25.0))
    Xs = torch.tensor(_perturbed(X, 7, 0.2))
    for _ in range(300):
        Xs = Xs + 2e-3 * cond.gradient(structure=Xs)["structure"]
    assert _median_error(Xs.numpy(), X, W) < 0.15


def _median_error(X, X_true, W):
    def dists(A):
        return np.sqrt(np.maximum(((A[:, None] - A[None]) ** 2).sum(-1), 1e-12))

    mask = W > 0
    return float(np.median(np.abs(dists(X) - dists(X_true))[mask]
                           / np.maximum(dists(X_true)[mask], 0.1)))


def test_conjugate_precision_moments(problem):
    """2,000 draws of the precision block at the truth: the mean within 5%
    of the analytic Gamma(2 + K/2, 0.1 + loss/2) mean, and within 5% of the
    JAX block's."""
    (X, D, W), jpost, (tX, tD, tW), post = problem
    block = restraint_precision_block(post)
    g = torch.Generator().manual_seed(9)
    pos = {"structure": tX, "precision": torch.tensor(1.0)}
    draws = np.array([float(block(g, pos)[0]["precision"]) for _ in range(2000)])
    loss = float(pairwise_loss_plain(tX, tD, tW))
    shape, rate = 2.0 + float(W.sum()) / 2, 0.1 + loss / 2
    assert draws.mean() == pytest.approx(shape / rate, rel=0.05)
    jblock = jchrom.restraint_precision_block(jpost)
    jpos = {"structure": jnp.asarray(X), "precision": jnp.ones(())}
    jdraws = jax.vmap(lambda k: jblock(k, jpos)[0]["precision"])(
        jax.random.split(jax.random.key(9), 2000))
    assert draws.mean() == pytest.approx(float(jdraws.mean()), rel=0.05)


def test_backbone_prior_matches_jax_and_samples():
    """The log density against the JAX prior; a draw has unit steps and is
    centred."""
    X = _perturbed(np.cumsum(np.eye(3)[np.arange(64) % 3], axis=0), 1, 0.1)
    want = float(jchrom.BackbonePrior.create(64).log_prob(structure=jnp.asarray(X)))
    prior = BackbonePrior.create(64)
    assert float(prior.log_prob(structure=torch.tensor(X))) == pytest.approx(want, rel=1e-5)
    S = prior.sample(torch.Generator().manual_seed(0))["structure"]
    np.testing.assert_allclose(torch.linalg.norm(S[1:] - S[:-1], dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert float(S.mean(0).abs().max()) < 1e-5


def test_tempering_applies_to_restraints(problem):
    (X, _, _), _, _, post = problem
    vals = dict(structure=torch.tensor(X), precision=torch.tensor(25.0))
    full = post.log_likelihood(**vals)
    half = post.tempered(0.5).log_likelihood(**vals)
    assert float(half) == pytest.approx(0.5 * float(full), rel=1e-5)


def test_synthetic_noise_precision_is_twice_the_nominal():
    """The reference symmetrises the noise, halving its variance: at the
    truth the restraints carry a precision near 2 x 25 = 50, not 25 (within
    10% at 256 beads)."""
    g = torch.Generator().manual_seed(0)
    X, D, W = synthetic_restraints(g, 256, observe_frac=0.3, device="cpu")
    emp = float(W.sum() / pairwise_loss_plain(X, D, W))
    assert emp == pytest.approx(50.0, rel=0.1)


def test_gibbs_run_improves_the_fit(problem):
    """The composition of ``examples/run_chromatin.py``: HMC over the
    structure (5 steps of 3e-3), then the exact precision draw, 60 sweeps
    from X_true + 0.3 noise at precision 5.  The restraint loss falls, HMC
    accepts, and the precision rises toward the noise's (~50)."""
    (X, _, W), _, (tX, tD, tW), post = problem
    kernel = gibbs({"structure": hmc_block(post, "structure", step_size=3e-3,
                                           num_integration_steps=5),
                    "precision": restraint_precision_block(post)})
    X0 = torch.tensor(_perturbed(X, 1))
    state = kernel.init({"structure": X0, "precision": torch.tensor(5.0)})
    g = torch.Generator().manual_seed(2)
    accs, precs = [], []
    for _ in range(60):
        state, infos = kernel.step(g, state)
        accs.append(float(infos["structure"].acceptance_prob))
        precs.append(float(state.position["precision"]))
    Xf = state.position["structure"]
    assert float(pairwise_loss_plain(Xf, tD, tW)) < float(pairwise_loss_plain(X0, tD, tW))
    assert np.mean(accs) > 0.5
    assert np.mean(precs[-20:]) > 2 * 5.0
    assert _median_error(Xf.numpy(), X, W) < _median_error(X0.numpy(), X, W)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_restraints(torch.Generator().manual_seed(0), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chromatin_problem_from_numpy(np.zeros((8, 3)), np.zeros((8, 8)), np.zeros((8, 8)))
