"""Parallel tempering (``binf_tpu_torch/samplers/tempering.py``) against
the JAX package's ``binf_tpu/samplers/tempering.py``, on the CPU.

Deterministic: the swap log-ratio of the same replicas, with the JAX
kernel's moves taken out (an inner kernel that keeps its state), so that
its reported swap probabilities are those of the given log densities: the
port's ``min(1, exp(ratio))`` agrees at 1e-5 relative.  The ladder agrees
at 1e-6 relative (a few float32 units in the last place), not bit for
bit: the port rounds the exact geometric ladder once, while the JAX
package's float32 ``log10``, ``linspace`` and ``pow`` on XLA's CPU each
round (no PyTorch or numpy float32 formula of them reproduced XLA's
bits).  Statistical: the JAX
tests' bounds (``tests/test_tempering.py``)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.samplers.base import SamplerKernel
from binf_tpu.samplers.tempering import geometric_betas as jax_betas
from binf_tpu.samplers.tempering import parallel_tempering as jax_pt
from binf_tpu_torch.samplers.rwm import rwm
from binf_tpu_torch.samplers.tempering import geometric_betas, parallel_tempering, swap_log_ratio

RTOL = 1e-5


def bimodal(pos):
    """Modes at -4 and +4, scale 0.5; one value per replica."""
    x = pos["x"]
    return torch.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2, -0.5 * ((x - 4.0) / 0.5) ** 2)


def jax_bimodal(pos):
    x = pos["x"]
    return jnp.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2, -0.5 * ((x - 4.0) / 0.5) ** 2)


@pytest.mark.parametrize("k, beta_min", [(6, 0.02), (4, 0.05), (10, 0.001), (2, 0.5), (1, 0.1)])
def test_geometric_betas_match_jax(k, beta_min):
    got = geometric_betas(k, beta_min).numpy()
    ref = np.asarray(jax_betas(k, beta_min))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[0] == 1.0


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_log_ratio_matches_jax(parity):
    K = 6
    betas = np.asarray(jax_betas(K, 0.02))
    x = np.random.default_rng(parity).normal(scale=3.0, size=K).astype(np.float32)

    # a PT step with frozen inner moves: positions go through unchanged
    kernel = jax_pt(jax_bimodal, betas, make_kernel=lambda b: _frozen_kernel())
    state = kernel.init({"x": jnp.asarray(x)})
    state = state._replace(step_parity=jnp.asarray(parity, jnp.int32))
    _, info = kernel.step(jax.random.key(3), state)

    logps = bimodal({"x": torch.tensor(x)})
    ratio = swap_log_ratio(torch.tensor(betas), logps, parity)
    p = torch.clamp_max(torch.exp(ratio), 1.0).numpy()
    active = (np.arange(K - 1) - parity) % 2 == 0
    np.testing.assert_allclose(p[:K - 1][active], np.asarray(info.swap_prob)[active], rtol=RTOL)
    assert (np.asarray(info.swap_prob)[~active] == 0).all()
    # both replicas of a pair see the same ratio
    idx = np.arange(K)
    partner = np.clip(np.where((idx - parity) % 2 == 0, idx + 1, idx - 1), 0, K - 1)
    np.testing.assert_allclose(ratio.numpy(), ratio.numpy()[partner], rtol=RTOL)


class _Frozen(NamedTuple):
    position: dict


def _frozen_kernel():
    """A within-temperature kernel that keeps its state."""
    return SamplerKernel(init=_Frozen, step=lambda key, st: (st, jnp.zeros(())))


def _run_pt(chains, steps, seed=0, K=6):
    kernel = parallel_tempering(bimodal, geometric_betas(K, beta_min=0.02), step_size=0.8)
    state = kernel.init({"x": torch.full((chains, K), -4.0)})
    g = torch.Generator().manual_seed(seed)
    xs, swaps = [], []
    for _ in range(steps):
        state, info = kernel.step(g, state)
        xs.append(state.positions["x"][:, 0])
        swaps.append(info.swap_accepted)
    return state, torch.stack(xs), torch.stack(swaps)


def test_pt_crosses_modes_and_swaps():
    """``tests/test_tempering.py::test_pt_crosses_modes`` and
    ``test_swap_acceptance_reasonable``: every replica starts in the left
    mode; the cold chains spend 0.25-0.75 of their time in the right mode,
    |x| within 0.3 of 4, pair swap rates in (0.1, 1) (128 chains, 600
    steps, the first 200 dropped)."""
    state, xs, swaps = _run_pt(128, 600)
    xs = xs[200:].numpy()
    assert 0.25 < (xs > 0).mean() < 0.75
    assert abs(np.abs(xs).mean() - 4.0) < 0.3
    rate = swaps.float().mean().item() * 2.0
    assert 0.1 < rate < 1.0
    assert state.positions["x"].shape == (128, 6) and swaps.shape == (600, 128, 5)


def test_plain_rwm_fails_to_cross():
    """The control of ``tests/test_tempering.py``: without tempering the
    chains stay in the left mode (64 chains, 600 steps)."""
    kernel = rwm(bimodal, step_size=0.8, proposal="normal")
    state = kernel.init({"x": torch.full((64,), -4.0)})
    g = torch.Generator().manual_seed(1)
    for _ in range(600):
        state, _ = kernel.step(g, state)
        assert bool((state.position["x"] < 0).all())


def test_one_chain_ladder_and_custom_inner_kernel():
    """One chain is a ``(K,)`` ladder; ``make_kernel(beta)`` gets beta over
    the ladder axis, and the swaps alternate parity."""
    K = 4
    seen = []

    def make_kernel(beta):
        seen.append(tuple(beta.shape))
        return rwm(lambda pos: beta * bimodal(pos), 0.5, proposal="normal")

    kernel = parallel_tempering(bimodal, geometric_betas(K, 0.05), make_kernel=make_kernel)
    state = kernel.init({"x": torch.full((K,), -4.0)})
    g = torch.Generator().manual_seed(2)
    state, info = kernel.step(g, state)
    assert seen == [(K,)] and info.swap_accepted.shape == (K - 1,)
    assert bool(info.swap_prob[1] == 0) and int(state.step_parity) == 1
    state, info = kernel.step(g, state)
    assert bool(info.swap_prob[0] == 0) and bool(info.swap_prob[2] == 0)
