"""K8's counterpart and the quadratic HMC route: the plain leapfrog against
the JAX package's ``lax.scan`` reference and its interpret-mode kernel, one
``quadratic_hmc`` step against JAX's arithmetic, the sampler's moments, and
a numpy emulation of the card kernel's 3xTF32 products against JAX's float32
reference.

Inputs are made with numpy from a seed and handed to both packages.  The
trajectories are the same float32 arithmetic in the same order but for the
product's summation order, so they agree to 1e-5 (relative to the
largest value) over L = 8 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.leapfrog import quadratic_leapfrog as jax_leapfrog
from binf_tpu.ops.pallas.leapfrog import quadratic_leapfrog_reference as jax_reference
from binf_tpu_torch.ops.kernels.leapfrog import (
    quadratic_leapfrog,
    quadratic_leapfrog_reference,
    quadratic_potential,
)
from binf_tpu_torch.parallel.runner import init_chains, run_chains
from binf_tpu_torch.samplers.quadratic_hmc import quadratic_hmc

C, D, L = 70, 8, 8


def _target(seed, symmetric=True, d=D):
    rng = np.random.default_rng(seed)
    M = 0.3 * rng.normal(size=(d, d))
    A = M @ M.T + np.eye(d)
    if not symmetric:
        A = A + 0.1 * rng.normal(size=(d, d))
    return (A.astype(np.float32), rng.normal(size=d).astype(np.float32),
            rng.normal(size=(C, d)).astype(np.float32), rng.normal(size=(C, d)).astype(np.float32),
            (0.5 + rng.random(d)).astype(np.float32))


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "nonsymmetric"])
@pytest.mark.parametrize("with_mass", [False, True], ids=["unit", "mass"])
def test_plain_leapfrog_matches_jax(symmetric, with_mass):
    A, b, q, p, im = _target(1 if symmetric else 2, symmetric)
    im = im if with_mass else None
    jim = None if im is None else jnp.asarray(im)
    args = (jnp.asarray(q), jnp.asarray(p), jnp.asarray(A), jnp.asarray(b), 0.1, L)
    ref = jax_reference(*args, inv_mass=jim)
    kern = jax_leapfrog(*args, inv_mass=jim, block_chains=32, interpret=True)
    got = quadratic_leapfrog_reference(torch.tensor(q), torch.tensor(p), torch.tensor(A),
                                       torch.tensor(b), 0.1, L,
                                       None if im is None else torch.tensor(im))
    wrapped = quadratic_leapfrog(q, p, A, b, 0.1, L, inv_mass=im, block_chains=32, device="cpu")
    for i in range(2):
        scale = float(np.abs(np.asarray(ref[i])).max())
        for want in (ref[i], kern[i]):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-5 * scale)
        assert torch.equal(wrapped[i], got[i])


def test_one_step_matches_jax_arithmetic():
    """One ``quadratic_hmc`` step against the arithmetic of
    ``quadratic_hmc.py:89-113`` in JAX, fed the step's own momentum normals,
    shared jitter uniform and accept uniforms (replayed from a generator of
    the same seed, in the step's order): the same acceptance probabilities,
    decisions and positions."""
    A, b, q, _, im = _target(3)
    eps, jitter = 0.3, 0.2
    g = torch.Generator().manual_seed(4)
    z = torch.randn((C, D), generator=g).numpy()
    u_eps = float(torch.rand((), generator=g))
    u_acc = torch.rand(C, generator=g).numpy()

    Aj, bj, imj, qj = (jnp.asarray(a) for a in (A, b, im, q))
    pot = lambda x: 0.5 * jnp.sum(x * (x @ Aj), axis=-1) - x @ bj
    p0 = jnp.asarray(z) / jnp.sqrt(imj)[None, :]
    e_before = pot(qj) + 0.5 * jnp.sum(p0 * p0 * imj[None, :], axis=-1)
    e = eps * (1.0 + jitter * (2.0 * jnp.float32(u_eps) - 1.0))
    qn, pn = jax_reference(qj, p0, Aj, bj, e, L, inv_mass=imj)
    delta = pot(qn) + 0.5 * jnp.sum(pn * pn * imj[None, :], axis=-1) - e_before
    delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
    want_p = jnp.minimum(1.0, jnp.exp(jnp.clip(-delta, -80.0, 80.0)))
    accepted = jnp.asarray(u_acc) < want_p
    want_q = jnp.where(accepted[:, None], qn, qj)

    kernel = quadratic_hmc(A, b, eps, L, inv_mass=im, jitter=jitter)
    state, info = kernel.step(torch.Generator().manual_seed(4), kernel.init(torch.tensor(q)))
    np.testing.assert_allclose(info.acceptance_prob.numpy(), np.asarray(want_p), rtol=1e-4,
                               atol=1e-6)
    assert np.array_equal(info.accepted.numpy(), np.asarray(accepted))
    assert 0 < int(info.accepted.sum()) < C
    np.testing.assert_allclose(state.position.numpy(), np.asarray(want_q), atol=1e-5)


def test_sampler_moments():
    """C = 256 chains of quadratic HMC over 400 steps, 100 dropped: the
    draws' mean is A^-1 b and their variances diag(A^-1), within a few
    Monte Carlo standard errors (mean 0.05, variances 10%)."""
    A, b, _, _, _ = _target(5)
    kernel = quadratic_hmc(A, b, 0.3, 10)
    q0 = torch.tensor(np.random.default_rng(6).normal(size=(256, D)), dtype=torch.float32)
    _, draws = run_chains(kernel, torch.Generator().manual_seed(7), init_chains(kernel, q0), 400)
    x = draws[100:].reshape(-1, D).double().numpy()
    cov = np.linalg.inv(A.astype(np.float64))
    np.testing.assert_allclose(x.mean(0), cov @ b, atol=0.05)
    np.testing.assert_allclose(x.var(0), np.diag(cov), rtol=0.1)


def test_routing_on_the_cpu():
    """``use_pallas=None`` and ``False`` run the plain version for chains on
    the CPU; ``True`` asks for the kernel, whose wrapper runs the plain
    version for a CPU tensor: the three agree bit for bit."""
    A, b, q, _, _ = _target(8)
    outs = []
    for use in (None, False, True):
        kernel = quadratic_hmc(A, b, 0.2, 5, use_pallas=use)
        state, _ = kernel.step(torch.Generator().manual_seed(0), kernel.init(torch.tensor(q)))
        outs.append(state.position)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("steps", [0, L])
def test_wrapper_potential_matches_jax(steps):
    """``return_potential``: U at the final positions, against the JAX
    package's potential of its reference's positions (to 1e-5 of its
    largest value); with no steps, U at the start and the positions
    unchanged."""
    A, b, q, p, im = _target(10, symmetric=False)
    qw, _, U = quadratic_leapfrog(q, p, A, b, 0.1, steps, inv_mass=im, device="cpu",
                                  return_potential=True)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    qj = jax_reference(jnp.asarray(q), jnp.asarray(p), Aj, bj, 0.1, steps,
                       inv_mass=jnp.asarray(im))[0]
    want = np.asarray(0.5 * jnp.sum(qj * (qj @ Aj), axis=-1) - qj @ bj)
    np.testing.assert_allclose(U.numpy(), want, atol=1e-5 * np.abs(want).max())
    assert torch.equal(U, quadratic_potential(qw, torch.tensor(A), torch.tensor(b)))
    if steps == 0:
        assert torch.equal(qw, torch.tensor(q))


def test_kernel_wrapper_checks_shapes():
    A, b, q, p, _ = _target(9)
    with pytest.raises(ValueError):
        quadratic_leapfrog(q, p[:, :4], A, b, 0.1, 3, device="cpu")
    with pytest.raises(ValueError):
        quadratic_leapfrog(q, p, A, b, 0.1, 3, block_chains=0, device="cpu")


def _tf32(x):
    """Round float32 to TF32 as the card's cvt.rna.tf32 does: to nearest,
    ties away from zero, then mask to a 10-bit mantissa."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_product(q, A, passes):
    """q A as K8's tensor route forms it: x = hi + lo with hi = tf32(x) and
    lo = tf32(x - hi), then lo_q hi_A + hi_q lo_A + hi_q hi_A in float32
    (passes=3); passes=1 is a single TF32 product, hi_q hi_A."""
    qh, Ah = _tf32(q), _tf32(A)
    if passes == 1:
        return qh @ Ah
    ql, Al = _tf32(q - qh), _tf32(A - Ah)
    return ((ql @ Ah) + (qh @ Al)) + (qh @ Ah)


def _split_leapfrog(q, p, A, b, eps, steps, passes):
    """The tensor route's trajectory in numpy: L + 1 split products, the
    trailing half kick from the last one."""
    eps = np.float32(eps)
    half = np.float32(0.5) * eps
    g = _split_product(q, A, passes) - b
    p = p - half * g
    for step in range(steps):
        q = q + eps * p
        g = _split_product(q, A, passes) - b
        p = p - eps * g
    return q, p + half * g


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "1xtf32"])
def test_split_product_keeps_float32_accuracy(passes):
    """On the quadratic path's target (A = M M^T + I, M = 0.05 N(0, 1),
    D = 128, step 0.15, L = 32), K8's 3xTF32 split matches the JAX package's
    float32 reference within the card check's 1e-4 of the largest value;
    a single TF32 pass does not, which is why the kernel takes three."""
    rng = np.random.default_rng(128)
    d = 128
    M = 0.05 * rng.normal(size=(d, d))
    A = (M @ M.T + np.eye(d)).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)
    q, p = (rng.normal(size=(64, d)).astype(np.float32) for _ in range(2))
    ref = jax_reference(jnp.asarray(q), jnp.asarray(p), jnp.asarray(A), jnp.asarray(b), 0.15, 32)
    got = _split_leapfrog(q, p, A, b, 0.15, 32, passes)
    err = max(float(np.abs(g - np.asarray(r)).max()) for g, r in zip(got, ref))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    if passes == 3:
        assert err <= 1e-4 * scale
    else:
        assert err > 1e-4 * scale
