"""K6's counterpart: the plain restraint loss and its gradient (through
``PairwiseRestraintLoss``) against the JAX package's Pallas path in
interpret mode (``pairwise_restraint_loss_pallas``) and its XLA reference.

Inputs are made with numpy from a seed: beads of a random walk (no two
coincident, so the kernels' ``d2 + eps`` and the reference's
``max(d2, eps)`` agree to rounding), targets near the true log-distances,
and a symmetric 0/1 weight matrix with a zero diagonal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.pairwise import (
    pairwise_restraint_block as jax_block,
    pairwise_restraint_loss_pallas as jax_pallas,
    pairwise_restraint_loss_reference as jax_reference,
)
from binf_tpu_torch.ops.kernels import _build
from binf_tpu_torch.ops.kernels.pairwise import (
    pairwise_forces_plain,
    pairwise_loss_plain,
    pairwise_restraint_block,
    pairwise_restraint_loss,
    pairwise_restraint_loss_pallas,
    pairwise_restraint_loss_reference,
)

N = 256


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(N, 3))
    X = np.cumsum(steps / np.linalg.norm(steps, axis=1, keepdims=True), axis=0)
    d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1) + np.eye(N))
    noise = rng.normal(size=(N, N)) * 0.2
    logD = np.log(d) + 0.5 * (noise + noise.T)
    raw = rng.uniform(size=(N, N))
    W = ((0.5 * (raw + raw.T)) < 0.3).astype(np.float32) * (1 - np.eye(N, dtype=np.float32))
    X = X + 0.1 * rng.normal(size=X.shape)
    return X.astype(np.float32), logD.astype(np.float32), W


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def test_loss_matches_jax_pallas_interpret_and_reference(field):
    """Sums of 2e4 positive float32 terms in different orders: 1e-5
    relative."""
    X, logD, W = field
    ref = float(jax_pallas(jnp.asarray(X), jnp.asarray(logD), jnp.asarray(W), block=128,
                           interpret=True))
    xla = float(jax_reference(jnp.asarray(X), jnp.asarray(logD), jnp.asarray(W)))
    tX, tD, tW = _t(X, logD, W)
    got = float(pairwise_restraint_loss(tX, tD, tW, block=128))
    assert got == pytest.approx(ref, rel=1e-5)
    assert got == pytest.approx(xla, rel=1e-5)
    assert float(pairwise_restraint_loss_reference(tX, tD, tW)) == pytest.approx(xla, rel=1e-5)
    assert float(pairwise_loss_plain(tX, tD, tW)) == got


def test_gradient_matches_jax_pallas_interpret(field):
    """The gradient through the Function's backward (the plain K6b) against
    the gradient of JAX's custom VJP around the interpret-mode kernels, and
    against torch.autograd through the plain loss itself: sums of 256
    signed terms of magnitude ~1, so 1e-4 absolute."""
    X, logD, W = field
    jg = np.asarray(jax.grad(lambda x: jax_pallas(x, jnp.asarray(logD), jnp.asarray(W),
                                                  block=128, interpret=True))(jnp.asarray(X)))
    tX, tD, tW = _t(X, logD, W)
    x = tX.clone().requires_grad_()
    pairwise_restraint_loss(x, tD, tW, block=128).backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, atol=1e-4, rtol=1e-5)
    x2 = tX.clone().requires_grad_()
    pairwise_loss_plain(x2, tD, tW).backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(2.0 * pairwise_forces_plain(tX, tD, tW).numpy(), jg,
                               atol=1e-4, rtol=1e-5)


def test_function_under_torch_func_grad(field):
    """``torch.func.grad`` goes through the Function (as the DSL takes its
    gradients), scaling by the outer derivative: d(3 loss)/dX = 3 grad."""
    X, logD, W = field
    tX, tD, tW = _t(X, logD, W)
    g = torch.func.grad(lambda x: 3.0 * pairwise_restraint_loss(x, tD, tW))(tX)
    np.testing.assert_allclose(g.numpy(), 6.0 * pairwise_forces_plain(tX, tD, tW).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_zero_loss_at_exact_targets(field):
    """Targets equal to the kernels' own log-distances: the loss is zero up
    to float32 rounding of the logs (|r| <~ 1e-7 per pair), and so are the
    forces."""
    X, _, W = field
    tX, tW = _t(X, W)
    diff = tX[:, None, :] - tX[None, :, :]
    logD = 0.5 * torch.log(1e-12 + (diff * diff).sum(-1))
    assert float(pairwise_restraint_loss(tX, logD, tW)) < 1e-9
    assert float(pairwise_forces_plain(tX, logD, tW).abs().max()) < 1e-5


def test_block_matches_jax(field):
    """The sharded evaluation's row block: rows 64..127 against all beads."""
    X, logD, W = field
    jl, jf = jax_block(jnp.asarray(X[64:128]), jnp.asarray(X), jnp.asarray(logD[64:128]),
                       jnp.asarray(W[64:128]))
    tl, tf = pairwise_restraint_block(*_t(X[64:128], X, logD[64:128], W[64:128]))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4, rtol=1e-5)


def test_kernel_choice(field):
    """On the CPU: None and False run the plain versions, True and the
    kernel entry raise; no kernel launches."""
    X, logD, W = field
    tX, tD, tW = _t(X, logD, W)
    before = dict(_build.LAUNCHES)
    want = float(pairwise_loss_plain(tX, tD, tW))
    assert float(pairwise_restraint_loss(tX, tD, tW, use_pallas=False)) == want
    assert float(pairwise_restraint_loss(tX, tD, tW, block=128)) == want
    with pytest.raises(ValueError, match="on the card"):
        pairwise_restraint_loss(tX, tD, tW, block=128, use_pallas=True)
    with pytest.raises(ValueError, match="on the card"):
        pairwise_restraint_loss_pallas(tX, tD, tW)
    assert dict(_build.LAUNCHES) == before


def test_coincident_beads_are_where_the_two_floors_differ():
    """Two beads at one point (d2 = 0), the only place the kernels' d2 + eps
    and the reference's max(d2, eps) part: both give log(eps) there, and
    both stay finite."""
    X = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    W = torch.ones((3, 3)) - torch.eye(3)
    logD = torch.zeros((3, 3))
    a = pairwise_restraint_loss(X, logD, W)
    b = pairwise_restraint_loss_reference(X, logD, W)
    assert torch.isfinite(a) and torch.isfinite(b)
    assert float(a) == pytest.approx(float(b), rel=1e-6)
