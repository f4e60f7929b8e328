"""The plain K3 and K4 at the family dimensions the reference's
constructors take (``family_dims_problems.py``: the mixture at K = 2, 4,
5, the hierarchical posterior at 4, 6 and 16 groups, the logistic
posterior at d = 12, linear regression at 12 coefficients) against the JAX
package's interpret-mode kernels on ``tile_potential_from_scalar`` of the
JAX density, on the CPU, on the same host noise, 16 chains in one tile:

- K4, 10 steps at step size 0.02 and an identity metric: draws to 2e-4
  and acceptance to 1e-6, as ``test_torch_families.py`` holds the
  families;
- K3, 4 warmup steps at 0.02 with its window fold and harvest: positions
  to 2e-4, step size to 1e-4 and metric to 1e-3 relative, as
  ``test_torch_hierarchical_density.py`` holds the hierarchical posterior.
  The pooled warmup is chaotic in float32 (ROADMAP section 3): a last-bit
  difference in a step's acceptance moves the dual-averaged step size,
  and at 6 steps the mixture of 4 components parts by 1.9e-3, so the
  horizon is 4 steps.

At seed 0 no MH decision lies within 5e-5 of its threshold (asserted), so
both sides take the same decisions and part by rounding alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import family_dims_problems as fdp
from binf_tpu.ops.pallas.fused_potential import fused_potential_hmc_run as jax_run
from binf_tpu.ops.pallas.fused_potential import fused_warmup_run as jax_warmup
from binf_tpu.ops.pallas.fused_potential import tile_potential_from_scalar
from binf_tpu_torch.ops.kernels.densities import device_density
from binf_tpu_torch.ops.kernels.fused_potential import (fused_potential_hmc_plain,
                                                        fused_warmup_plain)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

C, BC, STEPS, K3_STEPS, SEED, EPS = 16, 16, 10, 4, 0, 0.02


@pytest.fixture(scope="module", params=list(fdp.SHAPES))
def shape(request):
    name = request.param
    jfn, tfn, shapes, cls, centre = fdp.problem(name)
    potential, consts, _ = tile_potential_from_scalar(
        jfn, {k: jnp.zeros(s) for k, s in shapes.items()})
    return (name, potential, consts, device_density(tfn, fdp.template(shapes)),
            fdp.points(centre, 4, C, 0.1))


def test_plain_k4_matches_jax_interpret(shape):
    name, potential, consts, density, q0 = shape
    D = q0.shape[1]
    eps = np.full(C, EPS, np.float32)
    im = np.ones((C, D), np.float32)
    jr = jax_run(potential, jnp.asarray(q0), SEED, jnp.asarray(eps), jnp.asarray(im), consts,
                 num_steps=STEPS, block_chains=BC, steps_per_block=STEPS, interpret=True,
                 host_noise=True)
    noise = tuple(torch.tensor(a) for a in fdp.host_noise(SEED, STEPS, D, C))
    trace = fused_potential_hmc_plain(density, torch.tensor(q0), SEED, torch.tensor(eps),
                                      torch.tensor(im), num_steps=STEPS, block_chains=BC,
                                      noise=noise)
    assert float(trace.margin.abs().min()) > 5e-5
    got = trace.result
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    assert 0.0 < float(got.accept_rate) <= 1.0
    np.testing.assert_allclose(got.draws.numpy(), np.asarray(jr.draws), atol=2e-4)


def test_plain_k3_matches_jax_interpret(shape):
    name, potential, consts, density, q0 = shape
    D = q0.shape[1]
    jq, jeps, jim = jax_warmup(potential, jnp.asarray(q0), SEED, EPS, consts,
                               num_warmup=K3_STEPS, num_leapfrog=10, block_chains=BC,
                               interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in fdp.host_noise(SEED, K3_STEPS, D, C))
    margins = []
    tq, teps, tim = fused_warmup_plain(density, torch.tensor(q0), SEED, EPS,
                                       num_warmup=K3_STEPS, num_leapfrog=10, block_chains=BC,
                                       target_accept=0.8, init_search=False, noise=noise,
                                       margins=margins)
    assert float(torch.stack(margins).abs().min()) > 5e-5
    assert not bool(torch.all(tim == 1.0))  # the metric was harvested
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-4)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=1e-3, atol=1e-6)
