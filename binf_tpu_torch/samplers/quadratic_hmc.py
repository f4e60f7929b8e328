"""HMC specialised to quadratic potentials (port of
``binf_tpu/samplers/quadratic_hmc.py``).

For targets with ``log p(q) = -q^T A q / 2 + b^T q + const``
(linear-Gaussian conditionals: regression coefficient blocks, GP latents,
Kalman-style states) the trajectory runs in the leapfrog kernel K8
(``ops/kernels/leapfrog.py``).  ``step`` acts on a whole ``(C, D)`` chain
batch.  The MH test is still made: leapfrog is not exact.

Routing: ``use_pallas=None`` runs K8 for chains on the card and the plain
version on the CPU; ``False`` always the plain version.  The JAX package
routes ``None`` to its scan after a TPU v5e measurement; in the port
routing follows measurements on the H100 only (``chip_smoke.py``
``quadratic_path`` times both).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.ops.kernels.leapfrog import (
    quadratic_leapfrog,
    quadratic_leapfrog_reference,
    quadratic_potential,
)
from binf_tpu_torch.ops.math import safe_exp
from binf_tpu_torch.samplers.base import SamplerKernel

__all__ = ["QuadraticHMCInfo", "QuadraticHMCState", "quadratic_hmc"]


class QuadraticHMCState(NamedTuple):
    position: torch.Tensor  # (C, D)
    potential: torch.Tensor  # (C,)


class QuadraticHMCInfo(NamedTuple):
    accepted: torch.Tensor  # (C,)
    acceptance_prob: torch.Tensor  # (C,)


def quadratic_hmc(A, b, step_size=0.1, num_integration_steps: int = 10, inv_mass=None,
                  use_pallas: bool | None = None, block_chains: int = 256,
                  jitter: float = 0.2) -> SamplerKernel:
    """Batched HMC kernel for ``log p(q) = -(q^T A q / 2 - b^T q)``.

    ``jitter``: each step's step size is ``eps (1 + j (2 u - 1))`` with one
    uniform ``u`` shared by the whole chain batch (it breaks the
    trajectory-length resonances of a quadratic target's eigenmodes).  The
    operands move to the chains' device once, at the first step there; on
    the card a step then waits for the host nowhere, and K8 gives the
    proposal's potential with its trajectory."""
    A = torch.as_tensor(A, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    D = b.shape[0]
    im = torch.ones(D) if inv_mass is None else torch.as_tensor(inv_mass, dtype=torch.float32)
    eps0 = torch.as_tensor(step_size, dtype=torch.float32)
    placed = {}

    def on(dev):  # (A, b, im, eps) on dev
        if dev not in placed:
            placed[dev] = tuple(x.to(dev) for x in (A, b, im, eps0))
        return placed[dev]

    def kernel(dev) -> bool:
        return use_pallas if use_pallas is not None else dev.type == "cuda"

    def integrate(q, p, eps, num_steps):
        """``(q, p, U(q))`` after ``num_steps`` leapfrog steps."""
        A_d, b_d, im_d, _ = on(q.device)
        if kernel(q.device):
            return quadratic_leapfrog(q, p, A_d, b_d, eps, num_steps, inv_mass=im_d,
                                      block_chains=block_chains, device=q.device,
                                      return_potential=True)
        q, p = quadratic_leapfrog_reference(q, p, A_d, b_d, eps, num_steps, inv_mass=im_d)
        return q, p, quadratic_potential(q, A_d, b_d)

    def init(position) -> QuadraticHMCState:
        position = torch.as_tensor(position, dtype=torch.float32)
        # no steps: the potential at the start, from K8 on the card
        _, _, U = integrate(position, torch.zeros_like(position), on(position.device)[3], 0)
        return QuadraticHMCState(position, U)

    def step(generator: torch.Generator, state: QuadraticHMCState):
        q0 = state.position
        dev = q0.device
        _, _, im_d, eps = on(dev)
        p0 = chain_rows.randn(q0.shape, generator=generator, device=dev) / torch.sqrt(im_d)[None, :]
        e_before = state.potential + 0.5 * torch.sum(p0 * p0 * im_d[None, :], dim=-1)
        if jitter > 0:
            u_eps = torch.rand((), generator=generator, device=dev)
            eps = eps * (1.0 + jitter * (2.0 * u_eps - 1.0))
        q, p, U = integrate(q0, p0, eps, num_integration_steps)
        delta = U + 0.5 * torch.sum(p * p * im_d[None, :], dim=-1) - e_before
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        p_accept = torch.clamp_max(safe_exp(-delta), 1.0)
        u = chain_rows.rand(q0.shape[0], generator=generator, device=dev)
        accepted = u < p_accept
        new_state = QuadraticHMCState(torch.where(accepted[:, None], q, q0),
                                      torch.where(accepted, U, state.potential))
        return new_state, QuadraticHMCInfo(accepted, p_accept)

    return SamplerKernel(init=init, step=step)
