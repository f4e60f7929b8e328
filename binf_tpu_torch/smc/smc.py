"""Adaptive tempered Sequential Monte Carlo (port of ``binf_tpu/smc/smc.py``).

Anneals from the prior (beta = 0) to the posterior (beta = 1) through
p_beta ~ prior x likelihood^beta:

1. the next beta by bisection, so that the incremental weights' ESS is
   ``target_ess`` N (a fixed number of bisection steps);
2. resampling to equal weights (systematic, stratified or multinomial);
3. mutation: K steps of an eager sampler (``samplers/rwm.py``,
   ``samplers/hmc.py``, ``samplers/mala.py``) on the tempered posterior in
   unconstrained space, every particle a chain stepped at once,
   preconditioned by the particles' spread, the step size rescaled
   toward a target acceptance between stages;
4. the evidence: log Z accumulates each stage's log mean incremental
   weight (the densities are fully normalised).

The JAX package runs the whole run as one ``lax.while_loop``; here the
loop over stages is eager Python with the particles on their device
(the card unless ``device="cpu"``), and reading each stage's beta back
is its one synchronisation.

With ``mesh=`` (``parallel/mesh.py``) each rank holds its rows of the
particles.  A stage all-gathers the ``(N,)`` log-likelihoods once; every
rank bisects for the next beta and adds to the evidence on the whole
vector, finds the ancestors of its own slots (systematic: the search of
``parallel/collectives.py::distributed_systematic_indices`` on the
gathered weights; the other schemes: the global draw, its rows), and
takes them from the all-gathered particles (``take_along_chain``).  The
scales' std and the mutation's mean acceptance are taken over the
all-gathered particles and acceptances, and the mutation draws every
particle's noise on every rank and keeps its rows, so every stage's
arithmetic is the unsharded run's: a sharded run gives its bits wherever
a row's log density (and gradient) does not depend on how many rows are
batched with it (RWM moves on the CPU; a batched product's rounding may
depend on it).  A pooled sum would not do: the mutation's accept decisions
turn a last-bit difference in a scale or a step size into another
realisation within a few stages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.math import log_sum_exp
from binf_tpu_torch.ops.tree import tree_leaves, tree_map
from binf_tpu_torch.pdf.transforms import (
    Transform,
    constrain,
    default_transforms,
    transform_logdensity,
    unconstrain,
)
from binf_tpu_torch.samplers.base import Position
from binf_tpu_torch.smc.resampling import RESAMPLERS, effective_sample_size

__all__ = ["SMCResult", "tempered_smc"]


class SMCResult(NamedTuple):
    particles: Position  # (N, ...) final equally weighted particles
    log_evidence: torch.Tensor
    num_stages: torch.Tensor
    final_beta: torch.Tensor
    final_step_size: torch.Tensor
    mean_acceptance: torch.Tensor


def _find_next_beta(loglik: torch.Tensor, beta: torch.Tensor, target_ess: float,
                    n_bisect: int = 30) -> torch.Tensor:
    """The largest beta' in (beta, 1] with ESS((beta' - beta) loglik) >=
    target_ess N, by ``n_bisect`` bisection steps in float32; at least
    beta + 1e-5."""
    target = target_ess * loglik.shape[0]

    def ess_at(delta):
        return effective_sample_size(delta * loglik, axis=0)

    full = 1.0 - beta
    ok_full = ess_at(full) >= target
    lo, hi = torch.zeros_like(full), full
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        good = ess_at(mid) >= target
        lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid)
    delta = torch.clamp_min(torch.where(ok_full, full, lo), 1e-5)
    return torch.clamp_max(beta + delta, 1.0)


def _particle_scales(u_particles: Position, mesh=None) -> Position:
    """Per-leaf standard deviation over the particle axis, floored at
    1e-4: the mutation's preconditioner.  Under a mesh every rank gathers
    all the particles and takes the std of the whole, so the scales are
    the unsharded run's bits, not a pooled sum's rounding."""
    from binf_tpu_torch.parallel.collectives import all_gather_rows

    return tree_map(lambda x: torch.clamp_min(
        torch.std(all_gather_rows(x, mesh), dim=0, unbiased=False), 1e-4), u_particles)


def _sample_prior(posterior, generator: torch.Generator, n: int) -> Position:
    """``n`` joint draws from the posterior's priors, ``(n, ...)`` a
    variable: Gaussian and Gamma priors draw all ``n`` at once, any other
    prior one draw at a time through its ``sample``."""
    from binf_tpu_torch.pdf import distributions as dist
    from binf_tpu_torch.pdf.priors import GammaPrior, GaussianPrior

    out = {}
    for prior in posterior.priors.values():
        if isinstance(prior, GaussianPrior):
            eps = torch.randn((n,) + tuple(prior.means.shape), generator=generator,
                              device=generator.device).to(prior.means.device)
            out[prior.variable] = prior.means + torch.sqrt(prior.variances) * eps
        elif isinstance(prior, GammaPrior):
            out[prior.variable] = dist.gamma_sample(generator, prior.shape_param, prior.rate,
                                                    shape=(n,))
        else:
            draws = [prior.sample(generator) for _ in range(n)]
            out.update({k: torch.stack([d[k] for d in draws]) for k in draws[0]})
    missing = set(posterior.variables) - set(out)
    if missing:
        raise ValueError(f"no prior sampler covers variable(s) {sorted(missing)}")
    return {k: v for k, v in out.items() if k in posterior.variables}


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=resolve_device(device)).manual_seed(int(key))


def tempered_smc(
    posterior,
    key,
    num_particles: int = 1024,
    mutation: str = "rwm",
    num_mutation_steps: int = 5,
    initial_step_size: float = 0.5,
    hmc_integration_steps: int = 10,
    resampling: str = "systematic",
    target_ess: float = 0.5,
    max_stages: int = 100,
    target_accept: float | None = None,
    initial_particles: Position | None = None,
    transforms: dict[str, Transform] | None = None,
    mesh=None,
    device=None,
) -> SMCResult:
    """Adaptive tempered SMC targeting ``posterior``.

    ``key`` is an int seed or a ``torch.Generator``, which then fixes the
    device (else ``device``: the card unless ``"cpu"``).
    ``initial_particles`` overrides prior sampling (needed when a variable
    has no prior sampler).  ``transforms`` maps constrained variables to
    unconstrained space for the mutation (default: a log transform for
    positive-looking names).  ``mutation`` is ``"rwm"`` (normal proposals
    scaled by the particles' spread), ``"hmc"`` (the spread's square as
    the inverse mass) or ``"mala"``.

    ``mesh``: the particles are sharded over it (see the module's
    docstring); every rank passes the same key (and initial particles, or
    ``DTensor``\\ s of them), and the final particles come back as
    ``DTensor``\\ s.
    """
    if mutation not in ("rwm", "hmc", "mala"):
        raise ValueError(f"unknown mutation {mutation!r}; use 'rwm', 'hmc' or 'mala'")
    resampler = RESAMPLERS[resampling]
    if target_accept is None:
        target_accept = 0.3 if mutation == "rwm" else 0.7
    if transforms is None:
        transforms = default_transforms(posterior)
    generator = _generator(key, device)

    from binf_tpu_torch.parallel.collectives import (
        _systematic_rows,
        _take_rows,
        _u_of,
        all_gather_rows,
    )
    from binf_tpu_torch.parallel.mesh import drawing_chain_rows, local_rows, row_range, shard_rows

    if initial_particles is None:
        particles = _sample_prior(posterior, generator, num_particles)
    else:
        particles = dict(initial_particles)
        num_particles = tree_leaves(particles)[0].shape[0]
    particles = local_rows(particles, mesh)
    lo, hi = (0, num_particles) if mesh is None else row_range(num_particles, mesh)
    loglik_fn = torch.func.vmap(posterior.log_likelihood)

    def make_kernel(beta: float, step_size: float, scales):
        logdensity = torch.func.vmap(transform_logdensity(posterior.tempered(beta).log_prob,
                                                          transforms))
        if mutation == "rwm":
            from binf_tpu_torch.samplers.rwm import rwm

            return rwm(logdensity, tree_map(lambda s: step_size * s, scales), proposal="normal")
        if mutation == "hmc":
            from binf_tpu_torch.samplers.hmc import hmc

            return hmc(logdensity, step_size=step_size,
                       num_integration_steps=hmc_integration_steps,
                       inverse_mass=tree_map(lambda s: s * s, scales))
        from binf_tpu_torch.samplers.mala import mala

        return mala(logdensity, step_size)

    dev = generator.device
    beta = torch.zeros((), device=dev)
    log_z = torch.zeros((), device=dev)
    step_size, mean_accept, stage = float(initial_step_size), float(target_accept), 0
    while float(beta) < 1.0 and stage < max_stages:
        loglik = all_gather_rows(loglik_fn(particles), mesh)
        new_beta = _find_next_beta(loglik, beta, target_ess)
        inc_lw = (new_beta - beta) * loglik
        log_z = log_z + log_sum_exp(inc_lw) - math.log(float(num_particles))
        if mesh is None:
            ancestors = resampler(generator, inc_lw)
            particles = tree_map(lambda x: x[ancestors], particles)
        else:
            if resampling == "systematic":
                ancestors = _systematic_rows(_u_of(generator, inc_lw), inc_lw, lo, hi)
            else:
                ancestors = resampler(generator, inc_lw)[lo:hi]
            particles = _take_rows(particles, ancestors, mesh)

        u_particles = unconstrain(transforms, particles)
        kernel = make_kernel(float(new_beta), step_size, _particle_scales(u_particles, mesh))
        states = kernel.init(u_particles)
        accepts = []
        with drawing_chain_rows(mesh, hi - lo):
            for _ in range(num_mutation_steps):
                states, info = kernel.step(generator, states)
                accepts.append(torch.mean(all_gather_rows(info.acceptance_prob.float(), mesh)))
        particles = constrain(transforms, states.position)
        mean_accept = float(torch.stack(accepts).mean())
        # Robbins-Monro rescale toward the target acceptance
        step_size = step_size * math.exp(mean_accept - target_accept)
        beta, stage = new_beta, stage + 1

    return SMCResult(particles=shard_rows(particles, mesh), log_evidence=log_z,
                     num_stages=torch.tensor(stage, dtype=torch.int32),
                     final_beta=beta, final_step_size=torch.tensor(step_size),
                     mean_acceptance=torch.tensor(mean_accept))
