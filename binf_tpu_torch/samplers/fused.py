"""The user's routes to the fused whole-run kernels (port of
``binf_tpu/samplers/fused.py``).

:func:`fused_regression_hmc` reads a Bayesian linear-regression posterior
through the model DSL (``_introspect``), adapts with the eager Stan-window
warmup and samples inside one kernel (K2, ``fused_linreg_hmc_run``).

:func:`fused_model_hmc` packs chain-batched positions, adapts, and samples
inside one kernel (K4, ``fused_potential_hmc_run``), then unpacks.  With
``warmup="fused"`` the adaptation is a kernel too (K3,
``fused_warmup_run``); with ``warmup="xla"`` (the JAX package's default) it
is the eager Stan-window warmup (``samplers/adaptation.py::
window_adaptation`` over ``samplers/hmc.py``), the counterpart of the JAX
package's XLA path.  On the card the log density must have a device density
(``ops/kernels/densities.py::device_density``): a device density itself, or
the port's ``transform_logdensity`` of a linear-regression posterior; any
other callable raises there.  On the CPU (``device="cpu"``) any callable
runs through the plain versions, with its gradient from ``torch.func``.

Not ported yet, and raising ``NotImplementedError``: ``warmup="dense"``
(``samplers/dense.py``) and ``warmup="xla"`` with ChEES
(``samplers/chees.py::chees_adaptation``); ``mesh`` (``parallel/mesh.py``);
ROADMAP section 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels.densities import (
    CallableDensity,
    device_density,
    is_device_density,
)
from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity, fused_linreg_hmc_run
from binf_tpu_torch.ops.kernels.fused_potential import (
    fused_potential_hmc_run,
    fused_warmup_run,
    pack_positions,
    pack_template,
    unpack_draws,
)

__all__ = [
    "FusedModelResult",
    "FusedRegressionResult",
    "auto_block_chains",
    "eager_density",
    "fused_model_hmc",
    "fused_regression_hmc",
]

# the widest chain pool block_chains="auto" picks: the main path's tile
_MAX_AUTO_BLOCK_CHAINS = 16384


class FusedModelResult(NamedTuple):
    samples: dict | None  # unconstrained, (num_samples // thin, C, ...)
    accept_rate: torch.Tensor
    # per chain (C,) (warmup="fused", or "xla" with per_chain_step_size), else scalar
    step_size: torch.Tensor
    # per chain (C, D) (warmup="fused") or shared (D,) (warmup="xla");
    # pack order = sorted names
    inverse_mass: torch.Tensor
    mean: dict | None = None  # Welford moments (collect="moments")
    variance: dict | None = None
    final_positions: dict | None = None  # (C, ...) per leaf
    trajectory_length: torch.Tensor | None = None  # per chain T (trajectory="chees")


class FusedRegressionResult(NamedTuple):
    samples: dict  # constrained: coefficients (S, C, d), precision (S, C)
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    inverse_mass: torch.Tensor  # (d + 1,): coefficients, then log precision


def _introspect(posterior):
    """``(V, y, gamma_prior, gaussian_prior)`` of a Bayesian linear
    regression, by the rules of the JAX package's ``_introspect``
    (``binf_tpu/samplers/fused.py:57-88``): the first likelihood with a
    linear or polynomial forward model and a Gaussian error model, a
    ``GammaPrior`` on the precision and a ``GaussianPrior`` on another
    variable; ``ValueError`` for anything else."""
    from binf_tpu_torch.model.error import GaussianErrorModel
    from binf_tpu_torch.model.forward import LinearForwardModel, PolynomialForwardModel
    from binf_tpu_torch.pdf.priors import GammaPrior, GaussianPrior

    lik = next((l for l in posterior.likelihoods.values()
                if isinstance(getattr(l, "forward_model", None),
                              (LinearForwardModel, PolynomialForwardModel))
                and isinstance(getattr(l, "error_model", None), GaussianErrorModel)), None)
    if lik is None:
        raise ValueError("fused_regression_hmc needs a linear/polynomial forward model "
                         "with a Gaussian error model")
    fwm = lik.forward_model
    V = fwm.design if isinstance(fwm, LinearForwardModel) else fwm.vandermonde
    gamma = next((p for p in posterior.priors.values()
                  if isinstance(p, GammaPrior) and "precision" in p.variables), None)
    gauss = next((p for p in posterior.priors.values()
                  if isinstance(p, GaussianPrior) and p.variable != "precision"), None)
    if gamma is None or gauss is None:
        raise ValueError("need a GammaPrior on precision and a GaussianPrior on the "
                         "coefficients")
    return V, lik.error_model.data, gamma, gauss


def _regression_density(V, y, gamma, gauss, dev) -> LinregDensity:
    return LinregDensity(V.to(dev), y.to(dev), gauss.variances.to(dev),
                         float(gamma.shape_param), float(gamma.rate),
                         prior_mean=gauss.means.to(dev))


def _regression_sample(density, positions, inverse_mass, step_size, seed, *, num_samples,
                       num_leapfrog, host_noise=False, noise=None) -> FusedRegressionResult:
    """The sampling stage: K2 from adapted positions ``{"coefficients": (C,
    d), "precision": (C,)}`` (log precision) and the adapted metric (a dict
    of the same names), with Philox keyed by ``seed``, or the staged
    ``noise`` in the JAX host-noise layout."""
    d = density.d
    q0 = torch.cat([positions["coefficients"], positions["precision"][:, None]], dim=1)
    im = torch.cat([inverse_mass["coefficients"].reshape(d),
                    inverse_mass["precision"].reshape(1)])
    draws, acc = fused_linreg_hmc_run(
        q0, seed, density.V, density.y, density.prior_var, float(density.gamma_shape),
        float(density.gamma_rate), step_size, prior_mean=density.prior_mean, inverse_mass=im,
        num_steps=num_samples, num_leapfrog=num_leapfrog, d=d, block_chains=q0.shape[0],
        steps_per_block=num_samples, host_noise=host_noise, noise=noise, device=q0.device)
    samples = {"coefficients": draws[:, :, :d], "precision": torch.exp(draws[:, :, d])}
    return FusedRegressionResult(samples, acc, step_size, im)


def fused_regression_hmc(
    posterior,
    key,
    n_chains: int = 8192,
    num_warmup: int = 400,
    num_samples: int = 1000,
    num_leapfrog: int = 10,
    initial_step_size: float = 0.05,
    host_noise: bool = False,
    device=None,
) -> FusedRegressionResult:
    """Adaptive warmup, then whole-run sampling in one kernel (K2), on a
    Bayesian linear-regression posterior built with the model DSL.

    The posterior is read as the JAX package reads it: a linear or
    polynomial forward model under a Gaussian error model, a
    ``GammaPrior`` on the precision and a ``GaussianPrior`` on the
    coefficients (anything else raises ``ValueError``).  The chains start
    at the prior mean plus 0.1 x a standard normal, log precision 0; the
    eager Stan-window warmup (``samplers/adaptation.py::window_adaptation``
    over ``samplers/hmc.py``) pools the step size and a diagonal metric
    over all chains; K2 then runs ``num_samples`` steps from the adapted
    state.  Returns constrained draws ``(num_samples, n_chains, ...)``
    (``precision = exp(t)``), the acceptance rate, the step size and the
    metric.

    ``key`` is an int seed or a ``torch.Generator`` (in place of the JAX
    key): the start, the warmup's generator and K2's Philox seed are drawn
    from it.  ``host_noise`` stages K2's noise from a ``torch.Generator``
    instead of Philox.  Runs on the card unless ``device="cpu"``.  The JAX
    function's ``block_chains`` and ``interpret`` are TPU settings (the
    tile of a Pallas grid, the Pallas interpreter) and have no counterpart
    here: K2's result does not depend on any tiling.
    """
    from binf_tpu_torch.samplers.adaptation import window_adaptation
    from binf_tpu_torch.samplers.hmc import hmc

    V, y, gamma, gauss = _introspect(posterior)
    dev = resolve_device(device)
    density = _regression_density(V, y, gamma, gauss, dev)
    d = density.d
    spec = [("coefficients", (d,), d), ("precision", (), 1)]
    logdensity = eager_density(density, spec)

    def builder(step_size, inverse_mass):
        return hmc(logdensity, step_size, num_leapfrog, inverse_mass)

    generator = _generator(key)
    z = torch.randn((n_chains, d), generator=generator, device=generator.device).to(dev)
    positions = {"coefficients": density.prior_mean + 0.1 * z,
                 "precision": torch.zeros(n_chains, device=dev)}
    seed_w, seed_r = _draw_seed(generator), _draw_seed(generator)
    adapt = window_adaptation(builder, builder(initial_step_size, None).init(positions),
                              torch.Generator(device=dev).manual_seed(seed_w),
                              num_steps=num_warmup, initial_step_size=initial_step_size)
    return _regression_sample(density, adapt.final_states.position, adapt.inverse_mass,
                              adapt.step_size, seed_r, num_samples=num_samples,
                              num_leapfrog=num_leapfrog, host_noise=host_noise)


def auto_block_chains(n_chains: int) -> int:
    """``block_chains="auto"``: one warmup pool of all chains up to 16,384,
    else the widest tile of at most 16,384 chains that divides
    ``n_chains``.  The warmup kernel spreads any tile over the whole card,
    and on an H100 it ran fastest with the widest tile (``chip_smoke.py``'s
    sweep of 512, 2,048 and 16,384 chains a tile at 16,384 chains;
    ``PERF.md``).  The JAX package's rule (``fused.py:234-267``) is a VMEM
    cost model of the TPU and is not ported."""
    bc = min(n_chains, _MAX_AUTO_BLOCK_CHAINS)
    while n_chains % bc:
        bc -= 1
    return bc


def _draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))


def _generator(key) -> torch.Generator:
    """``key``: a ``torch.Generator``, or an int seed of a CPU generator."""
    return key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))


def eager_density(logdensity_fn, spec):
    """``logdensity_fn`` as a log density over positions with or without a
    leading chain axis, for the eager samplers: a device density is
    evaluated through its ``potential_and_grad`` on the packed positions;
    any other per-chain scalar callable is mapped over the chain axis with
    ``torch.func.vmap``."""
    name, shape, _ = spec[0]

    def lead(pos):
        x = pos[name]
        return tuple(x.shape[:x.dim() - len(shape)])

    if is_device_density(logdensity_fn):
        def packed(pos):
            batch = lead(pos)
            q = torch.cat([pos[n].reshape(batch + (size,)) for n, _, size in spec], dim=-1)
            return -logdensity_fn.potential_and_grad(q)[0]
        return packed
    mapped = torch.func.vmap(logdensity_fn)
    return lambda pos: mapped(pos) if lead(pos) else logdensity_fn(pos)


def fused_model_hmc(
    logdensity_fn,
    initial_positions: dict,
    key,
    num_warmup: int = 400,
    num_samples: int = 1000,
    num_leapfrog: int = 10,
    initial_step_size: float | None = 0.05,
    block_chains: int | str = "auto",
    per_chain_step_size: bool = False,
    thin: int = 1,
    mesh=None,
    host_noise: bool = False,
    trajectory: str = "fixed",
    max_leapfrog: int = 256,
    collect: str = "draws",
    warmup: str = "xla",
    device=None,
) -> FusedModelResult:
    """Whole-run fused HMC for a model: the sampling phase in one kernel
    (K4), after the eager Stan-window warmup (``warmup="xla"``) or the
    warmup kernel K3 (``warmup="fused"``).

    ``logdensity_fn`` is a per-chain log density over a position dict in
    unconstrained space (wrap constrained variables with
    ``pdf.transforms.transform_logdensity`` first); ``initial_positions``
    is chain-batched, ``(C, ...)`` per variable.  ``key`` is an int seed or
    a ``torch.Generator``; the warmup's and the run's Philox seeds are drawn
    from it.  ``warmup="xla"`` pools dual averaging (or, with
    ``per_chain_step_size``, adapts a step size per chain) and the diagonal
    metric over all chains; ``initial_step_size=None`` starts it with
    ``find_reasonable_step_size``.  ``warmup="fused"`` pools them, and with
    ``trajectory="chees"`` (target acceptance 0.651) the ChEES trajectory
    length, over each ``block_chains`` tile; ``initial_step_size=None``
    starts it with the in-kernel doubling search from 1.0.  Returns
    unconstrained draws (``collect="draws"``, every ``thin``-th step) or
    per-chain Welford moments (``collect="moments"``), the step sizes and
    metric (see :class:`FusedModelResult`), with ChEES the trajectory
    lengths, and the final positions.

    Runs on the card unless ``device="cpu"``.  ``host_noise`` draws the
    sampling kernel's noise from a ``torch.Generator`` instead of Philox.
    ``warmup="dense"``, ``warmup="xla"`` with ChEES and ``mesh`` are not
    ported yet and raise ``NotImplementedError``.
    """
    if warmup == "dense":
        raise NotImplementedError(
            "warmup='dense' adapts a full metric with samplers/dense.py, which is not ported "
            "yet (ROADMAP section 1); use warmup='xla' or 'fused'")
    if warmup not in ("xla", "fused"):
        raise ValueError(f"unknown warmup={warmup!r}; use 'xla', 'dense', or 'fused'")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (chains sharded over devices) comes with parallel/mesh.py, not ported "
            "yet (ROADMAP section 1)")
    if per_chain_step_size and warmup == "fused":
        raise ValueError(
            "per_chain_step_size is not supported with warmup='fused' (the fused "
            "warmup pools dual averaging per chain tile); use warmup='xla'")
    if trajectory not in ("fixed", "chees"):
        raise ValueError(f"unknown trajectory={trajectory!r}; use 'fixed' or 'chees'")
    if warmup == "xla" and trajectory == "chees":
        raise NotImplementedError(
            "warmup='xla' with trajectory='chees' adapts with samplers/chees.py::"
            "chees_adaptation, which is not ported yet (ROADMAP section 1); use "
            "warmup='fused'")
    if collect not in ("draws", "moments"):
        raise ValueError(f"unknown collect={collect!r}")
    if num_samples % thin:
        raise ValueError(f"num_samples={num_samples} must be divisible by thin={thin}")
    dev = resolve_device(device)

    template = {k: v[0] for k, v in initial_positions.items()}
    try:
        density = device_density(logdensity_fn, template)
    except NotImplementedError:
        if dev.type == "cuda":
            raise
        # the plain versions run any callable on the CPU
        density = CallableDensity(logdensity_fn, template)
    if isinstance(density, torch.nn.Module):
        density = density.to(dev)
    spec = pack_template(template)
    q0 = pack_positions({k: torch.as_tensor(v).to(dev, torch.float32)
                         for k, v in initial_positions.items()}, spec)
    n_chains = q0.shape[0]

    if block_chains == "auto":
        block_chains = auto_block_chains(n_chains)
    bc = min(block_chains, n_chains)
    while n_chains % bc:
        bc -= 1
    spb = min(max(50, thin), num_samples)
    while num_samples % spb or spb % thin:
        spb -= 1

    generator = _generator(key)
    seed_w, seed_r = _draw_seed(generator), _draw_seed(generator)

    chees = trajectory == "chees"
    if warmup == "xla":
        return _eager_warmup_run(
            logdensity_fn, density, spec, q0, seed_w, seed_r, num_warmup=num_warmup,
            num_samples=num_samples, num_leapfrog=num_leapfrog,
            initial_step_size=initial_step_size, per_chain_step_size=per_chain_step_size,
            block_chains=bc, steps_per_block=spb, host_noise=host_noise, thin=thin,
            collect=collect, dev=dev)
    warm = fused_warmup_run(
        density, q0, seed_w, 1.0 if initial_step_size is None else float(initial_step_size),
        num_warmup=num_warmup, num_leapfrog=num_leapfrog, block_chains=bc,
        host_noise=host_noise, target_accept=0.651 if chees else 0.8,
        init_search=initial_step_size is None, trajectory=trajectory,
        max_leapfrog=max_leapfrog, device=dev)
    qw, eps, im = warm[:3]
    T = warm[3] if chees else None
    res = fused_potential_hmc_run(
        density, qw, seed_r, eps, im, num_steps=num_samples, num_leapfrog=num_leapfrog,
        block_chains=bc, steps_per_block=spb, host_noise=host_noise, thin=thin,
        collect=collect, trajectory=trajectory, max_leapfrog=max_leapfrog,
        traj_length=T, device=dev)
    moments = collect == "moments"
    return FusedModelResult(
        samples=None if moments else unpack_draws(res.draws, spec),
        accept_rate=res.accept_rate,
        step_size=eps,
        inverse_mass=im,
        mean=unpack_draws(res.mean, spec) if moments else None,
        variance=unpack_draws(res.variance, spec) if moments else None,
        final_positions=unpack_draws(res.final_positions, spec),
        trajectory_length=T,
    )


def _eager_warmup_run(logdensity_fn, density, spec, q0, seed_w, seed_r, *, num_warmup,
                      num_samples, num_leapfrog, initial_step_size, per_chain_step_size,
                      block_chains, steps_per_block, host_noise, thin, collect, dev):
    """``warmup="xla"``: the eager window adaptation over every chain
    (``fused.py:839-863`` of the JAX package), then K4 with the adapted step
    size (pooled, or per chain) and the pooled metric.  The warmup steps
    the device density K4 runs, which lies on ``dev`` wherever the caller's
    model holds its data; a callable with no device density (CPU only) is
    stepped as given."""
    from binf_tpu_torch.samplers.adaptation import window_adaptation
    from binf_tpu_torch.samplers.hmc import hmc

    batched = eager_density(density if is_device_density(density) else logdensity_fn, spec)

    def builder(step_size, inverse_mass):
        return hmc(batched, step_size, num_leapfrog, inverse_mass)

    positions = unpack_draws(q0, spec)
    states = builder(1.0 if initial_step_size is None else initial_step_size,
                     None).init(positions)
    adapt = window_adaptation(builder, states, torch.Generator(device=dev).manual_seed(seed_w),
                              num_steps=num_warmup, initial_step_size=initial_step_size,
                              per_chain=per_chain_step_size)
    qw = pack_positions(adapt.final_states.position, spec)
    im = pack_positions({k: v[None] for k, v in adapt.inverse_mass.items()}, spec)[0]
    eps = torch.broadcast_to(adapt.step_size.reshape(-1), (qw.shape[0],))
    res = fused_potential_hmc_run(
        density, qw, seed_r, eps, im, num_steps=num_samples, num_leapfrog=num_leapfrog,
        block_chains=block_chains, steps_per_block=steps_per_block, host_noise=host_noise,
        thin=thin, collect=collect, device=dev)
    moments = collect == "moments"
    return FusedModelResult(
        samples=None if moments else unpack_draws(res.draws, spec),
        accept_rate=res.accept_rate,
        step_size=adapt.step_size,
        inverse_mass=im,
        mean=unpack_draws(res.mean, spec) if moments else None,
        variance=unpack_draws(res.variance, spec) if moments else None,
        final_positions=unpack_draws(res.final_positions, spec),
    )
