"""The user's routes to the fused whole-run kernels (port of
``binf_tpu/samplers/fused.py``).

:func:`fused_regression_hmc` reads a Bayesian linear-regression posterior
through the model DSL (``_introspect``), adapts with the eager Stan-window
warmup and samples inside one kernel (K2, ``fused_linreg_hmc_run``).

:func:`fused_model_hmc` packs chain-batched positions, adapts, and samples
inside one kernel (K4, ``fused_potential_hmc_run``), then unpacks.  With
``warmup="fused"`` the adaptation is a kernel too (K3,
``fused_warmup_run``); with ``warmup="xla"`` (the JAX package's default) it
is an eager warmup over the whole chain batch, the counterpart of the JAX
package's XLA path: the Stan-window warmup (``samplers/adaptation.py::
window_adaptation`` over ``samplers/hmc.py``), or with ``trajectory=
"chees"`` the ChEES warmup (``samplers/chees.py::chees_adaptation``); with
``warmup="dense"`` it is the eager dense-metric warmup
(``samplers/dense.py::dense_window_adaptation``) and K4 samples with the
``(D, D)`` metric.  On the card the kernels run the log density's device
density (``ops/kernels/densities.py::device_density``): a device density
itself, a posterior of a family with a hand-written functor, or the
``TracedDensity`` the density compiler makes of any other callable; a
callable the compiler refuses raises there, with the compiler's reason
(``not tile-compilable: ...``).  On the CPU (``device="cpu"``) any callable
runs through the plain versions, with its gradient from ``torch.func``.
With ``mesh=`` (``parallel/mesh.py``) each rank runs its rows of the
chains: the kernels on every shard with ``seed + r`` for shard ``r``, an
eager warmup pooled over the mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels.densities import (
    CallableDensity,
    TracedDensity,
    device_density,
    is_device_density,
    recognise,
)
from binf_tpu_torch.ops.kernels.fused_hmc import LinregDensity, fused_linreg_hmc_run
from binf_tpu_torch.ops.kernels.fused_potential import (
    fused_potential_hmc_run,
    fused_warmup_run,
    pack_positions,
    pack_template,
    refuse,
    unpack_draws,
)

__all__ = [
    "FusedModelResult",
    "FusedRegressionResult",
    "auto_block_chains",
    "eager_density",
    "eager_logdensity",
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
    # per chain (C, D) (warmup="fused"), shared (D,) (warmup="xla") or dense
    # (D, D) (warmup="dense"); pack order = sorted names
    inverse_mass: torch.Tensor
    mean: dict | None = None  # Welford moments (collect="moments")
    variance: dict | None = None
    final_positions: dict | None = None  # (C, ...) per leaf
    # T with trajectory="chees": per chain (warmup="fused") or one (warmup="xla")
    trajectory_length: torch.Tensor | None = None


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
    """A kernel seed from ``generator``, drawn on the generator's own device
    (a card generator cannot draw a CPU tensor)."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator, device=generator.device))


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


def eager_logdensity(logdensity_fn, template: dict, dev):
    """``logdensity_fn`` (per chain, unconstrained) as a chain-batched log
    density for the eager samplers on ``dev``: the closed form of its
    device density where it has one (faster than a traced callable), else
    the callable mapped over the chains."""
    density = recognise(logdensity_fn, template)
    if density is None:
        return eager_density(logdensity_fn, pack_template(template))
    if isinstance(density, torch.nn.Module):
        density = density.to(dev)
    return eager_density(density, pack_template(template))


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
    density=None,
) -> FusedModelResult:
    """Whole-run fused HMC for a model: the sampling phase in one kernel
    (K4), after an eager warmup over all chains (``warmup="xla"`` or
    ``"dense"``) or the warmup kernel K3 (``warmup="fused"``).

    ``logdensity_fn`` is a per-chain log density over a position dict in
    unconstrained space (wrap constrained variables with
    ``pdf.transforms.transform_logdensity`` first); ``initial_positions``
    is chain-batched, ``(C, ...)`` per variable.  ``key`` is an int seed or
    a ``torch.Generator``; the warmup's and the run's seeds are drawn from
    it.

    - ``warmup="xla"`` pools dual averaging (or, with
      ``per_chain_step_size``, adapts a step size per chain) and the
      diagonal metric over all chains; ``initial_step_size=None`` starts it
      with ``find_reasonable_step_size``.  With ``trajectory="chees"`` it is
      the eager ChEES warmup (target acceptance 0.651; a ``None`` start is
      0.1), and K4 jitters its trajectories around the adapted T.
    - ``warmup="dense"`` adapts a full ``(D, D)`` metric in the same
      windows (a ``None`` start is 0.1); K4 then draws ``p = W z`` and
      moves by ``M^-1 p``.  It needs ``trajectory="fixed"`` and a pooled
      step size.
    - ``warmup="fused"`` pools them, and with ``trajectory="chees"`` (target
      acceptance 0.651) the ChEES trajectory length, over each
      ``block_chains`` tile; ``initial_step_size=None`` starts it with the
      in-kernel doubling search from 1.0.

    Returns unconstrained draws (``collect="draws"``, every ``thin``-th
    step) or per-chain Welford moments (``collect="moments"``), the step
    sizes and metric (see :class:`FusedModelResult`; the metric is
    ``(D, D)`` with ``warmup="dense"``), with ChEES the trajectory
    length(s), and the final positions.

    Runs on the card unless ``device="cpu"``.  ``host_noise`` draws the
    sampling kernel's noise from a ``torch.Generator`` instead of Philox.
    ``density``: the device density of ``logdensity_fn`` where the caller
    has built it (``adaptive_hmc`` passes the router's), else it is built
    here (``device_density``).

    ``mesh``: the chains are sharded over it (``parallel/mesh.py``); every
    rank passes the same global positions (or ``DTensor``\\ s) and key.
    Shard ``r`` runs K4, and with ``warmup="fused"`` K3, on its rows with
    the warmup and run seeds plus ``r``, the JAX package's ``seed +
    axis_index("chain")``; ``block_chains`` tiles the rank's rows.  The
    eager warmups pool their statistics over the mesh (one generator on
    every rank), K3 pools per tile as without a mesh.  The accept rate is
    averaged over the mesh; draws, moments, final positions and the
    per-chain step sizes, metrics and T come back as ``DTensor``\\ s.
    """
    if warmup not in ("xla", "fused", "dense"):
        raise ValueError(f"unknown warmup={warmup!r}; use 'xla', 'dense', or 'fused'")
    if per_chain_step_size and warmup == "fused":
        raise ValueError(
            "per_chain_step_size is not supported with warmup='fused' (the fused "
            "warmup pools dual averaging per chain tile); use warmup='xla'")
    if per_chain_step_size and warmup == "dense":
        raise ValueError("per_chain_step_size is not supported with warmup='dense' (the "
                         "dense metric is pooled across chains)")
    if trajectory not in ("fixed", "chees"):
        raise ValueError(f"unknown trajectory={trajectory!r}; use 'fixed' or 'chees'")
    if warmup == "dense" and trajectory != "fixed":
        raise ValueError("warmup='dense' requires trajectory='fixed'")
    if collect not in ("draws", "moments"):
        raise ValueError(f"unknown collect={collect!r}")
    if num_samples % thin:
        raise ValueError(f"num_samples={num_samples} must be divisible by thin={thin}")
    dev = resolve_device(device)
    rank = _rank_index(mesh)
    from binf_tpu_torch.parallel.mesh import local_rows

    density, spec, q0 = _prepare(logdensity_fn, local_rows(initial_positions, mesh), dev,
                                 density)
    bc = _block_chains(block_chains, q0.shape[0])
    spb = _steps_per_block(num_samples, thin)

    generator = _generator(key)
    seed_w, seed_r = _draw_seed(generator), _draw_seed(generator)
    adapted = _adapt(warmup, logdensity_fn, density, spec, q0, seed_w, num_warmup=num_warmup,
                    num_leapfrog=num_leapfrog, initial_step_size=initial_step_size,
                    per_chain_step_size=per_chain_step_size, block_chains=bc,
                    host_noise=host_noise, trajectory=trajectory, max_leapfrog=max_leapfrog,
                    dev=dev, mesh=mesh)
    res = fused_potential_hmc_run(
        density, adapted.positions, seed_r + rank, adapted.step_size, adapted.inverse_mass,
        num_steps=num_samples, num_leapfrog=num_leapfrog, block_chains=bc, steps_per_block=spb,
        host_noise=host_noise, thin=thin, collect=collect, dense_mass=adapted.dense,
        trajectory=trajectory, max_leapfrog=max_leapfrog,
        traj_length=adapted.trajectory_length, device=dev)
    moments = collect == "moments"
    out = FusedModelResult(
        samples=None if moments else unpack_draws(res.draws, spec),
        accept_rate=res.accept_rate,
        step_size=adapted.step_size,
        inverse_mass=adapted.inverse_mass,
        mean=unpack_draws(res.mean, spec) if moments else None,
        variance=unpack_draws(res.variance, spec) if moments else None,
        final_positions=unpack_draws(res.final_positions, spec),
        trajectory_length=adapted.trajectory_length,
    )
    return out if mesh is None else _shard_result(out, mesh, warmup == "fused",
                                                  per_chain_step_size)


def _rank_index(mesh) -> int:
    """This rank's flat index in the mesh: its shard's seed offset."""
    if mesh is None:
        return 0
    from binf_tpu_torch.parallel.mesh import mesh_axis

    return mesh_axis(mesh)[1]


def _shard_result(res: FusedModelResult, mesh, per_chain_metric: bool,
                  per_chain_step: bool) -> FusedModelResult:
    """A shard's :class:`FusedModelResult` as the mesh's: chain-axis
    fields as ``DTensor``\\ s, the accept rate averaged over the mesh."""
    from binf_tpu_torch.parallel.collectives import pooled_mean
    from binf_tpu_torch.parallel.mesh import shard_rows

    def per_chain(x, yes):
        return shard_rows(x, mesh) if yes and x is not None else x

    return res._replace(
        samples=shard_rows(res.samples, mesh, dim=1),
        accept_rate=pooled_mean(res.accept_rate, mesh),
        step_size=per_chain(res.step_size, per_chain_metric or per_chain_step),
        inverse_mass=per_chain(res.inverse_mass, per_chain_metric),
        mean=shard_rows(res.mean, mesh), variance=shard_rows(res.variance, mesh),
        final_positions=shard_rows(res.final_positions, mesh),
        trajectory_length=per_chain(res.trajectory_length, per_chain_metric))


def _prepare(logdensity_fn, initial_positions: dict, dev, density=None):
    """The device density of ``logdensity_fn`` on ``dev`` (``density`` if
    given; on the card else ``device_density``, which compiles a callable
    of no recognised family; on the CPU a recognised density, else the
    callable itself), the pack spec, and the packed float32 start ``(C,
    D)``."""
    template = {k: v[0] for k, v in initial_positions.items()}
    if density is None and dev.type == "cuda":
        # the compiler's refusal raises here, before any build
        density = device_density(logdensity_fn, template)
    elif density is None:
        # the plain versions run any callable on the CPU
        density = recognise(logdensity_fn, template)
        if density is None:
            density = CallableDensity(logdensity_fn, template)
    if dev.type == "cuda":
        # before any warmup: a density K3 and K4 refuse raises here, with
        # the reason the router gives (fused_potential.kernel_refusal)
        refuse(density)
    if isinstance(density, torch.nn.Module):
        density = density.to(dev)
    spec = pack_template(template)
    q0 = pack_positions({k: torch.as_tensor(v).to(dev, torch.float32)
                         for k, v in initial_positions.items()}, spec)
    return density, spec, q0


def _block_chains(block_chains, n_chains: int) -> int:
    """``block_chains`` (``"auto"`` or an int) lowered to a divisor of C."""
    if block_chains == "auto":
        block_chains = auto_block_chains(n_chains)
    bc = min(block_chains, n_chains)
    while n_chains % bc:
        bc -= 1
    return bc


def _steps_per_block(num_steps: int, thin: int) -> int:
    """The JAX package's kernel grid step (``fused.py:364-366``): at most
    ``max(50, thin)``, dividing ``num_steps`` and divisible by ``thin``.
    K4's Philox counter reads it only through ``block_offset``."""
    spb = min(max(50, thin), num_steps)
    while num_steps % spb or spb % thin:
        spb -= 1
    return spb


class _Adapted(NamedTuple):
    """What a warmup hands K4: warmed positions ``(C, D)``, the step size
    (scalar pooled, or ``(C,)``), the metric (``(D,)`` pooled, ``(C, D)``
    per chain, or ``(D, D)`` dense), the trajectory length with ChEES, and
    whether the metric is dense."""

    positions: torch.Tensor
    step_size: torch.Tensor
    inverse_mass: torch.Tensor
    trajectory_length: torch.Tensor | None
    dense: bool


def _adapt(warmup: str, logdensity_fn, density, spec, q0: torch.Tensor, seed_w: int, *,
          num_warmup: int, num_leapfrog: int, initial_step_size, per_chain_step_size: bool,
          block_chains: int, host_noise: bool, trajectory: str, max_leapfrog: int,
          dev, mesh=None) -> _Adapted:
    """One warmup of ``fused_model_hmc`` (and ``parallel/production.py::
    run_fused_blocks``) from the packed start ``q0``: K3 (``"fused"``), or
    an eager warmup over every chain on ``dev`` (``"xla"``: the Stan
    windows or, with ChEES, ``chees_adaptation``; ``"dense"``: the dense
    windows) with a generator seeded by ``seed_w``.  The eager warmups step
    the device density K4 runs, which lies on ``dev`` wherever the caller's
    model holds its data; a callable with no closed form (a traced density,
    or any callable on the CPU) is stepped as given.  With a mesh, ``q0`` is this rank's rows: K3 runs on
    them with ``seed_w`` plus the rank's index, an eager warmup pools over
    the mesh from the same ``seed_w`` on every rank."""
    chees = trajectory == "chees"
    if warmup == "fused":
        warm = fused_warmup_run(
            density, q0, seed_w + _rank_index(mesh),
            1.0 if initial_step_size is None else float(initial_step_size),
            num_warmup=num_warmup, num_leapfrog=num_leapfrog, block_chains=block_chains,
            host_noise=host_noise, target_accept=0.651 if chees else 0.8,
            init_search=initial_step_size is None, trajectory=trajectory,
            max_leapfrog=max_leapfrog, device=dev)
        return _Adapted(warm[0], warm[1], warm[2], warm[3] if chees else None, False)

    # a traced density's plain version is torch.func on the callable itself
    closed_form = is_device_density(density) and not isinstance(density, TracedDensity)
    batched = eager_density(density if closed_form else logdensity_fn, spec)
    positions = unpack_draws(q0, spec)
    generator = torch.Generator(device=dev).manual_seed(seed_w)
    start = 0.1 if initial_step_size is None else float(initial_step_size)
    if warmup == "dense":
        from binf_tpu_torch.samplers.dense import _dense_window_adaptation

        a = _dense_window_adaptation(batched, positions, generator, num_steps=num_warmup,
                                     num_integration_steps=num_leapfrog,
                                     initial_step_size=start, mesh=mesh)
        return _Adapted(pack_positions(a.final_positions, spec), a.step_size,
                       a.inverse_mass_matrix, None, True)
    if chees:
        from binf_tpu_torch.samplers.chees import _chees_adaptation

        c = _chees_adaptation(batched, positions, generator, num_steps=num_warmup,
                              initial_step_size=start, max_leapfrog=max_leapfrog, mesh=mesh)
        im = pack_positions({k: v[None] for k, v in c.inverse_mass.items()}, spec)[0]
        return _Adapted(pack_positions(c.final_positions, spec), c.step_size, im,
                       c.trajectory_length, False)

    from binf_tpu_torch.samplers.adaptation import _window_adaptation
    from binf_tpu_torch.samplers.hmc import hmc

    def builder(step_size, inverse_mass):
        return hmc(batched, step_size, num_leapfrog, inverse_mass)

    states = builder(1.0 if initial_step_size is None else initial_step_size,
                     None).init(positions)
    w = _window_adaptation(builder, states, generator, num_steps=num_warmup,
                           initial_step_size=initial_step_size,
                           per_chain=per_chain_step_size, mesh=mesh)
    im = pack_positions({k: v[None] for k, v in w.inverse_mass.items()}, spec)[0]
    return _Adapted(pack_positions(w.final_states.position, spec), w.step_size, im, None, False)

