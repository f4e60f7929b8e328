"""Routing between the fused kernels and the eager path (port of
``binf_tpu/samplers/auto.py``).

The port has two ways to run adaptive HMC on a model:

* the fused path (``samplers/fused.py::fused_model_hmc``): the sampling
  run in one kernel (K4), after an eager or fused warmup; on the card it
  runs the model's device density (``ops/kernels/densities.py::
  device_density``): a hand-written CUDA functor for the six families, and
  for any other log density the functor the density compiler emits
  (``ops/kernels/density_compiler.py``, a ``TracedDensity``);
* the eager path (``parallel/runner.py::warmup_and_run`` over
  ``samplers/hmc.py``), the counterpart of the JAX package's XLA path: any
  PyTorch log density, the whole chain batch stepped by PyTorch calls.

:func:`route_algorithm` takes the fused path when the model has a device
density that K3 and K4 take (``fused_potential.kernel_refusal``: a unit at
its dimension, operands within the kernels' shared memory), and the eager
path when the compiler refuses the density before any build (``not
tile-compilable:``, the JAX router's rule 1) or the kernels refuse it, at
every chain count.  The card measured the fused route ahead of the eager
one at every size it ran: 2,048 and 8,192 chains on the hierarchical
posterior (hand-written functor), and the traced densities of
``chip_smoke.py``'s ``traced_path``.  The JAX package's rules 2-4 weigh TPU
measurements (the chains per device, the padded state width, a VMEM
budget, ``auto.py:65-175``); none of them carries over to the card, and a
rule of speed comes here only with an H100 measurement behind it.  The
rule does not depend on the device, so it holds on the CPU too.
:func:`adaptive_hmc` runs the chosen path with one result contract.
:func:`route_trajectory_sampler` weighs a request for NUTS against
fixed-L HMC by the card's own measurement (``chip_smoke.py``'s
``nuts_path`` and ``samplers_path``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from binf_tpu_torch._device import resolve_device
from binf_tpu_torch.ops.kernels.densities import TracedDensity, device_density
from binf_tpu_torch.ops.kernels.fused_potential import kernel_refusal, wide_warps
from binf_tpu_torch.ops.tree import tree_leaves
from binf_tpu_torch.samplers.fused import (
    FusedModelResult,
    auto_block_chains,
    eager_logdensity,
    fused_model_hmc,
)

__all__ = ["RoutingDecision", "adaptive_hmc", "route_algorithm", "route_trajectory_sampler"]

# What route_trajectory_sampler's rule rests on, measured by chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (nuts_path: the
# hierarchical posterior, D = 21, 2,048 chains after 100 eager warmup
# steps, stepped on the eager samplers through torch.func as a density
# with no CUDA functor is stepped (at 8 groups it has one now, and the
# router sends it to K3/K4; nuts_path keeps measuring it eagerly, as the
# basis for densities with no functor), and the chromatin posterior in
# Gram form, no functor for K3/K4, at 64 beads and 2,048 chains and at
# 2,048 beads and 16 chains, each after 100 eager warmup steps;
# samplers_path: eager NUTS on the logistic posterior at 4,096 chains
# against its fused route at 8,192).  ESS/s is the min bulk ESS over the run's wall seconds, ESS per
# gradient over the gradients the chains took; NUTS at max_doublings 8,
# the CLI's.
NUTS_MEASUREMENT = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "hmc_ess_per_s": 3332.0,  # fixed-L10 HMC, 183.2 ms a step, 40 steps
    "nuts_ess_per_s": 1801.6,  # NUTS D = 8, 1,203.2 ms a step, 20 steps
    "logistic_ratio": 71.08,  # the fused route's ESS/s over eager NUTS's
    # beads: (HMC ESS/s, NUTS ESS/s, HMC ESS per gradient, NUTS ESS per
    # gradient, NUTS gradients a chain and step)
    "chromatin": {64: (1448.7, 256.2, 3.01e-3, 8.64e-4, 208.0),
                  2048: (5.242, 1.469, 2.60e-3, 7.35e-4, 255.0)},
}


class RoutingDecision(NamedTuple):
    """The router's decision.

    ``path``: ``"fused"`` or ``"xla"`` (the eager path); ``reason``: the
    rule that fired (stable prefixes: ``"device density:"``, ``"not
    tile-compilable:"``, ``"device density refused by the kernels"``,
    ``"forced algorithm="``); ``d`` and ``d_pad``: the flat state
    dimension, equal because the port pads nothing; ``n_local_chains``: the
    chains (one card); ``sequential``: always ``False`` (a Python loop
    unrolls in the traced graph, and the route does not depend on it);
    ``block_chains``: the fused path's
    warmup tile (``auto_block_chains``), ``None`` on the eager path."""

    path: str
    reason: str
    d: int
    d_pad: int
    n_local_chains: int
    sequential: bool
    block_chains: int | None


def route_algorithm(logdensity_fn, initial_positions: dict, mesh=None) -> RoutingDecision:
    """``"fused"`` when ``logdensity_fn`` has a device density that K3 and
    K4 take, else ``"xla"``, the eager path, at every chain count.  A log
    density of no recognised family is compiled (``density_compiler``); one
    the compiler refuses before any build (an op with no lowering rule,
    data-dependent control flow, a graph past its node cap, more than
    ``density_compiler.MAX_D_WIDE`` = 4,096 coordinates) routes eagerly
    with a reason that begins ``not tile-compilable:`` and names what it
    refused, as the JAX package routes
    a density that is not tile-compilable to XLA (its rule 1).  A device
    density the kernels refuse (``kernel_refusal``: no unit at its
    dimension, or operands past the kernels' shared memory, e.g. the
    polynomial posterior at 5,000 points, 25,008 floats against 12,288)
    routes eagerly with the refusal as its reason.  The JAX package routes
    data past its VMEM budget to XLA by a TPU cost model
    (``binf_tpu/samplers/auto.py::_data_heavy``); the port routes on the
    limits its own kernels check.

    The JAX package sends the hierarchical posterior to XLA past 2,048
    chains a device from a TPU v5e measurement (``binf_tpu/samplers/
    auto.py:65-110``); that rule does not carry over.  On the card
    (``chip_smoke.py``'s ``hierarchical_path``, NVIDIA H100 80GB HBM3,
    700.00 W) the fused route (K3 and K4, 400 + 500 steps, L = 10) ran
    the hierarchical posterior of 8 groups at 3.94e6 ESS/s at 8,192
    chains (50.1 ms a run) and 9.56e5 at 2,048 (48.5 ms), min bulk ESS
    over every coordinate; eager adaptive HMC over the same closed-form
    potential, cut to 100 + 40 steps, ran at 6.50e3 and 1.55e3 (11.5 and
    10.6 s a run): the fused route led ~600x at both.  The same holds past
    32 coordinates, where the density compiler's wide form runs in K3's
    and K4's wide branches (a group of warps a chain): the JAX router takes
    the hierarchical posterior of 32 groups (D = 69) fused at 1,024 chains
    and sends it to XLA at 8,192 by its rule 4 (d_pad 72 > 8); the port
    keeps it fused at both (``chip_smoke.py``'s ``wide_path`` measures both
    beside an eager run).  Past 256 coordinates the JAX router's VMEM model
    (``_data_heavy``: d_pad + c_tot against its budget at a floor tile of
    min(512, max(chains, 128)) lanes) fuses the hierarchical posterior of
    128 groups (D = 261) at 128 chains and sends it to XLA at 512; the
    port's kernels keep a chain's state in shared memory, not in a tile, so
    it stays fused at both (``chip_smoke.py``'s ``wider_path``).

    With a mesh the decision is taken at the per-rank chain count
    ``n_local`` (``n_local_chains``, and the fused tile), as the JAX
    package decides per device.  A density the compiler takes is traced on
    the positions' device, where its data must lie (``adaptive_hmc``
    traces on its ``device``)."""
    return _route(logdensity_fn, initial_positions, mesh)[0]


def _route(logdensity_fn, initial_positions: dict, mesh=None, device=None):
    """:func:`route_algorithm`'s decision and the device density it built
    (None where there is none), which the fused run then takes.  The
    density is traced on ``device`` where the run's device is given (the
    positions' device otherwise)."""
    from binf_tpu_torch.parallel.mesh import local_rows

    initial_positions = local_rows(initial_positions, mesh)
    n_chains = tree_leaves(initial_positions)[0].shape[0]
    template = {k: v[0] if device is None else torch.as_tensor(v[0]).to(device)
                for k, v in initial_positions.items()}
    d = sum(torch.as_tensor(v).numel() for v in template.values())
    try:
        density = device_density(logdensity_fn, template)
    except NotImplementedError as e:
        return RoutingDecision("xla", f"{_refusal_reason(e)}; it runs on the eager path "
                               "(warmup_and_run)", d, d, n_chains, False, None), None
    refused = kernel_refusal(density)
    if refused is not None:
        return RoutingDecision("xla", f"{refused}; it runs on the eager path (warmup_and_run)",
                               d, d, n_chains, False, None), density
    return RoutingDecision(
        "fused", f"device density: {_density_name(density)} runs in the fused kernels",
        d, d, n_chains, False, auto_block_chains(n_chains)), density


def _refusal_reason(e: Exception) -> str:
    """The density compiler's refusal without the guidance after it."""
    return getattr(e, "reason", str(e))


def _density_name(density) -> str:
    if isinstance(density, TracedDensity):
        form = (f"its wide form, {wide_warps(density.D)} warp(s) a chain" if density.wide
                else "one lane a chain")
        return (f"TracedDensity (the functor {density.compiled.kernel_name} the density "
                f"compiler emitted, {density.compiled.nodes} nodes, D = {density.D}, {form})")
    return type(density).__name__


def route_trajectory_sampler(requested: str, logdensity_fn,
                             initial_positions: dict) -> tuple[str, str]:
    """``(sampler, reason)`` for a request of trajectory sampler: anything
    but ``"nuts"`` passes unchanged; NUTS is rerouted to fixed-L HMC when
    the density has a device density that K3 and K4 take (reason ``"...
    device density: ..."``: K4 then runs fixed-L HMC over it in one kernel;
    the hierarchical posterior at 2 to 16 groups is one; a density the
    kernels refuse, ``kernel_refusal``, is weighed as one with no functor),
    and otherwise when the card's
    measurement put eager fixed-L HMC ahead of eager NUTS in ESS per
    second; else it is honoured.  Callers that must honour the literal
    request skip this router.

    The measurement (``NUTS_MEASUREMENT``, ``chip_smoke.py``'s ``nuts_path``
    and ``samplers_path`` on an NVIDIA H100 80GB HBM3 at 700.00 W), the
    basis for densities with no functor: on the hierarchical posterior at
    2,048 chains, stepped eagerly as such a density is (through
    ``torch.func``, not through its functor), fixed-L10 HMC took 183.2 ms a
    step for 3,332 ESS/s; NUTS at ``max_doublings`` 8 took 1,203.2 ms a
    step (depth q50 3, q90 4, max 6; 9.7 leapfrogs a chain but 58.2 in
    lockstep) for 1,802 ESS/s; NUTS capped at 4 took 288.3 ms a step
    (depth q50 3, q90 4; 9.2 leapfrogs a chain, 15 in lockstep) for 5,617
    ESS/s.  The card sat idle ~95% of every eager step: a leapfrog is ~18
    ms of PyTorch calls on the host.  The rule weighs the request as the
    CLI makes it, NUTS at 8 doublings.  On the logistic posterior the
    fused route (K3 and K4) gave 71x the ESS/s of eager NUTS.

    No gradient-scarce branch.  The reference honours NUTS where a
    gradient is the scarce resource, a data-heavy density
    (``binf_tpu/samplers/auto.py:198-224``).  The chromatin posterior's
    gradient reads two (N, N) restraint matrices a chain, the costliest
    of the repo's densities with no functor, and fixed-L10 HMC led there
    too: 1,449 against 256 ESS/s (42.6 against 1,437.0 ms a step) and
    3.0e-3 against 8.6e-4 ESS per gradient at 64 beads and 2,048 chains,
    5.24 against 1.47 ESS/s (79.2 against 2,042.1 ms a step) and 2.6e-3
    against 7.4e-4 ESS per gradient at 2,048 beads and 16 chains (after
    100 warmup steps; HMC 40 steps, NUTS 10, so NUTS's ESS rests on 10
    draws a chain).  NUTS ran to its 8-doubling cap (208 and 255 gradients
    a chain and step): the stiff restraint springs bound the step, and
    the slow modes never turn the trajectory back.  So the measurement
    shows no gradient-scarce branch is needed: NUTS on a density with no
    functor is rerouted whatever its gradient costs.
    """
    if requested != "nuts":
        return requested, f"requested {requested!r} (no reroute rule)"
    template = {k: v[0] for k, v in initial_positions.items()}
    m = NUTS_MEASUREMENT
    compile_refusal = None
    try:
        density = device_density(logdensity_fn, template)
    except NotImplementedError as e:
        density, compile_refusal = None, _refusal_reason(e)
    refused = None if density is None else kernel_refusal(density)
    if density is not None and refused is None:
        why = "" if m is None else (
            f"; on the card the fused logistic route gave {m['logistic_ratio']:.3g}x the "
            f"ESS/s of eager NUTS ({m['card']}, chip_smoke.py samplers_path)")
        return "hmc", (f"nuts rerouted to fixed-L HMC: device density: "
                       f"{_density_name(density)} runs fixed-L HMC in one kernel (K4){why}")
    lack = f"no device density ({compile_refusal})" if refused is None else refused
    if m is not None and m["hmc_ess_per_s"] > m["nuts_ess_per_s"]:
        return "hmc", (
            f"nuts rerouted to fixed-L HMC: {lack}, and eager fixed-L10 HMC "
            f"measured {m['hmc_ess_per_s']:.4g} ESS/s against eager NUTS's "
            f"{m['nuts_ess_per_s']:.4g} on the hierarchical posterior ({m['card']}, "
            f"chip_smoke.py nuts_path)")
    why = "no measurement" if m is None else (
        f"eager NUTS measured {m['nuts_ess_per_s']:.4g} ESS/s against fixed-L10 HMC's "
        f"{m['hmc_ess_per_s']:.4g} on the hierarchical posterior ({m['card']})")
    return "nuts", f"nuts honored: {lack} ({why})"


def adaptive_hmc(
    logdensity_fn,
    initial_positions: dict,
    key,
    num_warmup: int = 400,
    num_samples: int = 1000,
    num_leapfrog: int = 10,
    initial_step_size: float | None = 0.05,
    thin: int = 1,
    mesh=None,
    collect: str = "draws",
    algorithm: str = "auto",
    target_accept: float = 0.8,
    device=None,
    **fused_kwargs: Any,
) -> tuple[FusedModelResult, RoutingDecision]:
    """Adaptive HMC on the path :func:`route_algorithm` picks.

    ``algorithm="auto"`` applies the router; ``"fused"`` or ``"xla"`` force
    a path.  Both paths warm up in Stan's windows (pooled dual averaging,
    a diagonal metric) and then take ``num_samples`` fixed-trajectory HMC
    steps; both return a :class:`~binf_tpu_torch.samplers.fused.
    FusedModelResult` in unconstrained space, with the decision.
    ``collect="moments"`` returns per-chain means and variances (ddof 1)
    instead of draws: K4's Welford moments on the fused path, a reduction
    over the stored draws on the eager path.

    Other keyword arguments (``warmup=``, ``block_chains=``,
    ``trajectory=``, ...) go to ``fused_model_hmc`` and raise if the run
    takes the eager path.  ``key`` is an int seed or a ``torch.Generator``;
    the eager path's generator lies on ``device``.  Runs on the card unless
    ``device="cpu"``.
    """
    if algorithm not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown algorithm={algorithm!r}; use 'auto', 'fused', or 'xla'")
    decision, density = _route(logdensity_fn, initial_positions, mesh, resolve_device(device))
    if algorithm != "auto":
        decision = decision._replace(path=algorithm, reason=f"forced algorithm={algorithm!r}")

    if decision.path == "fused":
        block_chains = fused_kwargs.pop("block_chains", decision.block_chains or "auto")
        result = fused_model_hmc(
            logdensity_fn, initial_positions, key, num_warmup=num_warmup,
            num_samples=num_samples, num_leapfrog=num_leapfrog,
            initial_step_size=initial_step_size, thin=thin, mesh=mesh, collect=collect,
            block_chains=block_chains, device=device, density=density, **fused_kwargs)
        return result, decision

    if fused_kwargs:
        raise ValueError(
            f"options {sorted(fused_kwargs)} apply to the fused path only, but this run "
            f"routed to the eager path ({decision.reason}); drop them or force "
            "algorithm='fused'")
    result = _xla_adaptive_hmc(
        logdensity_fn, initial_positions, key, num_warmup=num_warmup, num_samples=num_samples,
        num_leapfrog=num_leapfrog, initial_step_size=initial_step_size, thin=thin,
        collect=collect, target_accept=target_accept, device=device, mesh=mesh)
    return result, decision


def _xla_adaptive_hmc(logdensity_fn, initial_positions, key, *, num_warmup, num_samples,
                      num_leapfrog, initial_step_size, thin, collect, target_accept,
                      device, mesh=None) -> FusedModelResult:
    """The eager path, shaped into the fused result contract: the model's
    device density where it has one (its closed-form potential, faster than
    a traced callable), else the callable mapped over the chains."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_positions, pack_template
    from binf_tpu_torch.parallel.runner import _warmup_and_run
    from binf_tpu_torch.samplers.hmc import hmc

    if collect not in ("draws", "moments"):
        raise ValueError(f"unknown collect={collect!r}")
    from binf_tpu_torch.parallel.collectives import pooled_mean
    from binf_tpu_torch.parallel.mesh import local_rows, shard_rows

    dev = resolve_device(device)
    initial_positions = local_rows(initial_positions, mesh)
    positions = {k: torch.as_tensor(v).to(dev, torch.float32)
                 for k, v in initial_positions.items()}
    template = {k: v[0] for k, v in positions.items()}
    spec = pack_template(template)
    batched = eager_logdensity(logdensity_fn, template, dev)
    if isinstance(key, torch.Generator):
        if resolve_device(key.device) != dev:
            raise ValueError(f"the generator lies on {key.device}, the chains on {dev}")
        generator = key
    else:
        generator = torch.Generator(device=dev).manual_seed(int(key))

    def builder(step_size, inverse_mass):
        return hmc(batched, step_size, num_leapfrog, inverse_mass)

    (samples, accepted), final_states, adapt = _warmup_and_run(
        builder, positions, generator, num_warmup, num_samples, initial_step_size,
        target_accept, thin, lambda state, info: (state.position, info.accepted), False, mesh)
    im = pack_positions({k: v[None] for k, v in adapt.inverse_mass.items()}, spec)[0]
    moments = collect == "moments"
    return FusedModelResult(
        samples=None if moments else shard_rows(samples, mesh, dim=1),
        accept_rate=pooled_mean(accepted.float(), mesh),
        step_size=adapt.step_size,
        inverse_mass=im,
        mean=shard_rows({k: v.mean(dim=0) for k, v in samples.items()}, mesh) if moments
        else None,
        variance=shard_rows({k: v.var(dim=0, unbiased=True) for k, v in samples.items()}, mesh)
        if moments else None,
        final_positions=shard_rows(final_states.position, mesh),
    )
