"""Command-line inference runner: ``python -m binf_tpu_torch ...`` (port of
``binf_tpu/cli.py``).

Pick a registered model, an algorithm and run sizes; get a diagnostics
summary as JSON (printed, and written with ``--summary-out``):

    python -m binf_tpu_torch --model hierarchical --algorithm auto \\
        --warmup-mode fused --chains 8192
    python -m binf_tpu_torch --model polynomial --device cpu

Registered models: ``polynomial`` (the reference workload),
``hierarchical`` (Gaussian and Poisson channels), ``logistic`` (Bernoulli
GLM), ``chromatin`` (distance restraints, 64 beads), ``statespace``
(AR(1) trajectory) and ``mixture`` (Gaussian mixture).  Runs on the card
unless ``--device cpu``; with no card and no ``--device cpu`` it raises.
The data, the starts and the runs draw from ``torch.Generator`` streams
seeded by ``--seed``.

Routes that differ from the JAX package's on purpose:

* ``--algorithm auto`` sends every posterior with a CUDA functor that the
  kernels take to the fused kernels at every chain count
  (``samplers/auto.py``, measured on the card): the hierarchical posterior
  reads ``routed_to == "fused"`` where the JAX package's rule sends large
  batches to XLA;
* ``--algorithm chees`` takes the fused kernels when the density has a
  CUDA functor (``ops/kernels/densities.py::device_density``) that the
  kernels take (``ops/kernels/fused_potential.py::kernel_refusal``), where
  the JAX package asks whether its tile interpreter compiles it;
* ``--algorithm fused`` on a model with no CUDA functor raises on the card
  (the plain versions run any callable on the CPU), with no fallback;
* ``--algorithm chain-grid`` on the chromatin model runs its Gram-form
  density, the one the chain-grid kernel takes on the card;
* ``--persistent-cache`` names the kernel build directory, where every
  build is cached anyway; ``--checkpoint`` is parsed and unused, as in the
  JAX package.

``--mesh`` joins the process group (``parallel/mesh.py::
initialize_distributed``: a world of one, or what ``torchrun`` sets) and
shards the chains of every sampling route over ``make_chain_mesh()``, as
the JAX package's CLI does; the VI routes run whole on every rank.  Under
``torchrun --nproc-per-node N python -m binf_tpu_torch --mesh`` every rank
runs the same route on its rows and only rank 0 prints the summary, made
from the gathered draws.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, NamedTuple

import torch

MODELS = ("polynomial", "hierarchical", "logistic", "chromatin", "statespace", "mixture")


class Model(NamedTuple):
    """A registered model: its posterior, ``init_fn(n_chains, generator)``
    (constrained starts), the transforms to unconstrained space, and for
    the chromatin model the Gram-form density the chain-grid kernel runs."""

    posterior: object
    init_fn: Callable
    transforms: dict
    chain_grid_density: object = None


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def build_model(name: str, generator: torch.Generator, device=None) -> Model:
    """The model ``name`` with synthetic data drawn from ``generator`` (a
    generator of ``device``'s type)."""
    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.pdf.transforms import LogTransform

    dev = resolve_device(device)

    if name == "polynomial":
        from binf_tpu_torch.example import polynomial as ex

        xses, ys = ex.make_data(generator, device=dev)
        return Model(ex.make_posterior(xses, ys),
                     lambda n, generator=None: ex.initial_positions(n, generator=generator,
                                                                    device=dev),
                     {"precision": LogTransform})

    if name == "hierarchical":
        from binf_tpu_torch.example import hierarchical as ex

        n_groups = 8
        x, y, counts, _ = ex.synthetic_hierarchical_data(generator, n_groups, device=dev)

        def init_fn(n_chains, generator=None):
            g = generator if generator is not None else _seeded(0, dev)
            noise = torch.randn((n_chains, n_groups, 2), generator=g, device=g.device)
            return {"group_params": 0.1 * noise.to(dev),
                    "mu": torch.zeros((n_chains, 2), device=dev),
                    "log_tau": torch.full((n_chains, 2), -1.0, device=dev),
                    "precision": torch.full((n_chains,), 5.0, device=dev)}

        return Model(ex.make_hierarchical_posterior(x, y, counts, n_groups, device=dev), init_fn,
                     {"precision": LogTransform})

    if name == "logistic":
        from binf_tpu_torch.example import logistic as ex

        X, y = ex.synthetic_logistic_data(generator, device=dev)
        return Model(ex.make_logistic_posterior(X, y, device=dev),
                     lambda n, generator=None: ex.initial_positions(n, generator=generator,
                                                                    device=dev), {})

    if name == "chromatin":
        from binf_tpu_torch.example import chromatin as ex

        n_beads = 64
        _, log_target, W = ex.synthetic_restraints(generator, n_beads, observe_frac=0.3,
                                                   device=dev)
        # the plain restraint loss: at 64 beads the (N, N) field is small (the
        # restraint kernels pay off from thousands of beads)
        post = ex.make_chromatin_posterior(log_target, W, use_pallas=False)

        def init_fn(n_chains, generator=None):
            g = generator if generator is not None else _seeded(0, dev)
            draws = [post.sample_prior(g) for _ in range(n_chains)]
            return {k: torch.stack([d[k] for d in draws]).to(dev) for k in draws[0]}

        return Model(post, init_fn, {"precision": LogTransform},
                     chain_grid_density=ex.make_gram_logdensity(log_target, W, device=dev))

    if name == "statespace":
        from binf_tpu_torch.example import statespace as ex

        y = ex.synthetic_ar1_data(generator, device=dev)
        return Model(ex.make_ar1_posterior(y, device=dev),
                     lambda n, generator=None: ex.initial_positions(n, generator=generator,
                                                                    device=dev),
                     {"precision": LogTransform})

    if name == "mixture":
        from binf_tpu_torch.example import mixture as ex

        y = ex.synthetic_mixture_data(generator, device=dev)
        return Model(ex.make_mixture_posterior(y, device=dev),
                     lambda n, generator=None: ex.initial_positions(n, generator=generator,
                                                                    device=dev), {})

    raise SystemExit(f"unknown model {name!r}; choose {'|'.join(MODELS)}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="binf_tpu_torch")
    ap.add_argument("--model", default="polynomial")
    ap.add_argument("--algorithm", default="auto",
                    choices=["auto", "hmc", "nuts", "chees", "rwm", "mala", "gibbs", "smc",
                             "advi", "laplace", "svgd", "fused", "chain-grid", "pathfinder"],
                    help="'auto' (default) routes adaptive HMC to the fused kernels when "
                         "the density has a CUDA functor, else to the eager path "
                         "(samplers/auto.py)")
    ap.add_argument("--no-reroute", action="store_true",
                    help="run the requested sampler even where the router has measured it "
                         "losing (samplers/auto.py::route_trajectory_sampler)")
    ap.add_argument("--init", default="default", choices=["default", "pathfinder"],
                    help="chain initialization: the model's init_fn, or pathfinder draws "
                         "(chains start in the typical set, so short warmups suffice)")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-size", type=float, default=0.1)
    ap.add_argument("--summary-out", default=None)
    # parsed and never read, as in the JAX package's CLI
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="shard chains over all devices (not ported yet: raises)")
    ap.add_argument("--thin", type=int, default=1,
                    help="keep every k-th draw (fused algorithm: in-kernel)")
    ap.add_argument("--per-chain-step", action="store_true",
                    help="per-chain step-size adaptation (fused algorithm)")
    ap.add_argument("--auto-step-size", action="store_true",
                    help="seed warmup with find_reasonable_step_size (Hoffman & Gelman "
                         "Algorithm 4) instead of --step-size")
    ap.add_argument("--trajectory", default="fixed", choices=["fixed", "chees"],
                    help="fused algorithm: trajectory-length source (chees = ChEES-adapted "
                         "mean length, jittered in-kernel)")
    ap.add_argument("--warmup-mode", default="xla", choices=["xla", "fused", "dense"],
                    help="fused algorithm: adaptation on the eager path ('xla'), inside the "
                         "warmup kernel ('fused'), or 'dense' (full-covariance metric)")
    ap.add_argument("--collect", default="draws", choices=["draws", "moments"],
                    help="fused algorithm: collect draws, or stream Welford moments "
                         "in-kernel")
    ap.add_argument("--block-chains", default="auto",
                    help="fused algorithm: the warmup's chain-tile width (int, or 'auto')")
    ap.add_argument("--metric", default="diag", choices=["diag", "dense"],
                    help="hmc algorithm: diagonal or full-covariance mass matrix")
    ap.add_argument("--persistent-cache", action="store_true",
                    help="report the kernel build directory (every build is cached there)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions on the CPU; default the card")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _seeds(seed: int) -> dict:
    """The model's, the starts', the run's and pathfinder's seeds, drawn
    from ``seed`` (the JAX package splits one key three ways)."""
    root = torch.Generator().manual_seed(seed)
    draws = torch.randint(0, 2 ** 62, (4,), generator=root).tolist()
    return dict(zip(("model", "init", "run", "pathfinder"), draws))


def main(argv=None):
    args = parse_args(argv)
    from binf_tpu_torch._device import resolve_device

    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from binf_tpu_torch.parallel.mesh import initialize_distributed, make_chain_mesh

        initialize_distributed()
        mesh = make_chain_mesh(device=dev)
    if args.persistent_cache:
        from binf_tpu_torch.ops.kernels._build import build_dir

        print(f"# kernel builds are cached in {build_dir()}", file=sys.stderr)
    seeds = _seeds(args.seed)
    model = build_model(args.model, torch.Generator(device=dev).manual_seed(seeds["model"]),
                        device=dev)
    return run(args, model, mesh)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _logdensity(model: Model):
    """The posterior's log density in unconstrained space: the bound
    ``log_prob`` itself when no variable is transformed, so that the fused
    kernels recognise the logistic and mixture posteriors."""
    from binf_tpu_torch.pdf.transforms import transform_logdensity

    if not model.transforms:
        return model.posterior.log_prob
    return transform_logdensity(model.posterior.log_prob, model.transforms)


def _means(draws: dict) -> dict:
    return {k: v.mean(dim=0).tolist() for k, v in draws.items()}


def run(args: argparse.Namespace, model: Model, mesh=None) -> dict:
    """Run ``args.algorithm`` on ``model``; print the summary (and write it
    to ``--summary-out``) and return it, keyed as the JAX package's CLI.
    With a mesh the sampling routes shard their chains over it, every
    rank returns the summary of the gathered draws, and rank 0 alone
    prints and writes it."""
    from binf_tpu_torch._device import resolve_device
    from binf_tpu_torch.parallel.mesh import gather_chains
    from binf_tpu_torch.pdf.transforms import constrain, unconstrain

    dev = resolve_device(args.device)
    seeds = _seeds(args.seed)

    def gen(name):
        return torch.Generator(device=dev).manual_seed(seeds[name])

    posterior, init_fn, transforms = model.posterior, model.init_fn, model.transforms
    g_init, g_run = gen("init"), gen("run")
    t0 = time.perf_counter()

    if args.algorithm == "smc":
        from binf_tpu_torch.smc import tempered_smc

        result = tempered_smc(posterior, g_run, num_particles=args.chains, mutation="hmc",
                              num_mutation_steps=5, mesh=mesh, device=dev)
        _sync(dev)
        out = {"model": args.model, "algorithm": "smc",
               "log_evidence": float(result.log_evidence),
               "num_stages": int(result.num_stages),
               "elapsed_sec": round(time.perf_counter() - t0, 3),
               "posterior_means": _means(gather_chains(result.particles))}

    elif args.algorithm == "pathfinder":
        from binf_tpu_torch.vi import pathfinder

        seeds_u = unconstrain(transforms, init_fn(min(args.chains, 8), generator=g_init))
        fit = pathfinder(_logdensity(model), seeds_u, g_run, num_draws=1000, device=dev)
        draws = constrain(transforms, fit.samples)
        _sync(dev)
        out = {"model": args.model, "algorithm": "pathfinder",
               "best_elbo": float(fit.elbo.max()),
               "pareto_k": round(float(fit.pareto_k), 3),
               "elapsed_sec": round(time.perf_counter() - t0, 3),
               "posterior_means": _means(draws)}

    elif args.algorithm == "advi":
        from binf_tpu_torch.vi import advi, variational_sample

        result = advi(posterior, g_run, num_steps=args.samples * 4, transforms=transforms,
                      device=dev)
        draws = variational_sample(posterior, result, g_init, 1000, transforms)
        _sync(dev)
        out = {"model": args.model, "algorithm": "advi",
               "final_elbo": float(result.final_elbo),
               "elapsed_sec": round(time.perf_counter() - t0, 3),
               "posterior_means": _means(draws)}

    elif args.algorithm == "laplace":
        from binf_tpu_torch.vi import laplace_approximation, laplace_sample

        result = laplace_approximation(posterior, g_run, num_steps=args.samples * 4,
                                       transforms=transforms, device=dev)
        draws = laplace_sample(posterior, result, g_init, 1000, transforms)
        _sync(dev)
        out = {"model": args.model, "algorithm": "laplace",
               "converged": bool(result.converged),
               "log_evidence_laplace": float(result.log_evidence_laplace),
               "elapsed_sec": round(time.perf_counter() - t0, 3),
               "posterior_means": _means(draws)}

    elif args.algorithm == "svgd":
        from binf_tpu_torch.vi import svgd

        result = svgd(posterior, g_run, num_particles=args.chains, num_steps=args.samples * 4,
                      transforms=transforms, device=dev)
        _sync(dev)
        out = {"model": args.model, "algorithm": "svgd",
               "elapsed_sec": round(time.perf_counter() - t0, 3),
               "posterior_means": _means(result.particles)}

    elif args.algorithm == "gibbs":
        if args.model != "polynomial":
            raise SystemExit("--algorithm gibbs is wired for --model polynomial")
        from binf_tpu_torch.example.polynomial import make_collapsed_gibbs_kernel
        from binf_tpu_torch.parallel.runner import init_chains, run_chains

        kernel = make_collapsed_gibbs_kernel(posterior)
        states = init_chains(kernel, init_fn(args.chains, generator=g_init), mesh=mesh)
        # a first run, untimed, as the JAX package's excludes its compilation
        run_chains(kernel, gen("run"), states, args.samples, mesh=mesh)
        _sync(dev)
        t0 = time.perf_counter()
        _, samples = run_chains(kernel, gen("run"), states, args.samples, mesh=mesh)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        out = _summarize(args, gather_chains(samples), elapsed, burn=args.samples // 4)

    elif args.algorithm == "chain-grid":
        from binf_tpu_torch.samplers.chain_grid import chain_grid_model_hmc

        logdensity = _logdensity(model)
        u_positions = _init_positions(args, logdensity, model, args.chains, g_init,
                                      gen("pathfinder"), dev)
        result = chain_grid_model_hmc(
            model.chain_grid_density or logdensity, u_positions, g_run,
            num_warmup=args.warmup, num_samples=args.samples,
            initial_step_size=None if args.auto_step_size else args.step_size,
            thin=args.thin, mesh=mesh, collect=args.collect, device=dev)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        result = gather_chains(result)
        if args.collect == "moments":
            out = {"model": args.model, "algorithm": "chain-grid", "chains": args.chains,
                   "space": "unconstrained", "elapsed_sec": round(elapsed, 3),
                   "posterior_means": _means(result.mean)}
        else:
            out = _summarize(args, constrain(transforms, result.samples), elapsed, burn=0)
        out["accept_rate"] = round(float(result.accept_rate), 4)

    elif args.algorithm in ("fused", "auto"):
        logdensity = _logdensity(model)
        u_positions = _init_positions(args, logdensity, model, args.chains, g_init,
                                      gen("pathfinder"), dev)
        initial_step_size = None if args.auto_step_size else args.step_size
        decision = None
        if args.algorithm == "auto":
            from binf_tpu_torch.samplers.auto import adaptive_hmc

            # non-default fused-only flags go through (adaptive_hmc raises if
            # the run routes to the eager path while they are set)
            fused_only = {}
            if args.per_chain_step:
                fused_only["per_chain_step_size"] = True
            if args.trajectory != "fixed":
                fused_only["trajectory"] = args.trajectory
            if args.warmup_mode != "xla":
                fused_only["warmup"] = args.warmup_mode
            if args.block_chains != "auto":
                fused_only["block_chains"] = int(args.block_chains)
            result, decision = adaptive_hmc(
                logdensity, u_positions, g_run, num_warmup=args.warmup,
                num_samples=args.samples, initial_step_size=initial_step_size, thin=args.thin,
                mesh=mesh, collect=args.collect, device=dev, **fused_only)
        else:
            from binf_tpu_torch.samplers.fused import fused_model_hmc

            result = fused_model_hmc(
                logdensity, u_positions, g_run, num_warmup=args.warmup,
                num_samples=args.samples, initial_step_size=initial_step_size,
                block_chains=(args.block_chains if args.block_chains == "auto"
                              else int(args.block_chains)),
                per_chain_step_size=args.per_chain_step, thin=args.thin,
                trajectory=args.trajectory, warmup=args.warmup_mode, collect=args.collect,
                mesh=mesh, device=dev)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        result = gather_chains(result)
        if args.collect == "moments":
            # in-kernel streaming moments, in unconstrained space
            out = {"model": args.model, "algorithm": args.algorithm, "chains": args.chains,
                   "draws": args.samples * args.chains, "space": "unconstrained",
                   "elapsed_sec": round(elapsed, 3),
                   "posterior_means": _means(result.mean),
                   "posterior_variances": _means(result.variance)}
        else:
            out = _summarize(args, constrain(transforms, result.samples), elapsed,
                             burn=(args.samples // args.thin) // 4)
        out["accept_rate"] = round(float(result.accept_rate), 4)
        if decision is not None:
            out["routed_to"] = decision.path
            out["routing_reason"] = decision.reason

    else:  # gradient samplers after an eager warmup
        samples, sampler, reroute_reason = _gradient_sampler(args, model, g_init, g_run,
                                                             gen("pathfinder"), dev, mesh)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        out = _summarize(args, constrain(transforms, gather_chains(samples)), elapsed, burn=0)
        if sampler != args.algorithm:
            out["sampler"] = sampler
            if reroute_reason is not None:
                out["reroute_reason"] = reroute_reason

    if mesh is not None and torch.distributed.get_rank() != int(mesh.mesh.flatten()[0]):
        return out
    line = json.dumps(out, indent=2)
    print(line)
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            f.write(line)
    return out


def _gradient_sampler(args, model: Model, g_init, g_run, g_pathfinder, dev, mesh=None):
    """The eager gradient samplers: ChEES (fused when the density has a CUDA
    functor), dense-metric HMC, or HMC / NUTS (rerouted by the router's
    rule unless ``--no-reroute``) / MALA / RWM after the window warmup.
    Returns ``(unconstrained draws, sampler run, reroute reason)``."""
    from binf_tpu_torch.parallel.runner import init_chains, run_chains, warmup_and_run
    from binf_tpu_torch.samplers.fused import eager_logdensity

    logdensity = _logdensity(model)
    u_positions = _init_positions(args, logdensity, model, args.chains, g_init, g_pathfinder,
                                  dev)
    batched = eager_logdensity(logdensity, {k: v[0] for k, v in u_positions.items()}, dev)
    sampler, reroute_reason = args.algorithm, None

    if args.algorithm == "chees":
        from binf_tpu_torch.ops.kernels.densities import device_density
        from binf_tpu_torch.ops.kernels.fused_potential import kernel_refusal

        try:
            density = device_density(logdensity, {k: v[0] for k, v in u_positions.items()})
            fused_ok = kernel_refusal(density) is None
        except NotImplementedError:
            fused_ok = False
        if args.warmup_mode == "dense":
            raise ValueError("--algorithm chees does not support --warmup-mode dense (the "
                             "dense metric pairs with fixed trajectories); use --warmup-mode "
                             "xla/fused")
        if fused_ok:
            from binf_tpu_torch.samplers.fused import fused_model_hmc

            result = fused_model_hmc(
                logdensity, u_positions, g_run, num_warmup=args.warmup,
                num_samples=args.samples,
                initial_step_size=None if args.auto_step_size else args.step_size,
                trajectory="chees", warmup=args.warmup_mode, thin=args.thin, mesh=mesh,
                device=dev)
            return result.samples, "chees (fused in-kernel)", None
        from binf_tpu_torch.samplers.chees import chees_adaptation, chees_hmc

        adapt = chees_adaptation(batched, u_positions, g_run, num_steps=args.warmup,
                                 initial_step_size=args.step_size, mesh=mesh)
        kernel = chees_hmc(batched, adapt.step_size, adapt.trajectory_length,
                           adapt.inverse_mass)
        _, samples = run_chains(kernel, g_run, init_chains(kernel, adapt.final_positions, mesh),
                                args.samples, mesh=mesh)
        return samples, "chees (xla)", None

    if args.algorithm == "hmc" and args.metric == "dense":
        from binf_tpu_torch.samplers.dense import dense_hmc, dense_window_adaptation

        adapt = dense_window_adaptation(batched, u_positions, g_run, num_steps=args.warmup,
                                        num_integration_steps=10,
                                        initial_step_size=args.step_size, mesh=mesh)
        kernel = dense_hmc(batched, {k: v[0] for k, v in u_positions.items()},
                           adapt.step_size, 10, inverse_mass_matrix=adapt.inverse_mass_matrix)
        _, samples = run_chains(kernel, g_run, init_chains(kernel, adapt.final_positions, mesh),
                                args.samples, mesh=mesh)
        return samples, sampler, None

    from binf_tpu_torch.samplers.hmc import hmc
    from binf_tpu_torch.samplers.mala import mala
    from binf_tpu_torch.samplers.nuts import nuts
    from binf_tpu_torch.samplers.rwm import rwm

    if sampler == "nuts" and not args.no_reroute:
        from binf_tpu_torch.samplers.auto import route_trajectory_sampler

        sampler, reroute_reason = route_trajectory_sampler("nuts", logdensity, u_positions)
        if sampler != "nuts":
            print(f"# {reroute_reason}", file=sys.stderr)

    def builder(step_size, inverse_mass):
        if sampler == "hmc":
            return hmc(batched, step_size, 10, inverse_mass)
        if sampler == "nuts":
            return nuts(batched, step_size, 8, inverse_mass)
        if sampler == "mala":
            return mala(batched, step_size)
        return rwm(batched, step_size)

    samples, _, _ = warmup_and_run(
        builder, u_positions, g_run, num_warmup=args.warmup, num_samples=args.samples,
        initial_step_size=None if args.auto_step_size else args.step_size, mesh=mesh)
    return samples, sampler, reroute_reason


def _init_positions(args, logdensity, model: Model, n: int, g_init, g_pathfinder, dev) -> dict:
    """Unconstrained starting positions: the model's init_fn, or (with
    ``--init pathfinder``) draws from a pathfinder fit seeded by a few
    overdispersed init_fn points."""
    from binf_tpu_torch.pdf.transforms import unconstrain

    u = unconstrain(model.transforms, model.init_fn(n, generator=g_init))
    if args.init != "pathfinder":
        return u
    from binf_tpu_torch.vi import pathfinder_init

    seeds = {k: v[: min(n, 8)] for k, v in u.items()}
    return pathfinder_init(logdensity, seeds, g_pathfinder, n_chains=n, device=dev)


def _summarize(args, samples: dict, elapsed: float, burn: int = 0) -> dict:
    from binf_tpu_torch.diagnostics import summary

    kept = {k: v[burn:] for k, v in samples.items()}
    stats = summary(kept)
    first = kept[next(iter(kept))]
    n_draws = first.shape[0] * first.shape[1]
    return {
        "model": args.model,
        "algorithm": args.algorithm,
        "chains": args.chains,
        "draws": n_draws,
        "elapsed_sec": round(elapsed, 3),
        "draws_per_sec": round(n_draws / elapsed, 1),
        "summary": {name: {stat: (v.tolist() if hasattr(v, "tolist") else float(v))
                           for stat, v in s.items()}
                    for name, s in stats.items()},
    }


if __name__ == "__main__":
    main()
