"""Rank programs for the port's multi-device tests, run as
``python tests/torch_ranks.py BATTERY RANK WORLD DIR``.

Each rank joins a gloo group through a ``FileStore`` under ``DIR`` (no TCP
port, so test workers running at once cannot collide), builds a mesh over
every rank on the CPU, runs one battery on the inputs in ``DIR/inputs.pt``
and writes its results to ``DIR/rank<R>.pt``.  The batteries import only
``torch`` and the port, never JAX: the test files hold the results against
the JAX package in the pytest process.  :func:`spawn_ranks` starts the
ranks with a deadline of their own (the group's collective timeout, and a
wait that kills every child), and :func:`world_of_one` is an in-process
group of one for the cases that need no other rank.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the parent side ---------------------------------------------------------------


def spawn_ranks(battery: str, tmp_path, inputs: dict, world: int = 4,
                timeout: float = 150.0) -> list[dict]:
    """Run ``battery`` in ``world`` processes and return each rank's
    results.  The children are killed at ``timeout`` seconds; a rank that
    fails raises with every rank's output."""
    tmp = str(tmp_path)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), battery, str(rank), str(world), tmp,
             str(timeout)], stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        outputs = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                            + open(os.path.join(tmp, f"rank{r}.log")).read()[-4000:]
                            for r, c in enumerate(codes))
        raise RuntimeError(f"battery {battery!r} failed or ran out of time:\n{outputs}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def world_of_one():
    """A gloo group of one in this process, and its chain mesh on the CPU;
    the group is destroyed on exit."""
    import torch.distributed as dist

    from binf_tpu_torch.parallel.mesh import initialize_distributed, make_chain_mesh

    initialize_distributed(backend="gloo", timeout=60)
    try:
        yield make_chain_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


# -- the batteries (rank side) ------------------------------------------------------


def _full(tree):
    from binf_tpu_torch.parallel.mesh import gather_chains

    return gather_chains(tree)


def _local(tree):
    """Each ``DTensor`` leaf's local shard; plain leaves pass."""
    from torch.distributed.tensor import DTensor

    from binf_tpu_torch.ops.tree import tree_map

    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def battery_collectives(mesh, inp: dict) -> dict:
    from binf_tpu_torch.parallel import collectives as C
    from binf_tpu_torch.parallel.mesh import local_rows, shard_chains

    out = {}
    idx = C.distributed_systematic_indices(inp["u"], inp["lw"], mesh)
    out["indices"] = _full(idx)
    out["indices_full_tensor"] = idx.full_tensor()
    g = torch.Generator().manual_seed(3)
    out["indices_generator"] = _full(C.distributed_systematic_indices(
        g, shard_chains(inp["lw"], mesh), mesh))
    out["pmean"] = C.pmean_over_chains({"x": inp["x"]}, mesh)["x"]
    out["pmean_sharded"] = C.pmean_over_chains(shard_chains({"x": inp["x"]}, mesh), mesh)["x"]
    taken = C.take_along_chain(shard_chains(inp["particles"], mesh), inp["take"])
    out["taken"] = _full(taken)
    x = local_rows(inp["x"], mesh)
    out["chain_sum"] = C.chain_sum(x, mesh)
    out["chain_mean"] = C.chain_mean(x, mesh)
    out["chain_m2"] = C.chain_m2(x, C.chain_mean(x, mesh), mesh)
    out["pooled_mean"] = C.pooled_mean(x, mesh)
    out["row_37"] = C.broadcast_chain({"x": x}, 37, mesh)["x"]
    out["gathered_dim1"] = C.all_gather_rows(x.T.contiguous(), mesh, dim=1)

    # the f/g pair: the gradient of a sum of shards is the whole sum's
    data = local_rows(inp["data"], mesh)

    def f(p):
        return C.reduce_from_shards(torch.sum(C.copy_to_shards(p, mesh) * data), mesh)

    p = torch.tensor(2.0)
    out["fg_value"] = f(p)
    out["fg_grad"] = torch.func.grad(f)(p)
    ps = torch.linspace(0.5, 2.0, 8)
    out["fg_vmap_grad"] = torch.func.vmap(torch.func.grad(f))(ps)
    out["fg_grad_vmap"] = torch.func.grad(lambda q: torch.func.vmap(f)(q).sum())(ps)

    # the SMC resample step: indices, then one particle move
    lw = shard_chains(inp["lw64"], mesh)
    moved = C.take_along_chain(shard_chains({"theta": inp["theta"]}, mesh),
                               C.distributed_systematic_indices(inp["u"], lw, mesh))
    out["resampled"] = _full(moved)["theta"]
    return out


def _poly_posterior(inp, sharded_mesh=None):
    from binf_tpu_torch.example.polynomial import make_likelihood, make_priors
    from binf_tpu_torch.parallel.data_parallel import DataShardedLikelihood
    from binf_tpu_torch.pdf import Posterior

    lik = make_likelihood(inp["xs"], inp["ys"])
    if sharded_mesh is not None:
        lik = DataShardedLikelihood.create(lik, sharded_mesh, fwm_data_fields=("vandermonde",))
    return lik, Posterior.create({"points": lik}, make_priors(device="cpu"))


def eager_hmc_draws(post, start: dict, steps: int = 20, seed: int = 1) -> dict:
    """Eager HMC on a posterior's unconstrained density over a chain batch
    (shared by the data-parallel battery and its unsharded reference)."""
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
    from binf_tpu_torch.samplers.base import run_kernel
    from binf_tpu_torch.samplers.hmc import hmc

    tld = torch.func.vmap(transform_logdensity(post.log_prob, {"precision": LogTransform}))
    kernel = hmc(tld, 0.01, 5)
    _, draws = run_kernel(kernel, torch.Generator().manual_seed(seed), kernel.init(start), steps)
    return draws


def restraint_hmc(loss_fn, X, k_obs: float, steps: int = 30, seed: int = 3):
    """HMC on one structure under a restraint loss (the JAX package's
    ``test_sharded_hmc_on_structure``): final log density, acceptances."""
    from binf_tpu_torch.samplers.base import run_kernel
    from binf_tpu_torch.samplers.hmc import hmc

    def logdensity(pos):
        prec = 25.0
        return (-0.5 * prec * loss_fn(pos["structure"]) + 0.5 * k_obs * torch.log(
            torch.tensor(prec)) - 0.005 * torch.sum(pos["structure"] ** 2))

    kernel = hmc(logdensity, step_size=2e-3, num_integration_steps=5)
    final, accs = run_kernel(kernel, torch.Generator().manual_seed(seed),
                             kernel.init({"structure": X}), steps,
                             collect=lambda s, info: info.acceptance_prob)
    return final.logdensity, final.position["structure"], accs


def battery_data(mesh, inp: dict) -> dict:
    from binf_tpu_torch.example.chromatin import make_sharded_restraint_loss
    from binf_tpu_torch.parallel.data_parallel import shard_data, sharded_sum
    from binf_tpu_torch.parallel.mesh import make_data_mesh

    dmesh = make_data_mesh(device="cpu")
    out = {}
    fn = sharded_sum(lambda p, local: torch.sum(p * local), dmesh)
    out["sum"] = fn(torch.tensor(2.0), torch.arange(64.0))
    out["sum_sharded"] = fn(torch.tensor(2.0), shard_data(torch.arange(64.0), dmesh))
    lik, post = _poly_posterior(inp, dmesh)
    out["variables"] = list(lik.variables)
    c, prec = inp["c"], inp["prec"]
    out["lp"] = lik.log_prob(coefficients=c, precision=prec)
    out["grad"] = lik.gradient(coefficients=c, precision=prec)
    chains = {"coefficients": inp["chain_c"], "precision": inp["chain_p"]}
    out["lp_vmap"] = torch.func.vmap(lik.log_prob)(chains)
    out["grad_vmap"] = torch.func.vmap(torch.func.grad(lik.log_prob))(chains)
    out["grad_of_vmap"] = torch.func.grad(
        lambda ch: torch.func.vmap(lik.log_prob)(ch).sum())(chains)
    out["hmc"] = eager_hmc_draws(post, {"coefficients": inp["chain_c"],
                                        "precision": torch.log(inp["chain_p"])})

    loss_fn = make_sharded_restraint_loss(dmesh)
    X, logD, W = inp["X"], inp["logD"], inp["W"]
    out["loss"] = loss_fn(X, logD, W)
    out["loss_grad"] = torch.func.grad(loss_fn)(X, logD, W)
    Xs = torch.stack([X, 1.1 * X])
    out["loss_vmap"] = torch.func.vmap(loss_fn, in_dims=(0, None, None))(Xs, logD, W)
    out["loss_vmap_grad"] = torch.func.vmap(torch.func.grad(loss_fn),
                                            in_dims=(0, None, None))(Xs, logD, W)
    logD_s, W_s = shard_data((logD, W), dmesh)
    out["restraint_hmc"] = restraint_hmc(lambda x: loss_fn(x, logD_s, W_s), X, float(W.sum()))
    return out


def poly_logdensity(inp):
    from binf_tpu_torch.example.polynomial import make_posterior
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    return transform_logdensity(make_posterior(inp["xs"], inp["ys"]).log_prob,
                                {"precision": LogTransform})


FUSED_CONFIGS = [("xla", "fixed"), ("xla", "chees"), ("dense", "fixed"), ("fused", "fixed"),
                 ("fused", "chees")]
FUSED_KW = dict(num_warmup=6, num_samples=20, num_leapfrog=5, device="cpu")


def adapted_rows(tld, positions: dict, warmup: str, trajectory: str, mesh, key=0):
    """``fused_model_hmc``'s warmup on this rank's rows of ``positions``
    (the whole batch without a mesh), and the run seed: what K4 then
    samples from."""
    from binf_tpu_torch.samplers.fused import (
        _adapt,
        _block_chains,
        _draw_seed,
        _generator,
        _prepare,
    )

    density, spec, q0 = _prepare(tld, positions, torch.device("cpu"))
    g = _generator(key)
    seed_w, seed_r = _draw_seed(g), _draw_seed(g)
    a = _adapt(warmup, tld, density, spec, q0, seed_w, num_warmup=FUSED_KW["num_warmup"],
               num_leapfrog=FUSED_KW["num_leapfrog"], initial_step_size=0.05,
               per_chain_step_size=False, block_chains=_block_chains("auto", q0.shape[0]),
               host_noise=False, trajectory=trajectory, max_leapfrog=256,
               dev=torch.device("cpu"), mesh=mesh)
    return a, seed_r


def gram_problem(inp):
    from binf_tpu_torch.example.chromatin import make_gram_logdensity

    return make_gram_logdensity(inp["gram_logD"], inp["gram_W"], device="cpu")


GRID_KW = dict(num_warmup=6, num_samples=10, num_leapfrog=5, block_chains=2, device="cpu")
BLOCKS_KW = dict(block_size=10, num_warmup=6, num_leapfrog=5, block_chains=4, device="cpu")


def battery_kernels(mesh, inp: dict) -> dict:
    from binf_tpu_torch.io.checkpoint import load_checkpoint
    from binf_tpu_torch.ops.kernels.chain_grid import chain_grid_potential_from_scalar
    from binf_tpu_torch.parallel.mesh import local_rows
    from binf_tpu_torch.parallel.production import run_fused_blocks
    from binf_tpu_torch.samplers.chain_grid import _warmup, chain_grid_model_hmc
    from binf_tpu_torch.samplers.fused import _draw_seed, _generator, fused_model_hmc

    tld = poly_logdensity(inp)
    init = {"coefficients": inp["init_c"], "precision": inp["init_p"]}
    out = {}
    for warmup, trajectory in FUSED_CONFIGS:
        res = fused_model_hmc(tld, init, 0, warmup=warmup, trajectory=trajectory, mesh=mesh,
                              **FUSED_KW)
        a, seed_r = adapted_rows(tld, local_rows(init, mesh), warmup, trajectory, mesh)
        out[(warmup, trajectory)] = {
            "local": _local(res), "whole": _full(res), "adapted": a._asdict(),
            "seed_r": seed_r}

    density = gram_problem(inp)
    gpos = {"structure": inp["gram_X"], "precision": inp["gram_u"]}
    res = chain_grid_model_hmc(density, gpos, 0, mesh=mesh, **GRID_KW)
    local = local_rows(gpos, mesh)
    potential, _, spec = chain_grid_potential_from_scalar(density, {k: v[0] for k, v in
                                                                    local.items()})
    g = _generator(0)
    adapt = _warmup(density, potential, spec, local, g, torch.device("cpu"), mesh,
                    num_warmup=GRID_KW["num_warmup"], num_leapfrog=GRID_KW["num_leapfrog"],
                    initial_step_size=0.05, target_accept=0.8)
    out["chain_grid"] = {"local": _local(res), "whole": _full(res),
                         "positions": adapt.final_states.position, "step_size": adapt.step_size,
                         "inverse_mass": adapt.inverse_mass, "seed_r": _draw_seed(g)}

    out["dir"] = inp["dir"]
    path = os.path.join(inp["dir"], "blocks.pt")
    for warmup in ("xla", "fused"):
        whole = run_fused_blocks(tld, init, 0, num_steps=40, mesh=mesh, warmup=warmup,
                                 **BLOCKS_KW)
        run_fused_blocks(tld, init, 0, num_steps=20, checkpoint_path=path,
                         checkpoint_every_blocks=2, mesh=mesh, warmup=warmup, **BLOCKS_KW)
        saved = load_checkpoint(path, _full(whole.carry))
        resumed = run_fused_blocks(tld, init, 0, num_steps=40, checkpoint_path=path,
                                   resume=True, mesh=mesh, warmup=warmup, **BLOCKS_KW)
        out[("blocks", warmup)] = {"whole": _local(whole), "resumed": _local(resumed),
                                   "saved": saved, "gathered": _full(whole)}
        torch.distributed.barrier()
        if torch.distributed.get_rank() == 0:
            os.replace(path, os.path.join(inp["dir"], f"blocks_{warmup}.pt"))
        torch.distributed.barrier()
    return out


SMC_CASES = {
    "chromatin_rwm": dict(mutation="rwm", num_mutation_steps=2, max_stages=12, target_ess=0.6),
    "poly_hmc": dict(mutation="hmc", num_mutation_steps=2, max_stages=8,
                     initial_step_size=0.1, hmc_integration_steps=5),
    "poly_stratified": dict(mutation="rwm", num_mutation_steps=2, max_stages=8,
                            resampling="stratified"),
    # chip_smoke.py's smc settings: 4,096 particles from the prior, RWM, 10
    # moves a stage, to beta = 1; long enough for a last-bit difference in
    # a pooled statistic to become another realisation
    "poly_prior_long": dict(mutation="rwm", num_mutation_steps=10, max_stages=100,
                            num_particles=4096),
}


def smc_case(name: str, inp: dict, mesh=None):
    from binf_tpu_torch.example.chromatin import make_chromatin_posterior
    from binf_tpu_torch.example.polynomial import make_posterior
    from binf_tpu_torch.smc import tempered_smc

    if name.startswith("chromatin"):
        post = make_chromatin_posterior(inp["logD16"], inp["W16"], use_pallas=False)
        particles = {"structure": inp["smc_X"], "precision": inp["smc_prec"]}
    else:
        post = make_posterior(inp["xs"], inp["ys"])
        particles = {"coefficients": inp["smc_c"], "precision": inp["smc_p"]}
    if "num_particles" in SMC_CASES[name]:
        particles = None
    return tempered_smc(post, 6, initial_particles=particles, mesh=mesh, device="cpu",
                        **SMC_CASES[name])


def battery_smc(mesh, inp: dict) -> dict:
    out = {}
    for name in SMC_CASES:
        r = smc_case(name, inp, mesh)
        out[name] = {"particles": _full(r.particles), "log_evidence": r.log_evidence,
                     "num_stages": r.num_stages, "final_beta": r.final_beta,
                     "mean_acceptance": r.mean_acceptance}
    return out


RUNNER_CHAINS = 16


def runner_cases(inp: dict, mesh=None) -> dict:
    """The runner's routes on the polynomial posterior, sharded or not."""
    from binf_tpu_torch.example.polynomial import make_collapsed_gibbs_kernel, make_posterior
    from binf_tpu_torch.parallel.runner import init_chains, run_chains, warmup_and_run
    from binf_tpu_torch.samplers.auto import route_algorithm
    from binf_tpu_torch.samplers.hmc import hmc
    from binf_tpu_torch.samplers.nuts import nuts

    from binf_tpu_torch.samplers.fused import eager_density

    tld = poly_logdensity(inp)
    init = {"coefficients": inp["init_c"][:RUNNER_CHAINS],
            "precision": inp["init_p"][:RUNNER_CHAINS]}
    # batched over chains, and a single chain for the step-size search
    batched = eager_density(tld, [("coefficients", (4,), 4), ("precision", (), 1)])
    out = {"route": route_algorithm(tld, init, mesh)._asdict()}
    kernel = hmc(batched, 0.02, 5)
    states = init_chains(kernel, init, mesh)
    out["run_chains"] = _full(run_chains(kernel, torch.Generator().manual_seed(2), states, 5,
                                         mesh=mesh))
    for name, build in (("hmc", lambda e, m: hmc(batched, e, 5, m)),
                        ("nuts", lambda e, m: nuts(batched, e, 4, m))):
        samples, final, adapt = warmup_and_run(build, init, torch.Generator().manual_seed(3),
                                               num_warmup=6, num_samples=4, mesh=mesh)
        out[name] = {"samples": _full(samples), "step_size": adapt.step_size,
                     "inverse_mass": adapt.inverse_mass}
    samples, _, adapt = warmup_and_run(lambda e, m: hmc(batched, e, 5, m), init,
                                       torch.Generator().manual_seed(4), num_warmup=6,
                                       num_samples=4, initial_step_size=None,
                                       per_chain_step_size=True, mesh=mesh)
    out["per_chain"] = {"samples": _full(samples), "step_size": _full(adapt.step_size)}
    post = make_posterior(inp["xs"], inp["ys"])
    gibbs = make_collapsed_gibbs_kernel(post)
    start = {"coefficients": torch.ones((RUNNER_CHAINS, 4)),
             "precision": torch.ones(RUNNER_CHAINS)}
    out["gibbs"] = _full(run_chains(gibbs, torch.Generator().manual_seed(5),
                                    init_chains(gibbs, start, mesh), 5, mesh=mesh)[1])
    return out


CLI_RUNS = [
    ["--model", "polynomial", "--algorithm", "hmc", "--chains", "16", "--warmup", "10",
     "--samples", "10"],
    ["--model", "polynomial", "--algorithm", "gibbs", "--chains", "16", "--samples", "20"],
    ["--model", "polynomial", "--algorithm", "fused", "--warmup-mode", "fused", "--chains",
     "16", "--warmup", "10", "--samples", "10"],
    ["--model", "polynomial", "--algorithm", "smc", "--chains", "64"],
]


def battery_runner(mesh, inp: dict) -> dict:
    from binf_tpu_torch import cli

    out = runner_cases(inp, mesh)
    out["cli"] = []
    for argv in CLI_RUNS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = cli.main(argv + ["--device", "cpu", "--mesh"])
        out["cli"].append({"summary": summary, "printed": buf.getvalue()})
    return out


BATTERIES = {"collectives": battery_collectives, "data": battery_data,
             "kernels": battery_kernels, "smc": battery_smc, "runner": battery_runner}


def main(argv) -> None:
    battery, rank, world, tmp, timeout = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from binf_tpu_torch.parallel.mesh import initialize_distributed, make_chain_mesh

    initialize_distributed(init_method="file://" + os.path.join(tmp, "store"),
                           world_size=world, rank=rank, backend="gloo",
                           timeout=float(timeout))
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        inputs["dir"] = tmp
        results = BATTERIES[battery](make_chain_mesh(device="cpu"), inputs)
        torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
