"""The router (``samplers/auto.py``) on the CPU: which path a model takes
and why, the result contract of both paths, and the eager path's moments
against the JAX package's ``adaptive_hmc(algorithm="xla")`` on the same
posterior and start (other noise: within five Monte Carlo standard
errors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.pdf.transforms import LogTransform as JLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers.auto import adaptive_hmc as jax_adaptive_hmc
from binf_tpu_torch.example.polynomial import make_posterior
from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers.auto import RoutingDecision, adaptive_hmc, route_algorithm


def _polynomial(n_chains=64, seed=3):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2, 2, 20).astype(np.float32)
    ys = (np.polynomial.polynomial.polyval(xs, [2.0, -4.0, 1.0, 1.5])
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    init = {"coefficients": (0.1 * rng.normal(size=(n_chains, 4))).astype(np.float32),
            "precision": np.zeros(n_chains, np.float32)}
    return xs, ys, init


def _torch_polynomial(n_chains=64):
    xs, ys, init = _polynomial(n_chains)
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    return tld, {k: torch.tensor(v) for k, v in init.items()}


def _gaussian(pos):
    return -0.5 * torch.sum((pos["x"] - 1.0) ** 2 / torch.tensor([1.0, 4.0, 0.25]))


def _unlowered(pos):
    """The same Gaussian through ``linalg.eigvalsh`` of a diagonal, an op the
    density compiler has no lowering rule for (JAX ``tests/test_auto.py``
    routes eigvalsh to XLA)."""
    z = (pos["x"] - 1.0) / torch.tensor([1.0, 2.0, 0.5])
    return -0.5 * torch.linalg.eigvalsh(torch.diag(z * z)).sum()


def test_device_density_routes_to_fused():
    tld, init = _torch_polynomial(96)
    d = route_algorithm(tld, init)
    assert isinstance(d, RoutingDecision)
    assert d.path == "fused" and d.reason.startswith("device density")
    assert (d.d, d.d_pad, d.n_local_chains, d.sequential, d.block_chains) == (5, 5, 96, False, 96)
    gauss = DiagGaussianDensity([0.0, 1.0], [1.0, 2.0])
    d = route_algorithm(gauss, {"x": torch.zeros((40000, 2))})
    assert d.path == "fused" and d.block_chains == 10000 and "DiagGaussianDensity" in d.reason


def test_plain_callable_routes_to_eager():
    """A plain callable the density compiler takes routes to K3 and K4
    through its generated functor; one it refuses (an op with no lowering
    rule) routes to the eager path, with the op in the reason."""
    g = route_algorithm(_gaussian, {"x": torch.zeros((32, 3))})
    assert g.path == "fused" and g.reason.startswith("device density: TracedDensity")
    assert (g.d, g.d_pad, g.block_chains, g.sequential) == (3, 3, 32, False)
    d = route_algorithm(_unlowered, {"x": torch.zeros((32, 3))})
    assert d.path == "xla" and d.reason.startswith("not tile-compilable:")
    assert "aten._linalg_eigh" in d.reason
    assert (d.d, d.d_pad, d.block_chains, d.sequential) == (3, 3, None, False)
    # the rule reads the model, not the device: the same decision with a card
    tld, init = _torch_polynomial()
    assert route_algorithm(tld, init).path == "fused"
    # with a mesh the rule decides at the per-rank chain count (a group of
    # one here; 4 ranks in test_torch_mesh_runner.py)
    from torch_ranks import world_of_one

    with world_of_one() as mesh:
        assert route_algorithm(_unlowered, {"x": torch.zeros((32, 3))}, mesh=mesh) == d
        assert route_algorithm(_gaussian, {"x": torch.zeros((32, 3))}, mesh=mesh) == g
        assert route_algorithm(tld, init, mesh=mesh) == route_algorithm(tld, init)


def test_forced_path_and_fused_only_options():
    tld, init = _torch_polynomial()
    res, d = adaptive_hmc(tld, init, 0, num_warmup=30, num_samples=20, algorithm="xla",
                          device="cpu")
    assert d.path == "xla" and d.reason == "forced algorithm='xla'"
    assert res.samples["coefficients"].shape == (20, 64, 4)
    # a generator key drives the eager path on its own device
    g = torch.Generator().manual_seed(0)
    again, _ = adaptive_hmc(tld, init, g, num_warmup=30, num_samples=20, algorithm="xla",
                            device="cpu")
    same, _ = adaptive_hmc(tld, init, torch.Generator().manual_seed(0), num_warmup=30,
                           num_samples=20, algorithm="xla", device="cpu")
    assert torch.equal(again.samples["precision"], same.samples["precision"])
    with pytest.raises(ValueError, match="fused path only"):
        adaptive_hmc(_unlowered, {"x": torch.zeros((16, 3))}, 0, num_warmup=10,
                     num_samples=10, warmup="fused", device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        adaptive_hmc(_gaussian, {"x": torch.zeros((16, 3))}, 0, algorithm="nuts", device="cpu")


def test_both_paths_share_the_result_contract():
    """The routed fused run (K3 then K4's plain version) and the forced
    eager run give the same fields and shapes, and close moments."""
    tld, init = _torch_polynomial(64)
    kw = dict(num_warmup=150, num_samples=150, num_leapfrog=8, device="cpu")
    fused, d_f = adaptive_hmc(tld, init, 3, warmup="fused", **kw)
    eager, d_x = adaptive_hmc(tld, init, 3, algorithm="xla", **kw)
    assert d_f.path == "fused" and d_x.path == "xla"
    for r in (fused, eager):
        assert 0.5 < float(r.accept_rate) <= 1.0
        assert set(r.samples) == {"coefficients", "precision"}
        assert r.samples["coefficients"].shape == (150, 64, 4)
        assert r.final_positions["coefficients"].shape == (64, 4)
        assert r.inverse_mass.shape[-1] == 5
    for k in fused.samples:
        np.testing.assert_allclose(fused.samples[k][50:].mean(dim=(0, 1)).numpy(),
                                   eager.samples[k][50:].mean(dim=(0, 1)).numpy(), atol=0.25)


def test_eager_moments_match_jax_shapes():
    """``collect="moments"`` on the eager path: per-chain mean and variance
    (ddof 1) of the stored draws, shaped as the JAX package's."""
    xs, ys, init = _polynomial(32)
    jld = jax_transform(jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys)).log_prob,
                        {"precision": JLogTransform})
    j, _ = jax_adaptive_hmc(jld, {k: jnp.asarray(v) for k, v in init.items()},
                            jax.random.key(0), num_warmup=40, num_samples=40,
                            collect="moments", algorithm="xla")
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    t, _ = adaptive_hmc(tld, init, 0, num_warmup=40, num_samples=40, collect="moments",
                        algorithm="xla", device="cpu")
    assert t.samples is None and j.samples is None
    for k in ("coefficients", "precision"):
        assert tuple(t.mean[k].shape) == tuple(j.mean[k].shape)
        assert tuple(t.variance[k].shape) == tuple(j.variance[k].shape)
        assert bool((t.variance[k] >= 0).all())
    draws, _ = adaptive_hmc(tld, init, 0, num_warmup=40, num_samples=40, algorithm="xla",
                            device="cpu")
    c = draws.samples["coefficients"]
    np.testing.assert_allclose(t.mean["coefficients"].numpy(), c.mean(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(t.variance["coefficients"].numpy(),
                               c.var(0, unbiased=True).numpy(), rtol=1e-5)


def test_eager_path_matches_jax_moments():
    """``adaptive_hmc(algorithm="xla")`` in both packages on the polynomial
    posterior from the same start: coefficient means within five Monte
    Carlo standard errors of their difference (ESS taken as a quarter of
    the kept draws), the precision within 10%."""
    xs, ys, init = _polynomial(64)
    kw = dict(num_warmup=150, num_samples=200, num_leapfrog=8, algorithm="xla")
    jld = jax_transform(jax_make_posterior(jnp.asarray(xs), jnp.asarray(ys)).log_prob,
                        {"precision": JLogTransform})
    j, _ = jax_adaptive_hmc(jld, {k: jnp.asarray(v) for k, v in init.items()},
                            jax.random.key(1), **kw)
    tld = transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform})
    t, _ = adaptive_hmc(tld, init, 1, device="cpu", **kw)
    a = t.samples["coefficients"][50:].reshape(-1, 4).numpy()
    b = np.asarray(j.samples["coefficients"])[50:].reshape(-1, 4)
    se = np.sqrt(a.var(0) / (len(a) / 4) + b.var(0) / (len(b) / 4))
    assert bool((np.abs(a.mean(0) - b.mean(0)) < 5 * se).all())
    prec = [np.exp(np.asarray(s["precision"])[50:]).mean() for s in (t.samples, j.samples)]
    assert prec[0] == pytest.approx(prec[1], rel=0.1)
    assert abs(float(t.accept_rate) - float(j.accept_rate)) < 0.1


def _hierarchical(chains, groups=8):
    from binf_tpu_torch.example import hierarchical

    x, y, c, _ = hierarchical.synthetic_hierarchical_data(torch.Generator().manual_seed(30),
                                                          groups, device="cpu")
    post = hierarchical.make_hierarchical_posterior(x, y, c, groups, device="cpu")
    start = {"group_params": torch.zeros((chains, groups, 2)), "mu": torch.zeros((chains, 2)),
             "log_tau": torch.zeros((chains, 2)), "precision": torch.zeros(chains)}
    return transform_logdensity(post.log_prob, {"precision": LogTransform}), start


def _chromatin(beads, chains):
    from binf_tpu_torch.example import chromatin

    _, logD, W = chromatin.synthetic_restraints(torch.Generator().manual_seed(0), beads,
                                                observe_frac=0.3, device="cpu")
    start = {"structure": torch.zeros((chains, beads, 3)), "precision": torch.zeros(chains)}
    return chromatin, logD, W, start


@pytest.mark.parametrize("model", ["hierarchical", "chromatin_gram", "chromatin_posterior"])
def test_nuts_rule_on_densities_without_a_functor(model):
    """The NUTS rule's decision where no CUDA functor runs the density: the
    card measured fixed-L HMC ahead of eager NUTS on the hierarchical
    posterior (eager, as a density with no functor runs) and on the
    chromatin posterior at both sizes, in ESS/s and in ESS per gradient,
    so NUTS is rerouted whatever a gradient costs.  The hierarchical case
    is the posterior at 2,046 groups, past the density compiler's
    MAX_D_WIDE (D = 4,097); the chromatin posterior's at 86 beads (D = 259)
    calls a torch.autograd.Function, which the compiler refuses by name;
    neither has a functor."""
    from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE
    from binf_tpu_torch.samplers.auto import NUTS_MEASUREMENT, route_trajectory_sampler

    if model == "hierarchical":
        groups = (MAX_D_WIDE - 5) // 2 + 1
        ld, start = _hierarchical(4, groups=groups)
        assert 2 * groups + 5 == MAX_D_WIDE + 1
    else:
        chrom, logD, W, start = _chromatin(86 if model == "chromatin_posterior" else 32, 16)
        ld = (chrom.make_gram_logdensity(logD, W, device="cpu") if model == "chromatin_gram"
              else chrom.make_chromatin_posterior(logD, W).log_prob)
    with pytest.raises(NotImplementedError):
        from binf_tpu_torch.ops.kernels.densities import device_density

        device_density(ld, {k: v[0] for k, v in start.items()})
    m = NUTS_MEASUREMENT
    for hmc, nuts, hmc_g, nuts_g, _ in m["chromatin"].values():
        assert hmc > nuts and hmc_g > nuts_g
    sampler, reason = route_trajectory_sampler("nuts", ld, start)
    assert sampler == "hmc" and reason.startswith("nuts rerouted to fixed-L HMC: no device")
    assert route_trajectory_sampler("hmc", ld, start)[0] == "hmc"


def test_nuts_rule_past_256_coordinates():
    """The hierarchical posterior at 126 groups (D = 257), which had no
    functor while the wide form stopped at 256 coordinates, now compiles to
    the wide form at two warps a chain, so the NUTS rule reroutes it for
    its device density (K4 runs fixed-L HMC over it), not for the eager
    measurement."""
    from binf_tpu_torch.ops.kernels.densities import TracedDensity, device_density
    from binf_tpu_torch.samplers.auto import route_trajectory_sampler

    ld, start = _hierarchical(16, groups=126)
    density = device_density(ld, {k: v[0] for k, v in start.items()})
    assert isinstance(density, TracedDensity) and density.D == 257 and density.wide
    sampler, reason = route_trajectory_sampler("nuts", ld, start)
    assert sampler == "hmc", reason
    assert reason.startswith("nuts rerouted to fixed-L HMC: device density: TracedDensity"), reason
    assert "D = 257, its wide form, 2 warp(s) a chain" in reason, reason
