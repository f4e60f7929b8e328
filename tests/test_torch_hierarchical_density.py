"""The hierarchical posterior's device density (``binf_tpu_torch/csrc/
hierarchical_density.cuh``, ``ops/kernels/densities.py::HierarchicalDensity``)
against the JAX package, on the CPU.

Both packages build the posterior of 8 groups from the JAX package's
synthetic data as numpy arrays.  Checked:

- the closed-form potential and gradient against ``jax.value_and_grad`` of
  the JAX posterior under ``{"precision": LogTransform}`` at 16 seeded
  points, to 1e-5 relative to the largest value (float32 sums in other
  orders);
- the plain K4 and K3 at D = 21 against the JAX package's interpret-mode
  kernels on ``tile_potential_from_scalar`` of the JAX density, on the same
  host noise at d_pad 24: acceptance to 1e-6 and draws to 2e-4 on a seed
  whose decisions all lie past 5e-5 of their thresholds (asserted), K4
  also at a step where the divergence guard fires;
- a numpy float32 emulation of the functor split over lane groups of 1,
  2, 4 and 8 (lane r owns groups r, r + G, ...; its rows in row order, its
  groups in group order; a xor butterfly of the sums of squares and the
  Poisson values; each group's gradients from its owner) against the plain
  version and JAX, to 1e-5, and that every row lies with one lane;
- the recogniser's strictness, the constructor's carry-over of the JAX
  data (bit for bit against the recognised density), the width K3 and K4
  run, and that ``fused_model_hmc(device="cpu", warmup="fused")`` hands
  them this density."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import hierarchical as jh
from binf_tpu.ops.pallas.fused_potential import fused_potential_hmc_run as jax_run
from binf_tpu.ops.pallas.fused_potential import fused_warmup_run as jax_warmup
from binf_tpu.ops.pallas.fused_potential import tile_potential_from_scalar
from binf_tpu.pdf.transforms import LogTransform as JaxLog
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu_torch.example import hierarchical
from binf_tpu_torch.ops.kernels import densities
from binf_tpu_torch.ops.kernels import fused_potential as fp
from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE
from binf_tpu_torch.ops.kernels.densities import (HierarchicalDensity,
                                                  _hierarchical_from_posterior, device_density)
from binf_tpu_torch.ops.kernels.fused_potential import (fused_potential_hmc_plain,
                                                        fused_warmup_plain, pack_template,
                                                        unpack_draws)
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers import fused as fused_mod

RTOL = 1e-5
P = 16  # seeded points
NG, D = 8, 21
SHAPES = {"group_params": (NG, 2), "log_tau": (2,), "mu": (2,), "precision": ()}
WIDTHS = (1, 2, 4, 8)  # the widths a lane group of 8 groups takes
C, BC = 16, 16  # chains of the interpret-mode comparisons: one tile
f32 = np.float32


def _np(x):
    return np.array(x, np.float32)


def _template(shapes=SHAPES):
    return {k: torch.zeros(s) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def problem():
    """(JAX log density, port log density, the JAX data as numpy arrays)."""
    x, y, c, _ = jh.synthetic_hierarchical_data(jax.random.key(0), NG)
    data = tuple(_np(a) for a in (x, y, c))
    jfn = jax_transform(jh.make_hierarchical_posterior(x, y, c, NG).log_prob,
                        {"precision": JaxLog})
    post = hierarchical.make_hierarchical_posterior(*data, NG, device="cpu")
    return jfn, transform_logdensity(post.log_prob, {"precision": LogTransform}), data


@pytest.fixture(scope="module")
def density(problem):
    return device_density(problem[1], _template())


def _points(seed, n=P):
    """Points near the posterior's bulk: group params about (0.8, 1.2),
    log_tau about -1.3, mu about (0.8, 1.2), the log precision about 3.2."""
    rng = np.random.default_rng(seed)
    centre = np.concatenate([np.tile([0.8, 1.2], NG), [-1.3, -1.3, 0.8, 1.2, 3.2]])
    return (centre + 0.3 * rng.normal(size=(n, D))).astype(f32)


def _jax_potential(jfn, q):
    spec = pack_template(_template())

    def neg(v):
        pos, o = {}, 0
        for name, shape, size in spec:
            pos[name] = v[o:o + size].reshape(shape)
            o += size
        return -jfn(pos)

    U, g = jax.vmap(jax.value_and_grad(neg))(jnp.asarray(q))
    return np.asarray(U), np.asarray(g)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * np.abs(ref).max())


def test_potential_and_grad_match_jax(problem, density):
    assert type(density) is HierarchicalDensity and density.D == D
    q = _points(1)
    U, g = density.potential_and_grad(torch.tensor(q))
    U_j, g_j = _jax_potential(problem[0], q)
    _close(U.numpy(), U_j)
    _close(g.numpy(), g_j)
    # far from the bulk too: a wide funnel and a small precision
    q2 = (np.random.default_rng(2).normal(size=(P, D)) * 1.5).astype(f32)
    U2, g2 = density.potential_and_grad(torch.tensor(q2))
    U2_j, g2_j = _jax_potential(problem[0], q2)
    _close(U2.numpy(), U2_j)
    _close(g2.numpy(), g2_j)
    # the one-launch evaluation on the CPU is the plain version
    U3, g3 = densities.density_eval(density, torch.tensor(q), device="cpu")
    assert torch.equal(U3, U) and torch.equal(g3, g)


def test_constructor_carries_the_jax_data_bit_for_bit(problem, density):
    """``HierarchicalDensity(x, y, counts, 8)`` from the JAX example's numpy
    arrays equals the density the recogniser builds from the port's
    posterior, buffer for buffer."""
    x, y, c = problem[2]
    built = HierarchicalDensity(x, y, c, NG)
    for name, buf in density.named_buffers():
        other = dict(built.named_buffers())[name]
        assert other.dtype == buf.dtype == torch.float32 and torch.equal(other, buf), name
    assert built.n_groups == density.n_groups == NG and built.n == 15
    q = torch.tensor(_points(3))
    assert all(torch.equal(a, b) for a, b in zip(built.potential_and_grad(q),
                                                 density.potential_and_grad(q)))


def _noise(seed, steps):
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    d_pad = (D + 7) // 8 * 8
    return (np.asarray(jax.random.normal(k1, (steps, d_pad, C), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32)))


def _jax_tile(jfn):
    return tile_potential_from_scalar(jfn, {k: jnp.zeros(s) for k, s in SHAPES.items()})


K4_SEED, K4_STEPS = 1, 10


@pytest.mark.parametrize("step", [0.02, 0.05])
def test_plain_k4_matches_jax_interpret(problem, density, step):
    """At 0.02 every trajectory is stable; at 0.05 (the identity metric
    in the funnel) some leave the stable range and the divergence guard
    (NaN or |dE| > 1000 rejects) fires on both sides alike."""
    potential, consts, _ = _jax_tile(problem[0])
    q0 = _points(4, C)
    eps = np.full(C, step, f32)
    im = np.ones((C, D), f32)
    jr = jax_run(potential, jnp.asarray(q0), K4_SEED, jnp.asarray(eps), jnp.asarray(im), consts,
                 num_steps=K4_STEPS, block_chains=BC, steps_per_block=K4_STEPS,
                 interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in _noise(K4_SEED, K4_STEPS))
    trace = fused_potential_hmc_plain(density, torch.tensor(q0), K4_SEED, torch.tensor(eps),
                                      torch.tensor(im), num_steps=K4_STEPS, block_chains=BC,
                                      noise=noise)
    assert float(trace.margin.abs().min()) > 5e-5
    guarded = int(torch.isinf(trace.margin).sum())  # log u - (-inf)
    assert (guarded > 0) == (step > 0.02), guarded
    got = trace.result
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    assert 0.0 < float(got.accept_rate) < 1.0
    np.testing.assert_allclose(got.draws.numpy(), np.asarray(jr.draws), atol=2e-4)


K3_SEED, K3_STEPS, K3_EPS = 0, 6, 0.02


def test_plain_k3_matches_jax_interpret(problem, density):
    """Six warmup steps: the window fold and the harvest at the last
    boundary run; no decision lies within 5e-5 of its threshold, so both
    take the same decisions and differ by float32 rounding."""
    potential, consts, _ = _jax_tile(problem[0])
    q0 = _points(5, C)
    jq, jeps, jim = jax_warmup(potential, jnp.asarray(q0), K3_SEED, K3_EPS, consts,
                               num_warmup=K3_STEPS, num_leapfrog=10, block_chains=BC,
                               interpret=True, host_noise=True)
    noise = tuple(torch.tensor(a) for a in _noise(K3_SEED, K3_STEPS))
    margins = []
    tq, teps, tim = fused_warmup_plain(density, torch.tensor(q0), K3_SEED, K3_EPS,
                                       num_warmup=K3_STEPS, num_leapfrog=10, block_chains=BC,
                                       target_accept=0.8, init_search=False, noise=noise,
                                       margins=margins)
    assert float(torch.stack(margins).abs().min()) > 5e-5
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-4)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=1e-3, atol=1e-6)


# -- the lane split, emulated in float32 ------------------------------------------


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def _lane_groups(lane: int, G: int):
    """The groups lane ``lane`` of a group of ``G`` owns, in the order it
    adds them (lanes.cuh): lane, lane + G, ..."""
    return [lane + j * G for j in range(NG // G)]


def _butterfly(parts: np.ndarray) -> np.ndarray:
    """group_sum: lane l adds lane l ^ off's value for off = G/2, ..., 1;
    every lane ends with the same bits.  ``parts`` is (G, ...)."""
    G = parts.shape[0]
    off = G // 2
    while off:
        parts = (parts + parts[np.arange(G) ^ off]).astype(f32)
        off //= 2
    assert all(np.array_equal(parts[0], p) for p in parts)
    return parts[0]


def hierarchical_lanes(dens, q: np.ndarray, G: int):
    """U (P,) and grad U (P, 21) of the hierarchical functor at G lanes a
    chain, operation by operation as csrc/hierarchical_density.cuh and
    lanes.cuh round them."""
    x, y, cnt = dens.x.numpy(), dens.y.numpy(), dens.counts.numpy()
    offset, coef_t, rate, const = dens.scal.numpy()
    n = x.shape[0]
    one = f32(1)
    lam = np.exp(q[:, -1]).astype(f32)
    S_parts = np.zeros((G, q.shape[0]), f32)
    P_parts = np.zeros((G, q.shape[0]), f32)
    g = np.zeros_like(q)
    for lane in range(G):
        for grp in _lane_groups(lane, G):
            la, r = q[:, 2 * grp], q[:, 2 * grp + 1]
            A = np.exp(la).astype(f32)
            S = Ga = Gr = np.zeros(q.shape[0], f32)
            for i in range(n):
                s = (one / (one + np.exp(-(r * x[i]).astype(f32)).astype(f32))).astype(f32)
                m = (A * s).astype(f32)
                res = (m - y[grp * n + i]).astype(f32)
                S, Ga = _fma(res, res, S), _fma(res, m, Ga)
                Gr = _fma((res * (s * (one - s)).astype(f32)).astype(f32), x[i], Gr)
            eta = (offset + la).astype(f32)
            e = np.exp(eta).astype(f32)
            S_parts[lane] = (S_parts[lane] + S).astype(f32)
            P_parts[lane] = (P_parts[lane] + (e - (cnt[grp] * eta).astype(f32))).astype(f32)
            g[:, 2 * grp] = _fma(lam, Ga, (e - cnt[grp]).astype(f32))
            g[:, 2 * grp + 1] = (lam * (A * Gr).astype(f32)).astype(f32)
    S, P_ = _butterfly(S_parts), _butterfly(P_parts)
    lt, mu, t = q[:, 2 * NG:2 * NG + 2], q[:, 2 * NG + 2:2 * NG + 4], q[:, -1]
    it = np.exp(-lt).astype(f32)
    itau2 = (it * it).astype(f32)
    sq = np.zeros((q.shape[0], 2), f32)
    sd = np.zeros((q.shape[0], 2), f32)
    for k in range(2 * NG):
        j = k & 1
        d = (q[:, k] - mu[:, j]).astype(f32)
        sq[:, j] = _fma((d * d).astype(f32), itau2[:, j], sq[:, j])
        sd[:, j] = _fma(d, itau2[:, j], sd[:, j])
        g[:, k] = _fma(d, itau2[:, j], g[:, k])
    g[:, 2 * NG:2 * NG + 2] = ((f32(NG) - sq) + (lt + one)).astype(f32)
    g[:, 2 * NG + 2:2 * NG + 4] = _fma(f32(0.25), mu, -sd)
    prior = (0.5 * sq + NG * lt + 0.125 * mu * mu + 0.5 * (lt + 1) ** 2).sum(1).astype(f32)
    half = (f32(0.5) * lam * S).astype(f32)
    g[:, -1] = (half - coef_t + rate * lam).astype(f32)
    U = half - coef_t * t + rate * lam + P_ + prior + const
    return U.astype(f32), g


@pytest.mark.parametrize("G", WIDTHS)
def test_lane_split_matches_plain_and_jax(problem, density, G):
    q = _points(6)
    U, g = hierarchical_lanes(density, q, G)
    U_p, g_p = density.potential_and_grad(torch.tensor(q))
    U_j, g_j = _jax_potential(problem[0], q)
    for ref_U, ref_g in ((U_p.numpy(), g_p.numpy()), (U_j, g_j)):
        _close(U, ref_U)
        _close(g, ref_g)


@pytest.mark.parametrize("G", WIDTHS)
def test_lane_groups_cover_every_row_once(density, G):
    """Every (group, point) row lies with exactly one lane, at every width;
    within a lane the groups and their rows come in order."""
    n = density.n
    seen = []
    for lane in range(G):
        groups = _lane_groups(lane, G)
        assert groups == sorted(groups) and all(g % G == lane for g in groups)
        seen += [(g, i) for g in groups for i in range(n)]
    assert sorted(seen) == [(g, i) for g in range(NG) for i in range(n)]


def test_width_and_instantiation():
    """K3 and K4 run the hierarchical branch at 4 lanes, two groups a lane
    (the card's sweep of 1, 2, 4, 8), a width the kernels are
    instantiated for beside one lane; the functor is instantiated at
    D = 21 only.  At that width K3 (one CTA an SM on a card of 132 SMs)
    holds the families path's 8,192 chains in one round of 128 CTAs."""
    dens = HierarchicalDensity(np.linspace(-3, 3, 15), np.zeros(120), np.ones(8), NG)
    assert fp.lanes_for(dens) == 4 == fp.FAMILY_LANES["HierarchicalDensity"]
    assert fp.FAMILY_WIDTHS["HierarchicalDensity"] == (1, 4)
    assert tuple(densities.FAMILY_DIMS["HierarchicalDensity"]) == (21,)
    geo = fp.warmup_geometry(8192, 8192, 4, 132)
    assert geo.chains_per_cta == 64 and geo.ctas == 128 and geo.rounds == 1 and geo.resident


def test_other_group_counts_have_no_functor_on_the_card(monkeypatch):
    """A HierarchicalDensity of 20 groups (D = 45) runs on the CPU, and the
    kernels refuse it: they run 2 to 16 groups, and no unit is built past
    them."""
    x, y, c, _ = jh.synthetic_hierarchical_data(jax.random.key(1), 20)
    dens = HierarchicalDensity(_np(x), _np(y), _np(c), 20)
    assert dens.D == 45
    U, g = dens.potential_and_grad(torch.zeros((3, 45)))
    assert U.shape == (3,) and g.shape == (3, 45) and bool(torch.isfinite(g).all())
    with pytest.raises(NotImplementedError, match="D in 9, 11, .*, 37, not D=45"):
        fp.refuse(dens, ("K3",))


# -- recognition ----------------------------------------------------------------


def _posterior(groups=NG, seed=0):
    x, y, c, _ = jh.synthetic_hierarchical_data(jax.random.key(seed), groups)
    return hierarchical.make_hierarchical_posterior(_np(x), _np(y), _np(c), groups,
                                                    device="cpu")


def test_recogniser_is_strict():
    """Only the exact posterior is recognised: 20 groups, a fixed variable,
    no transform (or another one beside it), a tempered likelihood or a
    callable other than the bound method each give None, and no
    HierarchicalDensity: the density compiler's functor where it traces the
    callable (20 groups, D = 45: its wide form), else the callable's own
    error (the wrong template), raised as it is; at 126 groups (D = 257)
    the wide form too, at two warps a chain; past the compiler's
    MAX_D_WIDE coordinates (2,046 groups, D = 4,097) its refusal."""
    post = _posterior()
    t = _template()
    shapes4 = {**SHAPES, "group_params": (20, 2)}
    good = transform_logdensity(post.log_prob, {"precision": LogTransform})
    assert isinstance(_hierarchical_from_posterior(good, t), HierarchicalDensity)
    cases = [
        (transform_logdensity(_posterior(20).log_prob, {"precision": LogTransform}),
         _template(shapes4)),
        (transform_logdensity(post.fix(mu=torch.zeros(2)).log_prob,
                              {"precision": LogTransform}),
         {k: v for k, v in t.items() if k != "mu"}),
        (post.log_prob, t),
        (transform_logdensity(post.log_prob, {"precision": LogTransform,
                                              "log_tau": LogTransform}), t),
        (transform_logdensity(post.tempered(0.5).log_prob, {"precision": LogTransform}), t),
        (transform_logdensity(lambda p: post.log_prob(p), {"precision": LogTransform}), t),
        (good, {**t, "mu": torch.zeros(3)}),
    ]
    for k, (fn, template) in enumerate(cases):
        assert _hierarchical_from_posterior(fn, template) is None
        if k == 0:
            wide = device_density(fn, template)
            assert isinstance(wide, densities.TracedDensity) and wide.D == 45 and wide.wide
            shapes126 = {**SHAPES, "group_params": (126, 2)}
            fn126 = transform_logdensity(_posterior(126).log_prob, {"precision": LogTransform})
            assert _hierarchical_from_posterior(fn126, _template(shapes126)) is None
            wide126 = device_density(fn126, _template(shapes126))
            assert isinstance(wide126, densities.TracedDensity) and wide126.D == 257
            assert fp.lanes_for(wide126) == 64 and fp.kernel_refusal(wide126) is None
            past = (MAX_D_WIDE - 5) // 2 + 1
            shapes_past = {**SHAPES, "group_params": (past, 2)}
            fn_past = transform_logdensity(_posterior(past).log_prob,
                                           {"precision": LogTransform})
            assert _hierarchical_from_posterior(fn_past, _template(shapes_past)) is None
            with pytest.raises(NotImplementedError, match="not tile-compilable"):
                device_density(fn_past, _template(shapes_past))
        elif k == len(cases) - 1:
            with pytest.raises(RuntimeError) as e:
                device_density(fn, template)
            assert not isinstance(e.value, NotImplementedError), e.value
        else:
            assert isinstance(device_density(fn, template), densities.TracedDensity)


def test_fused_route_on_the_cpu_runs_the_device_density(problem, monkeypatch):
    """``fused_model_hmc(device="cpu", warmup="fused")`` hands K3 and K4 the
    HierarchicalDensity, not CallableDensity, and its draws are finite and
    accepted at a sane rate."""
    seen = []
    for attr in ("fused_warmup_run", "fused_potential_hmc_run"):
        real = getattr(fused_mod, attr)

        def spy(dens, *a, _real=real, **k):
            seen.append(type(dens))
            return _real(dens, *a, **k)

        monkeypatch.setattr(fused_mod, attr, spy)
    start = unpack_draws(torch.tensor(_points(7, 32)), pack_template(_template()))
    res = fused_mod.fused_model_hmc(problem[1], start, 0, num_warmup=60, num_samples=20,
                                    initial_step_size=0.02, block_chains=32, warmup="fused",
                                    device="cpu")
    assert seen == [HierarchicalDensity, HierarchicalDensity]
    assert all(bool(torch.isfinite(v).all()) for v in res.samples.values())
    assert res.samples["group_params"].shape == (20, 32, NG, 2)
    assert 0.2 < float(res.accept_rate) <= 1.0
