"""Lane groups for the logistic, AR(1) and mixture functors of K3 and K4
(``binf_tpu_torch/csrc/lanes.cuh``), on the CPU.

A numpy float32 emulation evaluates each functor as a group of G lanes
does on the card: for the logistic and the mixture lane r takes rows r,
r + G, ... (its register rows, then its shared-memory rows ``kRowUnroll``
at a time, each row's operations in the functor's order, each lane's sums
in row order); for AR(1) lane r takes a contiguous segment of the
recurrence and starts it from a shuffle scan of the segments' affine
maps; a xor butterfly adds the lanes' partials.  At G = 1, 4, 8, 16 and
32 it agrees with the plain ``potential_and_grad`` and with the JAX
posterior's log density and gradient at 16 seeded points, to 1e-5
relative to the largest value (the float32 sums run in other orders).  Also: the widths ``lanes_for`` picks,
K3's geometry at the new widths, and that every width the wrappers name
is instantiated in ``csrc``."""

import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.example import logistic as jl
from binf_tpu.example import mixture as jm
from binf_tpu.example import statespace as js
from binf_tpu.pdf.transforms import LogTransform as JaxLog
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu_torch.example import logistic, mixture, statespace
from binf_tpu_torch.ops.kernels import fused_potential as fp
from binf_tpu_torch.ops.kernels.densities import device_density
from binf_tpu_torch.ops.kernels.fused_potential import pack_template
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

CSRC = Path(fp.__file__).resolve().parents[2] / "csrc"
WIDTHS = (1, 4, 8, 16, 32)
HIER_WIDTHS = (1, 2, 4, 8)  # the hierarchical branch's: a lane owns whole groups
P = 16  # seeded points
RTOL = 1e-5
LANE_FLOATS, GROUP_ROWS, ROW_UNROLL = 16, 256, 4  # csrc/lanes.cuh: kFamilyLaneFloats, ...
f32 = np.float32


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def _lane_rows(lane: int, G: int, n: int, floats: int):
    """The rows lane ``lane`` of a group of ``G`` evaluates, in the order it
    adds them (lanes.cuh): its register rows (the first ``reg_rows`` of
    lane, lane + G, ..., those past n zeros that add nothing), then its
    shared-memory rows, kRowUnroll at a time, then one at a time; row
    indices past n are None."""
    reg = min(LANE_FLOATS // floats, -(-GROUP_ROWS // G))
    order = [lane + j * G if lane + j * G < n else None for j in range(reg)]
    i = lane + reg * G
    while i + (ROW_UNROLL - 1) * G < n:
        order += [i + j * G for j in range(ROW_UNROLL)]
        i += ROW_UNROLL * G
    while i < n:
        order.append(i)
        i += G
    return order


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


def logistic_lanes(dens, q: np.ndarray, G: int):
    """U (P,) and grad U (P, D) of the logistic functor at G lanes a chain."""
    X, y = dens.X.numpy(), dens.y.numpy()
    ipv, pm = dens.ipv.numpy(), dens.prior_mean.numpy()
    n, D = X.shape
    P_ = q.shape[0]
    u_parts = np.zeros((G, P_), f32)
    g_parts = np.zeros((G, P_, D), f32)
    for lane in range(G):
        u, g = np.zeros(P_, f32), np.zeros((P_, D), f32)
        for i in _lane_rows(lane, G, n, D + 1):
            if i is None:
                continue
            eta = np.zeros(P_, f32)
            for k in range(D):
                eta = _fma(X[i, k], q[:, k], eta)
            e = np.exp(-np.abs(eta)).astype(f32)
            t = (np.maximum(eta, f32(0)) + np.log1p(e) - y[i] * eta).astype(f32)
            r = ((np.where(eta >= 0, f32(1), e) / (f32(1) + e)) - y[i]).astype(f32)
            u = (u + t).astype(f32)
            for k in range(D):
                g[:, k] = _fma(X[i, k], r, g[:, k])
        u_parts[lane], g_parts[lane] = u, g
    u, g = _butterfly(u_parts), _butterfly(g_parts)
    prior = np.zeros(P_, f32)
    for k in range(D):
        qc = (q[:, k] - pm[k]).astype(f32)
        prior = _fma((qc * qc).astype(f32), ipv[k], prior)
        g[:, k] = _fma(qc, ipv[k], g[:, k])
    return (u + f32(0.5) * prior + f32(dens.const)).astype(f32), g


def mixture_lanes(dens, q: np.ndarray, G: int):
    """U (P,) and grad U (P, 7) of the mixture functor at G lanes a chain:
    every lane sorts the means and normalises the weights; the eight
    sums (log-sum-exps, responsibilities and their moments) are split."""
    y, ipv, pm = dens.y.numpy(), dens.ipv.numpy(), dens.prior_mean.numpy()
    n, K = y.shape[0], 3
    P_ = q.shape[0]
    s = q[:, 0]
    perm = np.argsort(q[:, 1 + K:], axis=1, kind="stable")
    m = np.take_along_axis(q[:, 1 + K:], perm, axis=1)
    lw = q[:, 1:1 + K]
    lw_max = lw.max(axis=1)
    wsum = np.zeros(P_, f32)
    for k in range(K):
        wsum = (wsum + np.exp((lw[:, k] - lw_max).astype(f32))).astype(f32)
    l = (lw - (lw_max + np.log(wsum)).astype(f32)[:, None]).astype(f32)
    w = np.exp(l).astype(f32)
    iv = np.exp(f32(-2.0) * s).astype(f32)
    parts = np.zeros((G, 8, P_), f32)
    for lane in range(G):
        S = np.zeros((8, P_), f32)
        for i in _lane_rows(lane, G, n, 1):
            if i is None:
                continue
            d = (y[i] - m).astype(f32)
            c = (((f32(-0.5) * iv)[:, None] * (d * d)) - s[:, None] + l).astype(f32)
            cmax = c.max(axis=1)
            e = np.exp((c - cmax[:, None]).astype(f32)).astype(f32)
            se = ((e[:, 0] + e[:, 1]).astype(f32) + e[:, 2]).astype(f32)
            S[0] = (S[0] + (cmax + np.log(se)).astype(f32)).astype(f32)
            inv = (f32(1) / se).astype(f32)
            for k in range(K):
                r = (e[:, k] * inv).astype(f32)
                S[1 + k] = (S[1 + k] + r).astype(f32)
                S[4 + k] = _fma(r, d[:, k], S[4 + k])
                S[7] = _fma((r * d[:, k]).astype(f32), d[:, k], S[7])
        parts[lane] = S
    S = _butterfly(parts)
    fn = f32(n)
    dL = np.zeros((P_, 7), f32)
    dL[:, 0] = (iv * S[7] - fn).astype(f32)
    for k in range(K):
        dL[:, 1 + k] = (S[1 + k] - fn * w[:, k]).astype(f32)
    np.put_along_axis(dL[:, 1 + K:], perm, (iv[:, None] * S[4:7].T).astype(f32), axis=1)
    prior = np.zeros(P_, f32)
    g = np.zeros((P_, 7), f32)
    for k in range(7):
        qc = (q[:, k] - pm[k]).astype(f32)
        prior = _fma((qc * qc).astype(f32), ipv[k], prior)
        g[:, k] = _fma(qc, ipv[k], -dL[:, k])
    return (-S[0] + f32(0.5) * prior + f32(dens.const)).astype(f32), g


def ar1_lanes(dens, q: np.ndarray, G: int):
    """U (P,) and grad U (P, 4) of the AR(1) functor at G lanes a chain:
    each lane's segment map (phi^L, its phi-derivative, sum_{j<L} phi^j,
    its phi-derivative), an inclusive Hillis-Steele scan of the maps up the
    group, shifted to exclusive, the lane's start state from it, its steps,
    then the butterfly of the four sums."""
    y, ipv, pm = dens.y.numpy(), dens.ipv.numpy(), dens.prior_mean.numpy()
    coef_t, rate, const = dens.scal.numpy()
    T = y.shape[0]
    seg = -(-T // G)
    phi = np.tanh(q[:, 0]).astype(f32)
    drift, x0 = q[:, 1], q[:, 2]
    bounds = [(min(r * seg, T), min(min(r * seg, T) + seg, T)) for r in range(G)]
    maps = []
    for s0, s1 in bounds:
        a, da = np.ones_like(phi), np.zeros_like(phi)
        S, dS = np.zeros_like(phi), np.zeros_like(phi)
        for _ in range(s0, s1):
            dS = _fma(phi, dS, S)
            S = _fma(phi, S, f32(1))
            da = _fma(phi, da, a)
            a = (phi * a).astype(f32)
        maps.append((a, da, S, dS))
    off = 1
    while off < G:
        prev = list(maps)
        for r in range(off, G):
            a, da, S, dS = prev[r]
            pa, pda, pS, pdS = prev[r - off]
            maps[r] = ((a * pa).astype(f32), _fma(da, pa, (a * pda).astype(f32)),
                       _fma(a, pS, S), _fma(da, pS, _fma(a, pdS, dS)))
        off *= 2
    one, zero = np.ones_like(phi), np.zeros_like(phi)
    excl = [(one, zero, zero, zero)] + maps[:-1]
    sums = np.zeros((G, 4, q.shape[0]), f32)
    for r, ((s0, s1), (ea, eda, eS, edS)) in enumerate(zip(bounds, excl)):
        x = _fma(ea, x0, (drift * eS).astype(f32))
        t_phi, t_drift, t_x0 = _fma(eda, x0, (drift * edS).astype(f32)), eS, ea
        m = sums[r]
        for s in range(s0, s1):
            res = (x - y[s]).astype(f32)
            m[0], m[1] = _fma(res, res, m[0]), _fma(res, t_phi, m[1])
            m[2], m[3] = _fma(res, t_drift, m[2]), _fma(res, t_x0, m[3])
            t_phi = _fma(phi, t_phi, x)
            t_drift = _fma(phi, t_drift, f32(1))
            t_x0 = (phi * t_x0).astype(f32)
            x = _fma(phi, x, drift)
    sumsq, a_phi, a_drift, a_x0 = _butterfly(sums)
    t = q[:, 3]
    lam = np.exp(t).astype(f32)
    qc = (q[:, :3] - pm).astype(f32)
    prior = np.zeros_like(phi)
    for k in range(3):
        prior = _fma((qc[:, k] * qc[:, k]).astype(f32), ipv[k], prior)
    g = np.stack([_fma((lam * a_phi).astype(f32), (f32(1) - phi * phi).astype(f32),
                       (qc[:, 0] * ipv[0]).astype(f32)),
                  _fma(lam, a_drift, (qc[:, 1] * ipv[1]).astype(f32)),
                  _fma(lam, a_x0, (qc[:, 2] * ipv[2]).astype(f32)),
                  (f32(0.5) * lam * sumsq - coef_t + rate * lam).astype(f32)], 1)
    U = (f32(0.5) * lam * sumsq - coef_t * t + rate * lam + f32(0.5) * prior + const)
    return U.astype(f32), g


@pytest.fixture(scope="module")
def families():
    """name -> (the port's device density, JAX log density, template shapes,
    16 seeded points), from the JAX package's synthetic data."""
    X, y = jl.synthetic_logistic_data(jax.random.key(0))
    y_ar = js.synthetic_ar1_data(jax.random.key(0))
    y_mx = jm.synthetic_mixture_data(jax.random.key(0))
    rng = np.random.default_rng(5)
    q_l = (0.5 * rng.normal(size=(P, 5))).astype(f32)
    q_a = (0.5 * rng.normal(size=(P, 4)) + np.array([0.9, 0.5, -1.0, 3.0])).astype(f32)
    q_m = (0.5 * rng.normal(size=(P, 7))
           + np.array([0.0, 0, 0, 0, -2.0, 0.5, 3.0])).astype(f32)
    out = {}
    for name, jfn, tfn, shapes, q in (
            ("ar1", jax_transform(js.make_ar1_posterior(y_ar).log_prob, {"precision": JaxLog}),
             transform_logdensity(statespace.make_ar1_posterior(np.asarray(y_ar, f32),
                                                                device="cpu").log_prob,
                                  {"precision": LogTransform}),
             {"dynamics": (3,), "precision": ()}, q_a),
            ("logistic", jl.make_logistic_posterior(X, y).log_prob,
             logistic.make_logistic_posterior(np.asarray(X, f32), np.asarray(y, f32),
                                              device="cpu").log_prob,
             {"weights": (5,)}, q_l),
            ("mixture", jm.make_mixture_posterior(y_mx).log_prob,
             mixture.make_mixture_posterior(np.asarray(y_mx, f32), device="cpu").log_prob,
             {"log_sigma": (), "log_weights": (3,), "means": (3,)}, q_m)):
        template = {k: torch.zeros(s) for k, s in shapes.items()}
        out[name] = (device_density(tfn, template), jfn, shapes, q)
    return out


def _jax_potential(jfn, shapes, q):
    spec = pack_template({k: torch.zeros(s) for k, s in shapes.items()})

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


@pytest.mark.parametrize("G", WIDTHS)
@pytest.mark.parametrize("name", ["logistic", "ar1", "mixture"])
def test_lane_split_matches_plain_and_jax(families, name, G):
    dens, jfn, shapes, q = families[name]
    emulate = {"logistic": logistic_lanes, "ar1": ar1_lanes, "mixture": mixture_lanes}[name]
    U, g = emulate(dens, q, G)
    U_p, g_p = dens.potential_and_grad(torch.tensor(q))
    U_j, g_j = _jax_potential(jfn, shapes, q)
    for ref_U, ref_g in ((U_p.numpy(), g_p.numpy()), (U_j, g_j)):
        _close(U, ref_U)
        _close(g, ref_g)


@pytest.mark.parametrize("name", ["logistic", "mixture"])
def test_lane_rows_cover_every_row_once(families, name):
    """Every row lies with exactly one lane, at every width, in row order
    within the lane."""
    dens = families[name][0]
    n, floats = dens.n, (dens.D + 1 if name == "logistic" else 1)
    for G in WIDTHS:
        seen = []
        for lane in range(G):
            rows = [i for i in _lane_rows(lane, G, n, floats) if i is not None]
            assert rows == sorted(rows) and all(i % G == lane for i in rows)
            seen += rows
        assert sorted(seen) == list(range(n))


def test_ar1_segments_cover_the_recurrence():
    """The lanes' segments tile the T steps in order at every width (the
    last lanes' may be empty)."""
    for T in (1, 7, 64, 100):
        for G in WIDTHS:
            seg = -(-T // G)
            bounds = [(min(r * seg, T), min(min(r * seg, T) + seg, T)) for r in range(G)]
            assert bounds[0][0] == 0 and bounds[-1][1] == T
            assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))


def test_lanes_for_the_families(families):
    """The logistic, AR(1) and mixture branches take the width the card's
    sweep chose, one the kernels are instantiated for; the diagonal
    Gaussian keeps one lane."""
    from binf_tpu_torch.ops.kernels.densities import DiagGaussianDensity

    for name, (dens, *_) in families.items():
        G = fp.lanes_for(dens)
        assert G == fp.FAMILY_LANES[dens.functor]
        assert G in fp.FAMILY_WIDTHS[dens.functor]
    assert fp.lanes_for(DiagGaussianDensity([0.0, 1.0], [1.0, 2.0])) == 1


def _instantiated(kernel: str, csrc=CSRC) -> dict:
    """(functor, G) pairs instantiated in csrc's units of ``kernel``
    (fused_warmup: BINF_K3_*, fused_potential: BINF_K4_*)."""
    macro = {"fused_warmup": "BINF_K3", "fused_potential": "BINF_K4"}[kernel]
    found = {}
    for path in csrc.glob(f"{kernel}.*.cu"):
        text = path.read_text()
        for functor, G in re.findall(rf"{macro}_INSTANTIATE\((\w+)(?:<\d+>)?, (\d+)\)", text):
            found.setdefault(functor, set()).add(int(G))
        for G in re.findall(rf"{macro}_LINREG\((\d+)\)", text):
            found.setdefault("LinregDensity", set()).add(int(G))
    return found


@pytest.mark.parametrize("kernel", ["fused_warmup", "fused_potential"])
def test_every_named_width_is_instantiated(kernel):
    """The widths the wrappers may launch (``FAMILY_WIDTHS``) are the ones
    csrc instantiates K3 and K4 for, and ``with_density`` dispatches the
    logistic, AR(1) and mixture widths (one lane and the chosen width,
    unless BINF_FAMILY_SWEEP asks for every width of the sweep); K3's
    geometry takes every one of them."""
    found = _instantiated(kernel)
    for functor, widths in fp.FAMILY_WIDTHS.items():
        assert found[functor] == set(widths), functor
        assert set(widths) <= set(fp.LANE_WIDTHS)
    text = (CSRC / "densities.cuh").read_text()
    package = text[text.index("#ifndef BINF_FAMILY_SWEEP"):text.index("#else")]
    sweep = text[text.index("#else"):text.index("#endif")]
    for functor, macro in (("LogisticDensity", "LOGISTIC"), ("AR1Density", "AR1"),
                           ("MixtureDensity", "MIXTURE"), ("HierarchicalDensity", "HIER")):
        swept = HIER_WIDTHS if functor == "HierarchicalDensity" else WIDTHS
        for part, widths in ((package, set(fp.FAMILY_WIDTHS[functor])),
                             (sweep, set(swept))):
            line = re.search(rf"#define BINF_{macro}_G\(X\)(.*)", part).group(1)
            assert {int(G) for G in re.findall(r"X\((\d+)\)", line)} == widths, functor


def test_the_width_sweep_builds_every_width(tmp_path):
    """scripts/family_lanes.py's copy of csrc holds K3's and K4's units for
    every family at every width of the sweep, compiled with the define
    that makes with_density dispatch them."""
    spec = importlib.util.spec_from_file_location(
        "family_lanes", CSRC.parents[1] / "scripts" / "family_lanes.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    build = types.SimpleNamespace(BUILD_ROOT=tmp_path, CSRC=CSRC, NVCC_FLAGS=("-O3",))
    script.sweep_sources(build, WIDTHS)
    assert build.NVCC_FLAGS == ("-O3", "-DBINF_FAMILY_SWEEP")
    assert build.CSRC.parent == tmp_path and (build.CSRC / "densities.cuh").exists()
    for kernel in ("fused_warmup", "fused_potential"):
        found = _instantiated(kernel, build.CSRC)
        for functor in ("LogisticDensity", "AR1Density", "MixtureDensity"):
            assert found[functor] == set(WIDTHS), (kernel, functor)
        assert found["HierarchicalDensity"] == set(HIER_WIDTHS), kernel
        assert found["LinregDensity"] == set(fp.FAMILY_WIDTHS["LinregDensity"])
    logistic = (build.CSRC / "fused_warmup.logistic.g16.cu").read_text()
    assert all(f"BINF_K3_INSTANTIATE(LogisticDensity<{D}>, 16)" in logistic
               for D in range(1, 9))


@pytest.mark.parametrize("G, fit, expect", [
    # the families path: 8,192 chains in one tile; a CTA round holds 256 / G
    # chains, a slice (S = 256 / G chains) spans S G / 32 = 8 warps
    (4, 264, dict(slice_chains=64, chains_per_cta=64, ctas=128, rounds=1, resident=True)),
    (8, 264, dict(slice_chains=32, chains_per_cta=32, ctas=256, rounds=1, resident=True)),
    (16, 264, dict(slice_chains=16, chains_per_cta=16, ctas=256, rounds=2, resident=False)),
    (16, 528, dict(slice_chains=16, chains_per_cta=16, ctas=512, rounds=1, resident=True)),
    (32, 264, dict(slice_chains=8, chains_per_cta=8, ctas=256, rounds=4, resident=False)),
    (32, 1056, dict(slice_chains=8, chains_per_cta=8, ctas=1024, rounds=1, resident=True)),
])
def test_warmup_geometry_at_the_family_widths(G, fit, expect):
    geo = fp.warmup_geometry(8192, 8192, G, fit)
    assert geo.lanes == G and geo.slices_per_tile == 8192 // geo.slice_chains
    for key, value in expect.items():
        assert getattr(geo, key) == value, key
    assert geo.slice_chains * G == fp.K3_THREADS  # one slice a CTA round
    assert geo.ctas * geo.rounds * geo.chains_per_cta >= 8192
    # small tiles at a wide group: the slice halves until it divides the tile
    small = fp.warmup_geometry(8192, 4, G, fit)
    assert small.slice_chains == min(4, 256 // G) and small.slices_per_tile == 4 // small.slice_chains


@pytest.mark.parametrize("G", [3, 48, 512])
def test_warmup_geometry_refuses_a_width_not_instantiated(G):
    """64, 128 and 256 lanes are the wide branches' groups of 2, 4 and 8
    warps (test_warmup_geometry_at_the_wide_widths); 48 and 512 no kernel
    takes."""
    with pytest.raises(ValueError, match="instantiated"):
        fp.warmup_geometry(8192, 8192, G, 264)


@pytest.mark.parametrize("G", [64, 128, 256])
def test_warmup_geometry_at_the_wide_widths(G):
    """The wide branch at a group of G / 32 warps a chain: 256 / G chains a
    CTA round, the slice no wider than a round."""
    geo = fp.warmup_geometry(128, 32, G, 264)
    assert geo.lanes == G and geo.chains_per_cta == 256 // G
    assert geo.slice_chains == 256 // G and geo.slices_per_tile == 32 // geo.slice_chains
    assert geo.ctas * geo.rounds * geo.chains_per_cta >= 128
