"""K3 and K4 at the family dimensions the reference's constructors take
(``binf_tpu_torch/ops/kernels/densities.py::KERNEL_DIMS``), on the CPU:
the mixture at K = 2, 4, 5, the hierarchical posterior at 4, 6 and 16
groups, the logistic posterior at d = 12 and linear regression at 12
coefficients (``family_dims_problems.py`` builds each in both packages
from the same numpy data).

Checked for each shape: the recogniser finds it, K3 and K4 take it
(``kernel_refusal``) through a unit built at first use (``_build.
shape_libraries``, named by the family code, D and the width
``lanes_for`` picks); ``potential_and_grad`` agrees with the JAX
package's ``log_prob`` and ``jax.grad`` at 16 seeded points to 1e-5
relative to the largest value (float32 sums in other orders; the linear
regression's potential drops the posterior's constants, so its values
agree up to one constant).  The plain K3 and K4 against the JAX package's
kernels are in ``test_torch_family_dims_kernels.py``.  Also: the bounds of the ranges, the hierarchical posterior's lane width,
one Philox stream contract at every D, the on-demand build with a stand-in
compiler, and the mixture's sorting network."""

import stat
import sys

import numpy as np
import pytest
import torch

import family_dims_problems as fdp
from binf_tpu_torch.ops.kernels import _build, densities
from binf_tpu_torch.ops.kernels import fused_potential as fp
from binf_tpu_torch.ops.kernels.densities import (DiagGaussianDensity, HierarchicalDensity,
                                                  LinregDensity, device_density)
from binf_tpu_torch.ops.kernels.prng import TAG_RUN, step_noise
from binf_tpu_torch.samplers import auto
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
P = 16
NAMES = list(fdp.SHAPES)
# the width lanes_for picks at each shape
LANES = {"mixture_k2": 8, "mixture_k4": 8, "mixture_k5": 8, "hierarchical_ng4": 4,
         "hierarchical_ng6": 2, "hierarchical_ng16": 4,
         "logistic_d12": 8, "linreg_12": 8}


@pytest.fixture(scope="module", params=NAMES)
def shape(request):
    name = request.param
    jfn, tfn, shapes, cls, centre = fdp.problem(name)
    return name, jfn, tfn, shapes, cls, centre, device_density(tfn, fdp.template(shapes))


def test_recogniser_finds_the_shape_and_the_kernels_take_it(shape, monkeypatch):
    name, _, tfn, shapes, cls, _, density = shape
    D = sum(int(np.prod(s)) for s in shapes.values())
    assert type(density) is cls and density.D == D
    assert D not in densities.FAMILY_DIMS[density.functor]  # no unit of csrc
    assert D in densities.KERNEL_DIMS[density.functor]
    assert fp.kernel_refusal(density) is None
    G = fp.lanes_for(density)
    assert G == LANES[name] and G in fp.LANE_WIDTHS
    asked = []
    monkeypatch.setattr(_build, "shape_libraries",
                        lambda *shape_: asked.append(shape_) or _build.shape_names(*shape_))
    assert fp._libraries(density, G) == _build.shape_names(densities.FAMILIES[density.functor],
                                                           D, G)
    assert asked == [(densities.FAMILIES[density.functor], D, G)]
    start = {k: torch.zeros((4,) + tuple(s)) for k, s in shapes.items()}
    dec = auto.route_algorithm(tfn, start)
    assert dec.path == "fused" and dec.reason.startswith(f"device density: {cls.__name__}")


def test_potential_and_grad_match_jax(shape):
    name, jfn, _, shapes, _, centre, density = shape
    q = fdp.points(centre, 1, P)
    U, g = density.potential_and_grad(torch.tensor(q))
    ld, jg = fdp.jax_value_and_grad(jfn, shapes, q)
    tol = RTOL * np.abs(ld).max()
    if isinstance(density, LinregDensity):  # U drops the posterior's constants
        offset = -U.numpy() - ld
        np.testing.assert_allclose(offset, offset[0], rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(-U.numpy(), ld, rtol=0, atol=tol)
    np.testing.assert_allclose(-g.numpy(), jg, rtol=0, atol=RTOL * np.abs(jg).max())


def test_bounds_of_the_ranges():
    """Past each range the recogniser finds nothing, or the kernels refuse
    the density with the reason the router gives; their raise is the
    predicate's."""
    from family_dims_problems import _np
    from binf_tpu.example import mixture as jm
    import jax
    from binf_tpu_torch.example import hierarchical, logistic, mixture
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    y = _np(jm.synthetic_mixture_data(jax.random.key(0)))
    X, _ = fdp._design(0, 50, 33)
    x, yh, c = np.linspace(-3, 3, 15), np.zeros(17 * 15), np.ones(17)
    unrecognised = [
        (mixture.make_mixture_posterior(y, 9, device="cpu").log_prob,
         {"log_sigma": (), "log_weights": (9,), "means": (9,)}),
        (logistic.make_logistic_posterior(X, np.ones(50), device="cpu").log_prob,
         {"weights": (33,)}),
        (transform_logdensity(hierarchical.make_hierarchical_posterior(
            x, yh, c, 17, device="cpu").log_prob, {"precision": LogTransform}),
         {"group_params": (17, 2), "log_tau": (2,), "mu": (2,), "precision": ()}),
    ]
    # each gets a generated functor instead: the mixture of 9 components (D
    # = 19) at one lane, the 33-feature logistic regression and the
    # 17-group hierarchical posterior (D = 39) in the wide form, which K3
    # and K4 take; a position past the wide form's MAX_D_WIDE coordinates
    # is refused by the compiler
    for (fn, shapes), D in zip(unrecognised, (19, 33, 39)):
        traced = device_density(fn, fdp.template(shapes))
        assert isinstance(traced, densities.TracedDensity) and traced.D == D
        assert traced.wide == (D > 32) and fp.kernel_refusal(traced) is None
    from binf_tpu_torch.ops.kernels.density_compiler import MAX_D_WIDE

    with pytest.raises(NotImplementedError, match=f"at most {MAX_D_WIDE}"):
        device_density(lambda p: -0.5 * torch.sum(p["x"] ** 2),
                       {"x": torch.zeros(MAX_D_WIDE + 1)})
    refused = [DiagGaussianDensity(np.zeros(33), np.ones(33)),
               LinregDensity(np.ones((20, 17)), np.zeros(20), np.ones(17), 1.0, 0.2),
               HierarchicalDensity(x, np.zeros(20 * 15), np.ones(20), 20)]
    for density in refused:
        why = fp.kernel_refusal(density)
        assert why.startswith(fp.REFUSED) and f"not D={density.D}" in why, why
        with pytest.raises(NotImplementedError, match="not D="):
            fp.refuse(density, ("K4",))
    assert fp.kernel_refusal(DiagGaussianDensity(np.zeros(32), np.ones(32))) is None


@pytest.mark.parametrize("NG", range(2, 17))
def test_hierarchical_lane_width(NG):
    """A lane owns whole groups: the widest of 1, 2, 4 dividing NG (the
    card's sweep kept 4 at 8 groups; at 16 the card ran 4 lanes faster
    than 8)."""
    dens = HierarchicalDensity(np.linspace(-3, 3, 5), np.zeros(NG * 5), np.ones(NG), NG)
    G = fp.lanes_for(dens)
    assert NG % G == 0 and G in fp.LANE_WIDTHS
    assert G == max(g for g in (1, 2, 4) if NG % g == 0)


@pytest.mark.parametrize("D", [9, 12, 13, 17, 21, 32, 37])
def test_one_philox_stream_at_every_dimension(D):
    """The stream contract is one at every D: coordinate k's normal is
    slot k // 2's, whatever D, and the accept uniform has its own slot, so
    a step's noise at D extends the noise at any smaller D."""
    chains = torch.arange(40, dtype=torch.int64)
    z, u = step_noise(5, TAG_RUN, chains, 3, D)
    z8, u8 = step_noise(5, TAG_RUN, chains, 3, 8)
    assert z.shape == (40, D) and torch.equal(z[:, :8], z8) and torch.equal(u, u8)
    zodd, _ = step_noise(5, TAG_RUN, chains, 3, D - 1)
    assert torch.equal(z[:, :D - 1], zodd)


def test_shape_build_with_a_stand_in_compiler(tmp_path, monkeypatch):
    """``shape_libraries`` compiles K3's and K4's shape units at once with
    the shape as -D macros into the hashed build directory, records the
    seconds, and loads nothing it did not build; a failed compile raises
    with the compiler's output."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "args = sys.argv[1:]\n"
                    "if '-DBINF_SHAPE_D=99' in args:\n"
                    "    print('error: no such shape'); sys.exit(2)\n"
                    "open(args[args.index('-o') + 1], 'w').write(' '.join(args))\n"
                    "print('ptxas info    : Used 40 registers')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "SHAPE_BUILDS", {})
    monkeypatch.setattr(_build, "_shapes_ready", set())
    names = _build.shape_libraries(4, 9, 8)
    assert names == ("fused_warmup_shape.f4.d9.g8", "fused_potential_shape.f4.d9.g8")
    out = _build.build_dir()
    for name in names:
        args = (out / f"lib{name}.so").read_text().split()
        assert {"-DBINF_SHAPE_FAMILY=4", "-DBINF_SHAPE_D=9", "-DBINF_SHAPE_G=8"} <= set(args)
        assert args[-1] == str(_build.CSRC / f"{name.split('.')[0]}.cu")
        assert "Used 40 registers" in (out / f"{name}.log").read_text()
    assert set(_build.SHAPE_BUILDS) == {"f4.d9.g8"} and _build.SHAPE_BUILDS["f4.d9.g8"] > 0
    _build.build_all((), [(5, 13, 4), (2, 12, 8), (4, 9, 8)])
    assert set(_build.SHAPE_BUILDS) == {"f4.d9.g8", "f5.d13.g4", "f2.d12.g8"}
    with pytest.raises(RuntimeError, match="is not built"):
        _build.load("fused_warmup_shape.f4.d11.g8")
    with pytest.raises(RuntimeError, match="no such shape"):
        _build.shape_libraries(1, 99, 1)
    assert not (out / "libfused_warmup_shape.f1.d99.g1.so").exists()


def test_shape_units_carry_the_entry_points():
    """The shape units define the C entry points the wrappers bind, and
    shape.cuh maps every family code of densities.py to its functor (a
    traced density's, family 6, is named by its emitted header through
    traced_density.cuh's macro)."""
    csrc = _build.CSRC
    k3 = (csrc / "fused_warmup_shape.cu").read_text()
    k4 = (csrc / "fused_potential_shape.cu").read_text()
    for fn in ("binf_fused_warmup(", "binf_fused_warmup_max_ctas("):
        assert fn in k3
    for fn in ("binf_fused_potential_hmc(", "binf_fused_potential_occupancy(",
               "binf_density_eval("):
        assert fn in k4
    shape = (csrc / "shape.cuh").read_text()
    cuh = (csrc / "densities.cuh").read_text()
    for functor, code in densities.FAMILIES.items():
        assert f"#{'if' if code == 0 else 'elif'} BINF_SHAPE_FAMILY == {code}\n" in shape
        if functor == "TracedDensity":
            assert "struct FromOperands<T>" in (csrc / "traced_density.cuh").read_text()
        else:
            assert f"struct FromOperands<{functor}" in cuh


def _odd_even(m):
    """The mixture functor's sort (csrc/mixture_density.cuh): K passes of
    compare-and-swap of neighbours (a, a + 1), a = pass % 2, pass % 2 + 2,
    ..., on a strict <, keeping the permutation."""
    m, perm = list(m), list(range(len(m)))
    K = len(m)
    for p in range(K):
        for a in range(p & 1, K - 1, 2):
            if m[a + 1] < m[a]:
                m[a], m[a + 1] = m[a + 1], m[a]
                perm[a], perm[a + 1] = perm[a + 1], perm[a]
    return m, perm


@pytest.mark.parametrize("K", range(2, 9))
def test_the_mixture_network_is_a_stable_sort(K):
    """At every K the network sorts, and keeps tied means in their order,
    as ``torch.sort(stable=True)`` in the plain version does (and
    ``jnp.sort``): a tie's gradient goes to the same coordinate on both."""
    rng = np.random.default_rng(K)
    for trial in range(200):
        m = rng.integers(0, 3, size=K).astype(np.float32)  # many ties
        if trial % 2:
            m = rng.normal(size=K).astype(np.float32)
        got, perm = _odd_even(m)
        ref = torch.sort(torch.tensor(m), stable=True)
        assert got == ref.values.tolist() and perm == ref.indices.tolist()
