"""The port's model DSL against the JAX package: ``core`` (Density,
conditioning), ``model`` (forward and error models), ``pdf``
(distributions, priors, derived parameters, transforms, likelihood,
posterior), ``ops.math`` and ``ops.tree``, ``example.polynomial`` and the
device densities of ``ops.kernels.densities``.

The reference values are those of ``tests/test_density.py`` (-13.0,
-29.0), ``tests/test_likelihood.py`` (252.0 and its chain-rule gradient)
and ``tests/test_posterior.py``, merged into parametrised cases.  Where the
port is held against the JAX function, both get the same numpy inputs and
agree to float32 rounding (rtol 1e-5 unless a case says otherwise).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binf_tpu.core as jcore
import binf_tpu.model as jmodel
import binf_tpu.ops.math as jmath
import binf_tpu.ops.tree as jtree
import binf_tpu.pdf.distributions as jdist
import binf_tpu.pdf.parameters as jparams
import binf_tpu.pdf.priors as jpriors
import binf_tpu.pdf.transforms as jtransforms
from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.ops.pallas.fused_hmc import linreg_unconstrained_logdensity
from binf_tpu_torch.core import Density, VariableSpec, frozen_dataclass, replace, static_field
from binf_tpu_torch.core.density import MOCK_DATA
from binf_tpu_torch.example.polynomial import make_posterior
import binf_tpu_torch.model as tmodel
from binf_tpu_torch.model import (
    ErrorModel,
    ForwardModel,
    LinearForwardModel,
    PolynomialForwardModel,
)
from binf_tpu_torch.ops import math as tmath
from binf_tpu_torch.ops import tree as ttree
from binf_tpu_torch.ops.kernels.densities import (
    CallableDensity,
    DiagGaussianDensity,
    LinregDensity,
    TracedDensity,
    device_density,
    recognise,
)
from binf_tpu_torch.pdf import GammaPrior, Likelihood
from binf_tpu_torch.pdf import distributions as tdist
from binf_tpu_torch.pdf import parameters as tparams
from binf_tpu_torch.pdf import priors as tpriors
from binf_tpu_torch.pdf import transforms as ttransforms

TRUTH = np.array([2.0, -4.0, 1.0, 1.5], np.float32)
XSES = np.linspace(-2, 2, 20).astype(np.float32)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


# -- core: the reference's mock density ------------------------------------------


@frozen_dataclass
class MockDensity(Density):
    """log p = -0.5 * A * (x^2 + y^2), A = 2 (the reference's mock)."""

    param_a: torch.Tensor
    fixed: dict
    name: str = static_field(default="mock")

    @classmethod
    def create(cls, a=2.0):
        return cls(param_a=torch.tensor(a), fixed={})

    @property
    def variable_specs(self):
        return (VariableSpec("x"), VariableSpec("y"))

    def _log_prob(self, values):
        return -0.5 * self.param_a * (values["x"] ** 2 + values["y"] ** 2)


@pytest.mark.parametrize("build, values, expected", [
    (lambda p: p, dict(x=3.0, y=2.0), -13.0),
    (lambda p: p.fix(y=2.0), dict(x=3.0), -13.0),
    (lambda p: p.conditional_factory(x=5.0), dict(y=2.0), -29.0),
    (lambda p: p.conditional_factory(x=5.0).conditional_factory(y=2.0), {}, -29.0),
    (lambda p: p.fix(x=5.0).update_fixed(x=1.0), dict(y=0.0), -1.0),
], ids=["joint", "fix", "conditional", "chained", "update_fixed"])
def test_reference_values(build, values, expected):
    assert float(build(MockDensity.create()).log_prob(**values)) == expected


@pytest.mark.parametrize("build, free", [
    (lambda p: p, ("x", "y")),
    (lambda p: p.fix(y=5.0), ("x",)),
    (lambda p: p.conditional_factory(x=5.0).conditional_factory(y=2.0), ()),
    (lambda p: MockDensity.create().set_fixed_from(p.fix(y=2.0)), ("x",)),
], ids=["sorted", "fix", "chained", "set_fixed_from"])
def test_free_variables(build, free):
    pdf = build(MockDensity.create())
    assert pdf.variables == free
    assert pdf.differentiable_variables == free
    for name, value in pdf.fixed.items():
        assert float(value) in (2.0, 5.0)


@pytest.mark.parametrize("call", [
    lambda p: p.log_prob(x=1.0),
    lambda p: p.log_prob(x=1.0, y=1.0, z=1.0),
    lambda p: p.fix(z=2.0),
    lambda p: p.update_fixed(x=1.0),
], ids=["missing", "unexpected", "fix_unknown", "update_not_fixed"])
def test_value_dict_strictness(call):
    with pytest.raises(ValueError):
        call(MockDensity.create())


def test_complete_values_injection_and_density():
    pdf = MockDensity.create().fix(x=7.0)
    complete = pdf._complete_values({"y": torch.tensor(2.34)})
    assert float(complete["x"]) == 7.0 and float(complete["y"]) == pytest.approx(2.34)
    assert float(MockDensity.create()(x=3.0, y=2.0)) == pytest.approx(math.exp(-13.0))


@pytest.mark.parametrize("pdf, values, expected", [
    (MockDensity.create(), dict(x=3.0, y=2.0), {"x": -6.0, "y": -4.0}),
    (MockDensity.create().fix(x=5.0), dict(y=2.0), {"y": -4.0}),
], ids=["joint", "conditional"])
def test_gradient(pdf, values, expected):
    g = pdf.gradient(**values)
    assert {k: float(v) for k, v in g.items()} == pytest.approx(expected)
    value, g2 = pdf.value_and_gradient(**values)
    assert float(value) == float(pdf.log_prob(**values))
    assert {k: float(v) for k, v in g2.items()} == pytest.approx(expected)


def test_vmap_over_values_and_init_values():
    pdf = MockDensity.create()
    xs = torch.arange(4.0)
    lps = torch.func.vmap(lambda x: pdf.log_prob(x=x, y=torch.tensor(0.0)))(xs)
    torch.testing.assert_close(lps, -0.5 * 2.0 * xs ** 2)
    assert {k: v.shape for k, v in pdf.init_values().items()} == {"x": (), "y": ()}
    assert replace(pdf, param_a=torch.tensor(4.0)).log_prob(x=1.0, y=0.0) == -2.0


# -- likelihood: the reference's mock forward and error models ----------------------


J = torch.tensor([[2.0, 1.0], [1.0, 2.0], [1.0, 2.0]])


@frozen_dataclass
class MockForwardModel(ForwardModel):
    """f(X, b) = b * [1, 2, 3] (X enters with zero weight)."""

    name: str = static_field(default="testfwm")

    @property
    def variable_specs(self):
        return (VariableSpec("X", shape=(2,)), VariableSpec("b", differentiable=False))

    def _evaluate(self, values):
        return values["b"] * torch.tensor([1.0, 2.0, 3.0]) + values["b"] * (
            J @ (values["X"] - values["X"]))


@frozen_dataclass
class MockLinearForwardModel(ForwardModel):
    """mock = b * (J @ X)."""

    name: str = static_field(default="linfwm")

    @property
    def variable_specs(self):
        return (VariableSpec("X", shape=(2,)), VariableSpec("b", differentiable=False))

    def _evaluate(self, values):
        return values["b"] * (J @ values["X"])


@frozen_dataclass
class MockErrorModel(ErrorModel):
    """log p = a * sum(mock_data^2)."""

    data: torch.Tensor
    fixed: dict
    name: str = static_field(default="stupid_error")

    @classmethod
    def create(cls):
        return cls(data=torch.zeros(3), fixed={})

    @property
    def variable_specs(self):
        return (VariableSpec(MOCK_DATA, shape=(3,)),
                VariableSpec("a", differentiable=False))

    def _log_prob(self, values):
        return values["a"] * torch.sum(values[MOCK_DATA] ** 2)


@pytest.fixture
def lik():
    return Likelihood.create("testL", MockForwardModel(), MockErrorModel.create())


def test_likelihood_variables_and_routing(lik):
    assert lik.variables == ("X", "a", "b") and MOCK_DATA not in lik.variables
    fwm_vals, em_vals = lik._split_values(
        {"X": torch.tensor([1.0, 2.0]), "a": torch.tensor(5.0), "b": torch.tensor(2.0)})
    assert set(fwm_vals) == {"X", "b"} and set(em_vals) == {"a"}
    assert lik.conditional_factory(b=3.0).variables == ("X", "a")


@pytest.mark.parametrize("build, values, expected", [
    (lambda l: l, dict(X=torch.tensor([1.2, 4.2]), a=2.0, b=3.0), 252.0),
    (lambda l: l.conditional_factory(b=3.0), dict(X=torch.zeros(2), a=2.0), 252.0),
    (lambda l: replace(l, temper=0.5), dict(X=torch.zeros(2), a=2.0, b=3.0), 126.0),
], ids=["log_prob", "conditioned", "tempered"])
def test_likelihood_252(lik, build, values, expected):
    assert float(build(lik).log_prob(**values)) == pytest.approx(expected)


def test_chain_rule_gradient_via_autodiff():
    """grad_X = (bJ)^T (2 a mock); with the reference's constant mock
    b * [1, 2, 3] it is [14 a b^2, 22 a b^2]."""
    lik = Likelihood.create("g", MockLinearForwardModel(), MockErrorModel.create())
    a, b = 2.0, 3.0
    X = torch.tensor([1.0, 1.0])
    g = lik.gradient(X=X, a=a, b=b)
    torch.testing.assert_close(g["X"], (b * J).T @ (2.0 * a * (b * (J @ X))))
    mock_ref = b * torch.tensor([1.0, 2.0, 3.0])
    torch.testing.assert_close((b * J).T @ (2.0 * a * mock_ref),
                               torch.tensor([14 * a * b ** 2, 22 * a * b ** 2]))


# -- posterior ----------------------------------------------------------------------


@pytest.fixture
def poly_posterior():
    ys = tmath.polyval(torch.tensor(XSES), torch.tensor(TRUTH))
    return make_posterior(XSES, ys)


def test_posterior_structure(poly_posterior):
    assert poly_posterior.variables == ("coefficients", "precision")
    assert poly_posterior.differentiable_variables == ("coefficients", "precision")
    cond = poly_posterior.conditional_factory(precision=2.5)
    assert cond.variables == ("coefficients",)
    c = torch.tensor(TRUTH)
    assert float(cond.log_prob(coefficients=c)) == pytest.approx(
        float(poly_posterior.log_prob(coefficients=c, precision=2.5)), rel=1e-6)


@pytest.mark.parametrize("prec", [1.0, 2.5])
def test_posterior_components(poly_posterior, prec):
    c = torch.tensor(TRUTH)
    parts = poly_posterior.component_log_probs(coefficients=c, precision=prec)
    assert set(parts) == {"points", "precision_prior", "coefficients_prior"}
    total = poly_posterior.log_prob(coefficients=c, precision=prec)
    assert float(total) == pytest.approx(float(sum(parts.values())), rel=1e-5)
    # zero residuals at the truth: the likelihood is n/2 log(prec)
    assert float(parts["points"]) == pytest.approx(10.0 * math.log(prec), abs=1e-4)


def test_posterior_gradient_analytic_and_fd(poly_posterior):
    c, prec = torch.tensor([1.0, 1.0, 1.0, 1.0]), 2.5
    g = poly_posterior.gradient(coefficients=c, precision=prec)
    V = poly_posterior.likelihoods["points"].forward_model.vandermonde
    y = poly_posterior.likelihoods["points"].error_model.data
    resid = V @ c - y
    torch.testing.assert_close(g["coefficients"], -prec * (V.T @ resid) - c / 5.0,
                               rtol=1e-4, atol=1e-3)
    expected_p = -0.5 * float(resid @ resid) + 0.5 * 20 / prec - 0.2
    assert float(g["precision"]) == pytest.approx(expected_p, rel=1e-4)
    # central differences in float32, the tolerance of tests/test_posterior.py
    c2, p2, h = torch.tensor([0.5, -1.0, 0.3, 0.7]), 1.7, 1e-3
    g2 = poly_posterior.gradient(coefficients=c2, precision=p2)["coefficients"]
    for i in range(4):
        dc = torch.zeros(4)
        dc[i] = h
        fd = (poly_posterior.log_prob(coefficients=c2 + dc, precision=p2)
              - poly_posterior.log_prob(coefficients=c2 - dc, precision=p2)) / (2 * h)
        assert float(g2[i]) == pytest.approx(float(fd), rel=2e-2)


def test_tempered_posterior_and_vmap(poly_posterior):
    c = torch.tensor([0.5, -1.0, 0.3, 0.7])
    ll = poly_posterior.log_likelihood(coefficients=c, precision=1.3)
    half = poly_posterior.tempered(0.5)
    assert float(half.log_likelihood(coefficients=c, precision=1.3)) == pytest.approx(
        0.5 * float(ll), rel=1e-5)
    parts = poly_posterior.tempered(0.0).component_log_probs(coefficients=c, precision=1.3)
    assert float(parts["points"]) == pytest.approx(0.0, abs=1e-6)
    batched = torch.func.vmap(
        lambda cc, pp: poly_posterior.log_prob(coefficients=cc, precision=pp))(
        torch.ones(8, 4), torch.full((8,), 2.0))
    assert batched.shape == (8,) and torch.isfinite(batched).all()


# -- the port's DSL against the JAX package's --------------------------------------------


def _both_posteriors():
    rng = np.random.default_rng(11)
    ys = (np.polynomial.polynomial.polyval(XSES, TRUTH)
          + rng.normal(size=20) / np.sqrt(2.5)).astype(np.float32)
    jpost = jax_make_posterior(jnp.asarray(XSES), jnp.asarray(ys))
    tpost = make_posterior(XSES, ys)
    return jpost, tpost, ys


def _positions(n=6, seed=12):
    rng = np.random.default_rng(seed)
    return [{"coefficients": (TRUTH + 0.5 * rng.normal(size=4)).astype(np.float32),
             "precision": np.float32(rng.normal(scale=0.5))} for _ in range(n)]


@pytest.mark.parametrize("space", ["constrained", "unconstrained"])
def test_dsl_posterior_matches_jax(space):
    """Value and gradient at seeded positions, rtol 1e-5 (values of a few
    hundred summed in float32)."""
    jpost, tpost, _ = _both_posteriors()
    if space == "unconstrained":
        jld = jtransforms.transform_logdensity(jpost.log_prob, {"precision": jtransforms.LogTransform})
        tld = ttransforms.transform_logdensity(tpost.log_prob, {"precision": ttransforms.LogTransform})
    else:
        jld, tld = jpost.log_prob, tpost.log_prob
    for pos in _positions():
        if space == "constrained":
            pos = dict(pos, precision=np.float32(np.exp(pos["precision"])))
        jv, jg = jax.value_and_grad(jld)({k: jnp.asarray(v) for k, v in pos.items()})
        tg, tv = torch.func.grad_and_value(tld)({k: torch.tensor(v) for k, v in pos.items()})
        np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5)
        for k in pos:
            np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]), rtol=1e-5, atol=1e-4)


def _dist_cases():
    x = np.array([0.2, 1.0, 3.7], np.float32)
    u = np.array([0.1, 0.5, 0.9], np.float32)
    k = np.array([0.0, 2.0, 5.0], np.float32)
    return [
        ("normal_log_prob", (x, 0.5, 2.0)),
        ("halfnormal_log_prob", (x - 1.0, 1.5)),
        ("mv_normal_diag_log_prob", (x, np.zeros(3, np.float32), np.array([1.0, 2.0, 0.5], np.float32))),
        ("gamma_log_prob", (x, 2.5, 1.3)),
        ("inverse_gamma_log_prob", (x, 2.5, 1.3)),
        ("exponential_log_prob", (x, 1.7)),
        ("uniform_log_prob", (x, 0.0, 2.0)),
        ("beta_log_prob", (u, 2.0, 3.0)),
        ("laplace_log_prob", (x, 0.5, 1.5)),
        ("student_t_log_prob", (x, 4.0, 0.5, 1.5)),
        ("cauchy_log_prob", (x, 0.5, 1.5)),
        ("lognormal_log_prob", (x, 0.1, 0.8)),
        ("poisson_log_prob", (k, np.float32(2.5))),
        ("bernoulli_log_prob", (np.array([0.0, 1.0, 1.0], np.float32), x - 1.0)),
        ("binomial_log_prob", (k, 6.0, x - 1.0)),
        ("negative_binomial_log_prob", (k, 3.0, x - 1.0)),
        ("categorical_log_prob", (np.array([0, 2, 1]), np.array([0.1, -1.0, 2.0], np.float32))),
        ("dirichlet_log_prob", (np.array([0.2, 0.3, 0.5], np.float32), np.array([1.5, 2.0, 3.0], np.float32))),
        ("weibull_log_prob", (x, 1.5, 2.0)),
        ("von_mises_log_prob", (x, 0.3, np.array([0.5, 4.0, 9.0], np.float32))),
        ("truncated_normal_log_prob", (x, 1.0, 1.5, 0.0, 3.0)),
    ]


@pytest.mark.parametrize("name, args", _dist_cases(), ids=[c[0] for c in _dist_cases()])
def test_distribution_matches_jax(name, args):
    ref = getattr(jdist, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tdist, name)(*[torch.as_tensor(np.asarray(a)) for a in args])
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fn", ["lgamma", "i0e"])
def test_special_polynomials_match_jax(fn):
    """The Lanczos lgamma and the A&S i0e are the JAX package's own
    polynomials, not torch.lgamma; equal to float32 rounding."""
    x = np.concatenate([np.linspace(0.05, 30.0, 200), [0.3, 0.5, 1.0, 2.0, 3.75, 3.76]])
    if fn == "i0e":
        x = np.concatenate([-x, x])
    x = x.astype(np.float32)
    ref = np.asarray(getattr(jmath, fn)(jnp.asarray(x)))
    got = _np(getattr(tmath, fn)(torch.tensor(x)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


def test_math_helpers_match_jax():
    x = np.array([[-100.0, -1.0, 0.0], [2.0, 50.0, 200.0]], np.float32)
    np.testing.assert_allclose(_np(tmath.safe_exp(torch.tensor(x))),
                               np.asarray(jmath.safe_exp(jnp.asarray(x))), rtol=1e-6)
    pos = np.abs(x) + 0.5
    np.testing.assert_allclose(_np(tmath.safe_log(torch.tensor(pos))),
                               np.asarray(jmath.safe_log(jnp.asarray(pos))), rtol=1e-6)
    # at zero the floor 1e-38 is a float32 subnormal, which XLA on the CPU
    # flushes to zero (log 0 = -inf); the port keeps the floor
    assert float(tmath.safe_log(torch.zeros(()))) == pytest.approx(math.log(1e-38), rel=1e-6)
    for axis in (None, 0, 1):
        np.testing.assert_allclose(
            _np(tmath.log_sum_exp(torch.tensor(x), axis=axis, keepdims=True)),
            np.asarray(jmath.log_sum_exp(jnp.asarray(x), axis=axis, keepdims=True)), rtol=1e-6)
    samples = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    js = jmath.welford_init({"a": jnp.zeros(3), "b": jnp.zeros(())})
    ts = tmath.welford_init({"a": torch.zeros(3), "b": torch.zeros(())})
    for s in samples:
        js = jmath.welford_update(js, {"a": jnp.asarray(s), "b": jnp.asarray(s[0])})
        ts = tmath.welford_update(ts, {"a": torch.tensor(s), "b": torch.tensor(s[0])})
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(tmath.welford_mean(ts)[k]),
                                   np.asarray(jmath.welford_mean(js)[k]), rtol=1e-6)
        np.testing.assert_allclose(_np(tmath.welford_variance(ts)[k]),
                                   np.asarray(jmath.welford_variance(js)[k]), rtol=1e-6)


def test_tree_helpers_match_jax():
    a = {"x": np.array([1.0, 2.0], np.float32), "s": np.float32(3.0)}
    b = {"x": np.array([0.5, -1.0], np.float32), "s": np.float32(-2.0)}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ta = {k: torch.tensor(v) for k, v in a.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    for name in ("tree_add", "tree_sub"):
        for k, v in getattr(ttree, name)(ta, tb).items():
            np.testing.assert_allclose(_np(v), np.asarray(getattr(jtree, name)(ja, jb)[k]))
    assert float(ttree.tree_dot(ta, tb)) == pytest.approx(float(jtree.tree_dot(ja, jb)))
    assert ttree.tree_size(ta) == jtree.tree_size(ja) == 3
    np.testing.assert_allclose(_np(ttree.tree_axpy(2.0, ta, tb)["x"]),
                               np.asarray(jtree.tree_axpy(2.0, ja, jb)["x"]))
    picked = ttree.tree_where(torch.tensor(False), ta, tb)
    assert float(picked["s"]) == -2.0
    g = torch.Generator().manual_seed(0)
    draws = ttree.tree_normal_like(g, ta)
    assert {k: v.shape for k, v in draws.items()} == {"s": (), "x": (2,)}
    u = ttree.tree_uniform_like(torch.Generator().manual_seed(0), ta, 2.0, 3.0)
    assert all(bool(((v >= 2.0) & (v <= 3.0)).all()) for v in u.values())


def _prior_pairs():
    return [
        ("GammaPrior", (2.0, 0.5), {"variable": "precision"}, 1.7),
        ("GaussianPrior", (np.array([0.0, 1.0], np.float32), np.array([2.0, 0.5], np.float32)),
         {"variable": "coefficients"}, np.array([0.3, 0.8], np.float32)),
        ("ExponentialPrior", (1.5,), {"variable": "rate"}, 0.7),
        ("UniformPrior", (-1.0, 2.0), {"variable": "u", "var_shape": (2,)},
         np.array([0.3, 1.5], np.float32)),
        ("HalfNormalPrior", (1.3,), {"variable": "scale"}, 0.9),
    ]


@pytest.mark.parametrize("name, args, kw, value", _prior_pairs(),
                         ids=[p[0] for p in _prior_pairs()])
def test_prior_matches_jax(name, args, kw, value):
    jp = getattr(jpriors, name).create(*args, **kw)
    tp = getattr(tpriors, name).create(*args, **kw)
    var = kw["variable"]
    assert tp.variables == jp.variables
    ref = jp.log_prob({var: jnp.asarray(value)})
    got = tp.log_prob({var: torch.tensor(value)})
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5)
    draw = tp.sample(torch.Generator().manual_seed(3))[var]
    assert draw.shape == tuple(np.shape(value)) and bool(torch.isfinite(tp.log_prob({var: draw})))


def test_function_prior_and_reparameterized_match_jax():
    fp = tpriors.FunctionPrior.create(lambda v: -v["z"] ** 2, (VariableSpec("z"),))
    assert float(fp.log_prob(z=2.0)) == -4.0

    @frozen_dataclass
    class FancyGaussian(Density):
        x: torch.Tensor
        fixed: dict

        @property
        def variable_specs(self):
            return (VariableSpec("location"), VariableSpec("scale"))

        def _log_prob(self, values):
            return tdist.normal_log_prob(self.x, values["location"], values["scale"])

    @jcore.pytree_dataclass
    class JFancyGaussian(jcore.Density):
        x: jax.Array
        fixed: dict

        @property
        def variable_specs(self):
            return (jcore.VariableSpec("location"), jcore.VariableSpec("scale"))

        def _log_prob(self, values):
            return jdist.normal_log_prob(self.x, values["location"], values["scale"])

    tr = tparams.Reparameterized.create(FancyGaussian(torch.tensor(1.3), {}),
                                        tparams.scale_from_precision())
    jr = jparams.Reparameterized.create(JFancyGaussian(jnp.asarray(1.3), {}),
                                        jparams.scale_from_precision())
    assert tr.variables == jr.variables == ("location", "precision")
    vals = {"location": 0.4, "precision": 2.2}
    np.testing.assert_allclose(_np(tr.log_prob(**vals)), np.asarray(jr.log_prob(**vals)),
                               rtol=1e-6)
    tg, jg = tr.gradient(**vals), jr.gradient(**vals)
    for k in vals:
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]), rtol=1e-5)
    assert float(tparams.precision_from_scale().fn(scale=torch.tensor(2.0))) == 0.25
    with pytest.raises(ValueError):
        tparams.Reparameterized.create(FancyGaussian(torch.tensor(1.3), {}),
                                       tparams.scale_from_precision(variable="nope"))


@pytest.mark.parametrize("name", ["LogTransform", "SoftplusTransform", "Sigmoid",
                                  "IdentityTransform"])
def test_transform_matches_jax(name):
    if name == "Sigmoid":
        jt, tt = jtransforms.SigmoidTransform(-1.0, 3.0), ttransforms.SigmoidTransform(-1.0, 3.0)
    else:
        jt, tt = getattr(jtransforms, name), getattr(ttransforms, name)
    u = np.array([-1.5, 0.2, 2.0], np.float32)
    x = np.asarray(jt.forward(jnp.asarray(u)))
    np.testing.assert_allclose(_np(tt.forward(torch.tensor(u))), x, rtol=1e-6)
    np.testing.assert_allclose(_np(tt.inverse(torch.tensor(x))),
                               np.asarray(jt.inverse(jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tt.log_det_jac(torch.tensor(u))),
                               np.asarray(jt.log_det_jac(jnp.asarray(u))), rtol=1e-6, atol=1e-7)
    tx = ttransforms.constrain({"a": tt}, {"a": torch.tensor(u), "b": torch.tensor(u)})
    assert torch.equal(tx["b"], torch.tensor(u))
    back = ttransforms.unconstrain({"a": tt}, tx)
    np.testing.assert_allclose(_np(back["a"]), u, rtol=1e-4, atol=1e-5)


def test_default_transforms_follow_jax():
    _, tpost, _ = _both_posteriors()

    @frozen_dataclass
    class Named(Density):
        fixed: dict

        @property
        def variable_specs(self):
            return tuple(VariableSpec(n) for n in ("log_sigma", "noise_scale", "mu", "tau"))

    assert set(ttransforms.default_transforms(Named({}))) == {"noise_scale", "tau"}
    assert ttransforms.default_transforms(tpost) == {"precision": ttransforms.LogTransform}


@pytest.mark.parametrize("name, data, extra, mock", [
    ("GaussianErrorModel", [0.5, 1.0, 2.0], {"precision": 1.7}, [0.4, 1.2, 1.5]),
    ("StudentTErrorModel", [0.5, 1.0, 2.0], {"scale": 0.8}, [0.4, 1.2, 1.5]),
    ("LaplaceErrorModel", [0.5, 1.0, 2.0], {"scale": 0.8}, [0.4, 1.2, 1.5]),
    ("PoissonErrorModel", [0.0, 3.0, 1.0], {}, [0.4, 2.2, 1.5]),
    ("BernoulliErrorModel", [0.0, 1.0, 1.0], {}, [-0.4, 1.2, 0.5]),
    ("LogNormalErrorModel", [0.5, 1.0, 2.0], {"precision": 1.7}, [0.4, 1.2, 1.5]),
])
def test_error_model_matches_jax(name, data, extra, mock):
    jm = getattr(jmodel, name).create(jnp.asarray(data))
    tm = getattr(tmodel, name).create(np.asarray(data, np.float32))
    assert tm.variables == jm.variables and tm.n_data == 3
    ref = jm.log_prob({MOCK_DATA: jnp.asarray(mock), **extra})
    got = tm.log_prob({MOCK_DATA: torch.tensor(mock), **extra})
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5)


def test_forward_models_match_jax():
    design = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    theta = np.array([0.3, -1.0, 2.0], np.float32)
    jl = jmodel.LinearForwardModel(design=jnp.asarray(design))
    tl = LinearForwardModel(design=torch.tensor(design))
    np.testing.assert_allclose(_np(tl(theta=torch.tensor(theta))),
                               np.asarray(jl(theta=jnp.asarray(theta))), rtol=1e-6)
    np.testing.assert_allclose(_np(tl.jacobian(theta=torch.tensor(theta))["theta"]),
                               np.asarray(jl.jacobian(theta=jnp.asarray(theta))["theta"]))
    jp = jmodel.PolynomialForwardModel.create(jnp.asarray(XSES), 4)
    tp = PolynomialForwardModel.create(XSES, 4)
    np.testing.assert_allclose(_np(tp(coefficients=torch.tensor(TRUTH))),
                               np.asarray(jp(coefficients=jnp.asarray(TRUTH))), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(tp.jacobian(coefficients=torch.tensor(TRUTH))["coefficients"],
                       tp.vandermonde)
    with pytest.raises(ValueError):
        tp(theta=torch.tensor(TRUTH))


# -- device densities -----------------------------------------------------------------


def test_logdensity_reference_matches_posterior():
    """The device density of the DSL posterior equals the posterior (up to
    the normalisers and the log-Jacobian, a constant) in unconstrained
    space, and its gradient equals the posterior's."""
    _, tpost, ys = _both_posteriors()
    dsl = ttransforms.transform_logdensity(tpost.log_prob, {"precision": ttransforms.LogTransform})
    template = {"coefficients": torch.zeros(4), "precision": torch.zeros(())}
    dens = device_density(dsl, template)
    assert isinstance(dens, LinregDensity) and dens.D == 5
    ker = linreg_unconstrained_logdensity(jnp.asarray(tmath.vandermonde(torch.tensor(XSES), 4).numpy()),
                                          jnp.asarray(ys), jnp.full(4, 5.0), 1.0, 0.2)
    diffs = []
    for pos in _positions(n=8, seed=13):
        q = torch.tensor(np.concatenate([pos["coefficients"], [pos["precision"]]]))
        U, gU = dens.potential_and_grad(q)
        tg, tv = torch.func.grad_and_value(dsl)({k: torch.tensor(v) for k, v in pos.items()})
        diffs.append(float(tv) + float(U))
        np.testing.assert_allclose(_np(-gU), np.concatenate([_np(tg["coefficients"]),
                                                             [_np(tg["precision"])]]),
                                   rtol=1e-4, atol=1e-3)
        # and the JAX package's own closed form agrees with the functor
        jv = ker({k: jnp.asarray(v) for k, v in pos.items()})
        assert float(-U) == pytest.approx(float(jv), rel=1e-5)
    # dE agrees only to rounding: values of a few hundred in float32
    np.testing.assert_allclose(diffs, diffs[0], atol=2e-3)


def _bad_posteriors():
    _, tpost, ys = _both_posteriors()
    log = {"precision": ttransforms.LogTransform}
    extra_prior = replace(tpost, priors={**tpost.priors, "x": GammaPrior.create(1.0, 1.0)})
    return [
        ("lambda", lambda p: tpost.log_prob(p), None),
        ("no transform", ttransforms.transform_logdensity(tpost.log_prob, {}), None),
        ("softplus", ttransforms.transform_logdensity(
            tpost.log_prob, {"precision": ttransforms.SoftplusTransform}), None),
        ("extra prior", ttransforms.transform_logdensity(extra_prior.log_prob, log), None),
        ("conditioned", ttransforms.transform_logdensity(
            tpost.fix(precision=2.0).log_prob, log), None),
        ("tempered", ttransforms.transform_logdensity(tpost.tempered(0.5).log_prob, log), None),
        ("wrong template", ttransforms.transform_logdensity(tpost.log_prob, log),
         {"coefficients": torch.zeros(3), "precision": torch.zeros(())}),
    ]


@pytest.mark.parametrize("name, fn, template", _bad_posteriors(),
                         ids=[b[0] for b in _bad_posteriors()])
def test_device_density_refuses_other_models(name, fn, template):
    """The recogniser refuses each (no LinregDensity); the density
    compiler then traces those it can (a TracedDensity); the others fail
    on their own error, which is raised and not taken for a refusal: a
    fixed variable the position still holds, the wrong template."""
    template = template or {"coefficients": torch.zeros(4), "precision": torch.zeros(())}
    assert recognise(fn, template) is None
    if name in ("lambda", "no transform", "softplus", "extra prior", "tempered"):
        assert isinstance(device_density(fn, template), TracedDensity)
    else:
        with pytest.raises((ValueError, RuntimeError)) as e:
            device_density(fn, template)
        assert not isinstance(e.value, NotImplementedError), e.value


def test_device_density_passes_device_densities_and_callable_density_matches():
    g = DiagGaussianDensity([0.5, -1.0], [1.0, 2.0])
    assert device_density(g, {"x": torch.zeros(2)}) is g
    with pytest.raises(ValueError):
        device_density(g, {"x": torch.zeros(3)})
    wrapped = CallableDensity(lambda p: -g(p["x"]), {"x": torch.zeros(2)})
    q = torch.tensor([[0.1, 0.2], [1.0, -3.0]])
    for a, b in zip(wrapped.potential_and_grad(q), g.potential_and_grad(q)):
        torch.testing.assert_close(a, b)
