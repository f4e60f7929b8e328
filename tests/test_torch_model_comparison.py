"""Model comparison (``binf_tpu_torch/diagnostics/model_comparison.py``)
and the polynomial example's plots (``binf_tpu_torch/example/plots.py``)
against the JAX package, on the CPU.

Both packages take the same numpy arrays: the JAX package's polynomial
data (``make_data(jax.random.key(1))``) and 1,000 draws about its least
squares fit; WAIC, PSIS-LOO and the Pareto tail fit are then fed the JAX
package's pointwise log-likelihoods on both sides.  Pointwise
log-likelihoods, WAIC, PSIS-LOO and the Pareto tail fit agree to 1e-5
relative to the largest value (float32 sums in other orders); the cases of ``tests/test_laplace_waic.py::
TestModelComparison`` hold with their bounds.  The plots run with the Agg
backend where matplotlib is installed, and their prediction band agrees
with the JAX package's to 1e-4."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.diagnostics import model_comparison as jmc
from binf_tpu.example import polynomial as jpoly
from binf_tpu_torch.diagnostics import (LOOResult, WAICResult, pointwise_log_likelihood,
                                        psis_loo, waic)
from binf_tpu_torch.diagnostics.model_comparison import _fit_pareto_k
from binf_tpu_torch.example import polynomial
from binf_tpu_torch.model import GaussianErrorModel, PolynomialForwardModel
from binf_tpu_torch.pdf import Likelihood

RTOL = 1e-5
S = 1000  # draws
f32 = np.float32


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _draws(x, y, degree, seed):
    """S draws about the least-squares fit of ``degree`` coefficients:
    coefficients within 0.05, the precision of the residuals within 10%."""
    rng = np.random.default_rng(seed)
    V = np.vander(x, degree, increasing=True).astype(np.float64)
    c, *_ = np.linalg.lstsq(V, y, rcond=None)
    prec = 1.0 / np.mean((y - V @ c) ** 2)
    return {"coefficients": (c + 0.05 * rng.normal(size=(S, degree))).astype(f32),
            "precision": (prec * np.exp(0.1 * rng.normal(size=S))).astype(f32)}


@pytest.fixture(scope="module")
def setup():
    xses, ys = jpoly.make_data(jax.random.key(1))
    x, y = np.asarray(xses, f32), np.asarray(ys, f32)
    return x, y, _draws(x, y, 4, 0)


def _ll_both(x, y, draws, degree=4):
    post = polynomial.make_posterior(x, y, n_coefficients=degree)
    ll = pointwise_log_likelihood(post.likelihoods["points"],
                                  {k: torch.tensor(v) for k, v in draws.items()})
    jpost = jpoly.make_posterior(jnp.asarray(x), jnp.asarray(y), n_coefficients=degree)
    jll = jmc.pointwise_log_likelihood(jpost.likelihoods["points"],
                                       {k: jnp.asarray(v) for k, v in draws.items()})
    return ll, np.asarray(jll)


def test_pointwise_log_likelihood_matches_jax(setup):
    """(draws, n_data), the JAX package's values; the pointwise terms sum
    to the fully normalised likelihood."""
    x, y, draws = setup
    ll, jll = _ll_both(x, y, draws)
    assert ll.shape == (S, 20)
    _close(ll.numpy(), jll)
    lik = Likelihood.create("p", PolynomialForwardModel.create(x, 4),
                            GaussianErrorModel.create(y, full_normalization=True))
    expect = float(lik.log_prob(coefficients=torch.tensor(draws["coefficients"][0]),
                                precision=torch.tensor(draws["precision"][0])))
    assert float(ll[0].sum()) == pytest.approx(expect, rel=1e-4)


def test_waic_matches_jax(setup):
    x, y, draws = setup
    jll = _ll_both(x, y, draws)[1]
    got, ref = waic(torch.tensor(jll)), jmc.waic(jnp.asarray(jll))
    assert isinstance(got, WAICResult)
    for a, b in zip(got, ref):
        _close(a.numpy(), np.asarray(b))


def test_psis_loo_matches_jax_and_waic(setup):
    """PSIS-LOO agrees with the JAX package's, lies within 2 of WAIC's
    elpd, and every Pareto k is below 1 (tests/test_laplace_waic.py)."""
    x, y, draws = setup
    ll, jll = _ll_both(x, y, draws)
    got, ref = psis_loo(torch.tensor(jll)), jmc.psis_loo(jnp.asarray(jll))
    assert isinstance(got, LOOResult)
    for a, b in zip(got, ref):
        _close(a.numpy(), np.asarray(b))
    got = psis_loo(ll)
    assert abs(float(waic(ll).elpd) - float(got.elpd)) < 2.0
    assert got.pareto_k.shape == (20,) and bool((got.pareto_k < 1.0).all())


@pytest.mark.parametrize("m", [6, 40, 1000])
def test_fit_pareto_k_matches_jax(m):
    """On heavy-tailed weights, per column, including the smallest tail of
    five."""
    r = np.random.default_rng(m).lognormal(0.0, 1.5, size=(m, 7)).astype(f32)
    got = _fit_pareto_k(torch.tensor(r)).numpy()
    ref = np.array([float(jmc._fit_pareto_k(jnp.asarray(r[:, j]))) for j in range(7)])
    _close(got, ref)
    _close(_fit_pareto_k(torch.tensor(r[:, 0])).numpy(), ref[:1])


def test_waic_prefers_true_model(setup):
    """The cubic (true) model beats a straight line on the same data."""
    x, y, draws = setup
    w_true = waic(_ll_both(x, y, draws)[0])
    under, j_under = _ll_both(x, y, _draws(x, y, 2, 1), degree=2)
    w_under = waic(under)
    _close(waic(torch.tensor(j_under)).elpd.numpy(),
           np.asarray(jmc.waic(jnp.asarray(j_under)).elpd))
    assert float(w_true.elpd) > float(w_under.elpd) + 2.0
    assert float(w_true.p_eff) > 0


# -- plots ----------------------------------------------------------------------


@pytest.fixture
def plt():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def test_plots_draw_and_the_band_matches_jax(setup, plt):
    from binf_tpu.example import plots as jplots
    from binf_tpu_torch.example import plots

    x, y, draws = setup
    samples = {k: torch.tensor(v[:200]) for k, v in draws.items()}
    truth = [2.0, -4.0, 1.0, 1.5]
    fig = plots.plot_hists(samples, truth, 2.5)
    assert len(fig.axes) == 5 and [a.get_title() for a in fig.axes][-1] == "precision"
    grid = np.linspace(-2.2, 2.2, 9).astype(f32)
    ax = plots.plot_fit(x, y, grid, draws["coefficients"].mean(0), truth)
    assert len(ax.lines) == 2 and len(ax.collections) == 1
    fit = ax.lines[0].get_ydata()
    np.testing.assert_allclose(fit, np.polynomial.polynomial.polyval(
        grid, draws["coefficients"].mean(0)), rtol=1e-4, atol=1e-4)
    band = plots.plot_prediction_tube(samples, grid, y.min() - 3, y.max() + 3, n_y=80)
    jband = jplots.plot_prediction_tube({k: jnp.asarray(v[:200]) for k, v in draws.items()},
                                        grid, y.min() - 3, y.max() + 3, n_y=80)
    got = band.collections[0].get_paths()[0].vertices
    ref = jband.collections[0].get_paths()[0].vertices
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_new_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'binf_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import binf_tpu_torch.diagnostics.model_comparison, binf_tpu_torch.example.plots\n"
        "import binf_tpu_torch.smc, binf_tpu_torch.smc.smc, binf_tpu_torch.smc.resampling\n"
        "from binf_tpu_torch.diagnostics import waic, psis_loo, pointwise_log_likelihood\n"
        "from binf_tpu_torch.smc import tempered_smc, systematic_resample, SMCResult\n"
        "from binf_tpu_torch.ops.kernels.densities import HierarchicalDensity\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
