"""Plotting helpers for the polynomial example (port of
``binf_tpu/example/plots.py``; matplotlib is imported lazily, so nothing
that does not plot pays for it):

* :func:`plot_hists`: marginal histograms of each coefficient and of the
  precision against the ground truth;
* :func:`plot_fit`: the data, the MAP curve and the true curve;
* :func:`plot_prediction_tube`: the equal-tailed credible band of the
  posterior predictive, from predictive CDFs on a y grid
  (:func:`binf_tpu_torch.example.polynomial.predict` over all draws).
"""

from __future__ import annotations

import numpy as np
import torch

from binf_tpu_torch.example.polynomial import predict
from binf_tpu_torch.ops.math import polyval

__all__ = ["plot_fit", "plot_hists", "plot_prediction_tube"]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def plot_hists(samples, real_coefficients, real_precision, bins=30, fig=None):
    """Marginal histograms with ground-truth lines."""
    plt = _plt()
    coeffs = _np(samples["coefficients"]).reshape(-1, len(real_coefficients))
    prec = _np(samples["precision"]).reshape(-1)
    n = coeffs.shape[1] + 1
    if fig is None:
        fig = plt.figure(figsize=(3 * n, 3))
    for j in range(coeffs.shape[1]):
        ax = fig.add_subplot(1, n, j + 1)
        ax.hist(coeffs[:, j], bins=bins, density=True, alpha=0.7)
        ax.axvline(real_coefficients[j], color="r", lw=2)
        ax.set_title(f"coefficient {j}")
    ax = fig.add_subplot(1, n, n)
    ax.hist(prec, bins=bins, density=True, alpha=0.7)
    ax.axvline(real_precision, color="r", lw=2)
    ax.set_title("precision")
    return fig


def _curve(grid, coefficients) -> np.ndarray:
    c = torch.as_tensor(_np(coefficients), dtype=torch.float32)
    return _np(polyval(torch.as_tensor(grid, dtype=torch.float32), c))


def plot_fit(xses, ys, plot_x, map_coefficients, real_coefficients=None, ax=None):
    """The data, the MAP polynomial and, if given, the true curve."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    ax.scatter(_np(xses), _np(ys), label="data", zorder=3)
    grid = _np(plot_x)
    ax.plot(grid, _curve(grid, map_coefficients), label="MAP fit", lw=2)
    if real_coefficients is not None:
        ax.plot(grid, _curve(grid, real_coefficients), "--", label="truth", lw=1.5)
    ax.legend()
    return ax


def plot_prediction_tube(samples, plot_x, y_min, y_max, n_y=150, level=0.95, ax=None):
    """The ``level`` equal-tailed posterior-predictive band: at each x the
    predictive density on a y grid, its CDF, and the tail quantiles."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    xs = _np(plot_x)
    y_grid = np.linspace(float(np.min(_np(y_min))), float(np.max(_np(y_max))), n_y)
    samples = {k: torch.as_tensor(v) for k, v in samples.items()}
    tail = (1.0 - level) / 2.0
    lows, highs = [], []
    for x in xs:
        dens = _np(predict(torch.full((n_y,), float(x)), torch.as_tensor(y_grid,
                                                                         dtype=torch.float32),
                           samples))
        cdf = np.cumsum(dens)
        cdf = cdf / cdf[-1]
        lows.append(np.interp(tail, cdf, y_grid))
        highs.append(np.interp(1.0 - tail, cdf, y_grid))
    ax.fill_between(xs, lows, highs, alpha=0.25, label=f"{level:.0%} predictive")
    ax.legend()
    return ax
