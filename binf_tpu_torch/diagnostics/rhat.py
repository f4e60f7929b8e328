"""Convergence diagnostics: rank-normalized split-R-hat and bulk/tail ESS
(port of ``binf_tpu/diagnostics/rhat.py``).

The estimators of Vehtari, Gelman, Simpson, Carpenter & Buerkner 2021
("Rank-normalization, folding, and localization"):

* :func:`rhat` -- max of the rank-normalized split-R-hat of the draws and of
  the FOLDED draws ``|x - median|``;
* :func:`ess_bulk` -- ESS of the rank-normalized draws;
* :func:`ess_tail` -- min ESS of the 5% / 95% quantile-indicator sequences.

The classic raw-scale :func:`split_rhat` and combined-chain :func:`ess`
are the building blocks.  Every function reduces a ``(draws, chains, ...)``
tensor on whatever device it lies on.  Two places differ from the obvious
PyTorch call, to keep the JAX package's numbers: the median averages the
two middle values (``torch.median`` returns the lower one), and quantiles
are taken from a sort (``torch.quantile`` refuses more than 2^24 values).
"""

from __future__ import annotations

import torch

__all__ = [
    "split_rhat", "ess", "rhat", "ess_bulk", "ess_tail", "summary",
]


def _split_chains(x: torch.Tensor) -> torch.Tensor:
    """(draws, chains, ...) -> (draws//2, 2*chains, ...)."""
    n = (x.shape[0] // 2) * 2
    return torch.cat([x[: n // 2], x[n // 2: n]], dim=1)


def split_rhat(x: torch.Tensor) -> torch.Tensor:
    """Split-R-hat over a (draws, chains, ...) tensor; returns shape (...)."""
    x = _split_chains(x)
    n = x.shape[0]
    chain_mean = x.mean(dim=0)
    chain_var = x.var(dim=0, correction=1)
    between = n * chain_mean.var(dim=0, correction=1)
    within = chain_var.mean(dim=0)
    var_plus = (n - 1) / n * within + between / n
    return torch.sqrt(var_plus / within)


def _autocovariance_fft(x: torch.Tensor) -> torch.Tensor:
    """Autocovariance along dim 0 via FFT; x is (draws, ...), demeaned."""
    n = x.shape[0]
    m = 1  # next power of two >= 2n
    while m < 2 * n:
        m *= 2
    f = torch.fft.rfft(x, n=m, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    return acov / n


def ess(x: torch.Tensor) -> torch.Tensor:
    """Bulk effective sample size over (draws, chains, ...) -> shape (...).

    Combined-chain estimator: mean autocovariance across chains plus
    between-chain variance (Stan's formulation), with Geyer initial-positive
    truncation as a mask.
    """
    x = _split_chains(x)
    n, m = x.shape[0], x.shape[1]
    chain_mean = x.mean(dim=0)
    acov = _autocovariance_fft(x - chain_mean[None]).mean(dim=1)  # (n, ...)

    within = x.var(dim=0, correction=1).mean(dim=0)
    between = chain_mean.var(dim=0, correction=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * within + between

    rho = 1.0 - (within - acov) / var_plus  # (n, ...)

    # Geyer: sum consecutive autocorrelation pairs; truncate at the first
    # non-positive pair sum, then enforce monotone decrease with a running
    # minimum.
    n_pairs = n // 2
    pair = rho[0: 2 * n_pairs: 2] + rho[1: 2 * n_pairs: 2]
    good = torch.cumprod((pair > 0.0).to(x.dtype), dim=0) > 0.0
    capped = torch.cummin(pair, dim=0).values
    tau = -1.0 + 2.0 * torch.where(good, capped, 0.0).sum(dim=0)
    floor = 1.0 / torch.log10(torch.tensor(float(n * m), dtype=x.dtype, device=x.device))
    tau = torch.maximum(tau, floor)
    return n * m / tau


# -- rank normalization & the modern estimators (Vehtari et al. 2021) --------


def _rank_normalize(x: torch.Tensor) -> torch.Tensor:
    """Fractional-rank z-scores of a (draws, chains, ...) tensor.

    Ordinal ranks over the POOLED draws (a stable sort breaks ties by
    position), mapped through the Blom offset (r - 3/8)/(S + 1/4) and the
    standard-normal quantile function.
    """
    n, m = x.shape[0], x.shape[1]
    s = n * m
    flat = x.reshape((s,) + x.shape[2:])
    order = torch.argsort(flat, dim=0, stable=True)
    positions = torch.arange(s, device=x.device).reshape((s,) + (1,) * (flat.dim() - 1))
    ranks = torch.empty_like(order).scatter_(0, order, positions.expand_as(order))
    z = torch.special.ndtri((ranks.to(torch.float32) + 1.0 - 0.375) / (s + 0.25))
    return z.reshape(x.shape)


def _sorted_quantile(sorted_x: torch.Tensor, prob: float, midpoint: bool = False):
    """Quantile along dim 0 of an already sorted tensor, with
    ``jnp.quantile``'s float32 index arithmetic: linear interpolation, or
    the midpoint of the two neighbours (``jnp.median``)."""
    count = torch.tensor(float(sorted_x.shape[0]), dtype=torch.float32)
    pos = torch.tensor(prob, dtype=torch.float32) * (count - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    lo = sorted_x[int(low.clamp(0, count - 1))]
    hi = sorted_x[int(high.clamp(0, count - 1))]
    if midpoint:
        return (lo + hi) * 0.5
    return lo * low_w.to(sorted_x.device) + hi * high_w.to(sorted_x.device)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """|x - median| over pooled draws -- sensitizes R-hat to scale/tails."""
    flat = x.reshape((-1,) + x.shape[2:])
    med = _sorted_quantile(torch.sort(flat, dim=0).values, 0.5, midpoint=True)
    return torch.abs(x - med)


def rhat(x: torch.Tensor) -> torch.Tensor:
    """Rank-normalized + folded split-R-hat (Vehtari et al. 2021, eq. 4 +
    section 4.2).  Shape (draws, chains, ...) -> (...)."""
    bulk = split_rhat(_rank_normalize(x))
    tail = split_rhat(_rank_normalize(_fold(x)))
    return torch.maximum(bulk, tail)


def ess_bulk(x: torch.Tensor) -> torch.Tensor:
    """Bulk ESS: combined-chain ESS of the rank-normalized draws."""
    return ess(_rank_normalize(x))


def ess_tail(x: torch.Tensor, prob: float = 0.05) -> torch.Tensor:
    """Tail ESS: min of the ESS of the ``prob`` and ``1-prob`` quantile
    indicator sequences I(x <= q) (Vehtari et al. 2021, section 4.4)."""
    flat_sorted = torch.sort(x.reshape((-1,) + x.shape[2:]), dim=0).values
    q_lo = _sorted_quantile(flat_sorted, prob)
    q_hi = _sorted_quantile(flat_sorted, 1.0 - prob)
    ess_lo = ess((x <= q_lo).to(x.dtype))
    ess_hi = ess((x <= q_hi).to(x.dtype))
    return torch.minimum(ess_lo, ess_hi)


def summary(samples: dict) -> dict:
    """Per-variable summary over (draws, chains, ...) sample tensors:
    mean, std, rank-normalized+folded R-hat, bulk ESS, tail ESS."""
    out = {}
    for name, x in samples.items():
        out[name] = {
            "mean": x.mean(dim=(0, 1)),
            "std": x.std(dim=(0, 1), correction=0),
            "rhat": rhat(x),
            "ess": ess_bulk(x),
            "ess_tail": ess_tail(x),
        }
    return out
