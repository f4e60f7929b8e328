"""Exact conjugate Gibbs updates (port of ``binf_tpu/samplers/conjugate.py``).

For a Gaussian error model with precision lambda, data y, mock data
m(theta) and a Gamma(alpha, beta) prior,

    lambda | theta, y ~ Gamma(shape = alpha + n/2, rate = beta + sum(r^2)/2)

(the exact shape; the reference's ``alpha + n/2 - 1`` is an offset against
its sampler's convention).  For a linear forward model ``mock = V theta``
under a N(mu0, diag(v0)) prior, ``theta | lambda, y`` is Gaussian with
precision ``lambda V^T V + diag(1/v0)``.  Together they make the
polynomial workload a collapsed Gibbs sampler with no rejections.

Both blocks draw for every chain of a chain-batched position in one call
(``samplers/gibbs.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binf_tpu_torch.ops import chain_rows
from binf_tpu_torch.pdf.distributions import gamma_sample
from binf_tpu_torch.samplers.base import Position
from binf_tpu_torch.samplers.gibbs import BlockFn, chain_ndim, direct_block

__all__ = ["ConjugateInfo", "gamma_precision_block", "gaussian_linear_block",
           "gaussian_linear_draw"]


class ConjugateInfo(NamedTuple):
    """Exact draws always 'accept'."""

    accepted: torch.Tensor
    acceptance_prob: torch.Tensor


def _exact(batch: torch.Size, device) -> ConjugateInfo:
    return ConjugateInfo(torch.ones(batch, dtype=torch.bool, device=device),
                         torch.ones(batch, device=device))


def _pick(components: dict, name, test, what: str) -> str:
    if name is not None:
        return name
    found = [n for n, c in components.items() if test(c)]
    if not found:
        raise ValueError(f"no {what} found")
    return found[0]


def gamma_precision_block(posterior, precision_var: str = "precision",
                          likelihood_name: str | None = None,
                          prior_name: str | None = None) -> BlockFn:
    """Exact Gibbs draw of a Gaussian error model's precision, from the
    posterior's Gaussian likelihood and Gamma prior over ``precision_var``."""
    from binf_tpu_torch.model.error import GaussianErrorModel
    from binf_tpu_torch.pdf.priors import GammaPrior

    likelihood_name = _pick(
        posterior.likelihoods, likelihood_name,
        lambda l: isinstance(getattr(l, "error_model", None), GaussianErrorModel)
        and precision_var in l.variables,
        f"Gaussian likelihood with variable {precision_var!r}")
    prior_name = _pick(posterior.priors, prior_name,
                       lambda p: isinstance(p, GammaPrior) and precision_var in p.variables,
                       f"GammaPrior over {precision_var!r}")
    lik = posterior.likelihoods[likelihood_name]
    prior = posterior.priors[prior_name]
    if not isinstance(prior, GammaPrior):
        raise TypeError(f"prior {prior_name!r} is not a GammaPrior")

    def sample_fn(generator: torch.Generator, position: Position):
        fwm = lik.forward_model
        fwm_vals = {k: position[k] for k in fwm.variables if k != precision_var}
        evaluate = fwm._evaluate
        for _ in range(chain_ndim(posterior, position)):
            evaluate = torch.func.vmap(evaluate)
        data = lik.error_model.data
        resid = evaluate(fwm_vals) - data
        batch = resid.shape[: resid.dim() - data.dim()]
        shape = prior.shape_param + 0.5 * data.shape[0]
        rate = prior.rate + 0.5 * torch.sum(resid * resid,
                                            dim=tuple(range(len(batch), resid.dim())))
        draw = gamma_sample(generator, shape.to(resid.device), shape=batch) / rate
        return {precision_var: draw}, _exact(batch, draw.device)

    return direct_block(sample_fn)


def gaussian_linear_draw(lam, V, y, means, prior_precision, z) -> torch.Tensor:
    """``theta | lambda`` for ``mock = V theta``: ``mean + L^-T z`` with
    ``L L^T = lam V^T V + diag(prior_precision)`` and the mean from the
    Cholesky solve, for every chain of ``lam`` (shape ``B``) and normals
    ``z (B + (d,))``."""
    lam = lam[..., None, None]
    P = lam * (V.T @ V) + torch.diag(prior_precision)
    b = lam[..., 0] * (V.T @ y) + means * prior_precision
    chol = torch.linalg.cholesky(P)
    mean = torch.cholesky_solve(b[..., None], chol)[..., 0]
    return mean + torch.linalg.solve_triangular(chol.mT, z[..., None], upper=True)[..., 0]


def gaussian_linear_block(posterior, coefficients_var: str = "coefficients",
                          precision_var: str = "precision",
                          likelihood_name: str | None = None,
                          prior_name: str | None = None) -> BlockFn:
    """Exact Gibbs draw of linear-model coefficients under a Gaussian prior:
    ``N(Sigma (lambda V^T y + mu0/v0), Sigma)``,
    ``Sigma^-1 = lambda V^T V + diag(1/v0)``, through a Cholesky factor."""
    from binf_tpu_torch.model.forward import LinearForwardModel, PolynomialForwardModel
    from binf_tpu_torch.pdf.priors import GaussianPrior

    likelihood_name = _pick(
        posterior.likelihoods, likelihood_name,
        lambda l: isinstance(getattr(l, "forward_model", None),
                             (LinearForwardModel, PolynomialForwardModel)),
        "linear forward model")
    prior_name = _pick(posterior.priors, prior_name,
                       lambda p: isinstance(p, GaussianPrior) and coefficients_var in p.variables,
                       f"GaussianPrior over {coefficients_var!r}")
    lik = posterior.likelihoods[likelihood_name]
    prior = posterior.priors[prior_name]
    fwm = lik.forward_model
    V = fwm.design if hasattr(fwm, "design") else fwm.vandermonde

    def sample_fn(generator: torch.Generator, position: Position):
        lam = position[precision_var]
        z = chain_rows.randn(lam.shape + (V.shape[1],), generator=generator, device=lam.device)
        draw = gaussian_linear_draw(lam, V, lik.error_model.data, prior.means,
                                    1.0 / prior.variances, z)
        return {coefficients_var: draw}, _exact(lam.shape, lam.device)

    return direct_block(sample_fn)
