"""The family shapes past csrc's units that the port's K3 and K4 run
through units built at first use, each as a JAX posterior and the port's
from the same numpy data: the mixture at K = 2, 4, 5 (on the JAX package's
240 synthetic points), the hierarchical posterior at 4, 6 and 16 groups
(the JAX package's synthetic data), the logistic posterior at d = 12 and
linear regression at 12 coefficients (a standardised design of 200 rows,
the first column the intercept, drawn by numpy).  Shared by
``test_torch_family_dims.py`` and ``test_torch_family_dims_k3.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from binf_tpu.example import hierarchical as jh
from binf_tpu.example import logistic as jl
from binf_tpu.example import mixture as jm
from binf_tpu.example import polynomial as jp
from binf_tpu.model import GaussianErrorModel as JaxGaussianError
from binf_tpu.model.forward import LinearForwardModel as JaxLinear
from binf_tpu.pdf import Likelihood as JaxLikelihood
from binf_tpu.pdf import Posterior as JaxPosterior
from binf_tpu.pdf.transforms import LogTransform as JaxLog
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu_torch.example import hierarchical, logistic, mixture, polynomial
from binf_tpu_torch.model import GaussianErrorModel, LinearForwardModel
from binf_tpu_torch.ops.kernels.densities import (HierarchicalDensity, LinregDensity,
                                                  LogisticDensity, MixtureDensity)
from binf_tpu_torch.pdf import Likelihood, Posterior
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

f32 = np.float32
# name -> (family, K, NG, d or coefficients)
SHAPES = {"mixture_k2": ("mixture", 2), "mixture_k4": ("mixture", 4),
          "mixture_k5": ("mixture", 5), "hierarchical_ng4": ("hierarchical", 4),
          "hierarchical_ng6": ("hierarchical", 6), "hierarchical_ng16": ("hierarchical", 16),
          "logistic_d12": ("logistic", 12), "linreg_12": ("linreg", 12)}


def _np(x):
    return np.array(x, f32)


def _design(seed, n, d):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1).astype(f32), rng


def problem(name):
    """(JAX log density, port log density, template shapes, the port's
    device density class, a centre of the posterior's bulk in pack order
    (sorted names))."""
    family, k = SHAPES[name]
    if family == "mixture":
        y = _np(jm.synthetic_mixture_data(jax.random.key(0)))
        shapes = {"log_sigma": (), "log_weights": (k,), "means": (k,)}
        centre = np.concatenate([[-0.5], np.zeros(k), np.linspace(-2.0, 3.0, k)])
        return (jm.make_mixture_posterior(jnp.asarray(y), k).log_prob,
                mixture.make_mixture_posterior(y, k, device="cpu").log_prob, shapes,
                MixtureDensity, centre)
    if family == "hierarchical":
        x, y, c, _ = (_np(a) for a in jh.synthetic_hierarchical_data(jax.random.key(0), k))
        shapes = {"group_params": (k, 2), "log_tau": (2,), "mu": (2,), "precision": ()}
        centre = np.concatenate([np.tile([0.8, 1.2], k), [-1.3, -1.3, 0.8, 1.2, 3.2]])
        jfn = jax_transform(jh.make_hierarchical_posterior(jnp.asarray(x), jnp.asarray(y),
                                                           jnp.asarray(c), k).log_prob,
                            {"precision": JaxLog})
        tfn = transform_logdensity(hierarchical.make_hierarchical_posterior(
            x, y, c, k, device="cpu").log_prob, {"precision": LogTransform})
        return jfn, tfn, shapes, HierarchicalDensity, centre
    X, rng = _design(10 + k, 200, k)
    w = (0.5 * rng.normal(size=k)).astype(f32)
    if family == "logistic":
        y = (rng.uniform(size=200) < 1.0 / (1.0 + np.exp(-X @ w))).astype(f32)
        return (jl.make_logistic_posterior(jnp.asarray(X), jnp.asarray(y)).log_prob,
                logistic.make_logistic_posterior(X, y, device="cpu").log_prob,
                {"weights": (k,)}, LogisticDensity, w)
    y = (X @ w + rng.normal(size=200) / np.sqrt(2.5)).astype(f32)
    jpost = JaxPosterior.create(
        {"points": JaxLikelihood.create(
            "points", JaxLinear(design=jnp.asarray(X), variable="coefficients"),
            JaxGaussianError.create(jnp.asarray(y)))}, jp.make_priors(k))
    tpost = Posterior.create(
        {"points": Likelihood.create(
            "points", LinearForwardModel(design=torch.tensor(X), variable="coefficients"),
            GaussianErrorModel.create(torch.tensor(y)))}, polynomial.make_priors(k, device="cpu"))
    return (jax_transform(jpost.log_prob, {"precision": JaxLog}),
            transform_logdensity(tpost.log_prob, {"precision": LogTransform}),
            {"coefficients": (k,), "precision": ()}, LinregDensity,
            np.concatenate([w, [np.log(2.5)]]))


def template(shapes):
    return {k: torch.zeros(s) for k, s in shapes.items()}


def points(centre, seed, n, scale=0.3):
    rng = np.random.default_rng(seed)
    return (centre + scale * rng.normal(size=(n, centre.shape[0]))).astype(f32)


def jax_value_and_grad(jfn, shapes, q):
    """The JAX posterior's log density and gradient at flat points ``q``
    (pack order: sorted names)."""
    names = sorted(shapes)

    def flat(v):
        out, o = {}, 0
        for name in names:
            size = int(np.prod(shapes[name]))
            out[name] = v[o:o + size].reshape(shapes[name])
            o += size
        return jfn(out)

    ld, g = jax.vmap(jax.value_and_grad(flat))(jnp.asarray(q))
    return np.asarray(ld), np.asarray(g)


def host_noise(seed, steps, D, C):
    """The JAX host-noise layout's normals (steps, d_pad, C) and uniforms
    (steps, 1, C), as numpy arrays."""
    k1, k2 = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)))
    d_pad = (D + 7) // 8 * 8
    return (np.asarray(jax.random.normal(k1, (steps, d_pad, C), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (steps, 1, C), jnp.float32)))
