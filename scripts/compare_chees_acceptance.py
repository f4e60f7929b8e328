#!/usr/bin/env python3
"""Acceptance of the fused ChEES path, the JAX package against the port, on
the data ``chip_smoke.py`` samples (``binf_tpu_torch.example.polynomial.make_data``,
seed 1) and its protocol (500 warmup steps from eps0 = 0.1, one tile of all
chains, max_leapfrog = 128), cut to 512 chains and 300 samples, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/compare_chees_acceptance.py

Prints one JSON line per package: acceptance, mean step size, mean T.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from binf_tpu.example.polynomial import make_posterior as jax_make_posterior
from binf_tpu.pdf.transforms import LogTransform as JaxLogTransform
from binf_tpu.pdf.transforms import transform_logdensity as jax_transform
from binf_tpu.samplers.fused import fused_model_hmc as jax_fused_model_hmc
from binf_tpu_torch.example.polynomial import make_data, make_posterior
from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity
from binf_tpu_torch.samplers.fused import fused_model_hmc

C = 512


def main():
    jax.config.update("jax_platforms", "cpu")
    xs, ys = make_data(torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    init = {"coefficients": (1.0 + 0.1 * torch.randn((C, 4), generator=g)).numpy(),
            "precision": np.zeros(C, np.float32)}
    kw = dict(num_warmup=500, num_samples=300, block_chains=C, warmup="fused",
              trajectory="chees", max_leapfrog=128, initial_step_size=0.1)
    port = fused_model_hmc(
        transform_logdensity(make_posterior(xs, ys).log_prob, {"precision": LogTransform}),
        init, 3, device="cpu", **kw)
    ref = jax_fused_model_hmc(
        jax_transform(jax_make_posterior(jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy())).log_prob,
                      {"precision": JaxLogTransform}),
        {k: jnp.asarray(v) for k, v in init.items()}, jax.random.key(3), **kw)
    for name, r in (("binf_tpu_torch", port), ("binf_tpu", ref)):
        print(json.dumps({"package": name, "chains": C, "accept": float(r.accept_rate),
                          "step_size": float(np.mean(np.asarray(r.step_size))),
                          "trajectory_length": float(np.mean(np.asarray(r.trajectory_length)))}))


if __name__ == "__main__":
    main()
