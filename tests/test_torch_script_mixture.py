"""``examples/run_mixture_torch.py`` on the CPU at 64 chains, 100 warmup
and 100 sampling steps (the plain K3 and K4 over the mixture's device
density), beside ``examples/run_mixture.py`` at the same size: the same
summary lines in the same order (numbers aside), and in both the sorted
means within 0.25, the weights within 0.1 and sigma within 0.1 of the
truth (``TRUE_MEANS``, ``TRUE_WEIGHTS``, ``TRUE_SIGMA``; each package
draws its own 240 points), acceptance in (0.6, 1) and at least 90% of the
held-out points classified as their nearest true mean."""

import numpy as np

import example_scripts as es
from binf_tpu_torch.example.mixture import TRUE_MEANS, TRUE_SIGMA, TRUE_WEIGHTS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--chains", "64", "--warmup", "100", "--samples", "100"]


def _check(lines):
    accept = es.numbers(es.line(lines, "fused HMC:"))[-1]
    means = es.numbers(es.line(lines, "means").split("truth")[0])
    weights = es.numbers(es.line(lines, "weights").split("truth")[0])
    sigma = es.numbers(es.line(lines, "sigma").split("truth")[0])[0]
    agree = es.numbers(es.line(lines, "held-out"))[-1]
    assert 0.6 < accept < 1.0
    assert np.abs(np.array(means) - np.sort(TRUE_MEANS)).max() < 0.25, means
    assert np.abs(np.array(weights) - np.array(TRUE_WEIGHTS)).max() < 0.1, weights
    assert abs(sigma - TRUE_SIGMA) < 0.1 and agree >= 90, (sigma, agree)


def test_port_script_prints_the_jax_scripts_summary():
    port = es.run_port("mixture", ARGV)
    jax_lines = es.run_jax("mixture", ARGV)
    assert es.form(port) == es.form(jax_lines)
    _check(port)
    _check(jax_lines)
