"""``examples/run_polynomial_torch.py`` on the CPU at 64 chains and 120
sweeps (20 burned), beside ``examples/run_polynomial.py`` at the same
size: the same summary lines in the same order (numbers aside), and in
both every posterior mean within three of its posterior standard
deviations of the truth (each package draws its own 20 data points, so the
posterior's centre moves with the data), R-hat below 1.05 (the collapsed
Gibbs draws are exact), the MAP coefficients within three standard
deviations of the truth too."""

import example_scripts as es
from binf_tpu_torch.example.polynomial import TRUE_COEFFICIENTS, TRUE_PRECISION
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--chains", "64", "--sweeps", "120", "--burn", "20"]


def _check(lines):
    truth = list(TRUE_COEFFICIENTS) + [TRUE_PRECISION]
    names = [f"coefficients[{j}]" for j in range(4)] + ["precision"]
    sds = []
    for name, tr in zip(names, truth):
        mean, std, rhat, ess, _ = es.numbers(es.line(lines, name).split(None, 1)[1])
        assert abs(mean - tr) <= 3 * std and rhat < 1.05 and ess > 1000, (name, mean, std, rhat)
        sds.append(std)
    mapc = es.numbers(es.line(lines, "MAP coefficients:"))
    assert all(abs(m - t) <= 3 * s for m, t, s in zip(mapc[:4], truth, sds)), mapc


def test_port_script_prints_the_jax_scripts_summary():
    port = es.run_port("polynomial", ARGV)
    jax_lines = es.run_jax("polynomial", ARGV)
    assert es.form(port) == es.form(jax_lines)
    assert es.numbers(port[0])[0] == 64 * 100 == es.numbers(jax_lines[0])[0]
    _check(port)
    _check(jax_lines)
