"""``examples/run_logistic_torch.py`` on the CPU at 64 chains, 100 warmup
and 150 sampling steps (the eager window warmup, then the plain K4 over
the logistic device density; the Laplace fit at 300 steps), beside
``examples/run_logistic.py`` at the same size: the same summary lines in
the same order (numbers aside, and the null feature's verdict, which
follows its printed interval), and in both each weight's mean within three
posterior standard deviations of ``TRUE_WEIGHTS`` (each package draws its
own 200 rows) with R-hat below 1.2 (a short run), held-out accuracy above
0.75, and the Laplace mode within 0.2 of the MCMC mean."""

import example_scripts as es
from binf_tpu_torch.example.logistic import TRUE_WEIGHTS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--chains", "64", "--warmup", "100", "--samples", "150"]


def _check(lines):
    rows = [es.numbers(ln) for ln in lines if ln.startswith("weight[")]
    assert len(rows) == len(TRUE_WEIGHTS)
    for j, (_, tr, mean, sd, rhat) in enumerate(rows):
        assert tr == TRUE_WEIGHTS[j] and abs(mean - tr) <= 3 * sd and rhat < 1.2, rows[j]
    ci = es.line(lines, "null feature")
    _, lo, hi = es.numbers(ci.split("(")[0])
    assert ("contains 0" in ci) == (lo < 0 < hi)
    assert es.numbers(es.line(lines, "held-out"))[-1] > 0.75
    laplace = es.line(lines, "Laplace MAP")
    assert es.numbers(laplace)[0] < 0.2 and "converged=True" in laplace


def test_port_script_prints_the_jax_scripts_summary():
    port = es.run_port("logistic", ARGV, LAPLACE_STEPS=300)
    jax_lines = es.run_jax("logistic", ARGV)
    assert es.form(port) == es.form(jax_lines)
    _check(port)
    _check(jax_lines)
