"""``examples/run_statespace_torch.py`` on the CPU at 128 chains, 200
warmup and 100 sampling steps (the plain K3 and K4 over the AR(1) device
density), its NUTS cross-check cut to 8 chains and 60 + 60 steps, beside
``examples/run_statespace.py`` at the same size (its cross-check as
written): the same summary lines in the same order (numbers aside), and in
both phi and the drift within 0.15 and x0 within 0.5 of
``TRUE_DYNAMICS`` (x0 is the least identified; each package draws its own
64 observations), the precision within 40% of ``TRUE_PRECISION``, and the
NUTS cross-check's means within 0.3 of the fused run's."""

import example_scripts as es
from binf_tpu_torch.example.statespace import TRUE_DYNAMICS, TRUE_PRECISION
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--chains", "128", "--warmup", "200", "--samples", "100"]


def _check(lines):
    dyn = es.numbers(es.line(lines, "dynamics").split("truth")[0])
    prec = es.numbers(es.line(lines, "precision"))[0]
    delta = es.numbers(es.line(lines, "NUTS cross-check"))[-1]
    assert max(abs(a - b) for a, b in zip(dyn[:2], TRUE_DYNAMICS[:2])) < 0.15, dyn
    assert abs(dyn[2] - TRUE_DYNAMICS[2]) < 0.5, dyn
    assert abs(prec / TRUE_PRECISION - 1.0) < 0.4 and delta < 0.3, (prec, delta)


def test_port_script_prints_the_jax_scripts_summary():
    port = es.run_port("statespace", ARGV, NUTS_CHAINS=8, NUTS_WARMUP=60, NUTS_SAMPLES=60)
    jax_lines = es.run_jax("statespace", ARGV)
    assert es.form(port) == es.form(jax_lines)
    _check(port)
    _check(jax_lines)
