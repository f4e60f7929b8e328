"""``examples/run_chromatin_torch.py`` on the CPU at 32 beads and 60
sweeps, beside ``examples/run_chromatin.py`` at the same size: the same
summary lines in the same order (numbers aside), and in both an HMC
acceptance in (0.3, 1], a restraint precision estimate in (10, 100) (the
scripts print a truth of 25; the symmetrised noise makes it about twice
that, ROADMAP section 3) and a median restrained-distance error below
0.2."""

import example_scripts as es
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--beads", "32", "--sweeps", "60"]


def _check(lines):
    accept, prec, _ = es.numbers(es.line(lines, "HMC acceptance"))
    assert 0.3 < accept <= 1.0 and 10 < prec < 100, (accept, prec)
    assert es.numbers(es.line(lines, "median restrained-distance"))[-1] < 0.2


def test_port_script_prints_the_jax_scripts_summary():
    port = es.run_port("chromatin", ARGV)
    jax_lines = es.run_jax("chromatin", ARGV)
    assert es.form(port) == es.form(jax_lines)
    _check(port)
    _check(jax_lines)
