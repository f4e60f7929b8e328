"""``examples/run_hierarchical_torch.py`` on the CPU at 8 chains, 60
warmup and 40 sampling steps of eager NUTS (ADVI cut to 300 steps and 500
draws), beside ``examples/run_hierarchical.py`` at the same size (its ADVI
as written): the same summary lines in the same order (numbers aside),
and in both mu within 0.2 of ``TRUE_MU``, tau within 0.4-2.5x of
``TRUE_TAU``, the precision within 40% of 25 (each package draws its own
data), and ADVI's mu within 0.15 of NUTS's."""

import example_scripts as es
from binf_tpu_torch.example.hierarchical import TRUE_MU, TRUE_TAU
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--chains", "8", "--warmup", "60", "--samples", "40"]


def _check(lines):
    mu = es.numbers(es.line(lines, "mu ").split("truth")[0])
    tau = es.numbers(es.line(lines, "tau").split("truth")[0])
    prec = es.numbers(es.line(lines, "precision"))[0]
    vi_mu = es.numbers(es.line(lines, "ADVI").split("mu =")[1].split("ELBO")[0])
    assert max(abs(a - b) for a, b in zip(mu, TRUE_MU)) < 0.2, mu
    assert all(0.4 * t < v < 2.5 * t for v, t in zip(tau, TRUE_TAU)), tau
    assert abs(prec / 25.0 - 1.0) < 0.4, prec
    assert max(abs(a - b) for a, b in zip(vi_mu, mu)) < 0.15, (vi_mu, mu)


def test_port_script_prints_the_jax_scripts_summary():
    port = es.run_port("hierarchical", ARGV, ADVI_STEPS=300, ADVI_DRAWS=500)
    jax_lines = es.run_jax("hierarchical", ARGV)
    assert es.form(port) == es.form(jax_lines)
    _check(port)
    _check(jax_lines)
