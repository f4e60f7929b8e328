"""The command line's eager routes on the other models, on the CPU
(``--device cpu``): the counterparts of ``tests/test_cli.py``'s cases,
which the JAX package marks slow, with the same gates at fewer steps.
``--algorithm chees`` takes the fused kernels when the density has a CUDA
functor (the hierarchical posterior's does), where the JAX package asks
whether its tile interpreter compiles it."""

from binf_tpu_torch.cli import main


def cli(*argv):
    return main([*argv, "--device", "cpu"])


def test_cli_chees_hierarchical():
    # 50 warmup steps (200 in the JAX test): the eager ChEES warmup takes
    # most of the run on the CPU
    out = cli("--model", "hierarchical", "--algorithm", "chees", "--chains", "32", "--warmup",
              "50", "--samples", "100")
    assert out["sampler"] == "chees (fused in-kernel)"
    assert out["summary"]["mu"]["rhat"][0] < 1.3


def test_cli_logistic_nuts():
    out = cli("--model", "logistic", "--algorithm", "nuts", "--no-reroute", "--chains", "16",
              "--warmup", "150", "--samples", "150")
    assert "sampler" not in out
    means = out["summary"]["weights"]["mean"]
    assert abs(means[1] + 2.0) < 0.7  # TRUE_WEIGHTS[1] = -2.0
    assert out["summary"]["weights"]["rhat"][0] < 1.2


def test_cli_mixture_hmc():
    # 80 + 60 steps (200 + 150 in the JAX test)
    out = cli("--model", "mixture", "--algorithm", "hmc", "--chains", "32", "--warmup", "80",
              "--samples", "60")
    assert "means" in out["summary"]
    assert out["summary"]["log_sigma"]["rhat"] < 1.5

