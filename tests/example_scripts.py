"""Runs the example scripts in this process for the tests of the port's
scripts (``tests/test_torch_script_*.py``): the port's
``examples/run_<name>_torch.py`` through its ``main(argv)``, the JAX
package's ``examples/run_<name>.py`` through its ``main()`` with
``sys.argv`` set, each with its stdout captured; and the summary lines'
form (their text with every number replaced) and numbers."""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
_NUMBER = r"[-+]?\d[\d,]*\.?\d*(?:e[-+]?\d+)?"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.strip()]


def run_port(name: str, argv: list[str], **constants) -> list[str]:
    """The port script's printed lines (on the CPU), with its module's
    constants (its cut sizes) set first."""
    module = _load(EXAMPLES / f"run_{name}_torch.py")
    for k, v in constants.items():
        assert hasattr(module, k), k
        setattr(module, k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main([*argv, "--device", "cpu"])
    return _lines(buf.getvalue())


def run_jax(name: str, argv: list[str]) -> list[str]:
    """The JAX script's printed lines, on the backend the tests set (the
    CPU)."""
    module = _load(EXAMPLES / f"run_{name}.py")
    saved = sys.argv
    sys.argv = [str(EXAMPLES / f"run_{name}.py"), *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = saved
    return _lines(buf.getvalue())


def form(lines: list[str]) -> list[str]:
    """Each line with its numbers as ``#`` and its spacing collapsed (numpy
    pads arrays by their values), the null feature's verdict as
    ``<verdict>``."""
    out = []
    for ln in lines:
        ln = re.sub(_NUMBER, "#", re.sub(r"\((contains|EXCLUDES) 0\)", "(<verdict>)", ln))
        ln = re.sub(r"\s+", " ", ln).replace("[ ", "[").replace(" ]", "]").strip()
        out.append(ln)
    return out


def numbers(line: str) -> list[float]:
    return [float(x.replace(",", "")) for x in re.findall(_NUMBER, line)]


def line(lines: list[str], start: str) -> str:
    found = [ln for ln in lines if ln.strip().startswith(start)]
    assert len(found) == 1, (start, lines)
    return found[0]
