"""Build the CUDA sources in ``binf_tpu_torch/csrc`` at first use and bind
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` under
``binf_tpu_torch/_build/<hash>/``, the hash covering every source and
header in ``csrc`` and the compiler flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A library may have more
translation units, ``csrc/<name>.<part>.cu`` (K3 and K4: one per
lane-group width); they are compiled to objects and linked with
``<name>.cu``.  Every translation unit of every missing library is
compiled by its own ``nvcc`` process, all at once.  The C entry points return a
``cudaError_t``; :func:`check` raises on anything but success.

Also here: the launch counters.  Every wrapper that launches a kernel adds
one to its kernel's count at the launch and nowhere else, so a run can show
which kernels its path went through; and the grid each whole-run kernel
reported for its last launch (``last_launch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("philox", "fused_hmc", "fused_warmup", "fused_potential", "fused_gibbs", "pairwise",
           "chain_grid", "leapfrog")
# no --use_fast_math: the plain versions are compared with logf/expf/cosf
# at full precision
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"philox": 0, "fused_linreg_hmc": 0, "fused_warmup": 0, "fused_potential_hmc": 0,
            "fused_gibbs": 0, "pairwise_fwd": 0, "pairwise_bwd": 0, "chain_grid_hmc": 0,
            "gram_eval": 0, "quadratic_leapfrog": 0}



class LaunchRecord(NamedTuple):
    """A whole-run kernel's launch as the launch reported it: ``lanes`` a
    chain, a grid of ``ctas`` CTAs of ``threads`` threads, ``cooperative``
    or not, ``rounds`` of chains a CTA (K7: the rounds of CTAs the card
    runs), ``steps`` (warmup or sampling) and the step-size search's
    ``search_trials``; for K3 ``barrier``, the grid barrier's word, whose
    generation counts the barriers the run passed; for K2
    ``rows_in_registers``, whether the density's rows sat in registers (the
    unrolled form at n = 20, d = 4); ``route``, K8's (``"tensor"`` or
    ``"simt"``) and K6b's (``"vector"``: 16-byte loads, or ``"scalar"``)."""

    lanes: int
    ctas: int
    threads: int
    cooperative: bool
    rounds: int
    steps: int
    search_trials: int
    barrier: "torch.Tensor | None"
    rows_in_registers: bool = False
    route: str = ""

    def barriers(self) -> int:
        """Grid barriers the run passed (waits for the run): none for a
        launch that is not cooperative."""
        return 0 if self.barrier is None else int(self.barrier[1])

    def barriers_per_step(self) -> float:
        return (self.barriers() - self.search_trials) / self.steps


# the last launch of each kernel by its LAUNCHES name
last_launch: dict[str, LaunchRecord] = {}


def record_grid(name: str, grid, steps: int = 1, route: str = "") -> None:
    """Record the grid (CTAs, threads a CTA) that a launch of one of the
    other kernels (K1, K5, K6, K8) reported, and the route K6b or K8 took."""
    last_launch[name] = LaunchRecord(1, grid[0], grid[1], False, 1, steps, 0, None,
                                     route=route)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def count_launch(*names: str) -> None:
    for name in names:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


def units(name: str) -> list[Path]:
    """The translation units of library ``name``: ``<name>.cu`` and its
    ``<name>.<part>.cu`` files."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob(f"{name}.*.cu"))]


def _run_all(jobs: dict, out_dir: Path) -> list[str]:
    """Run ``{log name: nvcc command}`` at once; each log goes to
    ``<log name>.log``.  Returns the failures' reports."""
    procs = {log: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for log, cmd in jobs.items()}
    failed = []
    for log, proc in procs.items():
        out, _ = proc.communicate()
        (out_dir / f"{log}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {log} (exit {proc.returncode})\n{out}")
    return failed


def build_all(names=SOURCES) -> Path:
    """Compile every library of ``names`` that is not built yet, all
    translation units at once, then link those of more than one; raise
    with the compiler's output if one fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    pid = os.getpid()
    compiles, links = {}, {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{pid}.tmp"
        srcs = units(name)
        if len(srcs) == 1:
            compiles[name] = [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(tmp),
                              str(srcs[0])]
        else:
            objs = [out_dir / f"{src.stem}.{pid}.o" for src in srcs]
            for src, obj in zip(srcs, objs):
                compiles[src.stem] = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj),
                                      str(src)]
            links[f"{name}.link"] = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                                     *map(str, objs)]
    failed = _run_all(compiles, out_dir)
    if not failed:
        failed = _run_all(links, out_dir)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    for name in todo:
        os.replace(out_dir / f"lib{name}.so.{pid}.tmp", out_dir / f"lib{name}.so")
    for obj in out_dir.glob(f"*.{pid}.o"):
        obj.unlink()
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            lib.binf_error_string.argtypes = [ctypes.c_int]
            lib.binf_error_string.restype = ctypes.c_char_p
            lib.binf_error_name.argtypes = [ctypes.c_int]
            lib.binf_error_name.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``fn`` of library ``name``, returning a ``cudaError_t``."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(name: str, err: int, what: str) -> None:
    if err != 0:
        lib = load(name)
        raise RuntimeError(f"{what}: CUDA error {err} {lib.binf_error_name(err).decode()} "
                           f"({lib.binf_error_string(err).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def nullable_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
