"""Build the CUDA sources in ``binf_tpu_torch/csrc`` at first use and bind
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` under
``binf_tpu_torch/_build/<hash>/``, the hash covering every source and
header in ``csrc`` and the compiler flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  All missing libraries are
compiled by parallel ``nvcc`` processes.  The C entry points return a
``cudaError_t``; :func:`check` raises on anything but success.

Also here: the launch counters.  Every wrapper that launches a kernel adds
one to its kernel's count at the launch and nowhere else, so a run can show
which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("philox", "fused_hmc", "fused_warmup", "fused_potential", "fused_gibbs", "pairwise")
# no --use_fast_math: the plain versions are compared with logf/expf/cosf
# at full precision
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"philox": 0, "fused_linreg_hmc": 0, "fused_warmup": 0, "fused_potential_hmc": 0,
            "fused_gibbs": 0, "pairwise_fwd": 0, "pairwise_bwd": 0}

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


def build_all(names=SOURCES) -> Path:
    """Compile every library of ``names`` that is not built yet, all at
    once; raise with the compiler's output if one fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            lib.binf_error_string.argtypes = [ctypes.c_int]
            lib.binf_error_string.restype = ctypes.c_char_p
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
        msg = load(name).binf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def nullable_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
