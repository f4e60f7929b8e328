"""Build the CUDA sources in ``binf_tpu_torch/csrc`` at first use and bind
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` under
``binf_tpu_torch/_build/<hash>/``, the hash covering every source and
header in ``csrc`` and the compiler flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A library may have more
translation units, ``csrc/<name>.<part>.cu`` (K3, K4 and K5: one per
density family and lane-group width); they are compiled to objects and linked with
``<name>.cu``.  Every translation unit of every missing library is
compiled by its own ``nvcc`` process, all at once.  The C entry points return a
``cudaError_t``; :func:`check` raises on anything but success.

A shape of K3 and K4 that no unit of ``csrc`` instantiates (a family at
another dimension or lane-group width) gets two libraries of its own,
built at first use by :func:`shape_libraries` from
``csrc/fused_{warmup,potential}_shape.cu`` with the shape as ``-D`` macros,
into the same hashed directory; they carry the C entry points of
``fused_warmup.cu`` and ``fused_potential.cu``.  A traced density (family 6,
``ops/kernels/density_compiler.py``) is a shape too, keyed by the hash of
its emitted header: that header is written into the build directory and
force-included into both units (``-include``), so one header is one pair of
libraries, whatever data it later runs on.  The chain-grid kernel (K7) on
a traced density's group form is a third library of that header,
:func:`chain_grid_library`, from ``csrc/chain_grid_shape.cu``.

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
import time
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
            "group_eval": 0, "quadratic_leapfrog": 0, "density_eval": 0}



class LaunchRecord(NamedTuple):
    """A whole-run kernel's launch as the launch reported it: ``lanes`` a
    chain (``warps``: W of a group of warps a chain), a grid of ``ctas``
    CTAs of ``threads`` threads, ``cooperative`` or not, ``rounds`` of
    chains a CTA (K7: the rounds of CTAs the card runs), ``steps`` (warmup or sampling) and the step-size search's
    ``search_trials``; for K3 ``barrier``, the grid barrier's word, whose
    generation counts the barriers the run passed; for K2
    ``rows_in_registers``, whether the density's rows sat in registers (the
    unrolled form at n = 20, d = 4; for K5 every row of every lane);
    ``route``, K8's (``"tensor"`` or
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

    @property
    def warps(self) -> int:
        """W, the warps a chain where a chain has whole warps (K3's and K4's
        wide branches, K7: ``lanes / 32``); 0 where chains share a warp."""
        return self.lanes // 32

    def barriers(self) -> int:
        """Grid barriers the run passed (waits for the run): none for a
        launch that is not cooperative."""
        return 0 if self.barrier is None else int(self.barrier[1])

    def barriers_per_step(self) -> float:
        return (self.barriers() - self.search_trials) / self.steps


# the last launch of each kernel by its LAUNCHES name
last_launch: dict[str, LaunchRecord] = {}
# the wall seconds of each shape's build in this process (build_all), by
# the shape's tag "f<family>.d<D>.g<G>"
SHAPE_BUILDS: dict[str, float] = {}


def record_grid(name: str, grid, steps: int = 1, route: str = "") -> None:
    """Record the grid (CTAs, threads a CTA) that a launch of one of the
    other kernels (K1, K6, K8) reported, and the route K6b or K8 took."""
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
        if path.suffix in (".cu", ".cuh", ".h"):
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


def _run_all(jobs: dict, out_dir: Path) -> tuple[list[str], dict[str, float]]:
    """Run ``{log name: nvcc command}`` at once; each writes its output to
    ``<log name>.log``.  Returns the failures' reports and each job's wall
    seconds from the common start."""
    t0 = time.perf_counter()
    procs = {}
    for log, cmd in jobs.items():
        with open(out_dir / f"{log}.log", "w") as f:
            procs[log] = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    seconds: dict[str, float] = {}
    while len(seconds) < len(procs):
        for log, proc in procs.items():
            if log not in seconds and proc.poll() is not None:
                seconds[log] = time.perf_counter() - t0
        time.sleep(0.02)
    failed = [f"--- nvcc {log} (exit {proc.returncode})\n{(out_dir / f'{log}.log').read_text()}"
              for log, proc in procs.items() if proc.returncode != 0]
    return failed, seconds


SHAPE_KINDS = ("fused_warmup", "fused_potential")
_build_lock = threading.Lock()


def shape_names(family: int, D: int, G: int, traced=None) -> tuple[str, str]:
    """K3's and K4's library names for one shape: ``<kind>_shape.f<family>
    .d<D>.g<G>``, with the key of a traced density's header after the
    family (``f6.<key>``) (``lib<name>.so`` and ``<name>.log`` in the build
    directory)."""
    fam = f"f{family}" if traced is None else f"f{family}.{traced.key}"
    return tuple(f"{kind}_shape.{fam}.d{D}.g{G}" for kind in SHAPE_KINDS)


def traced_header(traced) -> Path:
    """The build directory's copy of a traced density's emitted header,
    written at first use."""
    path = build_dir() / f"traced_{traced.key}.cuh"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(traced.header)
        os.replace(tmp, path)
    return path


def chain_grid_name(traced) -> str:
    """K7's library name for a traced density's group form:
    ``chain_grid_shape.<key>.d<D>``."""
    return f"chain_grid_shape.{traced.key}.d{traced.D}"


def build_all(names=SOURCES, shapes=(), grids=()) -> Path:
    """Compile every library of ``names`` that is not built yet, K3's
    and K4's libraries for every shape ``(family, D, G)`` or ``(family, D,
    G, traced)`` of ``shapes`` (the family code of ``csrc/densities.cuh``,
    the dimension, the lane-group width, and for family 6 the
    ``CompiledDensity``: ``csrc/<kind>_shape.cu`` with
    ``-DBINF_SHAPE_FAMILY``, ``-DBINF_SHAPE_D`` and ``-DBINF_SHAPE_G``, a
    traced density's header force-included), and K7's library for every
    ``CompiledDensity`` of ``grids`` (``csrc/chain_grid_shape.cu``, its
    header force-included), all translation units at once, then link those
    of more than one.  Each shape's wall seconds (its slower library's,
    from the common start) go to ``SHAPE_BUILDS``, a K7 unit's under its
    library name.  Raises with the compiler's output if one fails: nothing
    falls back."""
    with _build_lock:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
        todo_shapes = {name: tuple(shape) + (None,) * (4 - len(shape)) for shape in shapes
                       for name in shape_names(*shape)
                       if not (out_dir / f"lib{name}.so").exists()}
        todo_grids = {chain_grid_name(t): t for t in grids
                      if not (out_dir / f"lib{chain_grid_name(t)}.so").exists()}
        if not todo and not todo_shapes and not todo_grids:
            return out_dir
        nvcc = _nvcc()
        pid = os.getpid()
        compiles, links = {}, {}
        for name in todo:
            tmp = out_dir / f"lib{name}.so.{pid}.tmp"
            srcs = units(name)
            if len(srcs) == 1:
                compiles[name] = [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o",
                                  str(tmp), str(srcs[0])]
            else:
                objs = [out_dir / f"{src.stem}.{pid}.o" for src in srcs]
                for src, obj in zip(srcs, objs):
                    compiles[src.stem] = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o",
                                          str(obj), str(src)]
                links[f"{name}.link"] = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o",
                                         str(tmp), *map(str, objs)]
        for name, (family, D, G, traced) in todo_shapes.items():
            extra = [] if traced is None else [
                "-include", str(traced_header(traced)),
                f"-DBINF_TRACED_TYPE=binf::{traced.kernel_name}"]
            compiles[name] = [nvcc, *NVCC_FLAGS, f"-DBINF_SHAPE_FAMILY={family}",
                              f"-DBINF_SHAPE_D={D}", f"-DBINF_SHAPE_G={G}", *extra, "-shared",
                              "-I", str(CSRC), "-o", str(out_dir / f"lib{name}.so.{pid}.tmp"),
                              str(CSRC / f"{name.split('.')[0]}.cu")]
        for name, traced in todo_grids.items():
            compiles[name] = [nvcc, *NVCC_FLAGS, "-include", str(traced_header(traced)),
                              f"-DBINF_TRACED_TYPE=binf::{traced.group_name}", "-shared", "-I",
                              str(CSRC), "-o", str(out_dir / f"lib{name}.so.{pid}.tmp"),
                              str(CSRC / "chain_grid_shape.cu")]
        failed, seconds = _run_all(compiles, out_dir)
        if not failed:
            failed = _run_all(links, out_dir)[0]
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
        for name in [*todo, *todo_shapes, *todo_grids]:
            os.replace(out_dir / f"lib{name}.so.{pid}.tmp", out_dir / f"lib{name}.so")
        for obj in out_dir.glob(f"*.{pid}.o"):
            obj.unlink()
        for name in todo_shapes:
            tag = name.split(".", 1)[1]
            SHAPE_BUILDS[tag] = max(SHAPE_BUILDS.get(tag, 0.0), seconds[name])
        for name in todo_grids:
            SHAPE_BUILDS[name] = seconds[name]
    return out_dir


_shapes_ready: set = set()


def shape_libraries(family: int, D: int, G: int, traced=None) -> tuple[str, str]:
    """K3's and K4's library names for one shape (a traced density's with
    its ``CompiledDensity``), built first if they are not
    (:func:`build_all`)."""
    names = shape_names(family, D, G, traced)
    if names not in _shapes_ready:
        out_dir = build_dir()
        if not all((out_dir / f"lib{n}.so").exists() for n in names):
            build_all((), [(family, D, G, traced)])
        _shapes_ready.add(names)
    return names


def chain_grid_library(traced) -> str:
    """K7's library name for a traced density's group form, built first if
    it is not (:func:`build_all`)."""
    name = chain_grid_name(traced)
    if name not in _shapes_ready:
        if not (build_dir() / f"lib{name}.so").exists():
            build_all((), grids=[traced])
        _shapes_ready.add(name)
    return name


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use), or a
    shape's library that :func:`shape_libraries` built."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name in SOURCES:
                path = build_all() / f"lib{name}.so"
            else:
                path = build_dir() / f"lib{name}.so"
                if not path.exists():
                    raise RuntimeError(f"lib{name}.so is not built (shape_libraries builds "
                                       "a shape's libraries)")
            lib = ctypes.CDLL(str(path))
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
