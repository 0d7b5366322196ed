"""Build and load the hand-written CUDA kernels of ops/csrc/.

nvcc compiles each source of ops/csrc/ (ipm_iteration.cu, tube_stage.cu,
tube_chain.cu, corridor.cu, lqr.cu, reference.cu; all include common.cuh, and
ipm_iteration.cu and lqr.cu riccati.cuh) for sm_90a into its own shared
library with a plain C interface, loaded with ctypes.  A library is built
at first use into ops/csrc/build/ (git-ignored) and rebuilt whenever its
source, a header or the flags change (the file name carries their hash).
`build()` starts one nvcc per source, all at once.  Without nvcc the build
raises RuntimeError: there is no fallback.  `register_prebuilt` hands
`load` a library built elsewhere (utils/aot.py's shipped solver), which it
then loads without building anything.

This module is also the one way to reach a kernel.  A wrapper of ops/ sends
a CPU tensor to its plain version, checks its own argument rules, calls
`route` (each tensor's shape, dtype, device and contiguity, the refusal of
a device other than CUDA, the library) and `on_stream` (its `launch`, which
hands the return code to `check`), and counts the launch.  A new kernel
costs its `_bind`, its `launch` and a call of each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from forces_resilient_planner_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ipm_iteration.cu", "tube_stage.cu", "tube_chain.cu",
           "corridor.cu", "lqr.cu", "reference.cu")
BUILD_DIR = CSRC / "build"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
# no --use_fast_math: the NaN guards need IEEE division and isfinite;
# --expt-relaxed-constexpr lets device code read std::numeric_limits
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# lqr.cu contracts no multiply-add into an FMA: K4 and K5 then round op for
# op as their plain PyTorch versions do and match them bit for bit on the
# card, where the Riccati sweep of a late interior-point iteration turns a
# last-bit difference into a relative one of 1e-9 and more; corridor.cu
# neither, and writes the plain version's emulated FMAs as __fma_rn, so that
# it decides the ties of a voxel cloud as the plain version does; nor
# tube_chain.cu, which rounds the tube recursion and roots op for op as
# their plain versions do; nor reference.cu, which rounds the reference
# sampling and the yaw filter op for op as engine/reference.py does
SOURCE_FLAGS = {"lqr.cu": ("-fmad=false",), "corridor.cu": ("-fmad=false",),
                "tube_chain.cu": ("-fmad=false",),
                "reference.cu": ("-fmad=false",)}


class Built(NamedTuple):
    path: Path
    seconds: float      # build time (0-ish when the library was cached)
    ptxas_log: str      # nvcc -Xptxas -v output: registers, spills


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        shutil.which("nvcc"),
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        NVCC_FALLBACK,
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or at "
        f"{NVCC_FALLBACK}: cannot build the CUDA kernels of {CSRC.name}/ "
        "(the CUDA route has no fallback; CPU tensors use the plain "
        "PyTorch versions)"
    )


def _flags(source: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def source_hash(source: str) -> str:
    """The hash of a source, every header and the flags: the part of its
    library's file name that changes whenever any of them does."""
    src = CSRC / source
    if source not in SOURCES or not src.is_file():
        raise ValueError(f"unknown kernel source {source!r} (known: {SOURCES})")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return h.hexdigest()[:16]


def _paths(source: str):
    stem = f"{Path(source).stem}_{source_hash(source)}"
    return CSRC / source, BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"


def build(*sources: str) -> dict[str, Built]:
    """Compile the given sources (default: all), one nvcc process each, all
    started together; cached libraries are not rebuilt.  Each nvcc run is
    the span ops.build.<source stem>, from its start until it is collected."""
    t0 = time.perf_counter()
    jobs = []
    for source in sources or SOURCES:
        src, so, log = _paths(source)
        proc = tmp = span = None
        if not so.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            span = trace.span(f"ops.build.{Path(source).stem}").__enter__()
            proc = subprocess.Popen(
                [nvcc, *_flags(source), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        jobs.append((source, so, log, tmp, proc, span))
    out, failed = {}, []
    for source, so, log, tmp, proc, span in jobs:
        if proc is not None:
            stdout, stderr = proc.communicate()
            span.__exit__(None, None, None)
            if proc.returncode != 0:
                failed.append(f"{source}: nvcc exit code {proc.returncode}:\n"
                              f"{stdout}\n{stderr}")
                continue
            log.write_text(stdout + stderr)
            os.replace(tmp, so)
        out[source] = Built(
            path=so, seconds=time.perf_counter() - t0,
            ptxas_log=log.read_text() if log.exists() else "",
        )
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_libs: dict[str, ctypes.CDLL] = {}
_prebuilt: dict[str, Path] = {}


def register_prebuilt(source: str, so_path) -> None:
    """Make `load(source)` use the library at so_path and build nothing.
    Raises if this process already loaded another library of `source`."""
    if source not in SOURCES:
        raise ValueError(f"unknown kernel source {source!r} (known: {SOURCES})")
    so_path = Path(so_path).resolve()
    if not so_path.is_file():
        raise FileNotFoundError(f"no prebuilt library at {so_path}")
    if source in _libs and _prebuilt.get(source) != so_path:
        raise RuntimeError(
            f"{source}: this process already loaded another library of it")
    _prebuilt[source] = so_path


def load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of `source`, bound by `bind` (which sets each entry
    point's argtypes/restype): the registered prebuilt one, else built at
    first use in this process (the span ops.load.<source stem>)."""
    if source not in _libs:
        with trace.span(f"ops.load.{Path(source).stem}"):
            path = _prebuilt.get(source) or build(source)[source].path
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[source] = lib
    return _libs[source]


# the dtypes every kernel of ops/csrc/ is instantiated for
DTYPES = (torch.float32, torch.float64)


def route(source: str, bind: Callable, named) -> ctypes.CDLL:
    """The device route's checks, then the library of `source` (`load`).
    named: (name, tensor, shape[, dtype]) for each tensor a kernel reads;
    the first sets the dtype, one of DTYPES, and the device of all; a
    fourth entry gives a tensor its own dtype."""
    dtype, device = named[0][1].dtype, named[0][1].device
    if dtype not in DTYPES:
        raise ValueError(f"the CUDA kernels take float32 or float64, not {dtype}")
    for name, t, shape, *own in named:
        want = own[0] if own else dtype
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != want or t.device != device:
            raise ValueError(
                f"{name}: {t.dtype} on {t.device}, expected {want} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take contiguous tensors only")
    if device.type != "cuda":
        raise ValueError(f"no route for tensors on {device}")
    return load(source, bind)


def on_stream(device: torch.device, launch: Callable, *args, **kwargs):
    """launch(*args, stream, **kwargs) with `device` current and `stream`
    the handle of its current stream; returns what launch returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return launch(*args, stream, **kwargs)


def check(rc: int, kernel: str, **context) -> None:
    """Raise RuntimeError if a launch returned a CUDA error (rc != 0)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}"
                           + (f" {context}" if context else ""))
