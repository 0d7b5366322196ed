"""Build and load the hand-written CUDA kernels of ops/csrc/.

nvcc compiles each source of ops/csrc/ (ipm_iteration.cu, tube_stage.cu,
corridor.cu, lqr.cu; all include common.cuh, and ipm_iteration.cu and
lqr.cu riccati.cuh) for sm_90a into its own shared library with a plain C
interface, loaded with ctypes.  A library is built
at first use into ops/csrc/build/ (git-ignored) and rebuilt whenever its
source, a header or the flags change (the file name carries their hash).
`build()` starts one nvcc per source, all at once.  Without nvcc the build
raises RuntimeError: there is no fallback.  `register_prebuilt` hands
`load` a library built elsewhere (utils/aot.py's shipped solver), which it
then loads without building anything.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ipm_iteration.cu", "tube_stage.cu", "corridor.cu", "lqr.cu")
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
# it decides the ties of a voxel cloud as the plain version does
SOURCE_FLAGS = {"lqr.cu": ("-fmad=false",), "corridor.cu": ("-fmad=false",)}


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
    started together; cached libraries are not rebuilt."""
    t0 = time.perf_counter()
    jobs = []
    for source in sources or SOURCES:
        src, so, log = _paths(source)
        proc = tmp = None
        if not so.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *_flags(source), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        jobs.append((source, so, log, tmp, proc))
    out, failed = {}, []
    for source, so, log, tmp, proc in jobs:
        if proc is not None:
            stdout, stderr = proc.communicate()
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
    first use in this process."""
    if source not in _libs:
        path = _prebuilt.get(source) or build(source)[source].path
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _libs[source] = lib
    return _libs[source]
