"""Build and load the hand-written CUDA kernel of ops/csrc/.

nvcc compiles ops/csrc/ipm_iteration.cu for sm_90a into a shared library
with a plain C interface, loaded with ctypes.  The library is built at
first use into ops/csrc/build/ (git-ignored) and rebuilt whenever the
source or the flags change (the file name carries their hash).  Without
nvcc the build raises RuntimeError: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ipm_iteration.cu"
BUILD_DIR = CSRC / "build"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
# no --use_fast_math: the NaN guard needs IEEE division and isfinite;
# --expt-relaxed-constexpr lets device code read std::numeric_limits
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
N_POINTERS = 23  # 17 inputs, 5 outputs, 1 scratch (see the C entry points)


class Built(NamedTuple):
    lib: ctypes.CDLL
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
        f"{NVCC_FALLBACK}: cannot build {SOURCE.name} (the CUDA route has "
        "no fallback; CPU tensors use the plain PyTorch version)"
    )


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ipm_scratch_per_lane.argtypes = [ctypes.c_int]
    lib.ipm_scratch_per_lane.restype = ctypes.c_size_t
    for name in ("ipm_iteration_f32", "ipm_iteration_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * N_POINTERS
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def build() -> Built:
    """Compile (if needed) and load the kernel library."""
    t0 = time.perf_counter()
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"ipm_iteration_{digest}.so"
    log = BUILD_DIR / f"ipm_iteration_{digest}.log"
    if not so.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = _bind(ctypes.CDLL(str(so)))
    return Built(
        lib=lib, path=so, seconds=time.perf_counter() - t0,
        ptxas_log=log.read_text() if log.exists() else "",
    )


_built: Built | None = None


def load() -> Built:
    """The kernel library, built at first use in this process."""
    global _built
    if _built is None:
        _built = build()
    return _built
