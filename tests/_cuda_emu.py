"""Build a kernel source of ops/csrc/ for the CPU: g++ against the host
stand-in of the CUDA runtime in tests/cuda_emu/, its launch rewritten to
emu::launch and its dynamic shared memory to a per-block buffer.  The
library has the same C entry points as the nvcc build and takes CPU
pointers."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from forces_resilient_planner_tpu_torch.ops import _build

EMU = str(Path(__file__).resolve().parent / "cuda_emu")


def build(source: str, out: Path, bind) -> ctypes.CDLL:
    """csrc/<source> compiled into out/ and bound by `bind`; skips the test
    without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    src = (_build.CSRC / source).read_text()
    src, n_smem = re.subn(r"extern __shared__[^;]*\b(\w+)\[\];",
                          r"unsigned char* \1 = emu::shared_memory();", src)
    src, n_launch = re.subn(
        r"([\w:]+(?:<[^<>()]*>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(",
        r"emu::launch(\1, \2,\3,\4, ", src)
    assert n_smem == 1 and n_launch == 1
    cpp = out / (Path(source).stem + ".cpp")
    cpp.write_text(src)
    so = out / f"lib{Path(source).stem}_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", EMU, "-I", str(out), "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    bind(lib)
    return lib
