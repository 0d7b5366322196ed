"""Where K1's time goes on the card: its phase clocks and its lanes per CTA.

    python3 -m forces_resilient_planner_tpu_torch.tools.k1_phase_probe

Builds ops/csrc/ipm_iteration.cu once more with -DFRP_K1_CLOCKS (into the
git-ignored ops/csrc/build/), which records clock64() of block 0's first
lane at the kernel's phase boundaries, and launches it on the bench grid's
initial state (seed 2, f32, every lane active) at B = 1, 256 and 4096 with
4, 2 and 1 lanes per CTA.  Prints the cycles of each phase and the
kernel's ms per launch (CUDA events, 20 launches), with the card's name
and power limit.  Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.ops import _build, ipm_kernel
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.tools.parity_certificate import card_line

PHASES = ("copy in", "dynamics", "residuals, errors", "RHS",
          "stage QP blocks", "Riccati factor", "backsolve",
          "rollout, costates", "step ratios", "NaN guard",
          "update, CTA barrier")
STAGE_STEPS = ("Abar^T P, Bbar^T P", "Qh, Sh, Rh", "Cholesky, K")


def build_clocked():
    src = _build.CSRC / ipm_kernel.SOURCE
    out = _build.BUILD_DIR / "ipm_iteration_clocks.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DFRP_K1_CLOCKS", "-o",
         str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    ipm_kernel._bind(lib)
    lib.ipm_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.ipm_phase_clocks.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke

    card = card_line("cuda")
    lib = build_clocked()
    cfg = workloads.bench_config()
    state, params = chip_smoke.bench_lanes(cfg, 2, torch.float32, "cuda")
    for B in (1, 256, 4096):
        sub = [a[..., :B].contiguous() for a in state]
        sub_p = ipm_lanes._map_params(lambda a: a[..., :B].contiguous(),
                                      params)
        args = chip_smoke.iter_args(sub, sub_p, cfg)
        ins = [*args[:5], *args[5], *args[6:13]]
        outs = [torch.empty_like(t) for t in args[:5]]
        for lanes in (4, 2, 1):
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                ipm_kernel.launch(lib, ins, outs, cfg.model, cfg.solver,
                                  stream, max_lanes=lanes)

            ms = chip_smoke.cuda_ms(run, 20)
            clocks = (ctypes.c_longlong * 16)()
            if lib.ipm_phase_clocks(clocks) != 0:
                raise RuntimeError("cudaMemcpyFromSymbol failed")
            c = list(clocks)
            split = ", ".join(f"{name} {c[k + 1] - c[k]}"
                              for k, name in enumerate(PHASES))
            stage = ", ".join(f"{name} {c[k + 13] - c[k + 12]}"
                              for k, name in enumerate(STAGE_STEPS))
            print(f"K1 B={B} f32 lanes/CTA {lanes} [{card}]: {ms:.4f} ms; "
                  f"block 0 lane 0 cycles: total {c[11] - c[0]}: {split}; "
                  f"factor stage 1: {stage}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
