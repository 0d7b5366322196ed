"""Where the Riccati kernels' time goes on the card: their phase clocks.

    python3 -m forces_resilient_planner_tpu_torch.tools.k4_phase_probe

Builds ops/csrc/lqr.cu once more with -DFRP_K4_CLOCKS (into the git-ignored
ops/csrc/build/), which sums clock64() deltas of block 0's first lane over
the kernels' phases, and launches K4a and K4b on the predictor-corrector
grid's initial-state calls (chip_smoke.record_k4: the bench grid of seed 1,
f32), then K5a and K5b on chip_smoke.py's random blocks (seed 0, N = 20,
f32), each at B = 1, 256 and 4096.  Prints the cycles of each phase,
summed over the stages, and the kernel's ms per launch (CUDA events, 20
launches), with the card's name and power limit.  Needs an NVIDIA GPU and
nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.engine import workloads
from forces_resilient_planner_tpu_torch.ops import _build, lqr_kernel
from forces_resilient_planner_tpu_torch.tools.parity_certificate import card_line

# csrc/lqr.cu's K4_CLOCK indices: the factors' (K5a has no prologue; its
# phase 1 is the first copies and their wait) and the backsolves'
FACTOR_PHASES = {1: "prologue (K4a: stage QP values; K5a: first copies)",
                 2: "terminal stage, out", 9: "next stage's copies issued",
                 3: "G^T P", 4: "Qh, Sh, Rh", 5: "Cholesky, K",
                 6: "P = sym(Qh + Sh^T K)", 7: "copy wait, CTA barrier",
                 8: "stage out"}
SOLVE_PHASES = {10: "first copies, terminal",
                14: "next stage's copies issued", 11: "backward stages",
                12: "forward stages", 13: "copy wait, CTA barrier",
                15: "costates out"}


def build_clocked():
    src = _build.CSRC / lqr_kernel.SOURCE
    out = _build.BUILD_DIR / "lqr_clocks.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build._flags(lqr_kernel.SOURCE),
         "-DFRP_K4_CLOCKS", "-o", str(out), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    lqr_kernel._bind(lib)
    lib.lqr_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.lqr_phase_cycles.restype = ctypes.c_int
    return lib


def cycles(lib):
    """The phase cycles since the last call (which zeroes them)."""
    out = (ctypes.c_longlong * 16)()
    if lib.lqr_phase_cycles(out) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    return list(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke

    card = card_line("cuda")
    lib = build_clocked()
    cfg_pc = chip_smoke.with_pc(workloads.bench_config())
    state, params = chip_smoke.bench_lanes(cfg_pc, 1, torch.float32, "cuda")
    fa, sa = chip_smoke.record_k4(chip_smoke.lane_state(state), params,
                                  cfg_pc)
    fac, Ax, Bx, c, qx, qu, dx0 = sa[0]
    Q, R, S, qx5, qu5, A, Bm, c5, dx05 = (
        torch.as_tensor(a, dtype=torch.float32, device="cuda")
        for a in chip_smoke.random_lqr(np.random.default_rng(0),
                                       chip_smoke.LQR_N, chip_smoke.LQR_B))
    fac5 = lqr_kernel.lqr_factor_reference(Q, R, S, A, Bm)
    # (label, kernel, inputs, scalars, phases)
    jobs = (("K4a", "lqr_factor_fused", fa[:9], (fa[6].shape[1], fa[9],
                                                  fa[10]), FACTOR_PHASES),
            ("K4b", "lqr_backsolve_fused", (*fac, Ax, Bx, c, qx, qu, dx0), (),
             SOLVE_PHASES),
            ("K5a", "lqr_factor", (Q, R, S, A, Bm), (), FACTOR_PHASES),
            ("K5b", "lqr_backsolve", (*fac5, A, Bm, c5, qx5, qu5, dx05), (),
             SOLVE_PHASES))
    for label, kernel, ins, scalars, phases in jobs:
        for B in (1, 256, 4096):
            ins_b = [t[..., :B].contiguous() for t in ins]
            N = ins_b[0].shape[0]
            outs = (lqr_kernel._solution_like(ins_b[8])
                    if "backsolve" in kernel else lqr_kernel.LQRFactor(
                        *(ins_b[0].new_empty(s)
                          for s in lqr_kernel._factor_shapes(N, B))))

            def run():
                lqr_kernel.launch(lib, kernel, ins_b, outs,
                                  torch.cuda.current_stream().cuda_stream,
                                  scalars)

            ms = chip_smoke.cuda_ms(run, 20)
            cycles(lib)
            run()
            torch.cuda.synchronize()
            cyc = cycles(lib)
            total = sum(cyc[k] for k in phases)
            split = ", ".join(f"{what} {cyc[k]}"
                              for k, what in phases.items())
            print(f"{label} B={B} f32 [{card}]: {ms:.4f} ms; block 0 lane 0 "
                  f"cycles: total {total}: {split}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
