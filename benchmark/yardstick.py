"""The published peaks of the card and the operation counts of the IPM
iteration, by which a kernel's share of its roofline is read.

Frozen copy, taken at commit ad340bc, of
forces_resilient_planner_tpu_torch/utils/measure.py (HBM_BYTES_PER_S,
PEAK_FLOPS, bound, riccati_factor_flops, riccati_solve_flops, k1_flops,
card_line).  A multiply-add counts 2 operations.
"""
from __future__ import annotations

import subprocess

# NVIDIA H100 SXM published peaks (data sheet, dense, at 700 W): HBM3
# bytes/s and FLOP/s outside the tensor cores (the kernels use none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
NXB, NU = 13, 4
NTRI = NXB * (NXB + 1) // 2


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def least_seconds(nbytes: float, flops: float, dtype: str = "float32"):
    """(seconds, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def riccati_factor_flops(N: int, nh: int = 0) -> int:
    """Per lane: each gap stage's Abar^T P, Bbar^T P, their products with
    Abar and Bbar, Sh^T K over P's upper triangle, and with nh corridor
    rows the 3x3 corridor block of the stage QP."""
    macs = (2 * NXB ** 3 + 2 * NU * NXB * NXB + NU * NU * NXB
            + 2 * NU * NTRI + 9 * nh)
    return 2 * (N - 1) * macs


def riccati_solve_flops(N: int) -> int:
    """Per lane: P c, Abar^T Pc, Bbar^T Pc, K^T quh (backsolve); K dx,
    Abar dx, Bbar du (rollout); P dx (costates), per gap stage."""
    macs = 3 * NXB * NXB + 2 * NU * NXB + NXB * NU + NU * NXB
    return 2 * (N - 1) * macs


def k1_flops(N: int) -> int:
    """One IPM iteration of one lane: the factor with the corridor block and
    the solve, the Jacobian products Ax, Bx per gap stage; per stage the
    corridor products of the stationarity and the right-hand side,
    J_eq^T lam, and about 12 operations for each of the 64 rows in the
    three row passes (ratios, NaN guard, update)."""
    dyn = 2 * (81 * 9 + 36 * 9)
    stage = 2 * (2 * 3 * 30 + 13 * 9 + NXB * NXB) + 64 * 12 * 3
    return (riccati_factor_flops(N, 30) + riccati_solve_flops(N)
            + (N - 1) * dyn + N * stage)


def solve_bytes(N: int, nh: int, itemsize: int) -> int:
    """Bytes one lane's solve must move at least: its inputs read once
    (warm start Z0 (N, 17), xinit 9, ref_pos (N, 3), ref_yaw N, f_ext 3,
    corridor A (N, nh, 3) and b (N, nh), five stage weights (N,)) and its
    outputs written once (Z (N, 17), lam (N, 13), slacks and duals
    (N, 34 + nh) each, exit code, iterations, KKT error)."""
    ins = N * 17 + 9 + 3 * N + N + 3 + 3 * N * nh + N * nh + 5 * N
    outs = N * 17 + 13 * N + 2 * N * (34 + nh) + 3
    return (ins + outs) * itemsize
