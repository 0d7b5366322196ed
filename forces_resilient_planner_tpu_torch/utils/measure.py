"""Timing and bounds of work on the card: the card's name and power limit,
CUDA-event times, and the least time an NVIDIA H100 could take for a
kernel's work (the larger of its bytes over the memory rate and its
operations over the peak rate of their type), with the operation counts
of the IPM iteration (K1) and the Riccati kernels (K4, K5) per lane.

chip_smoke.py, k23_probe.py, the package's tools and examples and bench.py
use this one copy.
"""
from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM published peaks: HBM3 bytes/s, and FLOP/s outside the
# tensor cores (the kernels use none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
NXB, NU = 13, 4
NTRI = NXB * (NXB + 1) // 2


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's label when the run is on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """ms per call of fn, by CUDA events over `reps` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int) -> float:
    """ms per call of fn on the card alone: CUDA events over `reps` calls
    queued behind a ~10 ms wait on the card, so the card runs them back to
    back and the host's launch cost between them does not count."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in objs (tuples and named tuples walked)."""
    total = 0
    for o in objs:
        if torch.is_tensor(o):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(nbytes, flops, dtype=torch.float32):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def riccati_factor_flops(N, nh=0):
    """Per lane, multiply-add = 2: each gap stage's Abar^T P, Bbar^T P,
    their products with Abar and Bbar, Sh^T K over P's upper triangle, and
    with nh corridor rows the 3x3 corridor block of the stage QP."""
    macs = (2 * NXB ** 3 + 2 * NU * NXB * NXB + NU * NU * NXB
            + 2 * NU * NTRI + 9 * nh)
    return 2 * (N - 1) * macs


def riccati_solve_flops(N):
    """Per lane: P c, Abar^T Pc, Bbar^T Pc, K^T quh (backsolve); K dx, Abar
    dx, Bbar du (rollout); P dx (costates), per gap stage."""
    macs = 3 * NXB * NXB + 2 * NU * NXB + NXB * NU + NU * NXB
    return 2 * (N - 1) * macs


def k1_flops(N):
    """One K1 iteration per lane: the factor (with the corridor block) and
    the solve, the Jacobian products Ax, Bx per gap stage; per stage the
    corridor products of the stationarity and the RHS, J_eq^T lam, and ~12
    operations for each of the 64 rows in the three row passes (ratios,
    NaN guard, update)."""
    dyn = 2 * (81 * 9 + 36 * 9)
    stage = 2 * (2 * 3 * 30 + 13 * 9 + NXB * NXB) + 64 * 12 * 3
    return (riccati_factor_flops(N, 30) + riccati_solve_flops(N)
            + (N - 1) * dyn + N * stage)
