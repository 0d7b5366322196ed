"""Reference sampling along the kino path + yaw computation (torch).

Port of forces_resilient_planner_tpu/engine/reference.py (NMPCSolver::
getCurTraj / calculate_yaw, nmpc_solver.cpp:109-142, 834-862), batched over
a leading robot axis B.  The yaw low-pass filter is sequential by
construction: in the plain version a loop over the N stages on (B,)
tensors.  On a CUDA tensor `sample_references` is one launch of the kernel
ops/csrc/reference.cu (ops/reference_kernel.py), which computes the plain
version's numbers bit for bit, one thread a robot.

The sample index follows the JAX function as its callers run it, under
jit on XLA:CPU: floor(fma(i, Ts, t_offset) * (1 / Ts)), one rounding of
i Ts + t_offset and the division by the constant Ts as a product with its
reciprocal; the interpolation fraction rounds i Ts + t_offset twice (XLA
computes it in another fusion, uncontracted).  The two differ only when
t_offset lies on the Ts grid, which is every tick of the fleet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.ops import reference_kernel
from forces_resilient_planner_tpu_torch.utils.lanes import norm3

_PI = 3.1415926  # the reference's PI constant, exactly (nmpc_solver.cpp:3)


def _fma_small(i: torch.Tensor, c: float, t: torch.Tensor) -> torch.Tensor:
    """i * c + t as a near-FMA (double-double), for small integer-valued i
    (i < 2^12 at f32, i < 2^26 at f64; the step's stage index is below N):
    c split into halves of at most 12 (f32) or 26 (f64) bits makes i * hi
    and i * lo exact, the error of i * hi + t is carried by a TwoSum, and
    s + (err + i * lo) then rounds twice, so the result is not a correctly
    rounded FMA in every case.  It mirrors the contraction that XLA:CPU
    applies to the jitted reference (ROADMAP Queue 3)."""
    bits = 12 if t.dtype == torch.float32 else 27
    ct = torch.tensor(c, dtype=t.dtype, device=t.device)
    big = ct * (2.0 ** bits + 1.0)
    hi = big - (big - ct)
    lo = ct - hi
    a, b = i * hi, i * lo
    s = a + t
    bb = s - a
    err = (a - (s - bb)) + (t - bb)
    return s + (err + b)


class ReferenceResult(NamedTuple):
    ref_pos: torch.Tensor      # (B, N, 3)
    ref_yaw: torch.Tensor      # (B, N)
    stage0_jump: torch.Tensor  # (B,) ||ref_0 - predicted stage-1 pos||


def sample_references(
    kino_path: torch.Tensor,   # (B, K, 3) padded
    kino_size: torch.Tensor,   # (B,) int, actual sample count
    t_offset: torch.Tensor,    # (B,) seconds since kino path start
    last_yaw: torch.Tensor,    # (B,) mpc_output[:, 1, 16] (nmpc_solver.cpp:486)
    pred_pos1: torch.Tensor,   # (B, 3) mpc_output[:, 1] position
    N: int,
    Ts: float,
    lookahead: int = 5,
) -> ReferenceResult:
    """The references of B robots: on a CPU tensor the plain version, on
    any other one launch of the kernel (the views of mpc_output made
    contiguous first)."""
    if kino_path.device.type == "cpu":
        return sample_references_plain(kino_path, kino_size, t_offset,
                                       last_yaw, pred_pos1, N, Ts, lookahead)
    return ReferenceResult(*reference_kernel.sample_references_lanes(
        kino_path.contiguous(), kino_size.to(torch.int64),
        t_offset.contiguous(), last_yaw.contiguous(), pred_pos1.contiguous(),
        N, Ts, lookahead))


def sample_references_plain(
    kino_path: torch.Tensor,   # (B, K, 3) padded
    kino_size: torch.Tensor,   # (B,) int, actual sample count
    t_offset: torch.Tensor,    # (B,) seconds since kino path start
    last_yaw: torch.Tensor,    # (B,) mpc_output[:, 1, 16] (nmpc_solver.cpp:486)
    pred_pos1: torch.Tensor,   # (B, 3) mpc_output[:, 1] position
    N: int,
    Ts: float,
    lookahead: int = 5,
) -> ReferenceResult:
    """Plain PyTorch version, on any device: the kernel's reference (its
    order of operations is the kernel's)."""
    dtype, device = kino_path.dtype, kino_path.device
    B, K = kino_path.shape[0], kino_path.shape[1]
    size = kino_size.to(torch.int64)[:, None]                    # (B, 1)
    i = torch.arange(N, dtype=dtype, device=device)
    index_time = i[None] * Ts + t_offset[:, None]                # (B, N)
    fused = _fma_small(i[None], Ts, t_offset[:, None])
    kino_idx = torch.floor(fused * (1.0 / Ts)).to(torch.int64)
    frac = torch.remainder(index_time, Ts) * (1.0 / Ts)
    last = torch.clamp(size - 1, min=0)                          # (B, 1)

    rows = torch.arange(B, device=device)[:, None]

    def gather(idx):
        return kino_path[rows, torch.clamp(idx, 0, K - 1)]       # (B, n, 3)

    p0 = gather(kino_idx)
    p1 = gather(kino_idx + 1)
    interp = p0 + frac[..., None] * (p1 - p0)
    ref_pos = torch.where(
        (kino_idx + 1 < size)[..., None], interp, gather(last)
    )
    fwd_idx = torch.where(kino_idx + lookahead < size, kino_idx + lookahead,
                          last)
    fwd_pos = gather(fwd_idx)

    # sequential yaw LPF (calculate_yaw, nmpc_solver.cpp:834-862)
    y = last_yaw
    yaws = []
    for n in range(N):
        d = fwd_pos[:, n] - ref_pos[:, n]
        yaw_t = torch.where(norm3(d) > 0.1, torch.atan2(d[:, 1], d[:, 0]), y)
        big = torch.abs(yaw_t - y) > _PI
        yaw_w = torch.where(
            big, torch.where(yaw_t > 0, yaw_t - 2 * _PI, yaw_t + 2 * _PI),
            yaw_t,
        )
        y = 0.2 * y + 0.8 * yaw_w
        yaws.append(y)
    ref_yaw = torch.stack(yaws, dim=1)
    jump = norm3(ref_pos[:, 0] - pred_pos1)
    return ReferenceResult(ref_pos=ref_pos, ref_yaw=ref_yaw, stage0_jump=jump)


def wrap_yaw_outputs(Z: torch.Tensor) -> torch.Tensor:
    """Yaw unwrap of solver outputs (..., 17) to (-pi, pi]
    (updateFORCESResults, nmpc_solver.cpp:531-541)."""
    yaw = Z[..., 16]
    yaw = torch.where(yaw < -_PI, yaw + 2 * _PI, yaw)
    yaw = torch.where(yaw > _PI, yaw - 2 * _PI, yaw)
    return torch.cat([Z[..., :16], yaw[..., None]], dim=-1)
