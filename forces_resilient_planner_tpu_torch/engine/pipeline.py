"""The 20 Hz NMPC master step: references -> tubes -> corridors -> solve.

Port of forces_resilient_planner_tpu/engine/pipeline.py (NMPCSolver::
solveNMPC + setFORCESParams + getSikangConst, nmpc_solver.cpp:288-551).
The step is batched over a leading robot axis in engine/pipeline_batch.py;
`nmpc_step` here serves one robot as B = 1 of it (the per-lane JAX solver
is not ported).

Corridor strategy (getSikangConst, nmpc_solver.cpp:288-332): every stage's
fresh decomposition depends only on (ref_i, yaw_i, obstacles), so all N are
computed at once (ops/corridor_kernel.py), then the sequential reuse rule
is replayed as a loop over the N stages that selects, per robot, which
stage's polytope each stage keeps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.config import PlannerConfig
from forces_resilient_planner_tpu_torch.engine.reference import ReferenceResult
from forces_resilient_planner_tpu_torch.utils.lanes import norm3


class NMPCStepResult(NamedTuple):
    mpc_output: torch.Tensor   # (B, N+1, 17) updated deques (row N = row N-1)
    exit_code: torch.Tensor    # (B,) 1 optimal / 0 maxit / -6 NaN / -7 no-progress
    iters: torch.Tensor
    kkt_error: torch.Tensor
    ref: ReferenceResult
    corridor_A: torch.Tensor   # (B, N, nh, 3) selected (untightened) corridors
    corridor_b: torch.Tensor   # (B, N, nh)
    corridor_b_tight: torch.Tensor
    tube_E: torch.Tensor       # (B, N, 3, 3)
    # decision flags for the FSM (solveNMPC return-code logic, lines 435-481)
    reach_local_end: torch.Tensor
    switch_to_final: torch.Tensor
    diverged: torch.Tensor
    goal_reached: torch.Tensor
    ref_jump_replan: torch.Tensor


def corridor_seed2(ref: ReferenceResult, cfg: PlannerConfig) -> torch.Tensor:
    """Second seed point 10 cm along the reference yaw
    (nmpc_solver.cpp:317-319).  Works on (..., N, 3) / (..., N) refs."""
    L = cfg.corridor.seed_len
    return torch.stack([
        ref.ref_pos[..., 0] + L * torch.cos(ref.ref_yaw),
        ref.ref_pos[..., 1] + L * torch.sin(ref.ref_yaw),
        ref.ref_pos[..., 2],
    ], dim=-1)


def reuse_select(A_all, b_all, tube_E, ref_pos, cfg: PlannerConfig):
    """Sequential corridor reuse rule (getSikangConst, nmpc_solver.cpp:
    293-311): keep the previous stage's polytope while the inflated
    ellipsoid-tightened containment test of the reference point passes.
    A_all (B, N, nh, 3), b_all (B, N, nh), tube_E (B, N, 3, 3),
    ref_pos (B, N, 3) -> (A_sel, b_sel, sel (B, N))."""
    infl = cfg.tube.reuse_inflation
    B, N = ref_pos.shape[0], ref_pos.shape[1]
    rows = torch.arange(B, device=ref_pos.device)
    prev = torch.zeros(B, dtype=torch.int64, device=ref_pos.device)
    sel = []
    for i in range(N):
        A_prev = A_all[rows, prev]                               # (B, nh, 3)
        b_prev = b_all[rows, prev]
        Ea = A_prev @ tube_E[:, i].transpose(-1, -2)             # (B, nh, 3)
        r = ref_pos[:, i]
        margin = (A_prev[..., 0] * r[:, None, 0] + A_prev[..., 1] * r[:, None, 1]
                  + A_prev[..., 2] * r[:, None, 2]) - (b_prev - infl * norm3(Ea))
        row_valid = norm3(A_prev) > 1e-12
        contained = torch.where(row_valid, margin <= 0, True).all(dim=-1)
        # stage 0 always decomposes fresh (the poly list starts empty, line 290)
        if i > 0:
            prev = torch.where(contained, prev, i)
        sel.append(prev)
    sel = torch.stack(sel, dim=1)                                # (B, N)
    return A_all[rows[:, None], sel], b_all[rows[:, None], sel], sel


def build_corridors(ref: ReferenceResult, tube_E, obstacles, obstacle_mask,
                    cfg: PlannerConfig):
    """All-stage decomposition (the corridor kernel on a CUDA tensor) and
    the sequential reuse selection, batched over robots:
    obstacles (B, M, 3), obstacle_mask (B, M)."""
    from forces_resilient_planner_tpu_torch.ops import corridor_kernel

    A_all, b_all = corridor_kernel.decompose_stages_lanes(
        ref.ref_pos.contiguous(), corridor_seed2(ref, cfg).contiguous(),
        obstacles.contiguous(), obstacle_mask.contiguous(), cfg.corridor,
        cfg.model.nh,
    )
    return reuse_select(A_all, b_all, tube_E, ref.ref_pos, cfg)


def nmpc_step(
    mpc_output: torch.Tensor,     # (N+1, 17) previous deque
    kino_path: torch.Tensor,      # (K, 3)
    kino_size: torch.Tensor,      # () int
    t_offset: torch.Tensor,       # () mpc_start - kino_start [s]
    state_mpc: torch.Tensor,      # (9,) current odom state
    f_ext: torch.Tensor,          # (3,)
    end_pt: torch.Tensor,         # (3,) global goal
    obstacles: torch.Tensor,      # (M, 3)
    obstacle_mask: torch.Tensor,  # (M,)
    use_final: torch.Tensor,      # () bool: final (braking) profile
    cfg: PlannerConfig,
    accept_on_maxit: bool | torch.Tensor = False,
) -> NMPCStepResult:
    """One robot's step: B = 1 of engine/pipeline_batch.py::nmpc_step_batched,
    with the batch axis removed from every field of the result."""
    from forces_resilient_planner_tpu_torch.engine.pipeline_batch import (
        nmpc_step_batched,
    )

    args = (mpc_output, kino_path, kino_size, t_offset, state_mpc, f_ext,
            end_pt, obstacles, obstacle_mask, use_final)
    r = nmpc_step_batched(*(torch.as_tensor(a)[None] for a in args), cfg=cfg,
                          accept_on_maxit=accept_on_maxit)
    return NMPCStepResult(*(
        ReferenceResult(*(t[0] for t in f)) if isinstance(f, ReferenceResult)
        else f[0] for f in r
    ))
