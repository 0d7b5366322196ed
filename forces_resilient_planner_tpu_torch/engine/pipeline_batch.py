"""Batched full-pipeline NMPC step: the fleet-scale nmpc_step (torch).

Port of forces_resilient_planner_tpu/engine/pipeline_batch.py.  The step
is split at the solver boundary:

  references                    -> engine/reference.py, batched over robots
  tubes (per-stage math)        -> ops/tube_kernel.py (CUDA kernel K2)
  tubes (recursion and roots)   -> ops/tube_kernel.py (the tube chain kernel)
  corridors (all-stage decomp.) -> ops/corridor_kernel.py (CUDA kernel K3),
                                   then the sequential reuse selection
  tightening                    -> tube/lyapunov.py::tighten_corridor
  interior-point solve          -> solver/ipm_lanes.py (CUDA kernel K1)
  acceptance + FSM flags        -> vectorized over the batch

On CPU tensors every kernel's plain PyTorch version runs instead.  Same
reference anchors as engine/pipeline.py (solveNMPC / setFORCESParams,
nmpc_solver.cpp:288-551).
"""
from __future__ import annotations

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import PlannerConfig
from forces_resilient_planner_tpu_torch.engine.pipeline import (
    NMPCStepResult,
    build_corridors,
)
from forces_resilient_planner_tpu_torch.engine.reference import (
    sample_references,
    wrap_yaw_outputs,
)
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu_torch.tube.lyapunov import (
    propagate_tubes_batch,
    tighten_corridor,
)
from forces_resilient_planner_tpu_torch.utils import trace
from forces_resilient_planner_tpu_torch.utils.lanes import norm3

# the argument order of nmpc_step_batched (bench.PIPELINE_ARG_KEYS)
PIPELINE_ARG_KEYS = (
    "mpc_output", "kino_path", "kino_size", "t_offset", "state_mpc",
    "f_ext", "end_pt", "obstacles", "obstacle_mask", "use_final",
)


def pipeline_inputs_from_numpy(args, *, dtype, device) -> dict:
    """Carry a batched step's inputs across from numpy (e.g. the JAX
    package's bench inputs): floats to `dtype`, kino_size to int64, masks
    to bool, every field through numpy so both packages step the identical
    problem.  `args` maps PIPELINE_ARG_KEYS to array-likes."""
    out = {}
    for k in PIPELINE_ARG_KEYS:
        v = np.array(args[k])
        if k in ("obstacle_mask", "use_final"):
            t = torch.as_tensor(v.astype(bool), device=device)
        elif k == "kino_size":
            t = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            t = torch.as_tensor(v, dtype=dtype, device=device)
        out[k] = t
    return out


def pack_nlp_params(ref, corridor_A, corridor_b_tight, f_ext, mpc_output,
                    use_final, cfg: PlannerConfig) -> nlp.NLPParams:
    """The batched step's NLP: xinit = stage-1 prediction
    (forces_normal.cpp:62-72), the references, the tightened corridors, and
    per robot the normal or the final-profile stage weights.  Tensors in
    the dtype and on the device of `mpc_output`."""
    N, B = cfg.model.N, mpc_output.shape[0]
    dtype, device = mpc_output.dtype, mpc_output.device
    w_n = nlp.make_stage_weights(cfg.weights, N, final=False, dtype=dtype,
                                 device=device)
    w_f = nlp.make_stage_weights(cfg.weights, N, final=True, dtype=dtype,
                                 device=device)
    fin = use_final.reshape(B, 1)
    weights = nlp.StageWeights(*(
        torch.where(fin, b[None], a[None]) for a, b in zip(w_n, w_f)
    ))
    return nlp.NLPParams(
        xinit=mpc_output[:, 1, 8:17], ref_pos=ref.ref_pos,
        ref_yaw=ref.ref_yaw, f_ext=f_ext, corridor_A=corridor_A,
        corridor_b=corridor_b_tight, weights=weights,
    )


def nmpc_step_batched(
    mpc_output: torch.Tensor,     # (B, N+1, 17) previous deques
    kino_path: torch.Tensor,      # (B, K, 3)
    kino_size: torch.Tensor,      # (B,) int
    t_offset: torch.Tensor,       # (B,)
    state_mpc: torch.Tensor,      # (B, 9)
    f_ext: torch.Tensor,          # (B, 3)
    end_pt: torch.Tensor,         # (B, 3)
    obstacles: torch.Tensor,      # (B, M, 3)
    obstacle_mask: torch.Tensor,  # (B, M) bool
    use_final: torch.Tensor,      # (B,) bool
    cfg: PlannerConfig,
    accept_on_maxit: bool | torch.Tensor = False,
) -> NMPCStepResult:
    with trace.span("step"):
        mcfg = cfg.model
        N = mcfg.N
        B = mpc_output.shape[0]
        device = mpc_output.device

        # 1. references (getCurTraj loop, nmpc_solver.cpp:490-495)
        with trace.span("step.references"):
            ref = sample_references(
                kino_path, kino_size, t_offset, last_yaw=mpc_output[:, 1, 16],
                pred_pos1=mpc_output[:, 1, 8:11], N=N, Ts=mcfg.dt,
            )

        # 2. disturbance tubes (getDistrEllipsoid, nmpc_solver.cpp:567-611)
        with trace.span("step.tubes"):
            tube = propagate_tubes_batch(mpc_output[:, :N], mcfg, cfg.tube)

        # 3. corridors + tube tightening (forces_normal.cpp:111-136)
        with trace.span("step.corridors"):
            A_sel, b_sel, _ = build_corridors(ref, tube.E, obstacles,
                                              obstacle_mask, cfg)
            b_tight = tighten_corridor(A_sel, b_sel, tube.E)

        # 4. pack + lane-major tiered solve; warm start = previous rows 1..N.
        params = pack_nlp_params(ref, A_sel, b_tight, f_ext, mpc_output,
                                 use_final, cfg)
        Z0 = mpc_output[:, 1:N + 1]
        res = ipm_lanes.solve_batch_lanes_tiered(Z0, params, mcfg, cfg.solver)

        # 5. acceptance (solveNMPC lines 397-429; counters in the host FSM)
        ok = (res.exit_code == 1) | (
            torch.as_tensor(accept_on_maxit, device=device)
            & torch.isfinite(res.kkt_error)
        )
        Z_new = torch.where(ok.reshape(B, 1, 1), wrap_yaw_outputs(res.Z),
                            mpc_output[:, :N])
        out = torch.cat([Z_new, Z_new[:, -1:]], dim=1)

        # 6. status flags (solveNMPC lines 435-481), batch-vectorized
        fsm = cfg.fsm
        ref_end = out[:, N - 1, 8:11]
        max_index = torch.floor((N * mcfg.dt + t_offset) / mcfg.dt)
        K = kino_path.shape[1]
        kino_last = kino_path[
            torch.arange(B, device=device),
            torch.clamp(kino_size.to(torch.int64) - 1, 0, K - 1)]
        reach_local_end = (max_index > 0.5 * kino_size) & (
            norm3(end_pt - kino_last) > fsm.local_end_dist
        )
        switch_final = (max_index >= kino_size) | (
            norm3(ref_end - end_pt) < fsm.final_switch_dist
        )
        diverged = (norm3(out[:, 1, 8:11] - state_mpc[:, 0:3])
                    > fsm.divergence_dist)
        goal_reached = norm3(ref_end - end_pt) < fsm.goal_radius
        jump_replan = ref.stage0_jump > fsm.ref_jump_replan

        return NMPCStepResult(
            mpc_output=out, exit_code=res.exit_code, iters=res.iters,
            kkt_error=res.kkt_error, ref=ref, corridor_A=A_sel,
            corridor_b=b_sel, corridor_b_tight=b_tight, tube_E=tube.E,
            reach_local_end=reach_local_end, switch_to_final=switch_final,
            diverged=diverged, goal_reached=goal_reached,
            ref_jump_replan=jump_replan,
        )


def nmpc_step_stream(step_fn, input_sets):
    """Dispatch a batched step over independent input sets, one after
    another (step_fn: a callable over one input dict, e.g.
    lambda a: nmpc_step_batched(**a, cfg=cfg); input_sets: dicts already
    on the device).  The solver's host loop syncs once per IPM iteration,
    so sets do not overlap yet: this keeps the JAX package's entry point
    and is a placeholder for overlapped dispatch.  Returns the list of
    results."""
    return [step_fn(a) for a in input_sets]
