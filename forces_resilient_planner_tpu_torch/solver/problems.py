"""Problem-construction helpers: warm starts and simple corridor setups.

Port of forces_resilient_planner_tpu/solver/problems.py (hover warm start,
box corridor, hover-to-goal problem).  The LQR-rollout warm start is not
ported yet (ROADMAP.md, Queue 1, item "lqr_warm_start_batch").
"""
from __future__ import annotations

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, WeightConfig
from forces_resilient_planner_tpu_torch.solver.nlp import (
    NLPParams,
    make_stage_weights,
)

LQR_WARM_START_TODO = (
    "warm_start='lqr' is not ported yet (ROADMAP.md, Queue 1, item "
    "'lqr_warm_start_batch'); use the default warm_start='hover'"
)


def hover_warm_start(
    state: torch.Tensor, cfg: ModelConfig, thrust_seed: float | None = None,
    dtype=None,
) -> torch.Tensor:
    """Hover-seeded Z0 (N, 17): zero rates, hover thrust, state replicated.

    Mirrors initMPCOutput's seed (nmpc_solver.cpp:265-286).
    """
    dtype = dtype or state.dtype
    t = cfg.hover_thrust if thrust_seed is None else thrust_seed
    row = torch.cat([
        torch.tensor([0.0, 0.0, 0.0, t, 0.0, 0.0, 0.0, t],
                     dtype=dtype, device=state.device),
        state.to(dtype),
    ])
    return row[None, :].repeat(cfg.N, 1)


def box_corridor(
    center: np.ndarray, half: np.ndarray, N: int, nh: int = 30,
    dtype=torch.float64, *, device,
):
    """Axis-aligned box corridor, identical at every stage.  Returns (A, b)."""
    A = np.zeros((nh, 3))
    b = np.zeros((nh,))
    eye = np.eye(3)
    for k in range(3):
        A[2 * k] = eye[k]
        b[2 * k] = center[k] + half[k]
        A[2 * k + 1] = -eye[k]
        b[2 * k + 1] = -(center[k] - half[k])
    return (
        torch.as_tensor(np.tile(A[None], (N, 1, 1)), dtype=dtype, device=device),
        torch.as_tensor(np.tile(b[None], (N, 1)), dtype=dtype, device=device),
    )


def hover_to_goal_params(
    x0: np.ndarray,
    goal: np.ndarray,
    mcfg: ModelConfig,
    wcfg: WeightConfig,
    f_ext=(0.0, 0.0, 0.0),
    corridor_center=None,
    corridor_half=(5.0, 5.0, 2.0),
    final: bool = False,
    dtype=torch.float64,
    *,
    device,
) -> NLPParams:
    """BASELINE config-1 style problem: constant goal reference, box corridor."""
    N = mcfg.N
    ref_pos = torch.as_tensor(goal, dtype=dtype, device=device)[None].repeat(N, 1)
    dirv = np.asarray(goal[:2]) - np.asarray(x0[:2])
    yaw = float(np.arctan2(dirv[1], dirv[0])) if np.linalg.norm(dirv) > 1e-6 else 0.0
    center = (
        np.asarray(corridor_center)
        if corridor_center is not None
        else 0.5 * (np.asarray(x0[:3]) + np.asarray(goal))
    )
    A, b = box_corridor(
        center, np.asarray(corridor_half), N, dtype=dtype, device=device
    )
    return NLPParams(
        xinit=torch.as_tensor(x0, dtype=dtype, device=device),
        ref_pos=ref_pos,
        ref_yaw=torch.full((N,), yaw, dtype=dtype, device=device),
        f_ext=torch.as_tensor(f_ext, dtype=dtype, device=device),
        corridor_A=A,
        corridor_b=b,
        weights=make_stage_weights(
            wcfg, N, final=final, dtype=dtype, device=device
        ),
    )
