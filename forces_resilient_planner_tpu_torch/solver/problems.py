"""Problem-construction helpers: warm starts and simple corridor setups.

Port of forces_resilient_planner_tpu/solver/problems.py (hover and
LQR-rollout warm starts, box corridor, hover-to-goal problem).
"""
from __future__ import annotations

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, WeightConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import rk2_step
from forces_resilient_planner_tpu_torch.solver.nlp import (
    NLPParams,
    make_stage_weights,
)


def hover_warm_start(
    state: torch.Tensor, cfg: ModelConfig, thrust_seed: float | None = None,
    dtype=None,
) -> torch.Tensor:
    """Hover-seeded Z0 (..., N, 17) of states (..., 9): zero rates, hover
    thrust, the state replicated (the fleet seeds a batch, the JAX fleet a
    vmap of this).

    Mirrors initMPCOutput's seed (nmpc_solver.cpp:265-286).
    """
    dtype = dtype or state.dtype
    t = cfg.hover_thrust if thrust_seed is None else thrust_seed
    seed = torch.tensor([0.0, 0.0, 0.0, t, 0.0, 0.0, 0.0, t],
                        dtype=dtype, device=state.device)
    row = torch.cat([seed.expand(state.shape[:-1] + (8,)), state.to(dtype)],
                    dim=-1)
    return row[..., None, :].expand(
        state.shape[:-1] + (cfg.N, row.shape[-1])).contiguous()


def lqr_warm_start_batch(
    x0: torch.Tensor,         # (B, 9)
    ref_pos: torch.Tensor,    # (B, N, 3)
    ref_yaw: torch.Tensor,    # (B, N)
    f_ext: torch.Tensor,      # (B, 3)
    mcfg: ModelConfig,
    K: torch.Tensor,          # (4, 9) fixed feedback gain (nmpc_solver.cpp:28-31)
) -> torch.Tensor:
    """LQR-rollout warm start (B, N, 17) (JAX problems.py:41-96): close the
    loop with the reference's fixed gain, u = u_hover + K (x - x_ref) on
    the tracking error saturated per component, clipped inside the input
    bounds, and roll the NLP's own RK2 dynamics toward the reference, so
    the warm start's equality residuals are ~0.  The reference warm-starts
    FORCES from its previous solution (forces_normal.cpp:74-97); a one-shot
    sweep has none, and this rollout is its analog."""
    dtype, device = x0.dtype, x0.device

    def vec(values):
        return torch.tensor(values, dtype=dtype, device=device)

    rmax = mcfg.max_rate
    margin = 1e-2
    u_lo = vec([-rmax, -rmax, -rmax, mcfg.min_thrust]) + margin
    u_hi = vec([rmax, rmax, rmax, mcfg.max_thrust]) - margin
    u_hover = vec([0.0, 0.0, 0.0, mcfg.hover_thrust])
    Kt = K.to(dtype).T                                       # (9, 4)
    # the error is saturated BEFORE the gain so the inputs stay interior:
    # an input-saturated warm start parks IPM slacks at their bounds
    e_sat = vec([0.7, 0.7, 0.7, 1.5, 1.5, 1.5, 0.3, 0.3, 0.3])

    x, us, xs = x0, [], []
    for k in range(ref_pos.shape[1]):
        xref = torch.zeros_like(x)
        xref[:, 0:3] = ref_pos[:, k]
        xref[:, 8] = ref_yaw[:, k]
        err = torch.clamp(x - xref, -e_sat, e_sat)
        u = torch.clamp(u_hover[None] + err @ Kt, u_lo, u_hi)
        us.append(u)
        xs.append(x)
        x = rk2_step(x, u, f_ext, mcfg)
    u = torch.stack(us, dim=1)                               # (B, N, 4)
    uprev = torch.cat([u[:, 0:1], u[:, :-1]], dim=1)
    return torch.cat([u, uprev, torch.stack(xs, dim=1)], dim=-1)


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
