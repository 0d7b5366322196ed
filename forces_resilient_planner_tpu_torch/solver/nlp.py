"""NLP definition for the resilient-planner NMPC (torch).

Port of forces_resilient_planner_tpu/solver/nlp.py.  Stage variable
layout (the FORCES parity contract, setup.m:42-66):
    z = [u(4), u_prev(4), x(9)],  x = [p(3), v(3), rpy(3)]

The per-lane functions below (stage_hessians ... ineq_weighted_hessian)
take one problem's (N, 17) Z; the FORCES surface (solver/forces_api.py)
and the oracle (oracle/cpu_oracle.py) use them.  The solver itself runs
the lane-major forms in solver/ipm_lanes.py, whose fixed sum order
(utils/lanes.py) keeps the tiers bit-exact, so neither calls the other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, WeightConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import (
    rk2_jacobians_analytic,
    rk2_step,
)

# ---- index layout --------------------------------------------------------
IU = slice(0, 4)       # u
IUP = slice(4, 8)      # u_prev
IX = slice(8, 17)      # x
IPOS = slice(8, 11)
IVEL = slice(11, 14)
IRPY = slice(14, 17)
IYAW = 16

NXB = 13               # Riccati augmented state [x(9), u_prev(4)]
NU = 4
NZ = 17


class StageWeights(NamedTuple):
    """Per-stage weight table (N, ...); unifies the normal/final profiles."""

    w_wp: torch.Tensor       # (N,)
    w_input: torch.Tensor    # (N,)
    w_rate: torch.Tensor     # (N,)
    w_vel: torch.Tensor      # (N,)  nonzero only on the final-profile terminal stage
    w_uprev0: torch.Tensor   # (N,)  nonzero only on stage 0


class NLPParams(NamedTuple):
    """Everything that parameterizes one NMPC solve."""

    xinit: torch.Tensor       # (9,)
    ref_pos: torch.Tensor     # (N, 3)
    ref_yaw: torch.Tensor     # (N,)
    f_ext: torch.Tensor       # (3,)
    corridor_A: torch.Tensor  # (N, nh, 3)
    corridor_b: torch.Tensor  # (N, nh)  already tube-tightened
    weights: StageWeights


def make_stage_weights(
    cfg: WeightConfig, N: int, final: bool = False,
    dtype=torch.float64, *, device,
) -> StageWeights:
    """Per-stage weight table for one profile (forces_normal.cpp:36-52)."""
    if final:
        w_wp = np.full(N, cfg.w_final_stage_wp)
        w_in = np.full(N, cfg.w_final_stage_input)
        w_wp[-1] = cfg.w_final_terminal_wp
        w_in[-1] = cfg.w_final_terminal_input
        w_vel = np.zeros(N)
        w_vel[-1] = cfg.final_brake_factor * cfg.w_final_terminal_wp
    else:
        w_wp = np.full(N, cfg.w_stage_wp)
        w_in = np.full(N, cfg.w_stage_input)
        w_wp[-1] = cfg.w_terminal_wp
        w_in[-1] = cfg.w_terminal_input
        w_vel = np.zeros(N)
    w_rate = np.full(N, cfg.w_input_rate)
    w_uprev0 = np.zeros(N)
    w_uprev0[0] = cfg.stage1_uprev_factor * w_in[0]
    return StageWeights(*(
        torch.as_tensor(a, dtype=dtype, device=device)
        for a in (w_wp, w_in, w_rate, w_vel, w_uprev0)
    ))


def variable_bounds(cfg: ModelConfig, dtype=torch.float64, *, device):
    """(lb, ub) of shape (17,), mpc_generator_normal.m:28-46."""
    rmax = cfg.max_rate
    tmin, tmax = cfg.min_thrust, cfg.max_thrust
    mx, my, mz = cfg.map_halfsize
    lb = [-rmax, -rmax, -rmax, tmin, -rmax, -rmax, -rmax, tmin,
          -mx, -my, 0.0,
          -cfg.max_vel, -cfg.max_vel, -cfg.max_vel,
          -cfg.max_tilt, -cfg.max_tilt, -cfg.max_yaw]
    ub = [rmax, rmax, rmax, tmax, rmax, rmax, rmax, tmax,
          mx, my, mz,
          cfg.max_vel, cfg.max_vel, cfg.max_vel,
          cfg.max_tilt, cfg.max_tilt, cfg.max_yaw]
    return (
        torch.tensor(lb, dtype=dtype, device=device),
        torch.tensor(ub, dtype=dtype, device=device),
    )


def nlp_params_from_numpy(params, Z0, *, dtype, device):
    """Carry an NLP across from the JAX package (or any numpy source).

    `params` has the NLPParams field names (its `weights` the StageWeights
    names) with array-like values, e.g. the JAX package's NLPParams; Z0 is
    the matching warm start.  Every field goes through numpy, so both
    packages then solve the identical problem.  Returns (NLPParams, Z0).
    """
    def conv(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    weights = StageWeights(
        *(conv(getattr(params.weights, f)) for f in StageWeights._fields)
    )
    fields = {
        f: conv(getattr(params, f)) for f in NLPParams._fields if f != "weights"
    }
    return NLPParams(weights=weights, **fields), conv(Z0)


# ---- the per-lane NLP block (JAX nlp.py:125-231), one problem's (N, 17) Z --

def stage_hessians(w: StageWeights, cfg: ModelConfig,
                   dtype=torch.float64) -> torch.Tensor:
    """Constant per-stage cost Hessians H (N, 17, 17) (exact: the cost is
    quadratic).  Terms added in the JAX function's order."""
    N = w.w_wp.shape[0]
    rmax2 = cfg.max_rate ** 2
    H = torch.zeros((N, NZ, NZ), dtype=dtype, device=w.w_wp.device)
    for k in (8, 9, 10):                      # position tracking
        H[:, k, k] += 2 * w.w_wp
    H[:, IYAW, IYAW] += 24 * w.w_wp           # yaw tracking
    for k in range(11, 14):                   # final-profile braking
        H[:, k, k] += 2 * w.w_vel
    for k in range(3):                        # normalized rate cost
        H[:, k, k] += 2 * w.w_input / rmax2
    for k in range(4):                        # ||u - uprev||^2
        H[:, k, k] += 2 * w.w_rate
        H[:, 4 + k, 4 + k] += 2 * w.w_rate
        H[:, k, 4 + k] += -2 * w.w_rate
        H[:, 4 + k, k] += -2 * w.w_rate
    for k in range(4, 7):                     # stage-0 uprev slack
        H[:, k, k] += 2 * w.w_uprev0
    return H


def _g_lin(Z: torch.Tensor, p: NLPParams) -> torch.Tensor:
    g_lin = torch.zeros_like(Z)
    g_lin[:, IPOS] = -2.0 * p.weights.w_wp[:, None] * p.ref_pos
    g_lin[:, IYAW] = -24.0 * p.weights.w_wp * p.ref_yaw
    return g_lin


def cost_gradient(Z: torch.Tensor, p: NLPParams, H: torch.Tensor):
    """grad f = H z + g_lin per stage.  Z: (N, 17) -> (N, 17)."""
    return (H @ Z[..., None])[..., 0] + _g_lin(Z, p)


def cost_value(Z: torch.Tensor, p: NLPParams, H: torch.Tensor):
    """f(Z), a 0-d tensor."""
    quad = 0.5 * torch.einsum("ni,nij,nj->", Z, H, Z)
    w_wp = p.weights.w_wp
    const = torch.sum(w_wp * torch.sum(p.ref_pos ** 2, -1)) + torch.sum(
        12.0 * w_wp * p.ref_yaw ** 2)
    return quad + torch.einsum("ni,ni->", _g_lin(Z, p), Z) + const


def dynamics_residuals(Z: torch.Tensor, p: NLPParams, cfg: ModelConfig):
    """c_i = F(z_i) - E z_{i+1}, F(z) = [RK2(x, u); u], for i = 0..N-2.
    (N-1, 13)."""
    xn = rk2_step(Z[:-1, IX], Z[:-1, IU], p.f_ext, cfg)
    F = torch.cat([xn, Z[:-1, IU]], dim=-1)
    Enext = torch.cat([Z[1:, IX], Z[1:, IUP]], dim=-1)
    return F - Enext


def dynamics_jacobians(Z: torch.Tensor, p: NLPParams, cfg: ModelConfig):
    """Per-stage RK2 Jacobians (Ax (N-1, 9, 9), Bx (N-1, 9, 4)), closed form."""
    return rk2_jacobians_analytic(Z[:-1, IX], Z[:-1, IU], p.f_ext, cfg)


def inequality_residuals(Z: torch.Tensor, p: NLPParams, lb, ub, hu: float):
    """All stage-separable rows g(z) <= 0, (N, 64): [lb - z (17), z - ub
    (17), A p - b - hu (30)]."""
    g_cor = (p.corridor_A @ Z[:, IPOS, None])[..., 0] - p.corridor_b - hu
    return torch.cat([lb[None, :] - Z, Z - ub[None, :], g_cor], dim=-1)


def ineq_jac_T_times(p: NLPParams, v: torch.Tensor) -> torch.Tensor:
    """J_g^T v per stage without forming J_g.  v: (N, 64) -> (N, 17)."""
    out = -v[:, 0:17] + v[:, 17:34]
    out[:, IPOS] += (p.corridor_A.transpose(-1, -2) @ v[:, 34:64, None])[..., 0]
    return out


def ineq_jac_times(p: NLPParams, dz: torch.Tensor) -> torch.Tensor:
    """J_g dz per stage.  dz: (N, 17) -> (N, 64)."""
    cor = (p.corridor_A @ dz[:, IPOS, None])[..., 0]
    return torch.cat([-dz, dz, cor], dim=-1)


def ineq_weighted_hessian(p: NLPParams, sigma: torch.Tensor) -> torch.Tensor:
    """J_g^T diag(sigma) J_g per stage.  sigma: (N, 64) -> (N, 17, 17)."""
    W = torch.diag_embed(sigma[:, 0:17] + sigma[:, 17:34])
    A = p.corridor_A                                    # (N, nh, 3)
    W[:, IPOS, IPOS] += A.transpose(-1, -2) @ (A * sigma[:, 34:64, None])
    return W
