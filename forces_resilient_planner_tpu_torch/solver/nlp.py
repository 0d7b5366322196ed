"""NLP definition for the resilient-planner NMPC (torch).

Port of forces_resilient_planner_tpu/solver/nlp.py:33-123.  Stage variable
layout (the FORCES parity contract, setup.m:42-66):
    z = [u(4), u_prev(4), x(9)],  x = [p(3), v(3), rpy(3)]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, WeightConfig

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
