"""100 Hz command stream: interpolation of the MPC solution deque.

Equivalent of NMPCSolver::cmdTrajCallback (nmpc_solver.cpp:865-987) and
callInitYaw (228-262).  Pure functions of (mpc_output, clock); the host FSM
owns the CMD_STATUS state machine.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np

from forces_resilient_planner_tpu_torch.config import ModelConfig


class CmdStatus(enum.Enum):
    INIT_POSITION = 0
    ROTATE_YAW = 1
    PUB_END = 2
    PUB_TRAJ = 3
    WAIT = 4


@dataclass
class Command:
    pos: np.ndarray
    vel: np.ndarray
    acc: np.ndarray
    body_rates: np.ndarray
    yaw: float
    rpy: np.ndarray
    thrust: float


def _euler_to_rot(rpy):
    cr, sr = math.cos(rpy[0]), math.sin(rpy[0])
    cp, sp = math.cos(rpy[1]), math.sin(rpy[1])
    cy, sy = math.cos(rpy[2]), math.sin(rpy[2])
    return np.array(
        [
            [cy * cp, cy * sp * sr - cr * sy, cy * sp * cr + sy * sr],
            [cp * sy, cy * cr + sy * sp * sr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def interpolate_command(
    mpc_output: np.ndarray,  # (N+1, 17)
    t_since_mpc: float,
    cfg: ModelConfig,
) -> Command | None:
    """PUB_TRAJ branch (nmpc_solver.cpp:900-954): linear interpolation of
    stages cur..cur+1; world acceleration recovered from thrust+attitude.
    Returns None when the horizon is exhausted (finish_mpc_cmd)."""
    N = cfg.N
    cur = int(t_since_mpc / cfg.dt)
    if not (0 <= cur < N - 1) or t_since_mpc < 0.0:
        return None
    frac = (t_since_mpc % cfg.dt) / cfg.dt
    q = mpc_output[cur] + frac * (mpc_output[cur + 1] - mpc_output[cur])
    rpy = q[14:17]
    R = _euler_to_rot(rpy)
    thrust_w = R @ np.array([0.0, 0.0, q[3]])
    acc = thrust_w / cfg.mass - np.array([0.0, 0.0, cfg.g])
    return Command(
        pos=q[8:11].copy(),
        vel=q[11:14].copy(),
        acc=acc,
        body_rates=q[0:3].copy(),
        yaw=float(q[16]),
        rpy=rpy.copy(),
        thrust=float(q[3]),
    )


def rotate_yaw_command(
    odom: np.ndarray, init_yaw: float, init_yaw_dot: float, t_since_start: float
) -> Command:
    """ROTATE_YAW branch (nmpc_solver.cpp:883-893): rate-limited yaw ramp."""
    yaw_temp = odom[8] + t_since_start * init_yaw_dot
    desired = (
        min(yaw_temp, init_yaw) if init_yaw - odom[8] >= 0 else max(yaw_temp, init_yaw)
    )
    return Command(
        pos=odom[0:3].copy(),
        vel=np.zeros(3),
        acc=np.zeros(3),
        body_rates=np.array([0.0, 0.0, init_yaw_dot]),
        yaw=float(desired),
        rpy=np.array([0.0, 0.0, desired]),
        thrust=0.0,
    )


def init_yaw_rate(current_yaw: float, init_yaw: float, max_yaw_dot: float) -> float:
    """Wrapped, rate-capped initial yaw rate (callInitYaw, 237-257)."""
    # the reference's PI constant (nmpc_solver.cpp:3) is 3.1415926 exactly
    PI = 3.1415926
    d = init_yaw - current_yaw
    if d > PI:
        d = 2 * PI - d
    elif d < -PI:
        d = d + 2 * PI
    return float(np.clip(d, -max_yaw_dot, max_yaw_dot))


def end_command(end_pt: np.ndarray, last_rpy: np.ndarray) -> Command:
    """PUB_END branch (nmpc_solver.cpp:956-985)."""
    return Command(
        pos=np.asarray(end_pt, float).copy(),
        vel=np.zeros(3),
        acc=np.zeros(3),
        body_rates=np.zeros(3),
        yaw=float(last_rpy[2]),
        rpy=np.asarray(last_rpy, float).copy(),
        thrust=0.0,
    )
