"""External-force estimation (VID-Fusion analog), torch.

Port of forces_resilient_planner_tpu/estimation/force_estimator.py: a
momentum-residual disturbance observer that recovers the external force
acceleration from odometry velocity and the commanded thrust/attitude
through the planner's 9-state model (dynamics/quadrotor.py):

    v_dot_model = R e3 T/m - g e3 - R D R^T v          (no external force)
    f_hat      += (1 - exp(-L dt)) ((v_k - v_{k-1})/dt - v_dot_model - f_hat)

a low-pass filter on the model residual with bandwidth L [1/s].  The
functional core works on any leading batch shape; MomentumForceEstimator
is the stateful host wrapper of the 100 Hz loop.  The consumer-side
semantics (deadband, force-jump replan, panic stop) live in the FSM
(engine/planner.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import (
    continuous_dynamics,
)


class EstimatorState(NamedTuple):
    f_hat: torch.Tensor    # (..., 3) estimated external acceleration
    v_prev: torch.Tensor   # (..., 3) last velocity sample


def estimator_init(v0: torch.Tensor) -> EstimatorState:
    return EstimatorState(f_hat=torch.zeros_like(v0), v_prev=v0)


def estimator_update(
    st: EstimatorState,
    x: torch.Tensor,        # (..., 9) current odometry state [p, v, rpy]
    u: torch.Tensor,        # (..., 4) commanded [rates(3), thrust]
    dt: float,
    cfg: ModelConfig,
    bandwidth: float = 8.0,
) -> EstimatorState:
    """One observer step.  Works on any leading batch shape."""
    v = x[..., 3:6]
    v_dot_meas = (v - st.v_prev) / dt
    v_dot_model = continuous_dynamics(x, u, torch.zeros_like(v), cfg)[..., 3:6]
    resid = v_dot_meas - v_dot_model - st.f_hat
    gain = 1.0 - math.exp(-bandwidth * dt)   # exact discrete first-order LPF
    return EstimatorState(f_hat=st.f_hat + gain * resid, v_prev=v)


class MomentumForceEstimator:
    """Stateful host-side wrapper for the 100 Hz loop (single vehicle), its
    state f64 tensors on `device`.

    >>> est = MomentumForceEstimator(cfg, device="cuda")
    >>> f = est.update(odom_state, last_command, dt)   # (3,) accel [m/s^2]
    """

    def __init__(self, cfg: ModelConfig, bandwidth: float = 8.0, *,
                 device):
        self.cfg = cfg
        self.bandwidth = bandwidth
        self.device = torch.device(device)
        self._st: EstimatorState | None = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                               device=self.device)

    @property
    def f_hat(self) -> np.ndarray:
        return (
            np.zeros(3)
            if self._st is None
            else self._st.f_hat.cpu().numpy()
        )

    def update(self, x: np.ndarray, u: np.ndarray, dt: float) -> np.ndarray:
        xt = self._t(x)
        if self._st is None:
            self._st = estimator_init(xt[3:6])
            return np.zeros(3)
        self._st = estimator_update(
            self._st, xt, self._t(u), dt, self.cfg, self.bandwidth,
        )
        return self._st.f_hat.cpu().numpy()

    def sync(self, x: np.ndarray) -> None:
        """Track velocity without integrating the observer — for phases
        where the vehicle is not flying the model (position holds, yaw
        ramps): the momentum residual is meaningless there and would
        corrupt f_hat."""
        v = self._t(x)[3:6]
        if self._st is None:
            self._st = estimator_init(v)
        else:
            self._st = self._st._replace(v_prev=v)

    def reset(self) -> None:
        self._st = None
