"""Lightweight closed-loop quadrotor simulator.

Replaces the RotorS Gazebo stack for tests/benchmarks (SURVEY.md section 4:
"odom in -> trajectory command out" is the whole interface).  The plant
integrates the same 9-state model as the planner (commanded body rates +
thrust through the true dynamics) with the TRUE external force, plus
optional actuation lag and odometry noise — enough fidelity to exercise
replanning, tube tightening and the FSM fallback ladders.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from forces_resilient_planner_tpu_torch.config import ModelConfig
from forces_resilient_planner_tpu_torch.engine.commander import Command


def _dynamics(x, u, f_ext, cfg: ModelConfig):
    roll, pitch, yaw = x[6], x[7], x[8]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array(
        [
            [cy * cp, cy * sp * sr - cr * sy, cy * sp * cr + sy * sr],
            [cp * sy, cy * cr + sy * sp * sr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )
    D = np.diag([cfg.drag_coeff, cfg.drag_coeff, 0.0])
    v = x[3:6]
    acc = (
        R[:, 2] * u[3] / cfg.mass
        + f_ext
        - np.array([0.0, 0.0, cfg.g])
        - R @ D @ R.T @ v
    )
    return np.concatenate([v, acc, u[0:3]])


@dataclass
class QuadSim:
    cfg: ModelConfig
    state: np.ndarray            # (9,)
    f_ext: np.ndarray            # true external force acceleration
    rate_tau: float = 0.0        # first-order body-rate lag [s], 0 = ideal

    def __post_init__(self):
        self._rates = np.zeros(3)

    def step(self, cmd: Command | None, dt: float):
        if cmd is None or cmd.thrust <= 0.0:
            if cmd is not None:
                # position/yaw hold commands (ROTATE_YAW / PUB_END): treat as
                # perfectly tracked by the low-level controller
                self.state[0:3] = cmd.pos
                self.state[3:6] = 0.0
                self.state[8] = cmd.yaw
            return
        u_cmd = np.concatenate([cmd.body_rates, [cmd.thrust]])
        if self.rate_tau > 0:
            a = dt / max(self.rate_tau, dt)
            self._rates += a * (u_cmd[:3] - self._rates)
            u = np.concatenate([self._rates, [u_cmd[3]]])
        else:
            u = u_cmd
        # RK4 on the true dynamics
        x = self.state
        k1 = _dynamics(x, u, self.f_ext, self.cfg)
        k2 = _dynamics(x + 0.5 * dt * k1, u, self.f_ext, self.cfg)
        k3 = _dynamics(x + 0.5 * dt * k2, u, self.f_ext, self.cfg)
        k4 = _dynamics(x + dt * k3, u, self.f_ext, self.cfg)
        self.state = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def run_closed_loop(
    planner, sim: QuadSim, goal_xy, duration: float, dt: float = 0.01,
    odom_noise: float = 0.0, force_schedule=None, rng=None,
    external_force_feed: bool = True,
    sensor_feed=None, sensor_stride: int = 10,
    record_plans: bool = False,
):
    """Drive the full loop at the reference's timer rates
    (fsm/cmd 100 Hz, mpc/safety 20 Hz, nmpc_manage.cpp:44-46).

    force_schedule: optional callable t -> true external force (m/s^2).
    external_force_feed: publish the true force to the planner (the
    reference's VID-Fusion feed); False = the planner must sense it itself
    (planner.enable_force_estimation()).
    sensor_feed: optional callable (planner, sim, t) fired every
    sensor_stride ticks BEFORE the planner ticks — the depth-camera feed
    (the reference's ~10 Hz depth topic, occ_map.cpp:853-868).
    record_plans: also snapshot the accepted NMPC plan (stage positions)
    after every mpc tick, for utils.scene.dump_replay animation.
    Returns a trace dict.
    """
    rng = rng or np.random.default_rng(0)
    planner.set_goal(np.asarray(goal_xy))
    trace = {"t": [], "pos": [], "vel": [], "state": [], "force": []}
    if record_plans:
        trace["plans"] = []
    n = int(round(duration / dt))
    for k in range(n):
        t = k * dt
        if force_schedule is not None:
            sim.f_ext = np.asarray(force_schedule(t), float)
        odom = sim.state.copy()
        if odom_noise > 0:
            odom[0:6] += rng.normal(0, odom_noise, 6)
        planner.on_odometry(odom, t_now=t)
        if sensor_feed is not None and k % sensor_stride == 0:
            sensor_feed(planner, sim, t)
        if external_force_feed:
            # the estimator publishes the (noisy) true force
            planner.on_external_force(sim.f_ext)
        planner.tick_fsm(t)
        if k % 5 == 0:
            planner.tick_safety(t)
            planner.tick_mpc(t)
            if record_plans and getattr(planner, "mpc_output", None) is not None:
                trace["plans"].append(
                    (t, np.asarray(planner.mpc_output[:, 8:11], float))
                )
        cmd = planner.get_command(t)
        sim.step(cmd, dt)
        trace["t"].append(t)
        trace["pos"].append(sim.state[0:3].copy())
        trace["vel"].append(sim.state[3:6].copy())
        trace["state"].append(planner.state.name)
        trace["force"].append(sim.f_ext.copy())
    for key in ("pos", "vel", "force"):
        trace[key] = np.asarray(trace[key])
    return trace
