"""Host orchestration shell: mission FSM + planner facade (torch).

Port of forces_resilient_planner_tpu/engine/planner.py: the equivalent of
NMPCManage (plan_manage/src/nmpc_manage.cpp) and the host-side parts of
NMPCSolver (getKinoPath warm starting, solve accounting, command status
machine).  The device work (the NMPC step, the search, the map, the
collision checks) runs on the planner's device through the port's
modules; this class owns only control flow, counters and the simulated
clock.

FSM: INIT -> WAIT_TARGET -> INIT_YAW -> GEN_NEW_TRAJ/REPLAN_TRAJ ->
EXEC_TRAJ (nmpc_manage.h:15-23), with the reference's fail ladders:
  - plan_fail_count > 3 aborts to WAIT_TARGET (nmpc_manage.cpp:186-192)
  - solver fail_count > 2 escalates to replan; replan_count > 3 with
    exit-code 0 accepts the max-iter iterate (nmpc_solver.cpp:397-429)
  - force watchdog: deadband ext_noise_bound, jump replan, >10 m/s^2 panic
    stop (nmpc_manage.cpp:366-418)
  - goal-relocation ring scan when the goal becomes occupied
    (nmpc_manage.cpp:285-327; implemented with true radian angles — the
    reference passes degree values to cos/sin, a latent unit bug we fix)
  - trajectory collision recheck every 5th sample (lines 329-340)
"""
from __future__ import annotations

import contextlib
import enum
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG, PlannerConfig
from forces_resilient_planner_tpu_torch.engine import commander
from forces_resilient_planner_tpu_torch.engine.commander import CmdStatus, Command
from forces_resilient_planner_tpu_torch.engine.pipeline import nmpc_step
from forces_resilient_planner_tpu_torch.mapping import occ_grid as og
from forces_resilient_planner_tpu_torch.search import kinodynamic as kd
from forces_resilient_planner_tpu_torch.utils import trace
from forces_resilient_planner_tpu_torch.utils.timing import Timers


def _rpy_to_rot(rpy: np.ndarray) -> np.ndarray:
    """ZYX rotation R = Rz(yaw) @ Ry(pitch) @ Rx(roll) — NumPy twin of
    dynamics.quadrotor.euler_to_rot for host-side camera-pose math."""
    cr, sr = np.cos(rpy[0]), np.sin(rpy[0])
    cp, sp = np.cos(rpy[1]), np.sin(rpy[1])
    cy, sy = np.cos(rpy[2]), np.sin(rpy[2])
    return np.array(
        [
            [cy * cp, cy * sp * sr - cr * sy, cy * sp * cr + sy * sr],
            [cp * sy, cy * cr + sy * sp * sr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


class FSMState(enum.Enum):
    INIT = 0
    WAIT_TARGET = 1
    INIT_YAW = 2
    GEN_NEW_TRAJ = 3
    REPLAN_TRAJ = 4
    EXEC_TRAJ = 5


@dataclass
class PlannerDiagnostics:
    solves: int = 0
    solve_failures: int = 0
    replans: int = 0
    last_exit_code: int = -1
    last_iters: int = 0
    last_kkt: float = float("nan")
    fsm_transitions: list = field(default_factory=list)
    # per-phase wall-clock (search / solve / safety / mapping / command):
    # the reference prints one blue wall-clock line per solve
    # (nmpc_solver.cpp:431-433); here timing is a queryable subsystem
    timers: Timers = field(default_factory=Timers)

    def timing_report(self) -> dict:
        return self.timers.report()


class ResilientPlanner:
    """Complete planner stack behind a ROS-free interface.

    Inputs: odometry, external force estimate, goal, obstacle cloud or depth.
    Output: 100 Hz Command stream.
    """

    def __init__(self, cfg: PlannerConfig = DEFAULT_CONFIG, max_cloud: int = 4096,
                 dtype=torch.float32, *, device):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.max_cloud = max_cloud
        self.grid = og.make_grid(cfg.map, dtype, device=self.device)
        self.state = FSMState.INIT
        self.cmd_status = CmdStatus.INIT_POSITION
        self.diag = PlannerDiagnostics()

        self.have_odom = False
        self.have_target = False
        self.have_traj = False
        self.trigger = False
        self.exec_mpc = False
        self.consider_force = False
        self.replan_force_surpass = False
        self.pub_end = False
        self.initialized_output = False
        self.use_final = False

        self.plan_fail_count = 0
        self.fail_count = 0
        self.replan_count = 0
        self.surpass_count = 0

        self.odom = np.zeros(9)
        self.external_acc = np.zeros(3)
        self.last_external_acc = np.zeros(3)
        self.end_pt = np.zeros(3)
        self.init_yaw = 0.0
        self.init_yaw_dot = 0.0
        self.change_yaw_time = 0.0

        N = cfg.model.N
        self.mpc_output = np.zeros((N + 1, 17))
        self.pre_mpc_output = self.mpc_output.copy()
        self.pre_mpc_start_time = 0.0
        self.kino_start_time = 0.0
        self.kino_path = np.zeros((kd.MAX_SAMPLES, 3))
        self.kino_size = 0

        self.obstacles = np.zeros((max_cloud, 3))
        self.obstacle_mask = np.zeros(max_cloud, bool)

        # goal-relocation candidate offsets, EXACTLY the reference's scan
        # order (nmpc_manage.cpp:285-327: radius out, angle around, z up;
        # first free candidate wins) — z is absolute, xy relative to goal
        offs = [
            (r * math.cos(th), r * math.sin(th), nz)
            for r in np.arange(0.2, 1.2001, 0.2)
            for th in np.deg2rad(np.arange(-90, 271, 30))
            for nz in np.arange(1.0, 1.6001, 0.2)
        ]
        self._reloc_offsets = np.asarray(offs)
        self._traj_check_idx = np.arange(
            0, kd.MAX_SAMPLES, cfg.fsm.traj_check_stride
        )
        # previous depth frame + camera pose for the temporal-consistency
        # shift filter (last_T_wc0_/last_depth0_image_, occ_map.cpp:219-223)
        self._last_depth = None
        self._last_R_wc = None
        self._last_t_wc = None
        # host-side depth<->odom pairing buffers — the analog of the
        # reference's ApproximateTime synchronizer (occ_map.cpp:853-868)
        self._depth_queue: list = []
        self._odom_queue: list = []

    # ------------------------------------------------------- device work
    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _surround(self, pts, inflate: float) -> torch.Tensor:
        """checkPosSurround of one point (3,) or a batch (P, 3)."""
        return og.check_pos_surround(
            self.grid, self._t(pts), inflate, self.cfg.tube.ego_r,
            self.cfg.tube.ego_h, self.cfg.map,
        )

    def _search(self, start_p, start_v, start_a, init: bool):
        """One robot's search: B = 1 of search/kinodynamic.py::search."""
        cfg = self.cfg
        return kd.search(
            self.grid, self._t(start_p)[None], self._t(start_v)[None],
            self._t(start_a)[None], self._t(self.end_pt)[None],
            torch.zeros(1, 3, dtype=self.dtype, device=self.device),
            self._t(self.external_acc)[None], init,
            cfg.search, cfg.tube, cfg.map,
        )

    # ------------------------------------------------------------------ IO
    def enable_force_estimation(self, bandwidth: float = 8.0):
        """Self-contained external-force sensing: run the momentum observer
        (estimation/force_estimator.py, the VID-Fusion analog) on incoming
        odometry + the last issued command instead of requiring an external
        `/forces` feed.  Call once; on_external_force then fires internally
        on every odometry sample."""
        from forces_resilient_planner_tpu_torch.estimation import (
            MomentumForceEstimator,
        )

        self._force_estimator = MomentumForceEstimator(
            self.cfg.model, bandwidth, device=self.device
        )
        self._last_cmd_u = np.array(
            [0.0, 0.0, 0.0, self.cfg.model.mass * self.cfg.model.g]
        )
        self._last_odom_t: float | None = None

    def on_odometry(self, state: np.ndarray, t_now: float | None = None):
        """9-state odometry [p, v_world, rpy] (odometryCallback,
        nmpc_manage.cpp:421-448).  With force estimation enabled, pass
        t_now so the observer can integrate."""
        self.odom = np.asarray(state, float).copy()
        self.have_odom = True
        if t_now is not None:
            self._odom_queue.append((float(t_now), self.odom.copy()))
            if len(self._odom_queue) > 200:
                self._odom_queue.pop(0)
            if self._depth_queue:
                self._pair_depth_odom()
        est = getattr(self, "_force_estimator", None)
        if est is not None and t_now is not None:
            flying = (
                self.cmd_status == CmdStatus.PUB_TRAJ
                and self.initialized_output
            )
            if self._last_odom_t is not None and flying:
                dt = t_now - self._last_odom_t
                if dt > 1e-6:
                    f = est.update(self.odom, self._last_cmd_u, dt)
                    self.on_external_force(f)
            else:
                est.sync(self.odom)
            self._last_odom_t = t_now

    def on_odometry_body_frame(
        self, pos: np.ndarray, quat_wxyz: np.ndarray, vel_body: np.ndarray
    ):
        """RotorS-style odometry: body-frame velocity rotated to world,
        quaternion converted to ZYX euler (odometryTransCallback,
        nmpc_manage.cpp:456-478, selected by nmpc/sim_odom_type)."""
        w, x, y, z = np.asarray(quat_wxyz, float)
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        v_world = R @ np.asarray(vel_body, float)
        roll = np.arctan2(R[2, 1], R[2, 2])
        pitch = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
        yaw = np.arctan2(R[1, 0], R[0, 0])
        self.odom = np.concatenate(
            [np.asarray(pos, float), v_world, [roll, pitch, yaw]]
        )
        self.have_odom = True

    def on_external_force(self, force: np.ndarray):
        """Mass-normalized force estimate (extforceCallback, 366-418)."""
        f = np.asarray(force, float)
        if not self.consider_force:
            return
        bound = self.cfg.fsm.ext_noise_bound
        diverse = float(np.max(np.abs(f)))
        if diverse <= bound:
            self.external_acc = np.zeros(3)
            self.last_external_acc = f.copy()
            self.surpass_count = 0
            return
        self.external_acc = f.copy()
        surpass = float(np.max(np.abs(self.last_external_acc - f)))
        if surpass > bound:
            self.surpass_count += 1
            if self.surpass_count >= 1:
                self.replan_force_surpass = True
                self.last_external_acc = f.copy()
                if self.have_target:
                    self._change_state(FSMState.REPLAN_TRAJ, "force-watchdog")
                if surpass > self.cfg.fsm.panic_force:
                    self.have_target = False
                    self._change_state(FSMState.WAIT_TARGET, "force-panic")
        else:
            self.surpass_count = 0

    def set_goal(self, goal_xy: np.ndarray, z: float | None = None):
        """goalCallback: z pinned to 1.2 (nmpc_manage.cpp:481-493)."""
        g = np.asarray(goal_xy, float)
        self.end_pt = np.array(
            [g[0], g[1], self.cfg.fsm.goal_z if z is None else z]
        )
        self.trigger = True
        self.have_target = True

    def on_cloud(self, points: np.ndarray):
        """Direct obstacle cloud intake (cloudCallback analog)."""
        m = min(len(points), self.max_cloud)
        self.obstacles[:m] = points[:m]
        self.obstacle_mask[:] = False
        self.obstacle_mask[:m] = True

    def on_depth(self, depth: np.ndarray, R_wc: np.ndarray, t_wc: np.ndarray,
                 fx: float, fy: float, cx: float, cy: float):
        """Depth-image mapping path (depthOdomCallback, occ_map.cpp:218-312):
        local window follows the camera (lines 273-274), the shift filter
        rejects temporally-inconsistent pixels against the PREVIOUS frame
        (lines 357-430), and the raycast batch-updates log odds."""
        with self.diag.timers.phase("mapping"):
            mcfg = self.cfg.map
            d, R, t = self._t(depth), self._t(R_wc), self._t(t_wc)
            self.grid = og.update_local_window(
                self.grid, t, self._t(mcfg.local_radius)
            )
            if mcfg.use_shift_filter and self._last_depth is not None:
                pts, valid = og.project_depth_shift_filter(
                    d, R, t, self._last_depth, self._last_R_wc,
                    self._last_t_wc, mcfg, fx, fy, cx, cy,
                )
            else:
                pts, valid = og.project_depth(d, R, t, mcfg, fx, fy, cx, cy)
            self.grid = og.raycast_update(self.grid, pts, valid, t, mcfg)
            self._last_depth, self._last_R_wc, self._last_t_wc = d, R, t
            self.refresh_cloud()

    def on_depth_image(self, depth: np.ndarray, t_stamp: float,
                       fx: float, fy: float, cx: float, cy: float):
        """Raw depth intake for a real sensor feed: frames are queued and
        paired with the nearest-in-time odometry sample (the host-side
        equivalent of the reference's message_filters ApproximateTime sync,
        occ_map.cpp:853-868); the camera pose comes from the paired odometry
        through the body->camera extrinsic T_ic (occ_map.cpp:264-274,794-797).
        """
        self._depth_queue.append(
            (float(t_stamp), np.asarray(depth, float), (fx, fy, cx, cy))
        )
        if len(self._depth_queue) > 100:
            self._depth_queue.pop(0)
        self._pair_depth_odom()

    def _pair_depth_odom(self):
        tol = self.cfg.map.sync_tolerance
        while self._depth_queue:
            td, depth, intr = self._depth_queue[0]
            if not self._odom_queue:
                return
            ts = np.asarray([o[0] for o in self._odom_queue])
            if ts[-1] < td:
                # a closer odom sample may still arrive — hold the frame
                # unless it is already hopelessly stale
                if td - ts[-1] > 10 * tol:
                    self._depth_queue.pop(0)
                    continue
                return
            k = int(np.argmin(np.abs(ts - td)))
            t_o, st = self._odom_queue[k]
            self._depth_queue.pop(0)
            if abs(t_o - td) > tol:
                continue  # unmatched frame: dropped, as ApproximateTime would
            R_wi = _rpy_to_rot(st[6:9])
            R_ic = np.asarray(self.cfg.map.cam_R_ic, float)
            t_ic = np.asarray(self.cfg.map.cam_t_ic, float)
            self.on_depth(
                depth, R_wi @ R_ic, st[0:3] + R_wi @ t_ic, *intr
            )

    def refresh_cloud(self):
        pts, mask = og.occupied_cloud(self.grid, self.cfg.map, self.max_cloud)
        self.obstacles = pts.cpu().numpy().astype(float)
        self.obstacle_mask = mask.cpu().numpy()

    def set_occupied(self, points: np.ndarray):
        """Test/global-map convenience: mark voxels occupied directly."""
        self.grid = og.set_occupancy(
            self.grid, self._t(points),
            torch.ones(len(points), dtype=torch.bool, device=self.device),
            self.cfg.map,
        )
        self.refresh_cloud()

    @contextlib.contextmanager
    def profile_trace(self, log_dir: str):
        """torch.profiler trace context over any stretch of planner
        activity, host and (on a card) device, written to log_dir as a
        Chrome trace on exit:

            with planner.profile_trace("trace_dir") as prof:
                planner.tick_fsm(t); planner.tick_mpc(t); ...

        View in TensorBoard or chrome://tracing; prof.key_averages() sums
        the time by operator and kernel.  The program's spans
        (utils/trace.py) are annotated in it, over the work they issued."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with trace.annotate(), torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        ) as prof:
            yield prof

    # ------------------------------------------------------------ internals
    def _change_state(self, new: FSMState, who: str):
        if new != self.state:
            self.diag.fsm_transitions.append((self.state.name, new.name, who))
        self.state = new

    def _init_mpc_output(self):
        """Hover-seeded deque (initMPCOutput, nmpc_solver.cpp:265-286)."""
        row = np.zeros(17)
        row[3] = row[7] = self.cfg.fsm.hover_thrust_seed
        row[8:17] = self.odom
        self.mpc_output = np.tile(row, (self.cfg.model.N + 1, 1))
        self.pre_mpc_output = self.mpc_output.copy()
        self.initialized_output = True

    def _get_kino_path(self, t_now: float, replan: bool) -> bool:
        """getKinoPath (nmpc_solver.cpp:145-226)."""
        cfg = self.cfg
        start_p = self.odom[0:3]
        start_v = self.odom[3:6]
        start_a = np.zeros(3)
        if replan and self.diag.last_exit_code == 1:
            t_cur = t_now - self.pre_mpc_start_time
            cur = int(t_cur / cfg.model.dt)
            if 0 <= cur < cfg.model.N - 1 and t_cur >= 0.0:
                frac = (t_cur % cfg.model.dt) / cfg.model.dt
                q = self.pre_mpc_output[cur] + frac * (
                    self.pre_mpc_output[cur + 1] - self.pre_mpc_output[cur]
                )
                start_p = q[8:11]
                start_v = q[11:14]
                R = commander._euler_to_rot(q[14:17])
                tw = R @ np.array([0.0, 0.0, q[3]]) / cfg.model.mass
                start_a = tw - np.array([0.0, 0.0, cfg.model.g])

        with self.diag.timers.phase("search"):
            res = self._search(start_p, start_v, start_a, True)
            if int(res.status[0]) == kd.NO_PATH:
                # retry with discontinuous initial state (lines 196-209)
                res = self._search(self.odom[0:3], self.odom[3:6],
                                   np.zeros(3), False)
                if int(res.status[0]) == kd.NO_PATH:
                    return False
            path, size = kd.get_kino_traj(
                res, self._t(self.external_acc)[None], cfg.model.dt
            )
        self.kino_path = path[0].cpu().numpy().astype(float)
        self.kino_size = int(size[0])
        self.use_final = False
        self.kino_start_time = t_now
        self.cmd_status = CmdStatus.PUB_TRAJ
        self.pub_end = False
        return True

    def _solve_nmpc(self, t_now: float) -> int:
        """solveNMPC host wrapper (nmpc_solver.cpp:351-482)."""
        if self.cmd_status == CmdStatus.WAIT:
            return 0
        if self.pub_end:
            return -1
        cfg = self.cfg
        if not self.initialized_output or self.diag.last_exit_code != 1:
            self._init_mpc_output()
        self.pre_mpc_start_time = t_now
        t_offset = t_now - self.kino_start_time

        accept_maxit = self.replan_count > 3
        with self.diag.timers.phase("solve"):
            res = nmpc_step(
                self._t(self.mpc_output),
                self._t(self.kino_path),
                self._t(self.kino_size, torch.int64),
                self._t(t_offset),
                self._t(self.odom),
                self._t(self.external_acc),
                self._t(self.end_pt),
                self._t(self.obstacles),
                self._t(self.obstacle_mask, torch.bool),
                self._t(self.use_final, torch.bool),
                cfg=cfg,
                accept_on_maxit=accept_maxit,
            )
            exit_code = int(res.exit_code)
        self.diag.solves += 1
        self.diag.last_exit_code = exit_code
        self.diag.last_iters = int(res.iters)
        self.diag.last_kkt = float(res.kkt_error)

        kino_replan = bool(res.ref_jump_replan)
        if exit_code == 1:
            self.fail_count = 0
            self.replan_count = 0
            self.mpc_output = res.mpc_output.cpu().numpy().astype(float)
            self.pre_mpc_output = self.mpc_output.copy()
        else:
            self.diag.solve_failures += 1
            if self.replan_count > 3 and exit_code == 0:
                self.fail_count = 0
                self.replan_count = 0
                self.mpc_output = res.mpc_output.cpu().numpy().astype(float)
                self.pre_mpc_output = self.mpc_output.copy()
            elif exit_code == -7:
                # NOPROGRESS: the solver certified the tightened problem
                # infeasible (empty corridor after tube tightening) —
                # retrying the identical problem is useless, so skip the
                # fail counter and replan the front-end immediately (the
                # reference burns max_solve_fails ticks before escalating,
                # nmpc_solver.cpp:405-421; branching on the code family is
                # the deliberate improvement the taxonomy buys)
                self.fail_count = 0
                self.replan_count += 1
                kino_replan = True
            elif self.fail_count + 1 > 2:
                self.fail_count = 0
                self.replan_count += 1
                kino_replan = True
            else:
                self.fail_count += 1

        if bool(res.reach_local_end):
            kino_replan = True
        if bool(res.switch_to_final):
            self.use_final = True
        if bool(res.diverged):
            self.cmd_status = CmdStatus.WAIT
            return -3
        if bool(res.goal_reached):
            self.pub_end = True
            return -1
        if kino_replan:
            self.diag.replans += 1
            return -2
        return 1

    # ------------------------------------------------------------- timers
    def tick_mpc(self, t_now: float):
        """20 Hz mpcCallback (nmpc_manage.cpp:50-98)."""
        if not self.exec_mpc:
            return
        status = self._solve_nmpc(t_now)
        if status == 0:
            self.exec_mpc = False
            self.have_target = False
            self._change_state(FSMState.WAIT_TARGET, "mpc")
        elif status == -2:
            self.exec_mpc = False
            self._change_state(FSMState.REPLAN_TRAJ, "mpc")
        elif status == -3:
            self.exec_mpc = False
            self._change_state(FSMState.WAIT_TARGET, "mpc")

    def tick_fsm(self, t_now: float):
        """100 Hz execFSMCallback (nmpc_manage.cpp:109-260)."""
        s = self.state
        cfg = self.cfg
        if s == FSMState.INIT:
            if self.have_odom:
                self._change_state(FSMState.WAIT_TARGET, "fsm")
        elif s == FSMState.WAIT_TARGET:
            if not self.have_target:
                self.consider_force = False
            else:
                self._change_state(FSMState.INIT_YAW, "fsm")
                d = self.end_pt - self.odom[0:3]
                self.init_yaw = math.atan2(d[1], d[0])
                if abs(self.odom[8] - self.init_yaw) >= cfg.fsm.yaw_gate:
                    self.init_yaw_dot = commander.init_yaw_rate(
                        self.odom[8], self.init_yaw, cfg.fsm.max_yaw_dot
                    )
                    self.change_yaw_time = t_now
                    self.cmd_status = CmdStatus.ROTATE_YAW
                    self._rotate_odom_ref = self.odom.copy()
        elif s == FSMState.INIT_YAW:
            if abs(self.odom[8] - self.init_yaw) < cfg.fsm.yaw_gate:
                self.consider_force = True
                self._change_state(FSMState.GEN_NEW_TRAJ, "fsm")
        elif s in (FSMState.GEN_NEW_TRAJ, FSMState.REPLAN_TRAJ):
            replan = s == FSMState.REPLAN_TRAJ
            self.exec_mpc = False
            if self.plan_fail_count > cfg.fsm.max_plan_fails:
                self.have_target = False
                self.plan_fail_count = 0
                self._change_state(FSMState.WAIT_TARGET, "fsm")
                return
            if self._get_kino_path(t_now, replan):
                self.have_traj = True
                self.trigger = False
                self.exec_mpc = True
                self.replan_force_surpass = False
                self.plan_fail_count = 0
                self._change_state(FSMState.EXEC_TRAJ, "fsm")
            else:
                self.plan_fail_count += 1
                self._change_state(FSMState.GEN_NEW_TRAJ, "fsm")
        elif s == FSMState.EXEC_TRAJ:
            if self.trigger and self.exec_mpc:
                self._change_state(FSMState.REPLAN_TRAJ, "fsm")

    def tick_safety(self, t_now: float):
        """20 Hz checkReplanCallback (nmpc_manage.cpp:285-341).

        Device work is batched: the goal-relocation scan (up to 312
        candidates) and the trajectory recheck (every 5th sample) are each
        ONE batched surround check; candidate selection takes the first free
        candidate in the repo's established (r, theta, z) enumeration
        order.  Deliberate deviation from the reference: nmpc_manage.cpp:
        300-315 only breaks the innermost z loop, keeps scanning r/theta
        relative to the already-moved goal, and passes degrees to cos/sin;
        here all candidates are offsets from the ORIGINAL goal (radians)
        and the first free one wins.
        """
        cfg = self.cfg
        with self.diag.timers.phase("safety"):
            if self.have_target:
                goal_free = bool(
                    self._surround(self.end_pt, cfg.fsm.goal_inflate)
                )
                if not goal_free:
                    cand = self._reloc_offsets.copy()
                    cand[:, 0] += self.end_pt[0]
                    cand[:, 1] += self.end_pt[1]
                    free = self._surround(
                        cand, cfg.fsm.goal_relocate_inflate
                    ).cpu().numpy()
                    relocated = bool(free.any())
                    if relocated:
                        self.end_pt = cand[int(np.argmax(free))]
                    if self.state == FSMState.EXEC_TRAJ:
                        self._change_state(FSMState.REPLAN_TRAJ, "safety-goal")
                    elif not relocated:
                        self.have_target = False
                        self._change_state(FSMState.WAIT_TARGET, "safety-goal")
            if self.have_traj and self.kino_size > 0:
                free = self._surround(
                    self.kino_path[self._traj_check_idx], cfg.fsm.goal_inflate
                ).cpu().numpy()
                valid = self._traj_check_idx < self.kino_size
                if bool(np.any(valid & ~free)):
                    self._change_state(FSMState.REPLAN_TRAJ, "safety-traj")

    def get_command(self, t_now: float) -> Command | None:
        """100 Hz command output (cmdTrajCallback, nmpc_solver.cpp:865-987)."""
        cs = self.cmd_status
        if cs in (CmdStatus.INIT_POSITION, CmdStatus.WAIT):
            return None
        self.diag.timers.count("commands")
        if cs == CmdStatus.ROTATE_YAW:
            return commander.rotate_yaw_command(
                self._rotate_odom_ref, self.init_yaw, self.init_yaw_dot,
                t_now - self.change_yaw_time,
            )
        if cs == CmdStatus.PUB_TRAJ:
            if not self.initialized_output:
                return None
            cmd = commander.interpolate_command(
                self.pre_mpc_output, t_now - self.pre_mpc_start_time,
                self.cfg.model,
            )
            if cmd is not None and hasattr(self, "_last_cmd_u"):
                self._last_cmd_u = np.concatenate(
                    [cmd.body_rates, [cmd.thrust]]
                )
            if cmd is None and self.pub_end:
                self.cmd_status = CmdStatus.PUB_END
                return self.get_command(t_now)
            return cmd
        if cs == CmdStatus.PUB_END:
            cmd = commander.end_command(
                self.end_pt, self.pre_mpc_output[self.cfg.model.N - 1, 14:17]
            )
            self.initialized_output = False
            self.cmd_status = CmdStatus.WAIT
            return cmd
        return None
