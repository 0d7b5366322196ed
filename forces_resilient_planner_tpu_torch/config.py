"""Typed configuration tree of the resilient planner (the port's own copy).

A copy of forces_resilient_planner_tpu/config.py (numpy only), so that the
port imports nothing of the JAX package; tests/test_torch_config.py holds
every dataclass default and DEFAULT_CONFIG equal to the original.

Every constant that is hard-coded or ROS-parameterized in the reference
(ZJU-FAST-Lab/forces_resilient_planner) becomes a named field here.
Reference provenance is cited per field group:

- physical constants / problem dimensions: matlab_code/setup.m:11-40
- cost weights:                            plan_manage/src/nmpc_solver.cpp:62-76
- search parameters:                       plan_manage/launch/advanced_param.xml:97-110
- mapping parameters:                      plan_manage/launch/advanced_param.xml:57-94
- FSM / safety thresholds:                 plan_manage/src/nmpc_manage.cpp, nmpc_solver.cpp
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Quadrotor model + horizon dimensions (setup.m:11-40, nmpc_utils.h:186-205)."""

    mass: float = 0.745319
    g: float = 9.81
    drag_coeff: float = 0.33          # rotor drag, x/y only (nonlinear_dynamics.m:27)
    N: int = 20                       # horizon length
    dt: float = 0.05                  # stage timestep [s]
    nx: int = 9                       # state dim  [p(3), v(3), rpy(3)]
    nu: int = 4                       # input dim  [wx, wy, wz, thrust]
    nvar: int = 17                    # stage var  [u(4), u_prev(4), x(9)]
    nh: int = 30                      # corridor rows per stage
    npar: int = 130                   # per-stage parameter block (10 + 4*nh)

    # input bounds (setup.m:26-28)
    max_rate: float = math.radians(90.0)
    min_thrust_factor: float = 0.5    # * m * g
    max_thrust_factor: float = 2.0    # * m * g

    # state bounds (mpc_generator_normal.m:28-46)
    map_halfsize: Tuple[float, float, float] = (20.0, 20.0, 5.0)
    max_vel: float = 2.0
    max_tilt: float = 0.4 * math.pi   # roll/pitch bound
    max_yaw: float = 2.0 * math.pi

    @property
    def min_thrust(self) -> float:
        return self.min_thrust_factor * self.mass * self.g

    @property
    def max_thrust(self) -> float:
        return self.max_thrust_factor * self.mass * self.g

    @property
    def hover_thrust(self) -> float:
        return self.mass * self.g


@dataclasses.dataclass(frozen=True)
class WeightConfig:
    """Cost weights; defaults from nmpc_solver.cpp:62-70.

    Two profiles exist in the reference ("normal" tracking solver and "final"
    braking solver).  They share the same cost structure; the final solver
    additionally applies a terminal 20*w_wp*||v||^2 braking term
    (mpc_objectiveN_final.m:27).
    """

    w_stage_wp: float = 15.0
    w_stage_input: float = 3.0
    w_terminal_wp: float = 15.0
    w_terminal_input: float = 0.0
    w_input_rate: float = 80.0
    w_final_stage_wp: float = 20.0
    w_final_stage_input: float = 5.0
    w_final_terminal_wp: float = 20.0
    w_final_terminal_input: float = 5.0
    yaw_weight_factor: float = 12.0       # 12*w_wp on yaw (mpc_objective_normal.m:22)
    stage1_uprev_factor: float = 10.0     # 10*w_input on stage-1 u_prev (mpc_objective1.m:41)
    final_brake_factor: float = 20.0      # 20*w_wp on terminal velocity (final profile)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Interior-point settings (mpc_generator_normal.m:51-79, FORCESNLPsolver_normal.h:86-107)."""

    max_iters: int = 60               # fixed-trip-count IPM iterations under jit
    tol_stat: float = 1e-4
    tol_eq: float = 1e-4
    tol_ineq: float = 1e-4
    tol_comp: float = 1e-4
    corridor_slack: float = 1e-5      # hu = 1e-5 (mpc_generator_normal.m:14)
    mu_init: float = 1.0
    kappa_mu: float = 0.2             # barrier decrease factor (monotone path)
    frac_to_boundary: float = 0.995
    reg: float = 1e-8                 # primal regularization on the KKT diagonal
    # Mehrotra predictor-corrector: affine probe + centering corrector per
    # iteration, both backsolves against ONE Riccati factorization (FORCES'
    # PDIP is the same family of method).  Cuts single-solve iteration
    # counts ~15-20%, but on large batches its adaptive centering makes the
    # convergence TAIL heavier (max iters 21 -> 28-36 over 4096 lanes) and
    # the lockstep while_loop pays the max, so the monotone Fiacco-McCormick
    # schedule (False: one backsolve per iteration) is the batched default.
    # (The JAX package measured this on its TPU; the port's own numbers
    # on the H100 are in PERF.md.)
    predictor_corrector: bool = False
    sigma_min: float = 0.0            # centering floor for the PC path
    mu_gate: bool = True              # gate barrier shrink on err<=gate*mu
    #                                   (ungated geometric schedules lose
    #                                   ~1.5% solved fraction and are slower)
    mu_gate_factor: float = 10.0      # gate threshold multiplier
    mu_superlin: float = 1.5          # superlinear tail exponent: the
    #                                   barrier update is
    #                                   max(tol/20, min(kappa*mu, mu**superlin))
    # Exit-code taxonomy threshold: a lane that stops (max-iter or NaN
    # guard) with max(g + s) above this is classified "no progress /
    # infeasible" (-7, the NOPROGRESS family of
    # FORCESNLPsolver_normal.h:130-131) instead of plain max-iter (0) —
    # the inequality residual r_g = g + s contracts by (1 - alpha) per
    # step and is bounded below by the primal infeasibility gap, so a
    # stuck r_g after the full iteration budget is the IPM's
    # infeasibility certificate.
    infeas_tol: float = 1e-3
    # Tiered batch solve (solver/ipm_lanes.py::solve_lanes_tiered): run the
    # full batch for tier_phase1 iterations, then compact the unconverged
    # minority into a tier_frac-sized sub-batch for the tail iterations.
    # tier_phase1 <= 0 disables tiering.
    tier_phase1: int = 0
    tier_frac: float = 0.25
    # Multi-level schedule ((iter_cap, frac_of_full_batch), ...) — when
    # non-empty it overrides tier_phase1/tier_frac and each level compacts
    # the still-unconverged lanes into a smaller sub-batch
    # (solver/ipm_lanes.py::solve_lanes_multitier).
    tiers: Tuple[Tuple[int, float], ...] = ()
    # One-shot sweep warm start: "hover" = hover seed (initMPCOutput,
    # nmpc_solver.cpp:265-286); "lqr" = closed-loop LQR rollout toward the
    # reference with the fixed gain K (problems.lqr_warm_start_batch — the
    # sweep analog of FORCES' previous-solution warm start,
    # forces_normal.cpp:74-97).
    warm_start: str = "hover"


@dataclasses.dataclass(frozen=True)
class TubeConfig:
    """Disturbance-tube propagation (nmpc_solver.cpp:28-31, 90-99, 486-519)."""

    ego_r: float = 0.27
    ego_h: float = 0.0425
    ext_noise_bound: float = 0.5      # disturbance channel bound w_i
    epsilon: float = 0.06             # initial uncertainty Q_init = eps^2 I (nmpc_utils.h:187)
    # fixed feedback gain K (4x9), rows: wx, wy, wz, thrust (nmpc_solver.cpp:28-31)
    K: Tuple[Tuple[float, ...], ...] = (
        (-2.0, 5.0, 0.0, -1.0, 4.0, 0.0, -8.0, 0.0, 0.0),
        (-5.0, -2.0, 0.0, -4.0, -1.0, 0.0, 0.0, -8.0, 0.0),
        (-2.0, -2.0, 0.0, -1.0, -1.0, 0.0, 0.0, 0.0, -8.0),
        (0.0, 0.0, -8.0, 0.0, 0.0, -6.0, 0.0, 0.0, 0.0),
    )
    reuse_inflation: float = 1.1      # corridor-reuse containment inflation (nmpc_solver.cpp:302)


@dataclasses.dataclass(frozen=True)
class CorridorConfig:
    """Safe-flight-corridor generation (nmpc_solver.cpp:314-329, line_segment.h)."""

    local_bbox: Tuple[float, float, float] = (2.0, 2.0, 1.0)
    seed_len: float = 0.1             # 2-point seed length along ref yaw
    max_obs_planes: int = 24          # + 6 bbox walls = 30 = nh
    max_obstacles: int = 2048         # fixed obstacle buffer per decomposition
    shrink_iters: int = 16            # bounded ellipsoid-shrink iterations
    epsilon: float = 1e-10            # decomp_basis/data_type.h:128
    # gather the closest-to-segment in-bbox obstacles into this many slots
    # before the shrink/peel loops (0 = off).  Only in-bbox points matter
    # (set_obs, decomp_base.h:33-38); when they fit the buffer the result
    # is identical, otherwise the farthest are dropped first — every loop
    # round then costs max_active/max_obstacles of the full sweep.
    # OPT-IN (default 0 = reference-faithful): in the overflow regime a
    # dense near cluster can hog every slot and a dropped far obstacle can
    # then sit strictly INSIDE the compacted polytope (measured ~7 cm in
    # tests/test_corridor.py::test_obstacle_compaction_overflow_unsound) —
    # only enable on workloads where the in-bbox count is known to fit.
    # The production batched path (ops/corridor_pallas.py) never compacts.
    max_active_obstacles: int = 0


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Kinodynamic front-end (advanced_param.xml:97-110)."""

    max_tau: float = 0.5
    init_max_tau: float = 0.5
    max_vel: float = 2.0
    max_acc: float = 3.0
    w_time: float = 10.0
    horizon: float = 7.5
    lambda_heu: float = 5.0
    resolution: float = 0.1
    time_resolution: float = 0.8
    check_num: int = 15
    allocate_num: int = 100000
    tie_breaker: float = 1.0 / 10000.0
    acc_res: float = 0.5              # input lattice step factor (max_acc * res, res=1/2)
    # ego-inflation ratio of the search's checkState collision probe
    # (the reference hard-codes 1.5, kinodynamic_astar.cpp via
    # checkState's inflate argument).  The front-end knows nothing of
    # the disturbance tube; for scenes with gaps narrower than
    # 2*(ego_r + far-stage tube lateral) raise this to
    # ~ (ego_r + tube_lateral)/ego_r so paths clear what the tightened
    # corridor must later hold.  (Round-5 note: the fleet panic
    # attrition initially blamed on this was actually the missing
    # ancillary feedback loop — see engine/fleet.py — so the default
    # stays at the reference value.)
    clearance_inflate: float = 1.5
    expand_width: int = 32            # frontier nodes expanded per round (TPU batching)
    max_rounds: int = 256             # bounded best-first rounds
    node_capacity: int = 8192         # fixed node-table size
    init_sub_durations: int = 8       # first-expansion sub-durations (time_res_init=1/8)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Occupancy grid (advanced_param.xml:57-94)."""

    size: Tuple[float, float, float] = (40.0, 40.0, 6.0)
    origin: Tuple[float, float, float] = (-20.0, -20.0, -1.0)
    resolution: float = 0.1
    prob_hit_log: float = 1.2
    prob_miss_log: float = -0.5
    clamp_min_log: float = -1.0
    clamp_max_log: float = 2.0
    min_occupancy_log: float = 1.70
    min_ray_length: float = 0.1
    max_ray_length: float = 6.0
    depth_scale: float = 1000.0
    skip_pixel: int = 2
    depth_filter_margin: int = 1
    depth_filter_maxdist: float = 6.0
    depth_filter_mindist: float = 0.1
    depth_filter_tolerance: float = 0.2
    rows: int = 480
    cols: int = 640
    # sensor-following local map window half-extents (occ_map/local_radius_*,
    # advanced_param.xml:63-65; window update occ_map.cpp:273-274)
    local_radius: Tuple[float, float, float] = (6.0, 6.0, 3.0)
    # temporal-consistency depth filter toggle (advanced_param.xml:76,
    # projectDepthImage shift branch occ_map.cpp:357-430)
    use_shift_filter: bool = True
    # depth<->odom pairing tolerance [s] — the host-side analog of the
    # reference's message_filters ApproximateTime sync (occ_map.cpp:853-868)
    sync_tolerance: float = 0.05
    # body(imu)->camera extrinsic rotation+translation T_ic (occ_map.cpp:794-797)
    cam_R_ic: Tuple[Tuple[float, float, float], ...] = (
        (0.0, 0.0, 1.0),
        (-1.0, 0.0, 0.0),
        (0.0, -1.0, 0.0),
    )
    cam_t_ic: Tuple[float, float, float] = (0.1, 0.0, 0.086)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return tuple(int(round(s / self.resolution)) for s in self.size)


@dataclasses.dataclass(frozen=True)
class FSMConfig:
    """Mission FSM thresholds (nmpc_manage.cpp, nmpc_solver.cpp)."""

    goal_z: float = 1.2               # goal z fixed (nmpc_manage.cpp:491)
    yaw_gate: float = 0.8             # init-yaw alignment gate [rad] (nmpc_manage.cpp:164)
    max_yaw_dot: float = 0.4 * math.pi
    ext_noise_bound: float = 0.5
    panic_force: float = 10.0         # m/s^2 panic-stop threshold (nmpc_manage.cpp:404)
    divergence_dist: float = 2.0      # odom-vs-prediction guard (nmpc_solver.cpp:453)
    goal_radius: float = 0.15         # reached test (nmpc_solver.cpp:466)
    final_switch_dist: float = 1.0    # normal->final switch (nmpc_solver.cpp:446)
    local_end_dist: float = 0.7       # local-end replan test (nmpc_solver.cpp:439)
    ref_jump_replan: float = 1.0      # hard-to-follow replan (nmpc_solver.cpp:136)
    max_plan_fails: int = 3
    max_solve_fails: int = 2
    max_replans: int = 3
    goal_inflate: float = 1.2
    goal_relocate_inflate: float = 1.5
    traj_check_stride: int = 5
    cmd_rate_hz: float = 100.0
    mpc_rate_hz: float = 20.0
    hover_thrust_seed: float = 7.3    # real_thrust_c_ (nmpc_utils.h:196)


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    weights: WeightConfig = dataclasses.field(default_factory=WeightConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    tube: TubeConfig = dataclasses.field(default_factory=TubeConfig)
    corridor: CorridorConfig = dataclasses.field(default_factory=CorridorConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    fsm: FSMConfig = dataclasses.field(default_factory=FSMConfig)

    def K_matrix(self) -> np.ndarray:
        return np.asarray(self.tube.K, dtype=np.float64)


DEFAULT_CONFIG = PlannerConfig()
