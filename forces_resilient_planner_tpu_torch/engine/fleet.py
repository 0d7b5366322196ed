"""Fleet-scale batched closed loop: map -> search -> NMPC per scenario (torch).

Port of forces_resilient_planner_tpu/engine/fleet.py: B independent
scenarios (start x goal x true-force) flown SIMULTANEOUSLY through the
full pipeline — the batched kinodynamic search (HOT LOOP 1,
kinodynamic_astar.cpp:17-286), the batched nmpc_step (tube + corridor
kernels + lane-major solver) and an RK4 plant on the device — with
synchronized replanning.  One shared occupancy scene; per-lane goals,
forces and fates.

Simplifications vs the single-robot host stack (engine/planner.py),
documented deviations for the batched setting:
  - receding-horizon execution applies stage-1 controls for one dt with
    the fixed tube gain K as ancillary feedback, u = u_nom + K(x - x_nom)
    — the closed loop Phi = A + B K that getDistrEllipsoid's tubes model
    (nmpc_solver.cpp:28-31, 567-611); without it the plant drifts from
    the solver's prediction-anchored state while every solve reports
    optimal, and 23-31% of lanes end in perpetual -7 panics;
  - replanning is synchronized: the cadence replan plus escalated replans
    whenever any lane's fail ladder crosses max_solve_fails or the solver
    certifies its problem infeasible (exit -7, NOPROGRESS);
  - reached lanes freeze (their plant stops integrating) — per-lane
    failure isolation.

Every lane ends with an attributed outcome (OUTCOME_* below): reached /
collided / panicked (with the solver exit that drove the panic) /
never-found-a-path / still-flying-at-timeout.

A tick is three plain functions on tensors, search_fleet (on replan
ticks), mpc_step and plant_step; the host reads the exit codes and the
reached and collision flags once per tick, and the path sizes on replan
ticks.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import PlannerConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import (
    continuous_dynamics,
)
from forces_resilient_planner_tpu_torch.engine.pipeline_batch import (
    nmpc_step_batched,
)
from forces_resilient_planner_tpu_torch.mapping import occ_grid as og
from forces_resilient_planner_tpu_torch.search import kinodynamic as kd
from forces_resilient_planner_tpu_torch.solver.problems import hover_warm_start
from forces_resilient_planner_tpu_torch.utils.lanes import norm3

# per-lane terminal outcomes (FleetResult.outcome)
OUTCOME_REACHED = 1        # entered goal_radius of its goal
OUTCOME_COLLIDED = 2       # plant state entered an occupied voxel
OUTCOME_PANICKED = 3       # froze after `panic_after` consecutive solve fails
OUTCOME_NO_PATH = 4        # the batched search never produced a path
OUTCOME_TIMEOUT = 5        # still flying (solves OK) when duration ran out
OUTCOME_NAMES = {
    OUTCOME_REACHED: "reached",
    OUTCOME_COLLIDED: "collided",
    OUTCOME_PANICKED: "panicked",
    OUTCOME_NO_PATH: "no_path",
    OUTCOME_TIMEOUT: "timeout",
}


class FleetResult(NamedTuple):
    reached_frac: float
    collided_frac: float
    mean_final_dist: float
    solved_frac: float          # mean solver success over all live ticks
    n_ticks: int
    batch: int
    wall_s: float
    searches: int
    final_states: np.ndarray    # (B, 9)
    # --- attribution: every lane's fate, explained ----------------------
    outcome: np.ndarray         # (B,) OUTCOME_* codes
    outcome_counts: Dict[str, int]
    time_to_goal: np.ndarray    # (B,) seconds, nan where not reached
    # solver exit-code family fractions over live (unfrozen) lane-ticks
    tick_code_fracs: Dict[str, float]
    # per-lane count of NOPROGRESS (-7, tube-tightened-infeasible) ticks
    infeas_ticks: np.ndarray    # (B,) int
    # exit code of the tick that tipped a lane into panic (0 elsewhere)
    panic_exit_code: np.ndarray  # (B,) int


def _rk4_plant(state, u, f_true, mcfg, dt):
    """Device-side plant: RK4 on the true dynamics with ideal rate
    tracking — the tensor twin of engine/simulator.QuadSim.step."""
    def f(x):
        return continuous_dynamics(x, u, f_true, mcfg)

    k1 = f(state)
    k2 = f(state + 0.5 * dt * k1)
    k3 = f(state + 0.5 * dt * k2)
    k4 = f(state + dt * k3)
    return state + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def hover_deques(states: torch.Tensor, mcfg) -> torch.Tensor:
    """Every lane's hover-seeded deque (B, N+1, 17), row N = row N-1
    (initMPCOutput, nmpc_solver.cpp:265-286)."""
    Z = hover_warm_start(states, mcfg)
    return torch.cat([Z, Z[:, -1:]], dim=1)


def search_fleet(grid: og.OccGrid, states, goals, f_true, cfg: PlannerConfig):
    """Every lane's search from its state to its goal, its disturbance as
    the search's bias, and the found path resampled at dt.
    Returns (status (B,), path (B, S, 3), size (B,))."""
    z3 = torch.zeros_like(goals)
    res = kd.search(grid, states[:, 0:3], states[:, 3:6], z3, goals, z3,
                    f_true, False, cfg.search, cfg.tube, cfg.map)
    path, size = kd.get_kino_traj(res, f_true, cfg.model.dt)
    return res.status, path, size


def mpc_step(mpc_output, path, size, t_off, states, use_final, last_ok,
             goals, f_true, obs_b, mask_b, cfg: PlannerConfig):
    """The per-lane fail ladder, the batched initMPCOutput + divergence
    guard (nmpc_solver.cpp:362-364, 453-463), then nmpc_step_batched.  A
    lane whose last solve failed, or whose stage-1 prediction drifted
    beyond the divergence bound from the MEASURED state, re-seeds its deque
    from hover at the measured state.  Re-anchor seeds are clamped into the
    NLP's velocity box: a measured state beyond v_max (possible
    transiently under strong wind) can never satisfy the xinit equality
    inside the bounds, so an unclamped seed would report -7 forever; the
    clamped seed yields a brake-back plan."""
    mcfg = cfg.model
    seed = states.clone()
    seed[:, 3:6] = torch.clamp(states[:, 3:6], -mcfg.max_vel, mcfg.max_vel)
    pred_err = norm3(mpc_output[:, 1, 8:11] - states[:, 0:3])
    reanchor = (~last_ok) | (pred_err > cfg.fsm.divergence_dist)
    Zin = torch.where(reanchor[:, None, None], hover_deques(seed, mcfg),
                      mpc_output)
    return nmpc_step_batched(Zin, path, size, t_off, states, f_true, goals,
                             obs_b, mask_b, use_final, cfg=cfg)


def plant_step(r, states, frozen, goals, f_true, grid: og.OccGrid,
               goal_radius: float, cfg: PlannerConfig):
    """Ancillary feedback u = u_nom + K (x_real - x_nom) with the fixed
    tube gain (nmpc_solver.cpp:28-31), clamped to the input box, one RK4
    step of the true plant, frozen lanes held.  Returns (new_states,
    reached, occupied)."""
    mcfg = cfg.model
    u_nom = r.mpc_output[:, 1, 0:4]
    x_nom = r.mpc_output[:, 1, 8:17]
    Kfb = torch.as_tensor(cfg.K_matrix(), dtype=states.dtype,
                          device=states.device)
    du = (states - x_nom) @ Kfb.T
    lo = states.new_tensor([-mcfg.max_rate] * 3 + [mcfg.min_thrust])
    hi = states.new_tensor([mcfg.max_rate] * 3 + [mcfg.max_thrust])
    u0 = torch.clamp(u_nom + du, lo, hi)
    new_states = _rk4_plant(states, u0, f_true, mcfg, mcfg.dt)
    new_states = torch.where(frozen[:, None], states, new_states)
    reached = norm3(new_states[:, 0:3] - goals) < goal_radius
    occ = og.voxel_state(grid, new_states[:, 0:3], cfg.map) == 1
    return new_states, reached, occ


def run_fleet(
    cfg: PlannerConfig,
    grid: og.OccGrid,
    obstacles: torch.Tensor,      # (M, 3) shared scene cloud
    obstacle_mask: torch.Tensor,  # (M,)
    starts: np.ndarray,           # (B, 9)
    goals: np.ndarray,            # (B, 3)
    f_true: np.ndarray,           # (B, 3) true external force accel
    duration: float,
    replan_every: int = 10,       # MPC ticks between synchronized replans
    goal_radius: float = 0.3,
    tick_trace: list | None = None,   # appended per tick: dict of np arrays
) -> FleetResult:
    """Fly B lanes for `duration` seconds.  The lanes' tensors take the
    dtype and device of the grid's buffer."""
    mcfg = cfg.model
    dt = mcfg.dt
    B = starts.shape[0]
    M = obstacles.shape[0]
    dtype, device = grid.buffer.dtype, grid.buffer.device
    # fail-ladder constants: escalation (replan request) fires when a
    # lane's consecutive-fail count EXCEEDS max_solve_fails; the panic
    # freeze is derived from the same config with fixed headroom so
    # escalation always precedes panic for any max_solve_fails value
    # (the >10 m/s^2 panic / WAIT_TARGET abort analog,
    # nmpc_manage.cpp:380-411)
    escalate_after = cfg.fsm.max_solve_fails + 1
    panic_after = cfg.fsm.max_solve_fails + 4
    if not escalate_after < panic_after:
        raise ValueError("escalation must precede panic")

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    states = t(starts)
    goals_t = t(goals)
    f_t = t(f_true)
    obs_b = obstacles.to(dtype)[None].expand(B, M, 3)
    mask_b = obstacle_mask.to(device)[None].expand(B, M)

    mpc_output = hover_deques(states, mcfg)
    use_final = torch.zeros(B, dtype=torch.bool, device=device)
    last_ok = torch.ones(B, dtype=torch.bool, device=device)
    reached_mask = np.zeros(B, bool)
    panicked = np.zeros(B, bool)
    fail_count = np.zeros(B, np.int32)
    collided = np.zeros(B, bool)
    ever_path = np.zeros(B, bool)
    replan_pending = np.zeros(B, bool)
    time_reached = np.full(B, np.nan)
    infeas_ticks = np.zeros(B, np.int64)
    panic_code = np.zeros(B, np.int32)   # dominant exit at panic time
    code_counts = {1: 0, 0: 0, -6: 0, -7: 0}
    live_ticks = 0
    solved_accum = []

    n_ticks = int(round(duration / dt))
    t0 = time.perf_counter()
    status, path, size = search_fleet(grid, states, goals_t, f_t, cfg)
    ever_path |= size.cpu().numpy() > 0
    searches = 1
    # a failed search (NO_PATH / empty traj) keeps the lane's previous
    # path (the FSM's plan-fail behavior: the old trajectory stays live,
    # nmpc_manage.cpp:186-192); time origins are tracked per lane
    t_planned = torch.zeros(B, dtype=dtype, device=device)
    for k in range(n_ticks):
        t_now = k * dt
        # replan on cadence OR when any live lane's ladder escalated or
        # its solver certified infeasibility (-7) last tick
        escalate = bool(np.any(replan_pending & ~panicked & ~reached_mask))
        if k > 0 and (k % replan_every == 0 or escalate):
            _, path2, size2 = search_fleet(grid, states, goals_t, f_t, cfg)
            good = size2.cpu().numpy() > 0
            ever_path |= good
            good_t = torch.as_tensor(good, device=device)
            path = torch.where(good_t[:, None, None], path2, path)
            size = torch.where(good_t, size2, size)
            t_planned = torch.where(good_t, t_planned.new_tensor(t_now),
                                    t_planned)
            searches += 1
            replan_pending[:] = False
        t_off = t_now - t_planned
        frozen = torch.as_tensor(reached_mask | panicked, device=device)
        r = mpc_step(mpc_output, path, size, t_off, states, use_final,
                     last_ok, goals_t, f_t, obs_b, mask_b, cfg)
        states, reached, occ_hit = plant_step(r, states, frozen, goals_t, f_t,
                                              grid, goal_radius, cfg)
        mpc_output = r.mpc_output
        # use_final is LATCHED (the host FSM latches it until a new goal,
        # planner.py; fleet goals never change) so a post-replan t_offset
        # reset cannot oscillate a lane back to the normal weight profile
        use_final = use_final | r.switch_to_final
        ec_np = r.exit_code.cpu().numpy()
        ok_np = ec_np == 1
        last_ok = torch.as_tensor(ok_np, device=device)
        live = ~(reached_mask | panicked)
        live_ticks += int(live.sum())
        for code in code_counts:
            code_counts[code] += int(((ec_np == code) & live).sum())
        infeas_ticks += ((ec_np == -7) & live).astype(np.int64)
        fail_count = np.where(ok_np, 0, fail_count + 1)
        # escalated replan request: ladder crossing OR infeasibility
        # certificate (NOPROGRESS means the corridor around the CURRENT
        # path is empty after tube tightening — only a new path helps)
        replan_pending |= (fail_count >= escalate_after) | (
            (ec_np == -7) & live
        )
        newly_panicked = (fail_count >= panic_after) & ~reached_mask & ~panicked
        panic_code[newly_panicked] = ec_np[newly_panicked]
        panicked |= newly_panicked
        newly_reached = reached.cpu().numpy() & ~panicked & ~reached_mask
        time_reached[newly_reached] = t_now + dt
        reached_mask |= newly_reached
        collided |= occ_hit.cpu().numpy() & ~reached_mask & ~panicked
        if live.any():
            solved_accum.append(float(ok_np[live].mean()))
        if tick_trace is not None:
            tick_trace.append(dict(
                t=t_now, states=states.cpu().numpy(), ec=ec_np,
                fail=fail_count.copy(),
                u0=mpc_output[:, 1, 0:4].cpu().numpy(),
                use_final=use_final.cpu().numpy(),
                t_off=t_off.cpu().numpy(), size=size.cpu().numpy(),
            ))
    states_np = states.cpu().numpy()
    wall = time.perf_counter() - t0

    outcome = np.full(B, OUTCOME_TIMEOUT, np.int32)
    outcome[~ever_path] = OUTCOME_NO_PATH
    outcome[panicked] = OUTCOME_PANICKED
    outcome[collided] = OUTCOME_COLLIDED
    outcome[reached_mask] = OUTCOME_REACHED
    outcome_counts = {
        name: int((outcome == code).sum())
        for code, name in OUTCOME_NAMES.items()
    }
    tick_code_fracs = (
        {
            "optimal": code_counts[1] / live_ticks,
            "maxit": code_counts[0] / live_ticks,
            "badfuneval": code_counts[-6] / live_ticks,
            "noprogress": code_counts[-7] / live_ticks,
        }
        if live_ticks
        else {}
    )

    dist = np.linalg.norm(states_np[:, 0:3] - np.asarray(goals), axis=-1)
    return FleetResult(
        reached_frac=float(reached_mask.mean()),
        collided_frac=float(collided.mean()),
        mean_final_dist=float(dist[~panicked].mean()) if (~panicked).any()
        else float("nan"),
        solved_frac=float(np.mean(solved_accum)) if solved_accum else 1.0,
        n_ticks=n_ticks,
        batch=B,
        wall_s=wall,
        searches=searches,
        final_states=states_np,
        outcome=outcome,
        outcome_counts=outcome_counts,
        time_to_goal=time_reached,
        tick_code_fracs=tick_code_fracs,
        infeas_ticks=infeas_ticks,
        panic_exit_code=panic_code,
    )
