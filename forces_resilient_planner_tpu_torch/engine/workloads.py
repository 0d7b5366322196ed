"""The benchmark workloads that chip_smoke.py and the port's bench.py drive,
in the port's own copy.

Copies of bench.py's scenario grid (HALVES, N_GOALS, N_FORCES, bench_seeds,
bench_config), of __graft_entry__._small_cfg, of the JAX bench's fleet
workload (tools/fleet_probe.py's fleet_cfg and fleet_scene, bench.py's
fleet lanes, B, duration and replan cadence), of the closed-loop tests'
configuration (tests/test_closed_loop.py's CFG), of config 3's fence and
wind (bench.py's closed-loop smoke) and of the adversarial
solver distribution (tools/stress_oracle_classify.py's stress_params, the
empty slab of tests/test_solver_stress.py), so that neither the port nor
chip_smoke.py imports those modules (their configs come from the JAX
package).  tests/test_torch_config.py and tests/test_torch_stress.py hold
each copy equal to its original.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.mapping import occ_grid as og
from forces_resilient_planner_tpu_torch.solver import ipm_lanes
from forces_resilient_planner_tpu_torch.solver.nlp import NLPParams
from forces_resilient_planner_tpu_torch.solver.problems import (
    box_corridor,
    hover_to_goal_params,
    hover_warm_start,
)

# the bench grid: 256 goals x 16 forces x 1 box = 4096 scenarios
HALVES = np.array([[5.0, 5.0, 2.0]])
N_GOALS, N_FORCES = 256, 16


def bench_config():
    """The benchmarked configuration: DEFAULT_CONFIG with the multi-level
    tier schedule ((16, 0.25), (18, 0.0625)) chosen from the grid's
    iteration histogram (bench.py:31-48)."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(
            DEFAULT_CONFIG.solver, tiers=((16, 0.25), (18, 0.0625))
        ),
    )


def bench_seeds(seed, n_goals=N_GOALS, n_forces=N_FORCES):
    """Scenario seed set: goals x forces grid, deterministic per seed."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (n_goals, 3))
    forces = rng.uniform(-1.5, 1.5, (n_forces, 3))
    return goals, forces


def small_cfg():
    """DEFAULT_CONFIG with reduced caps (max_iters 25, 128 obstacles, 4 + 4
    shrink rounds, 12 obstacle planes): __graft_entry__._small_cfg, whose
    caps keep the JAX compiles short."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(DEFAULT_CONFIG.solver, max_iters=25),
        corridor=dataclasses.replace(
            DEFAULT_CONFIG.corridor,
            max_obstacles=128,
            shrink_iters=4,
            max_obs_planes=12,
        ),
    )


# the JAX bench's fleet section (bench.py:420-465): 128 scenarios flown for
# 8 s (160 ticks at dt 0.05), a synchronized replan every 10 ticks
FLEET_B, FLEET_DURATION, FLEET_REPLAN_EVERY = 128, 8.0, 10


def fleet_cfg():
    """DEFAULT_CONFIG on the fleet's 12 x 12 x 4 m map, search expand_width
    8, node_capacity 4096, max_rounds 32, corridor max_obstacles 512,
    shrink_iters 8, max_obs_planes 12 (tools/fleet_probe.py:23-48)."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        map=dataclasses.replace(
            DEFAULT_CONFIG.map, size=(12.0, 12.0, 4.0),
            origin=(-6.0, -6.0, -1.0),
        ),
        search=dataclasses.replace(
            DEFAULT_CONFIG.search, expand_width=8, node_capacity=4096,
            max_rounds=32,
        ),
        corridor=dataclasses.replace(
            DEFAULT_CONFIG.corridor, max_obstacles=512, shrink_iters=8,
            max_obs_planes=12,
        ),
    )


def fleet_scene(cfg, dtype, *, device):
    """The fence at x = 1.5 with its 1.8 m gap at y in (0.3, 2.1): the grid
    and its occupied cloud of 2048 points (tools/fleet_probe.py:51-66)."""
    grid = og.make_grid(cfg.map, dtype, device=device)
    ys = np.arange(-4.0, 4.0, 0.1)
    zs = np.arange(0.0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    pts = pts[~((pts[:, 1] > 0.3) & (pts[:, 1] < 2.1))]
    grid = og.set_occupancy(
        grid, torch.as_tensor(pts, dtype=dtype, device=device),
        torch.ones(len(pts), dtype=torch.bool, device=device), cfg.map,
    )
    obs, mask = og.occupied_cloud(grid, cfg.map, 2048)
    return grid, obs, mask


def fleet_lanes(B=FLEET_B, seed=5):
    """Starts, goals and true forces of the fleet's B lanes (bench.py:
    438-446): starts at x -0.5, goals at x 3.2, both threading the gap."""
    rng = np.random.default_rng(seed)
    starts = np.zeros((B, 9))
    starts[:, 0] = -0.5
    starts[:, 1] = rng.uniform(0.8, 1.6, B)
    starts[:, 2] = 1.2
    goals = np.stack(
        [np.full(B, 3.2), rng.uniform(0.9, 1.5, B), np.full(B, 1.2)], -1
    )
    f_true = rng.uniform(-0.5, 0.5, (B, 3))
    return starts, goals, f_true


def closed_loop_cfg():
    """DEFAULT_CONFIG on a 16 x 16 x 4 m map with search expand_width 8,
    node_capacity 4096, max_rounds 48: the single-robot closed-loop tests'
    configuration (tests/test_closed_loop.py:22-30)."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        map=dataclasses.replace(
            DEFAULT_CONFIG.map, size=(16.0, 16.0, 4.0),
            origin=(-8.0, -8.0, -1.0),
        ),
        search=dataclasses.replace(
            DEFAULT_CONFIG.search, expand_width=8, node_capacity=4096,
            max_rounds=48,
        ),
    )


def fence_points():
    """BASELINE config 3's fence (tests/test_closed_loop.py's obstacle
    scene, bench.py:383-387): points on a 0.1 m lattice in the plane
    x = 1.5, y in [-3, 3), z in [0, 2.6), less its gap at y in (-0.2, 1.6)."""
    ys = np.arange(-3, 3, 0.1)
    zs = np.arange(0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    return pts[~((pts[:, 1] > -0.2) & (pts[:, 1] < 1.6))]


def wind(t):
    """Config 3's time-varying wind (bench.py:389-390): 0.8 sin(0.5 t)
    m/s^2 along x."""
    return np.array([0.8 * np.sin(0.5 * t), 0.0, 0.0])


# the adversarial solver distribution's start: hover at (0, 0, 1.2)
STRESS_X0 = np.array([0.0, 0.0, 1.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])


def stack_params(problems) -> NLPParams:
    """Single problems' NLPParams stacked along a new leading lane axis."""
    return NLPParams(
        *(torch.stack(f) for f in zip(*(p[:-1] for p in problems))),
        weights=type(problems[0].weights)(
            *(torch.stack(f) for f in zip(*(p.weights for p in problems)))),
    )


def stress_params(B: int, seed: int = 123, *, dtype, device):
    """(Z0 (B, N, 17), params) of the adversarial stress distribution
    (tools/stress_oracle_classify.py:48-79, the batch of tests/
    test_solver_stress.py::test_stress_batch_no_false_optimals enlarged):
    random goals, forces up to 4 m/s^2 a component, random tight and
    shifted box corridors, each lane built at f64 on the CPU by
    hover_to_goal_params, then cast to `dtype` on `device`."""
    mcfg = DEFAULT_CONFIG.model
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(B):
        goal = rng.uniform([-2.5, -2.5, 0.6], [2.5, 2.5, 2.2], 3)
        f = rng.uniform(-4, 4, 3)
        half = rng.uniform([0.3, 0.3, 0.4], [4.0, 4.0, 2.0], 3)
        center = 0.5 * (STRESS_X0[:3] + goal) + rng.uniform(-0.5, 0.5, 3)
        problems.append(hover_to_goal_params(
            STRESS_X0, goal, mcfg, DEFAULT_CONFIG.weights, f_ext=tuple(f),
            corridor_center=center, corridor_half=tuple(half), device="cpu"))
    params = stack_params(problems)
    Z0 = hover_warm_start(torch.as_tensor(STRESS_X0), mcfg)[None]
    return (Z0.expand(B, -1, -1).to(dtype=dtype, device=device).contiguous(),
            ipm_lanes._map_params(lambda a: a.to(dtype=dtype, device=device),
                                  params))


def empty_slab_params(*, dtype, device) -> NLPParams:
    """The exit-code taxonomy's infeasible problem (tests/
    test_solver_stress.py:207-237): hover to (1, 0, 1.2) in a 5 x 5 x 2 m
    box whose x rows read x <= 0.5 and x >= 0.6, an empty slab."""
    mcfg = DEFAULT_CONFIG.model
    goal = np.array([1.0, 0.0, 1.2])
    p = hover_to_goal_params(STRESS_X0, goal, mcfg, DEFAULT_CONFIG.weights,
                             dtype=dtype, device=device)
    A, b = box_corridor(np.array([0.0, 0.0, 1.2]), np.array([5, 5, 2.0]),
                        mcfg.N, dtype=dtype, device=device)
    b[:, 0] = 0.5
    b[:, 1] = -0.6
    return p._replace(corridor_A=A, corridor_b=b)
