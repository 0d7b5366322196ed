"""The benchmark workloads that chip_smoke.py drives, in the port's own copy.

Copies of bench.py's scenario grid (HALVES, N_GOALS, N_FORCES, bench_seeds,
bench_config), of __graft_entry__._small_cfg, of the JAX bench's fleet
workload (tools/fleet_probe.py's fleet_cfg and fleet_scene, bench.py's
fleet lanes, B, duration and replan cadence) and of the closed-loop tests'
configuration (tests/test_closed_loop.py's CFG), so that neither the port
nor chip_smoke.py imports those modules (their configs come from the JAX
package).  tests/test_torch_config.py holds each copy equal to its
original.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu_torch.mapping import occ_grid as og

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
