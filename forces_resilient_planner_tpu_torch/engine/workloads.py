"""The benchmark workloads that chip_smoke.py drives, in the port's own copy.

Copies of bench.py's scenario grid (HALVES, N_GOALS, N_FORCES, bench_seeds,
bench_config) and of __graft_entry__._small_cfg, so that neither the port
nor chip_smoke.py imports those modules (their configs come from the JAX
package).  tests/test_torch_config.py holds each copy equal to its
original.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG

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
