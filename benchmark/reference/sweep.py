"""The sharded Monte-Carlo sweep's plain reference: its scenario draws and
the statistics of a gathered set.

The draws are written again from the published recipe of BASELINE config
5's sweep (forces_resilient_planner_tpu_torch/parallel/mesh.py::
sweep_scenarios at commit 61d2f80, itself the JAX module's): numpy's
default generator seeded with the call's seed draws the goals uniform in
[-4, 4] x [-4, 4] x [1.0, 1.6] m, then the forces uniform in [-2, 2]^3
m/s^2; every scenario has the one 6 x 6 x 2 m box.  The scenarios'
problems are reference/grid.py's, lane for lane (goal-major, then force,
then box), and their solve reference/solver.py's.
"""
from __future__ import annotations

import numpy as np
import torch

GOAL_LOW = (-4.0, -4.0, 1.0)
GOAL_HIGH = (4.0, 4.0, 1.6)
FORCE_BOUND = 2.0
HALF = (6.0, 6.0, 2.0)


def draws(seed: int, n_goals: int, n_forces: int, n_corridors: int = 1):
    """(goals (G, 3), forces (F, 3), halves (C, 3)) in float64."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform(GOAL_LOW, GOAL_HIGH, (n_goals, 3))
    forces = rng.uniform(-FORCE_BOUND, FORCE_BOUND, (n_forces, 3))
    return goals, forces, np.tile(np.asarray([HALF]), (n_corridors, 1))


def stats(exit_code, iters) -> tuple[float, float, float]:
    """(n, n_solved, mean iterations) of a gathered set, on the host in
    float64; solved is exit code 1."""
    ec = np.asarray(exit_code)
    it = np.asarray(iters, dtype=np.float64)
    return float(ec.size), float((ec == 1).sum()), float(it.sum() / ec.size)


def reduced_stats(exit_code, iters, shard, world: int, dtype):
    """The same statistics reduced as the ranks reduce them, in `dtype`:
    each shard's count, solved count and iteration sum (torch.sum, its
    result in `dtype`), their sum over the shards with every addition
    rounded to `dtype`, as an all-reduce in `dtype` adds, then the mean.
    `shard` (L,) names each answer's rank."""
    ec = torch.as_tensor(np.asarray(exit_code))
    it = torch.as_tensor(np.asarray(iters)).to(dtype)
    shard = torch.as_tensor(np.asarray(shard))
    totals = [torch.zeros((), dtype=dtype) for _ in range(3)]
    for r in range(world):
        mine = shard == r
        part = (mine.to(dtype).sum(), (mine & (ec == 1)).to(dtype).sum(),
                it[mine].sum())
        totals = [a + b for a, b in zip(totals, part)]
    n, n_solved, it_sum = totals
    return float(n), float(n_solved), float(it_sum / n)


def gap(got, want) -> float:
    """The widest of |n - n'|, |n_solved - n_solved'| and the relative gap
    of the mean iterations: any miscount reads 1 or more."""
    (n, s, m), (n0, s0, m0) = got, want
    return max(abs(n - n0), abs(s - s0), abs(m - m0) / max(abs(m0), 1e-30))
