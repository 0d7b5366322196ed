"""Batched scenario engine: thousands of NMPC problems per card (torch).

Port of forces_resilient_planner_tpu/engine/batch.py: cartesian
(goal x force profile x corridor) scenario grids, expanded from their
seeds on the solving device, and solved by the lane-major tiered IPM.
Per-scenario failure isolation comes from the per-lane exit codes and the
solver's NaN guard.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import PlannerConfig
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu_torch.solver.ipm import SolveResult
from forces_resilient_planner_tpu_torch.solver.problems import (
    hover_warm_start,
    lqr_warm_start_batch,
)
from forces_resilient_planner_tpu_torch.utils import trace


class ScenarioSet(NamedTuple):
    """Batched NLP parameters + warm starts.  Leading axis = scenario."""

    Z0: torch.Tensor
    params: nlp.NLPParams

    @property
    def batch(self) -> int:
        return self.Z0.shape[0]


def _default_x0():
    x0 = np.zeros(9)
    x0[2] = 1.2
    return x0


def make_scenarios(
    cfg: PlannerConfig,
    goals: np.ndarray,            # (G, 3)
    forces: np.ndarray,           # (F, 3)
    corridor_halves: np.ndarray,  # (Cc, 3) box half-extents
    x0: np.ndarray | None = None,
    dtype=torch.float32,
    *,
    device,
) -> ScenarioSet:
    """Cartesian scenario grid (goal x force x corridor) with every field
    materialized (the device expansion below, copied out of its views)."""
    x0 = _default_x0() if x0 is None else x0

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    weights = nlp.make_stage_weights(
        cfg.weights, cfg.model.N, final=False, dtype=dtype, device=device
    )
    scen = _expand_scenarios_device(
        cfg, t(x0), t(goals), t(forces), t(corridor_halves), weights
    )
    return ScenarioSet(
        Z0=scen.Z0.contiguous(),
        params=ipm_lanes._map_params(lambda a: a.contiguous(), scen.params),
    )


def _expand_scenarios_device(
    cfg: PlannerConfig,
    x0: torch.Tensor,       # (9,)
    goals: torch.Tensor,    # (G, 3)
    forces: torch.Tensor,   # (F, 3)
    halves: torch.Tensor,   # (Cc, 3)
    weights: nlp.StageWeights,  # per-stage (N,) tables
) -> ScenarioSet:
    """Cartesian scenario expansion on the tensors' device: only the
    scenario seeds (a few KB) come from the host; the per-scenario NLP
    parameters (corridor rows, references, warm starts) are materialized
    where they are solved.  Fields are broadcast views (batch-leading).
    The warm start is cfg.solver.warm_start: "lqr" the LQR rollout
    (problems.lqr_warm_start_batch), otherwise the hover seed."""
    mcfg = cfg.model
    N, nh = mcfg.N, mcfg.nh
    dtype, device = goals.dtype, goals.device
    G, F, Cc = goals.shape[0], forces.shape[0], halves.shape[0]
    B = G * F * Cc

    g = goals.repeat_interleave(F * Cc, dim=0)                 # (B, 3)
    f = forces.repeat_interleave(Cc, dim=0).repeat(G, 1)       # (B, 3)
    ch = halves.repeat(G * F, 1)                               # (B, 3)

    ref_pos = g[:, None, :].expand(B, N, 3)
    dirv = g[:, :2] - x0[None, :2]
    yaw = torch.where(
        torch.linalg.vector_norm(dirv, dim=-1) > 1e-6,
        torch.atan2(dirv[:, 1], dirv[:, 0]),
        torch.zeros((), dtype=dtype, device=device),
    )
    ref_yaw = yaw[:, None].expand(B, N)

    centers = 0.5 * (x0[None, :3] + g)
    eye = torch.eye(3, dtype=dtype, device=device)
    A_one = torch.zeros((nh, 3), dtype=dtype, device=device)
    A_one[0:6:2] = eye
    A_one[1:6:2] = -eye
    A = A_one[None, None].expand(B, N, nh, 3)
    b_one = torch.zeros((B, nh), dtype=dtype, device=device)
    b_one[:, 0:6:2] = centers + ch
    b_one[:, 1:6:2] = -(centers - ch)
    b = b_one[:, None, :].expand(B, N, nh)

    if cfg.solver.warm_start == "lqr":
        Z0 = lqr_warm_start_batch(
            x0[None].expand(B, 9), ref_pos, ref_yaw, f, mcfg,
            torch.as_tensor(cfg.K_matrix(), dtype=dtype, device=device),
        )
    else:
        Z0 = hover_warm_start(x0, mcfg)[None].expand(B, N, nlp.NZ)
    params = nlp.NLPParams(
        xinit=x0[None].expand(B, 9),
        ref_pos=ref_pos, ref_yaw=ref_yaw, f_ext=f,
        corridor_A=A, corridor_b=b,
        weights=nlp.StageWeights(*(a[None].expand(B, N) for a in weights)),
    )
    return ScenarioSet(Z0=Z0, params=params)


def solve_scenario_grid(
    cfg: PlannerConfig,
    goals: np.ndarray,
    forces: np.ndarray,
    corridor_halves: np.ndarray,
    x0: np.ndarray | None = None,
    dtype=torch.float32,
    *,
    device,
) -> SolveResult:
    """Expand the grid from its seeds on `device` and solve it there with
    the tiered lane-major IPM (scfg.tiers).  Batch-leading results."""
    with trace.span("grid.expand"):
        scen = make_scenarios(cfg, goals, forces, corridor_halves, x0=x0,
                              dtype=dtype, device=device)
    return solve_scenarios(scen, cfg)


def solve_scenario_stream(
    cfg: PlannerConfig,
    seed_sets,                    # iterable of (goals, forces) numpy pairs
    corridor_halves: np.ndarray,
    x0: np.ndarray | None = None,
    dtype=torch.float32,
    *,
    device,
):
    """Solve a stream of scenario seed sets, one after another (the host
    loop syncs once per IPM iteration, so sets do not overlap yet).
    Returns the list of SolveResults."""
    return [
        solve_scenario_grid(
            cfg, g, f, corridor_halves, x0=x0, dtype=dtype, device=device
        )
        for g, f in seed_sets
    ]


def solve_scenarios(scen: ScenarioSet, cfg: PlannerConfig) -> SolveResult:
    """One batched tiered solve of a ScenarioSet."""
    return ipm_lanes.solve_batch_lanes_tiered(
        scen.Z0, scen.params, cfg.model, cfg.solver
    )


class SweepStats(NamedTuple):
    n: torch.Tensor
    n_solved: torch.Tensor
    mean_iters: torch.Tensor
    max_kkt_solved: torch.Tensor
    mean_cost: torch.Tensor


def sweep_stats(res: SolveResult) -> SweepStats:
    """Reductions over a batch: "solved" is exit_code == 1, never a sum of
    exit codes (they include negatives).  Every leaf lives on the result's
    device, so the stats can be all-reduced across ranks as they are."""
    solved = res.exit_code == 1
    return SweepStats(
        n=torch.tensor(float(res.exit_code.shape[0]),
                       device=res.exit_code.device),
        n_solved=solved.to(torch.float32).sum(),
        mean_iters=res.iters.to(torch.float32).mean(),
        max_kkt_solved=torch.where(
            solved, res.kkt_error, torch.zeros_like(res.kkt_error)
        ).max(),
        mean_cost=(res.Z[:, :, 0:4] ** 2).sum(dim=(1, 2)).mean(),
    )
