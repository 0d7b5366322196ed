"""Realistic corridor-rich scenario generators, shared by tests and tools
(torch).

Port of forces_resilient_planner_tpu/engine/scenarios.py.  The fence
scenes produce scenarios whose corridors come from REAL ellipsoid
decompositions (corridor/decomp.py) with genuinely active non-bbox rows.
Deterministic per (B, seed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import DEFAULT_CONFIG, PlannerConfig
from forces_resilient_planner_tpu_torch.corridor.decomp import decompose_segment
from forces_resilient_planner_tpu_torch.engine.batch import ScenarioSet
from forces_resilient_planner_tpu_torch.solver import nlp
from forces_resilient_planner_tpu_torch.solver.problems import hover_warm_start


def fence_scene() -> np.ndarray:
    """Fence with a gap at y in (0, 1.2), plus a second staggered fence."""
    pts = []
    for x, gap_lo, gap_hi in ((1.5, 0.0, 1.2), (3.0, -1.2, 0.0)):
        ys = np.arange(-3.0, 3.0, 0.15)
        zs = np.arange(0.0, 2.6, 0.15)
        yy, zz = np.meshgrid(ys, zs)
        keep = ~((yy.ravel() > gap_lo) & (yy.ravel() < gap_hi))
        pts.append(
            np.stack(
                [np.full(keep.sum(), x), yy.ravel()[keep], zz.ravel()[keep]],
                -1,
            )
        )
    return np.concatenate(pts, axis=0)


def corridor_scenarios(
    cfg: PlannerConfig, B: int, dtype=torch.float64, seed: int = 42, *,
    device,
) -> ScenarioSet:
    """B scenarios threading the fence gaps; corridors from real per-stage
    segment decompositions (build_corridors' inner op), every (scenario,
    stage) at once."""
    mcfg = cfg.model
    N = mcfg.N
    rng = np.random.default_rng(seed)
    obs_np = fence_scene()
    M = cfg.corridor.max_obstacles
    sel = rng.choice(len(obs_np), size=min(M, len(obs_np)), replace=False)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    obs = t(obs_np[sel])
    mask = torch.ones(len(sel), dtype=torch.bool, device=device)

    x0 = np.zeros(9)
    x0[2] = 1.2
    goals = rng.uniform([3.8, -2.0, 1.0], [4.5, 2.0, 1.6], (B, 3))
    forces = rng.uniform(-1.0, 1.0, (B, 3))

    # reference: piecewise line start -> gap1 -> gap2 -> goal, walked at a
    # per-scenario reference speed <= v_max so the horizon's references stay
    # dynamically reachable (the kino front-end resamples at Ts=0.05 the
    # same way); scenarios differ in speed and gap entry point, so stages
    # near the fence get genuinely different corridor decompositions
    gap1 = np.stack(
        [np.full(B, 1.5), rng.uniform(0.2, 1.0, B), np.full(B, 1.2)], -1
    )
    wp = np.stack(
        [
            np.tile(x0[:3], (B, 1)),
            gap1,
            np.tile([3.0, -0.6, 1.2], (B, 1)),
            goals,
        ],
        axis=1,
    )  # (B, 4, 3)
    seg = np.linalg.norm(np.diff(wp, axis=1), axis=-1)  # (B, 3)
    cum = np.concatenate([np.zeros((B, 1)), np.cumsum(seg, axis=1)], axis=1)
    v_ref = rng.uniform(1.0, 1.9, (B, 1))
    s = np.minimum(
        np.arange(N)[None] * mcfg.dt * v_ref, cum[:, -1:]
    )
    ref_pos = np.stack(
        [
            np.stack(
                [np.interp(s[b], cum[b], wp[b, :, k]) for k in range(3)], -1
            )
            for b in range(B)
        ],
        0,
    )  # (B, N, 3)
    d = np.diff(ref_pos, axis=1)
    yaw = np.arctan2(d[:, :, 1], d[:, :, 0])
    ref_yaw = np.concatenate([yaw, yaw[:, -1:]], axis=1)  # (B, N)

    seed2 = ref_pos + cfg.corridor.seed_len * np.stack(
        [np.cos(ref_yaw), np.sin(ref_yaw), np.zeros_like(ref_yaw)], -1
    )

    dec = decompose_segment(t(ref_pos), t(seed2), obs, mask, cfg.corridor,
                            mcfg.nh)
    weights = nlp.make_stage_weights(cfg.weights, N, final=False, dtype=dtype,
                                     device=device)
    params = nlp.NLPParams(
        xinit=t(x0)[None].expand(B, 9),
        ref_pos=t(ref_pos),
        ref_yaw=t(ref_yaw),
        f_ext=t(forces),
        corridor_A=dec.A,
        corridor_b=dec.b,
        weights=nlp.StageWeights(*(w[None].expand((B,) + w.shape)
                                   for w in weights)),
    )
    Z0 = hover_warm_start(t(x0), mcfg)[None].expand(B, N, nlp.NZ)
    return ScenarioSet(Z0=Z0, params=params)


# the corridor/solver caps the realism suites + parity certificate run at
PARITY_SCENE_CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    solver=dataclasses.replace(
        DEFAULT_CONFIG.solver, tiers=((16, 0.25), (18, 0.0625))
    ),
    corridor=dataclasses.replace(
        DEFAULT_CONFIG.corridor,
        max_obstacles=512, shrink_iters=8, max_obs_planes=12,
    ),
)
