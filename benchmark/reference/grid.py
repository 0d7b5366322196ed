"""The scenario grid's problems worked out from the grid's own inputs
(goals, forces, box half-extents): frozen copy, taken at commit ad340bc,
of forces_resilient_planner_tpu_torch/engine/batch.py::
_expand_scenarios_device with the hover warm start, for chosen lanes."""
from __future__ import annotations

import torch

from benchmark.reference import solver


def problems(cfg, x0, goals, forces, halves, lanes):
    """(Z0 (L, N, 17), Problem) of the grid lanes `lanes` (L,) of the
    Cartesian grid goal-major, then force, then box (engine/batch.py's
    order).  x0 (9,), goals (G, 3), forces (F, 3), halves (C, 3): tensors
    in the reference's dtype and device."""
    m = cfg.model
    N, nh = m.N, m.nh
    F, C = forces.shape[0], halves.shape[0]
    L = lanes.shape[0]
    g = goals[lanes // (F * C)]
    f = forces[(lanes // C) % F]
    ch = halves[lanes % C]
    dirv = g[:, :2] - x0[None, :2]
    yaw = torch.where(torch.linalg.vector_norm(dirv, dim=-1) > 1e-6,
                      torch.atan2(dirv[:, 1], dirv[:, 0]),
                      torch.zeros((), dtype=g.dtype, device=g.device))
    centers = 0.5 * (x0[None, :3] + g)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    A_one = torch.zeros((nh, 3), dtype=g.dtype, device=g.device)
    A_one[0:6:2] = eye
    A_one[1:6:2] = -eye
    b_one = torch.zeros((L, nh), dtype=g.dtype, device=g.device)
    b_one[:, 0:6:2] = centers + ch
    b_one[:, 1:6:2] = -(centers - ch)
    w = solver.stage_weights(cfg.weights, N, False, g.dtype, g.device)
    prob = solver.Problem(
        xinit=x0[None].expand(L, 9), ref_pos=g[:, None].expand(L, N, 3),
        ref_yaw=yaw[:, None].expand(L, N), f_ext=f,
        corridor_A=A_one[None, None].expand(L, N, nh, 3),
        corridor_b=b_one[:, None].expand(L, N, nh),
        weights=solver.StageWeights(*(a[None].expand(L, N) for a in w)))
    return solver.hover_warm_start(x0[None].expand(L, 9), m, N), prob
