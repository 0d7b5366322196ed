"""Solver result type (port of forces_resilient_planner_tpu/solver/ipm.py:48).

Single solves are served as B = 1 of the lane-major solver
(solver/ipm_lanes.py); the per-lane JAX solver itself is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SolveResult(NamedTuple):
    Z: torch.Tensor          # (B, N, 17) primal solution
    lam: torch.Tensor        # (B, N, 13) equality multipliers (row 0 = init)
    s: torch.Tensor          # (B, N, 64) slacks
    mu_d: torch.Tensor       # (B, N, 64) inequality duals
    exit_code: torch.Tensor  # (B,) 1 optimal / 0 max-iter / -6 NaN / -7 no-progress
    iters: torch.Tensor      # (B,)
    kkt_error: torch.Tensor  # (B,) final max KKT residual
