"""FORCES-Pro-compatible solver interface (drop-in migration surface), torch.

Port of forces_resilient_planner_tpu/solver/forces_api.py.  The reference
ships ctypes Python interfaces for its generated solvers
(solver/normal/interface/FORCESNLPsolver_normal_py.py and
definitions.py:11-60) with the struct layout

    params:  xinit (9,), x0 (340,), all_parameters (2600,), num_of_threads
    outputs: x01..x20, each (17,)
    info:    it, solvetime, fevalstime, res_eq, res_ineq, rdgap, pobj, ...

and the C++ wrappers (forces_normal.cpp:36-140 / forces_final.cpp) pack the
per-stage 130-double parameter block as

    [0:3]    reference position           (index.p.wayPoint)
    [3:6]    external acceleration        (index.p.extForceBias)
    [6:9]    weights w_wp, w_input, w_input_rate   (index.p.weights,
             baked once by setParasNormal, terminal stage overridden)
    [9]      reference yaw                (index.p.yaw)
    [10:100] corridor rows A, 30 x 3 row-major    (index.p.polyConstA)
    [100:130] tube-tightened offsets b - ||E a^T||  (index.p.polyConstb,
             tightening done by the wrapper, forces_normal.cpp:111-136)

The structs stay numpy (the reference's flat host layout); a solve runs as
B = 1 of the lane-major solver (solver/ipm_lanes.py), so on a CUDA device
every monotone iteration is one launch of the IPM kernel (K1) and a
predictor-corrector configuration launches the Riccati kernels (K4a, K4b).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import (
    DEFAULT_CONFIG,
    PlannerConfig,
)
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu_torch.utils import trace

# dimensions (setup.m:30-40, FORCESNLPsolver_normal.h:153-168)
N = 20
NVAR = 17
NX = 9
NH = 30
NUM_PRE_PARAMS = 10
NPAR_STAGE = NUM_PRE_PARAMS + 4 * NH     # 130
NPAR_TOTAL = N * NPAR_STAGE              # 2600
X0_TOTAL = N * NVAR                      # 340

# exit codes, the reference's return-code families
# (FORCESNLPsolver_normal.h:110-139).  TIMEOUT (2), the parameter errors
# (-4, -11, -12) and LICENSE_ERROR (-100) cannot occur: there is no
# wall-clock cap, shapes are fixed, and there is no license.
OPTIMAL = 1          # converged within desired accuracy
MAXITREACHED = 0     # iteration budget exhausted, still progressing
BADFUNCEVAL = -6     # NaN/Inf encountered (in-loop guard tripped)
NOPROGRESS = -7      # no progress: inequality residual stuck
#                      (primal-infeasibility certificate, e.g. an empty
#                      tube-tightened corridor)
EXIT_NAMES = {
    OPTIMAL: "OPTIMAL",
    MAXITREACHED: "MAXITREACHED",
    BADFUNCEVAL: "BADFUNCEVAL",
    NOPROGRESS: "NOPROGRESS",
}


@dataclasses.dataclass
class ForcesParams:
    """Mirror of FORCESNLPsolver_normal_params (definitions.py:11-35)."""

    xinit: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NX)
    )
    x0: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(X0_TOTAL)
    )
    all_parameters: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NPAR_TOTAL)
    )
    num_of_threads: int = 1   # accepted for layout parity; ignored (the
    #                           batch dimension is the card's parallelism)


@dataclasses.dataclass
class ForcesInfo:
    """Mirror of FORCESNLPsolver_normal_info (definitions.py:43-60)."""

    it: int = 0
    solvetime: float = 0.0
    fevalstime: float = 0.0
    res_eq: float = 0.0
    res_ineq: float = 0.0
    rdgap: float = 0.0
    pobj: float = 0.0


def set_stage_weights(
    params: ForcesParams,
    w_stage_wp: float,
    w_stage_input: float,
    w_input_rate: float,
    w_terminal_wp: float,
    w_terminal_input: float,
) -> None:
    """setParasNormal/setParasFinal analog (forces_normal.cpp:36-52): bake
    the weights into all_parameters slots 6-8, terminal stage overridden."""
    ap = params.all_parameters.reshape(N, NPAR_STAGE)
    ap[:, 6] = w_stage_wp
    ap[:, 7] = w_stage_input
    ap[:, 8] = w_input_rate
    ap[N - 1, 6] = w_terminal_wp
    ap[N - 1, 7] = w_terminal_input


def pack_stage_params(
    params: ForcesParams,
    ref_pos: np.ndarray,        # (N, 3)
    ref_yaw: np.ndarray,        # (N,)
    external_acc: np.ndarray,   # (3,)
    corridor_A: np.ndarray,     # (N, nh, 3), zero rows = inactive
    corridor_b: np.ndarray,     # (N, nh) raw offsets
    tube_E: np.ndarray | None = None,   # (N, 3, 3) uncertainty sqrt matrices
) -> None:
    """solveNormal's per-stage packing loop (forces_normal.cpp:74-137),
    including the tube tightening b_tilde = b - ||E a^T|| applied to rows
    with nonzero normals (lines 111-136)."""
    ap = params.all_parameters.reshape(N, NPAR_STAGE)
    ap[:, 0:3] = ref_pos
    ap[:, 3:6] = external_acc[None, :]
    ap[:, 9] = ref_yaw
    A = np.asarray(corridor_A, float)
    b = np.asarray(corridor_b, float).copy()
    if tube_E is not None:
        Ea = np.einsum("nij,nkj->nki", np.asarray(tube_E, float), A)
        shrink = np.linalg.norm(Ea, axis=-1)
        active = np.linalg.norm(A, axis=-1) > 0
        b = np.where(active, b - shrink, 0.0)
    ap[:, NUM_PRE_PARAMS:NUM_PRE_PARAMS + 3 * NH] = A.reshape(N, 3 * NH)
    ap[:, NUM_PRE_PARAMS + 3 * NH:] = b


def pack_warm_start(params: ForcesParams, Z: np.ndarray) -> None:
    """x0 packing: stage-major (N, 17) -> flat 340 (forces_normal.cpp:74-97)."""
    params.x0[:] = np.asarray(Z, float).reshape(X0_TOTAL)


def unpack_params(
    params: ForcesParams, cfg: PlannerConfig, final: bool,
    dtype=torch.float64, *, device,
) -> Tuple[torch.Tensor, nlp.NLPParams]:
    """FORCES parameter block -> (Z0 (N, 17), NLPParams) on `device`.

    The weights travel IN the parameter block (slots 6-8), so the stage
    weight table is built from them, not from the config; the implicit
    cost terms the generated solver hard-codes relative to those weights
    (12*w_wp yaw, stage-1 10*w_input u_prev penalty, final-profile
    20*w_wp terminal braking; mpc_objective*.m) are reproduced here.
    """
    ap = np.asarray(params.all_parameters, float).reshape(N, NPAR_STAGE)
    w_wp = ap[:, 6].copy()
    w_in = ap[:, 7].copy()
    w_rate = ap[:, 8].copy()
    w_vel = np.zeros(N)
    if final:
        w_vel[-1] = cfg.weights.final_brake_factor * w_wp[-1]
    w_uprev0 = np.zeros(N)
    w_uprev0[0] = cfg.weights.stage1_uprev_factor * w_in[0]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    p = nlp.NLPParams(
        xinit=t(params.xinit),
        ref_pos=t(ap[:, 0:3]),
        ref_yaw=t(ap[:, 9]),
        f_ext=t(ap[0, 3:6]),
        corridor_A=t(
            ap[:, NUM_PRE_PARAMS:NUM_PRE_PARAMS + 3 * NH].reshape(N, NH, 3)),
        corridor_b=t(ap[:, NUM_PRE_PARAMS + 3 * NH:]),
        weights=nlp.StageWeights(*(t(a) for a in (
            w_wp, w_in, w_rate, w_vel, w_uprev0))),
    )
    return t(params.x0).reshape(N, NVAR), p


class ForcesSolver:
    """FORCESNLPsolver_normal/_final-shaped entry point.

    >>> solver = ForcesSolver("normal", device="cpu")
    >>> params = ForcesParams()
    >>> solver.set_params(15.0, 3.0, 80.0, 15.0, 0.0)   # setParasNormal
    >>> ... pack xinit / x0 / per-stage params ...
    >>> output, exitflag, info = solver.solve(params)
    >>> output["x01"]        # (17,) stage-1 solution, z = [u, u_prev, x]

    device None means the card ("cuda"); there is no fallback to the CPU.
    """

    def __init__(
        self,
        profile: str = "normal",
        cfg: PlannerConfig = DEFAULT_CONFIG,
        dtype=torch.float64,
        *,
        device=None,
    ):
        if profile not in ("normal", "final"):
            raise ValueError(f"unknown profile {profile!r}")
        self.profile = profile
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device("cuda" if device is None else device)
        self._pending_weights = None

    def set_params(self, *weights) -> None:
        """Kept for call-site parity; weights are read from the parameter
        block at solve time, so this is pack-only (use set_stage_weights)."""
        self._pending_weights = weights

    def solve(
        self, params: ForcesParams
    ) -> Tuple[Dict[str, np.ndarray], int, ForcesInfo]:
        with trace.span("api"):
            if self._pending_weights is not None:
                set_stage_weights(params, *self._pending_weights)
                self._pending_weights = None
            mcfg, scfg = self.cfg.model, self.cfg.solver
            Z0, p = unpack_params(
                params, self.cfg, final=(self.profile == "final"),
                dtype=self.dtype, device=self.device,
            )
            t0 = time.perf_counter()
            res = ipm_lanes.solve_batch_lanes_tiered(
                Z0[None], ipm_lanes._map_params(lambda a: a[None], p), mcfg,
                scfg,
            )
            Zt = res.Z[0]
            Z = Zt.cpu().double().numpy()
            dt = time.perf_counter() - t0

            out = {f"x{i + 1:02d}": Z[i] for i in range(N)}
            H = nlp.stage_hessians(p.weights, mcfg, self.dtype)
            c = nlp.dynamics_residuals(Zt, p, mcfg)
            lb, ub = nlp.variable_bounds(mcfg, self.dtype, device=self.device)
            g = nlp.inequality_residuals(Zt, p, lb, ub, scfg.corridor_slack)
            info = ForcesInfo(
                it=int(res.iters[0]),
                solvetime=dt,
                fevalstime=0.0,
                res_eq=float(c.abs().max()),
                res_ineq=float(g.clamp(min=0.0).max()),
                rdgap=float(res.kkt_error[0]),
                pobj=float(nlp.cost_value(Zt, p, H)),
            )
            return out, int(res.exit_code[0]), info
