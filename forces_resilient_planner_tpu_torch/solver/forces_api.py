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

Around that solve, a card's route issues little: the structs go over in
one copy of one staged buffer, the info struct (residuals, cost) is one
replay of a CUDA graph captured at the instance's first solve, and the
answers come back in one copy and one wait.  It gives the same bits as
the eager route, which issues each operation on its own and is what the
CPU runs.
"""
from __future__ import annotations

import dataclasses
import math
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


def _param_arrays(
    params: ForcesParams, cfg: PlannerConfig, final: bool,
) -> Dict[str, np.ndarray]:
    """The FORCES structs as the solver's inputs, float64 numpy, keyed and
    ordered as _STAGED.

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
    return dict(
        xinit=params.xinit,
        x0=params.x0,
        ref_pos=ap[:, 0:3],
        ref_yaw=ap[:, 9],
        f_ext=ap[0, 3:6],
        corridor_A=ap[:, NUM_PRE_PARAMS:NUM_PRE_PARAMS + 3 * NH].reshape(
            N, NH, 3),
        corridor_b=ap[:, NUM_PRE_PARAMS + 3 * NH:],
        w_wp=w_wp, w_input=w_in, w_rate=w_rate, w_vel=w_vel,
        w_uprev0=w_uprev0,
    )


def _nlp_of(f: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, nlp.NLPParams]:
    """(Z0 (N, 17), NLPParams) of _param_arrays' fields as tensors."""
    return f["x0"].reshape(N, NVAR), nlp.NLPParams(
        xinit=f["xinit"],
        ref_pos=f["ref_pos"],
        ref_yaw=f["ref_yaw"],
        f_ext=f["f_ext"],
        corridor_A=f["corridor_A"],
        corridor_b=f["corridor_b"],
        weights=nlp.StageWeights(*(f[k] for k in nlp.StageWeights._fields)),
    )


def unpack_params(
    params: ForcesParams, cfg: PlannerConfig, final: bool,
    dtype=torch.float64, *, device,
) -> Tuple[torch.Tensor, nlp.NLPParams]:
    """FORCES parameter block -> (Z0 (N, 17), NLPParams) on `device`, a
    tensor a field (see _param_arrays)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _nlp_of(
        {k: t(a) for k, a in _param_arrays(params, cfg, final).items()})


# ---------------------------------------------------------------------------
# the card's route: one copy in, the info struct as one graph replay, one
# copy out
# ---------------------------------------------------------------------------

GRAPH_REPLAYS = 0       # solves whose info struct ran as a CUDA-graph replay

# One solve's inputs as staged, in order: (field, shape).  Each field
# starts on a _FIELD_ALIGN-byte boundary, as a fresh allocation does, so
# every kernel sees the same alignment as in the eager route.
_STAGED = (
    ("xinit", (NX,)),
    ("x0", (N, NVAR)),
    ("ref_pos", (N, 3)),
    ("ref_yaw", (N,)),
    ("f_ext", (3,)),
    ("corridor_A", (N, NH, 3)),
    ("corridor_b", (N, NH)),
    *((name, (N,)) for name in nlp.StageWeights._fields),
)
_FIELD_ALIGN = 512
# the packed info tensor: Z, then these, all in the solver's dtype
_PACKED = ("it", "exitflag", "res_eq", "res_ineq", "rdgap", "pobj")


class _Staged:
    """One solve's inputs in one buffer of the solver's dtype.  numpy casts
    the structs into a host copy (pinned on a card; the cast rounds to
    nearest, as torch.as_tensor's does), one copy moves it to a static
    device buffer, and the solver reads views of that buffer (`Z0`, `p`)."""

    def __init__(self, dtype, device: torch.device):
        step = _FIELD_ALIGN // torch.empty((), dtype=dtype).element_size()
        self.slots, size = {}, 0     # name -> (offset, size, shape)
        for name, shape in _STAGED:
            n = math.prod(shape)
            self.slots[name] = (size, n, shape)
            size += -(-n // step) * step
        self.host = torch.zeros(size, dtype=dtype,
                                pin_memory=device.type == "cuda")
        self.dev = torch.zeros(size, dtype=dtype, device=device)
        self._host_np = self.host.numpy()
        self.Z0, self.p = _nlp_of({
            name: self.dev[o:o + n].view(shape)
            for name, (o, n, shape) in self.slots.items()
        })

    def load(self, arrays: Dict[str, np.ndarray]) -> None:
        """Stage _param_arrays' output; the copy to the device is queued
        on the current stream (the solve that reads it follows there).
        The host buffer is free to write: every solve ends in a wait."""
        for name, (o, n, _) in self.slots.items():
            self._host_np[o:o + n] = np.asarray(arrays[name]).reshape(n)
        self.dev.copy_(self.host, non_blocking=True)


def packed_info(Z, iters, exit_code, kkt_error, p: nlp.NLPParams, lb, ub,
                mcfg, scfg) -> torch.Tensor:
    """[Z (N * 17) | _PACKED] in Z's dtype: the eager route's info struct
    (ForcesSolver._solve_eager), each field by the same operations, with
    iters, exit_code and kkt_error the solve's (1,) results."""
    H = nlp.stage_hessians(p.weights, mcfg, Z.dtype)
    c = nlp.dynamics_residuals(Z, p, mcfg)
    g = nlp.inequality_residuals(Z, p, lb, ub, scfg.corridor_slack)
    return torch.cat([
        Z.reshape(-1), iters.to(Z.dtype), exit_code.to(Z.dtype),
        c.abs().max()[None], g.clamp(min=0.0).max()[None], kkt_error,
        nlp.cost_value(Z, p, H)[None],
    ])


def _unpacked(h: np.ndarray, solvetime: float):
    """(out, exitflag, ForcesInfo) of packed_info's values on the host."""
    Z = h[:X0_TOTAL].astype(np.float64).reshape(N, NVAR)
    v = dict(zip(_PACKED, (float(x) for x in h[X0_TOTAL:])))
    info = ForcesInfo(
        it=int(v["it"]), solvetime=solvetime, fevalstime=0.0,
        res_eq=v["res_eq"], res_ineq=v["res_ineq"], rdgap=v["rdgap"],
        pobj=v["pobj"],
    )
    return ({f"x{i + 1:02d}": Z[i] for i in range(N)}, int(v["exitflag"]),
            info)


class _InfoGraph:
    """packed_info over static inputs, captured once as a CUDA graph after
    one eager warm-up.  `run(res)` copies a solve's result into the inputs,
    replays the graph and brings the packed tensor to pinned host memory
    with one wait."""

    def __init__(self, p: nlp.NLPParams, lb, ub, mcfg, scfg, dtype,
                 device: torch.device):
        self.Z = torch.zeros((N, NVAR), dtype=dtype, device=device)
        self.iters = torch.zeros(1, dtype=torch.int32, device=device)
        self.exit_code = torch.zeros(1, dtype=torch.int32, device=device)
        self.kkt = torch.zeros(1, dtype=dtype, device=device)
        self.host = torch.zeros(X0_TOTAL + len(_PACKED), dtype=dtype,
                                pin_memory=True)
        # the graph reads these tensors' memory: hold every one of them
        self.args = args = (self.Z, self.iters, self.exit_code, self.kkt, p,
                            lb, ub, mcfg, scfg)
        # warm-up and capture on one side stream (one more cuBLAS
        # workspace); unlike torch.cuda.graph, no gc.collect or
        # empty_cache first: the graph needs a few kB
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            packed_info(*args)
            self.graph.capture_begin()
            try:
                self.out = packed_info(*args)
            finally:
                self.graph.capture_end()
        stream.wait_stream(side)

    def run(self, res: ipm_lanes.SolveResult) -> np.ndarray:
        global GRAPH_REPLAYS
        self.Z.copy_(res.Z[0])
        self.iters.copy_(res.iters)
        self.exit_code.copy_(res.exit_code)
        self.kkt.copy_(res.kkt_error)
        self.graph.replay()
        GRAPH_REPLAYS += 1
        self.host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.out.device).synchronize()
        return self.host.numpy()


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
        self._staged = None     # the card's route: _Staged, _InfoGraph
        self._info = None

    def set_params(self, *weights) -> None:
        """Kept for call-site parity; weights are read from the parameter
        block at solve time, so this is pack-only (use set_stage_weights)."""
        self._pending_weights = weights

    def solve(
        self, params: ForcesParams
    ) -> Tuple[Dict[str, np.ndarray], int, ForcesInfo]:
        """Solve one packed problem: (outputs, exitflag, info).  On a card
        the inputs go over in one copy and the info struct is one graph
        replay (_solve_graphed); elsewhere every operation is issued on its
        own (_solve_eager).  Both give the same bits."""
        with trace.span("api"):
            if self._pending_weights is not None:
                set_stage_weights(params, *self._pending_weights)
                self._pending_weights = None
            if self.device.type == "cuda":
                return self._solve_graphed(params)
            return self._solve_eager(params)

    def _solve_graphed(self, params: ForcesParams):
        mcfg, scfg = self.cfg.model, self.cfg.solver
        if self._staged is None:
            self._staged = _Staged(self.dtype, self.device)
        staged = self._staged
        staged.load(_param_arrays(params, self.cfg,
                                  final=(self.profile == "final")))
        t0 = time.perf_counter()
        res = ipm_lanes.solve_batch_lanes_tiered(
            staged.Z0[None],
            ipm_lanes._map_params(lambda a: a[None], staged.p), mcfg, scfg,
        )
        if self._info is None:
            lb, ub = nlp.variable_bounds(mcfg, self.dtype, device=self.device)
            self._info = _InfoGraph(staged.p, lb, ub, mcfg, scfg, self.dtype,
                                    self.device)
        h = self._info.run(res)
        return _unpacked(h, time.perf_counter() - t0)

    def _solve_eager(self, params: ForcesParams):
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
