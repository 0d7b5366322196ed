"""Riccati factor and backsolve of the IPM's KKT system: CUDA kernels and
their plain PyTorch versions.

Counterpart of forces_resilient_planner_tpu/ops/lqr_pallas.py.  The
kernels of csrc/lqr.cu replace its four Pallas TPU kernels:

  K4a lqr_factor_fused_lanes     _lqr_factor_fused_kernel (lqr_pallas.py:269)
  K4b lqr_backsolve_fused_lanes  _lqr_solve_fused_kernel  (lqr_pallas.py:316)
  K5a lqr_factor_lanes           _lqr_factor_kernel       (lqr_pallas.py:100)
  K5b lqr_backsolve_lanes        _lqr_solve_kernel        (lqr_pallas.py:132)

K4 assembles the barrier-weighted stage QP blocks and the augmented
dynamics [[Ax, 0], [0, 0]], [[Bx], [I4]] itself, from the stage weight
tables, the barrier sigmas, the corridor rows and the RK2 Jacobians:
solver/ipm_lanes.py::lane_step runs it where K1 is off (the Mehrotra
predictor-corrector, corridors of other than 30 rows).  K4 runs a warp per
lane and up to MAX_LANES lanes per CTA, each lane's working set in shared
memory (csrc/lqr.cu's header says how); `launch_geometry` gives the lanes,
threads and shared memory per CTA for a kernel, dtype and horizon.  K5
reads pre-assembled Q/R/S/A/B blocks and runs K4's recursion on the same
design, with K4's factor body and backsolve kernel; solve_lqr_lanes joins
K5a and K5b behind solver/riccati.py::solve_lqr_batched.

Route by device: a CPU tensor runs the plain version beside each wrapper
(`*_reference`).  Any other tensor is checked (1 <= nh <= 30 here, the
rest by ops/_build.py::route) and then launches the kernel if it lies on
CUDA, or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.ops import _build
from forces_resilient_planner_tpu_torch.solver import nlp, riccati
from forces_resilient_planner_tpu_torch.solver.riccati import (
    LQRFactor,
    LQRSolution,
)
from forces_resilient_planner_tpu_torch.utils.lanes import sum_dim

SOURCE = "lqr.cu"
NX, NXB, NU = 9, 13, 4
NH = 30  # the most corridor rows per stage K4 takes
WARP = 32               # threads per lane
MAX_LANES = 8           # lanes per CTA
SMEM_PER_CTA = 232_448  # shared memory one CTA may use on sm_90 (bytes)

# kernel launches per kernel, over all calls in this process
LAUNCHES = dict.fromkeys(
    ("lqr_factor_fused", "lqr_backsolve_fused", "lqr_factor", "lqr_backsolve"),
    0,
)

_SUFFIX = {torch.float32: ("f32", ctypes.c_float),
           torch.float64: ("f64", ctypes.c_double)}


def _bind(lib):
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.lqr_lane_elements.argtypes = [i, i, i]
    lib.lqr_lane_elements.restype = i
    for suffix, ctype in _SUFFIX.values():
        # (N, B[, nh, reg, rmax2], lanes_log2, stride), inputs, outputs,
        # stream
        for name in LAUNCHES:
            fn = getattr(lib, f"{name}_{suffix}")
            scalars = [i, ctype, ctype] if name == "lqr_factor_fused" else []
            fn.argtypes = [i, i, *scalars, i, i, p, p, p]
            fn.restype = i


# ---------------------------------------------------------------------------
# the launch geometry (csrc/lqr.cu: fac_layout, solve_layout)
# ---------------------------------------------------------------------------

class Geometry(NamedTuple):
    lanes: int    # lanes per CTA, a power of two
    threads: int  # threads per CTA: a warp per lane
    smem: int     # bytes of shared memory per CTA
    stride: int   # values of the dtype between two lanes' memory


def lane_elements(N: int, backsolve: bool = False,
                  blocks: bool = False) -> int:
    """Values of one lane's shared-memory layout at horizon N: K4a's, or
    with backsolve K4b's, or with blocks K5a's / K5b's.
    The factor (csrc/lqr.cu::fac_layout): every stage's 24 QP values (K5a:
    two stages' [Q; R; S], 237 values each), two stages' G = [A | B] (13 x
    17), two P (P_{i+1}; Qh, then P_i), [AtP; BtP] and a zero row (18 x 13),
    Sh, Rh, two K, two packed factors of Rh, RiS, cRt.  The backsolve
    (solve_layout): the p / nu and k stacks, three dxb and two du, two
    stage blocks (P, Ax and Bx (K5b: A and B), c, qx, qu, K, cRh), Pc,
    qxh / quh, RiS and R^{-1} qu."""
    nn, g = NXB * NXB, NXB * (NXB + NU)
    if backsolve:
        dyn = nn + NXB * NU if blocks else NX * NX + NX * NU
        block = nn + dyn + NXB + NXB + NU + NU * NXB + 10
        return (N * NXB + (N - 1) * NU + 3 * NXB + 2 * NU + 2 * block
                + NXB + NXB + NU + NU * NXB + NU)
    qp = 2 * (nn + NU * NU + NU * NXB) if blocks else N * (NXB + 6 + NU + 1)
    return (qp + 2 * g + 2 * nn + 18 * NXB
            + NU * NXB + NU * NU + 2 * NU * NXB + 2 * 10 + NU * NXB + 10)


def launch_geometry(dtype, N: int, backsolve: bool = False,
                    max_lanes: int = MAX_LANES,
                    blocks: bool = False) -> Geometry:
    """K4a's geometry at `dtype` and horizon N (with backsolve K4b's, with
    blocks K5a's or K5b's): the most lanes per CTA, a power of two up to
    max_lanes, whose memory fits in SMEM_PER_CTA.  The stride pads a lane
    to a multiple of 32 values plus 32 / lanes, so that the CTA's copies,
    which give a warp 32 / lanes rows of every lane, spread over the
    shared-memory banks."""
    if N < 2:
        raise ValueError(f"need N >= 2 stages, got {N}")
    if dtype not in _SUFFIX:
        raise ValueError(f"the CUDA kernels take float32 or float64, not {dtype}")
    size = torch.empty((), dtype=dtype).element_size()
    elements = -(-lane_elements(N, backsolve, blocks) // 32) * 32
    lanes = max_lanes
    while lanes > 1 and lanes * (elements + WARP // lanes) * size > SMEM_PER_CTA:
        lanes //= 2
    stride = elements + WARP // lanes
    if stride * size > SMEM_PER_CTA:
        raise ValueError(
            f"one lane at N = {N} needs {stride * size} B of shared memory, "
            f"more than a CTA's {SMEM_PER_CTA} B at {dtype}"
        )
    return Geometry(lanes, WARP * lanes, lanes * stride * size, stride)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _assemble_qp_blocks(w: nlp.StageWeights, A, sigma, reg, rmax2):
    """Partitioned barrier-weighted stage Hessian, assembled directly:
    W = H + J_g^T diag(sigma) J_g + reg*I, in the Riccati partition
    xbar = [x(9), u_prev(4)], u(4):  Wp (N,13,13,B), Rp (N,4,4,B),
    Sp (N,4,13,B)."""
    N, _, _, B = A.shape
    dtype, device = A.dtype, A.device
    sig_u = sigma[:, 0:4] + sigma[:, 17:21]
    sig_up = sigma[:, 4:8] + sigma[:, 21:25]
    sig_x = sigma[:, 8:17] + sigma[:, 25:34]
    sc = sigma[:, 34:]
    w_rate = w.w_rate[:, None]

    r_diag = 2.0 * w_rate + sig_u + reg
    r_diag[:, 0:3] += 2.0 * w.w_input[:, None] / rmax2
    Rp = torch.zeros((N, NU, NU, B), dtype=dtype, device=device)
    for k in range(NU):
        Rp[:, k, k] = r_diag[:, k]

    x_diag = sig_x + reg
    x_diag[:, 0:3] += 2.0 * w.w_wp[:, None]
    x_diag[:, 3:6] += 2.0 * w.w_vel[:, None]
    x_diag[:, 8] += 24.0 * w.w_wp
    up_diag = 2.0 * w_rate + sig_up + reg
    up_diag[:, 0:3] += 2.0 * w.w_uprev0[:, None]
    Wp = torch.zeros((N, NXB, NXB, B), dtype=dtype, device=device)
    for k in range(9):
        Wp[:, k, k] = x_diag[:, k]
    for k in range(NU):
        Wp[:, 9 + k, 9 + k] = up_diag[:, k]
    # corridor 3x3 position block: sum_k A_kj sc_k A_kl
    for j in range(3):
        Asj = A[:, :, j] * sc
        for l in range(j, 3):
            blk = sum_dim(Asj * A[:, :, l], 1)
            Wp[:, j, l] += blk
            if l != j:
                Wp[:, l, j] += blk

    Sp = torch.zeros((N, NU, NXB, B), dtype=dtype, device=device)
    for k in range(NU):
        Sp[:, k, 9 + k] = -2.0 * w_rate[:, 0]
    return Wp, Rp, Sp


def _aug_dynamics(Ax, Bx):
    """Abar = [[Ax, 0], [0, 0]] (N-1, 13, 13, B) and Bbar = [[Bx], [I4]]
    (N-1, 13, 4, B): the dynamics of the Riccati state [x, u_prev]."""
    N1, _, _, B = Ax.shape
    dtype, device = Ax.dtype, Ax.device
    Abar = torch.zeros((N1, NXB, NXB, B), dtype=dtype, device=device)
    Abar[:, :9, :9] = Ax
    Bbar = torch.zeros((N1, NXB, NU, B), dtype=dtype, device=device)
    Bbar[:, :9, :] = Bx
    for k in range(NU):
        Bbar[:, 9 + k, k] = 1.0
    return Abar, Bbar


def lqr_factor_fused_reference(w_wp, w_input, w_rate, w_vel, w_uprev0, sigma,
                               Acor, Ax, Bx, reg: float,
                               rmax2: float) -> LQRFactor:
    """Plain PyTorch version of K4a: the stage QP blocks and the augmented
    dynamics assembled in full, then riccati.lqr_factor_ll."""
    w = nlp.StageWeights(w_wp, w_input, w_rate, w_vel, w_uprev0)
    Wp, Rp, Sp = _assemble_qp_blocks(w, Acor, sigma, reg, rmax2)
    Abar, Bbar = _aug_dynamics(Ax, Bx)
    return riccati.lqr_factor_ll(Wp, Rp, Sp, Abar, Bbar)


def lqr_backsolve_fused_reference(fac: LQRFactor, Ax, Bx, c, qx, qu,
                                  dx0) -> LQRSolution:
    """Plain PyTorch version of K4b: riccati.lqr_solve_ll against the
    augmented dynamics."""
    Abar, Bbar = _aug_dynamics(Ax, Bx)
    return riccati.lqr_solve_ll(fac, Abar, Bbar, c, qx, qu, dx0)


# plain PyTorch versions of K5a and K5b
lqr_factor_reference = riccati.lqr_factor_ll
lqr_backsolve_reference = riccati.lqr_solve_ll


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _horizon(N: int, B: int):
    if N < 2 or B < 1:
        raise ValueError(f"need N >= 2 stages and B >= 1 lanes, got {N}, {B}")


def _factor_shapes(N: int, B: int):
    return ((N, NXB, NXB, B), (N - 1, NU, NXB, B), (N - 1, 10, B), (NU, NXB, B),
            (10, B))


def _check_backsolve(fac, d0, d1, c, qx, qu, dx0, d_shapes):
    """The device route's checks of a backsolve's arguments; the library."""
    N, B = qx.shape[0], qx.shape[-1]
    _horizon(N, B)
    named = [("qx", qx, (N, NXB, B))]
    named += [(f"fac.{f}", t, s) for f, t, s in
              zip(LQRFactor._fields, fac, _factor_shapes(N, B))]
    named += [("dynamics[0]", d0, d_shapes[0]), ("dynamics[1]", d1, d_shapes[1]),
              ("c", c, (N - 1, NXB, B)), ("qu", qu, (N, NU, B)),
              ("dx0", dx0, (NX, B))]
    return _build.route(SOURCE, _bind, named)


def _solution_like(qx):
    N, B = qx.shape[0], qx.shape[-1]
    return LQRSolution(qx.new_empty((N, NXB, B)), qx.new_empty((N, NU, B)),
                       qx.new_empty((N, NXB, B)), qx.new_empty((NU, B)))


def launch(lib, name: str, ins, outs, stream, scalars=(),
           max_lanes: int = MAX_LANES):
    """One launch of a kernel of LAUNCHES from `lib` (the nvcc build, or the
    CPU build of the tests) on checked, contiguous tensors, on `stream`:
    K4a ("lqr_factor_fused": ins the nine inputs of lqr_factor_fused_lanes,
    scalars (nh, reg, rmax2)) or K5a ("lqr_factor": ins Q, R, S, A, B),
    outs the LQRFactor fields; K4b ("lqr_backsolve_fused": ins the factor's
    five fields, Ax, Bx, c, qx, qu, dx0) or K5b ("lqr_backsolve": the same
    with A, B), outs the LQRSolution fields.  Raises when the launch
    fails."""
    backsolve = name.startswith("lqr_backsolve")
    blocks = not name.endswith("_fused")
    like = ins[8] if backsolve else ins[0]
    N, B = like.shape[0], like.shape[-1]
    geo = launch_geometry(like.dtype, N, backsolve, max_lanes, blocks)
    if lib.lqr_lane_elements(N, int(backsolve), int(blocks)) > geo.stride:
        raise RuntimeError("csrc/lqr.cu's lane layout outgrew lane_elements()")
    rc = getattr(lib, f"{name}_{_SUFFIX[like.dtype][0]}")(
        N, B, *scalars, geo.lanes.bit_length() - 1, geo.stride,
        (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins)),
        (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs)),
        stream,
    )
    _build.check(rc, name)


def lqr_factor_fused_lanes(w_wp, w_input, w_rate, w_vel, w_uprev0, sigma,
                           Acor, Ax, Bx, reg: float,
                           rmax2: float) -> LQRFactor:
    """K4a: assemble every stage's QP blocks from the weight tables w_*
    (N, B), the barrier sigmas (N, 34 + nh, B) and the corridor rows Acor
    (N, nh, 3, B), the augmented dynamics from Ax (N-1, 9, 9, B) and Bx
    (N-1, 9, 4, B), and factor: LQRFactor (P, K, cRh, RiS, cRt)."""
    if sigma.device.type == "cpu":
        return lqr_factor_fused_reference(w_wp, w_input, w_rate, w_vel,
                                          w_uprev0, sigma, Acor, Ax, Bx, reg,
                                          rmax2)
    N, B = w_wp.shape
    nh = Acor.shape[1]
    _horizon(N, B)
    if not 1 <= nh <= NH:
        raise ValueError(
            f"the kernel takes 1 to {NH} corridor rows per stage, got {nh} "
            "(nor can the JAX K4 take more: lqr_pallas.py:216-217)"
        )
    weights = (w_wp, w_input, w_rate, w_vel, w_uprev0)
    named = [(f, t, (N, B)) for f, t in zip(nlp.StageWeights._fields, weights)]
    named += [("sigma", sigma, (N, 34 + nh, B)), ("Acor", Acor, (N, nh, 3, B)),
              ("Ax", Ax, (N - 1, NX, NX, B)), ("Bx", Bx, (N - 1, NX, NU, B))]
    lib = _build.route(SOURCE, _bind, named)
    fac = LQRFactor(*(sigma.new_empty(s) for s in _factor_shapes(N, B)))
    _build.on_stream(sigma.device, launch, lib, "lqr_factor_fused",
                     [t for _, t, _ in named], fac, scalars=(nh, reg, rmax2))
    LAUNCHES["lqr_factor_fused"] += 1
    return fac


def lqr_backsolve_fused_lanes(fac: LQRFactor, Ax, Bx, c, qx, qu,
                              dx0) -> LQRSolution:
    """K4b: backsolve one right-hand side (c (N-1, 13, B), qx (N, 13, B),
    qu (N, 4, B), dx0 (9, B)) against a K4a factor, with the augmented
    dynamics rebuilt from Ax, Bx: LQRSolution (dxb, du, nu, dtheta)."""
    if qx.device.type == "cpu":
        return lqr_backsolve_fused_reference(fac, Ax, Bx, c, qx, qu, dx0)
    N, B = qx.shape[0], qx.shape[-1]
    lib = _check_backsolve(fac, Ax, Bx, c, qx, qu, dx0,
                           ((N - 1, NX, NX, B), (N - 1, NX, NU, B)))
    sol = _solution_like(qx)
    _build.on_stream(qx.device, launch, lib, "lqr_backsolve_fused",
                     [*fac, Ax, Bx, c, qx, qu, dx0], sol)
    LAUNCHES["lqr_backsolve_fused"] += 1
    return sol


def lqr_factor_lanes(Q, R, S, A, B) -> LQRFactor:
    """K5a: factor pre-assembled blocks Q (N, 13, 13, Bn), R (N, 4, 4, Bn),
    S (N, 4, 13, Bn), A (N-1, 13, 13, Bn), B (N-1, 13, 4, Bn)."""
    if Q.device.type == "cpu":
        return lqr_factor_reference(Q, R, S, A, B)
    N, Bn = Q.shape[0], Q.shape[-1]
    _horizon(N, Bn)
    named = [("Q", Q, (N, NXB, NXB, Bn)), ("R", R, (N, NU, NU, Bn)),
             ("S", S, (N, NU, NXB, Bn)), ("A", A, (N - 1, NXB, NXB, Bn)),
             ("B", B, (N - 1, NXB, NU, Bn))]
    lib = _build.route(SOURCE, _bind, named)
    fac = LQRFactor(*(Q.new_empty(s) for s in _factor_shapes(N, Bn)))
    _build.on_stream(Q.device, launch, lib, "lqr_factor",
                     [t for _, t, _ in named], fac)
    LAUNCHES["lqr_factor"] += 1
    return fac


def lqr_backsolve_lanes(fac: LQRFactor, A, B, c, qx, qu, dx0) -> LQRSolution:
    """K5b: backsolve one right-hand side against a K5a factor with the
    pre-assembled dynamics A, B."""
    if qx.device.type == "cpu":
        return lqr_backsolve_reference(fac, A, B, c, qx, qu, dx0)
    N, Bn = qx.shape[0], qx.shape[-1]
    lib = _check_backsolve(fac, A, B, c, qx, qu, dx0,
                           ((N - 1, NXB, NXB, Bn), (N - 1, NXB, NU, Bn)))
    sol = _solution_like(qx)
    _build.on_stream(qx.device, launch, lib, "lqr_backsolve",
                     [*fac, A, B, c, qx, qu, dx0], sol)
    LAUNCHES["lqr_backsolve"] += 1
    return sol


def solve_lqr_lanes(Q, R, S, qx, qu, A, B, c, dx0) -> LQRSolution:
    """Lane-major LQR solve: K5a, then K5b (lqr_pallas.py:556)."""
    fac = lqr_factor_lanes(Q, R, S, A, B)
    return lqr_backsolve_lanes(fac, A, B, c, qx, qu, dx0)
