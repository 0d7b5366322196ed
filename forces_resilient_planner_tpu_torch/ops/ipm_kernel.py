"""One whole monotone IPM iteration: CUDA kernel + plain PyTorch version.

Counterpart of forces_resilient_planner_tpu/ops/ipm_pallas.py.  The
kernel (csrc/ipm_iteration.cu) replaces the Pallas TPU kernel
`_iter_kernel` (ipm_pallas.py:218): per lane it linearizes the dynamics,
evaluates residuals and KKT errors, updates the barrier, factors and
backsolves the Riccati KKT system, takes fraction-to-boundary steps and
applies the NaN guard and the masked state update.

The kernel runs one team of 64 threads (two warps) per lane and `lanes`
lanes per CTA, each lane's working set in shared memory (csrc/ipm_iteration.cu's
header says how); `launch_geometry` picks the lanes per CTA and the
shared-memory bytes for a dtype and horizon.

Route by device: on a CPU tensor `ipm_iteration_fused` runs
`ipm_iteration_reference` (one monotone step of solver/ipm_lanes.py::
lane_step); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, SolverConfig
from forces_resilient_planner_tpu_torch.ops import _build
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp

SOURCE = "ipm_iteration.cu"
NZ, NXB, NU, NX, NH = 17, 13, 4, 9, 30
NIN = 64  # inequality rows per stage: 17 lb + 17 ub + 30 corridor
N_INPUTS, N_OUTPUTS = 17, 5
TEAM = 64               # threads per lane (two warps)
MAX_LANES = 4           # lanes per CTA: <= 256 threads
SMEM_PER_CTA = 232_448  # shared memory one CTA may use on sm_90 (bytes)

# kernel launches, over all calls in this process
LAUNCHES = 0

_SCALARS = (
    "mass", "g", "drag", "dt", "rmax2", "hu", "tol", "mu_floor", "tol_ref",
    "tau", "mu_gate_factor", "kappa_mu", "reg",
)


def _consts_struct(ctype):
    class IterConsts(ctypes.Structure):
        # layout of IterConsts<T> in csrc/ipm_iteration.cu
        _fields_ = (
            [(name, ctype) for name in _SCALARS]
            + [("lb", ctype * NZ), ("ub", ctype * NZ), ("mu_gate", ctypes.c_int)]
        )
    return IterConsts


_CONSTS = {
    torch.float32: (_consts_struct(ctypes.c_float), "ipm_iteration_f32"),
    torch.float64: (_consts_struct(ctypes.c_double), "ipm_iteration_f64"),
}


def lane_elements(N: int) -> int:
    """Values of one lane's shared-memory layout at horizon N
    (csrc/ipm_iteration.cu::lane_layout): the inputs, the dynamics (Ax, Bx,
    c), grad f / q / dZ, the stage QP blocks, P's upper triangles, K, the
    Cholesky factors, k, p / nu and the phase scratch."""
    n1 = N - 1
    inputs = (NZ + NXB + 2 * NIN + 5 + 3 + 1 + 3 * NH + NH) * N + 4 + 3 + NX + 1
    per_gap = NX * NX + NX * NU + NXB + NU * NXB + 10 + NU
    stage_blocks = NXB + 6 + NU + 1
    per_stage = NZ + stage_blocks + NXB * (NXB + 1) // 2 + NXB
    factor_scratch = 3 * NXB * NXB + NU * NU + 2 * NU * NXB
    reductions = 2 * 16
    return (inputs + 2 * NZ + reductions + n1 * per_gap + N * per_stage
            + NU * NXB + 10 + max(factor_scratch, NH * N))


def launch_geometry(dtype, N: int, max_lanes: int = MAX_LANES):
    """(lanes per CTA, shared-memory bytes per CTA, lane stride in values)
    for the kernel at `dtype` and horizon N: the most lanes, a power of two
    up to max_lanes, whose stacks fit in SMEM_PER_CTA.  The stride pads a
    lane to a multiple of 32 values plus 8, so that the CTA's copy of row
    r for consecutive lanes spreads over the shared-memory banks."""
    if N < 2:
        raise ValueError(f"need N >= 2 stages, got {N}")
    if dtype not in _CONSTS:
        raise ValueError(f"the CUDA kernel takes float32 or float64, not {dtype}")
    stride = -(-lane_elements(N) // 32) * 32 + 8
    per_lane = stride * torch.empty((), dtype=dtype).element_size()
    lanes = 1
    while 2 * lanes <= max_lanes and 2 * lanes * per_lane <= SMEM_PER_CTA:
        lanes *= 2
    if per_lane > SMEM_PER_CTA:
        raise ValueError(
            f"one lane at N = {N} needs {per_lane} B of shared memory, more "
            f"than a CTA's {SMEM_PER_CTA} B at {dtype}"
        )
    return lanes, lanes * per_lane, stride


def _bind(lib):
    lib.ipm_lane_elements.argtypes = [ctypes.c_int]
    lib.ipm_lane_elements.restype = ctypes.c_int
    for name in ("ipm_iteration_f32", "ipm_iteration_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int


def _consts(struct, mcfg: ModelConfig, scfg: SolverConfig):
    lb, ub = nlp.variable_bounds(mcfg, torch.float64, device="cpu")
    tol = max(scfg.tol_stat, scfg.tol_eq, scfg.tol_ineq, scfg.tol_comp)
    return struct(
        mass=mcfg.mass, g=mcfg.g, drag=mcfg.drag_coeff, dt=mcfg.dt,
        rmax2=mcfg.max_rate ** 2, hu=scfg.corridor_slack, tol=tol,
        mu_floor=tol / 20.0, tol_ref=1e-4, tau=scfg.frac_to_boundary,
        mu_gate_factor=scfg.mu_gate_factor, kappa_mu=scfg.kappa_mu,
        reg=scfg.reg, lb=tuple(lb.tolist()), ub=tuple(ub.tolist()),
        mu_gate=int(scfg.mu_gate),
    )


def _check_monotone(scfg: SolverConfig):
    if scfg.predictor_corrector:
        raise ValueError(
            "ipm_iteration_fused is one monotone iteration; the "
            "predictor-corrector path is solver/ipm_lanes.py::lane_step"
        )


def ipm_iteration_reference(
    Z, lam, s, mu_d, scal, weights: nlp.StageWeights, ref_pos, ref_yaw,
    A, b, f_ext, xinit, max_iters_lane, mcfg: ModelConfig, scfg: SolverConfig,
):
    """Plain PyTorch version of the kernel: one monotone step of
    ipm_lanes.lane_step (its Riccati sweeps plain too, on any device), with
    the lane state packed as the kernel packs it (scal (4, B) =
    [mu, it, done, err] in the working dtype)."""
    _check_monotone(scfg)
    params = nlp.NLPParams(xinit, ref_pos, ref_yaw, f_ext, A, b, weights)
    st = (Z, lam, s, mu_d, scal[0], scal[1], scal[2] > 0.5, scal[3])
    Zn, lamn, sn, mudn, mu, it, done, err = ipm_lanes.lane_step(
        st, params, mcfg, scfg, max_iters_lane, plain=True
    )
    return Zn, lamn, sn, mudn, torch.stack([mu, it, done.to(Z.dtype), err])


def ipm_iteration_fused(
    Z, lam, s, mu_d, scal,          # lane-major state; scal (4, B)
    weights: nlp.StageWeights,      # (N, B) tables
    ref_pos, ref_yaw,               # (N, 3, B), (N, B)
    A, b,                           # (N, 30, 3, B), (N, 30, B)
    f_ext,                          # (3, B) — dynamics run in the kernel
    xinit,                          # (9, B)
    max_iters_lane,                 # (B,) per-lane iteration cap
    mcfg: ModelConfig, scfg: SolverConfig,
):
    """One fused IPM iteration; returns (Z', lam', s', mu_d', scal')."""
    global LAUNCHES
    _check_monotone(scfg)
    if Z.device.type == "cpu":
        return ipm_iteration_reference(
            Z, lam, s, mu_d, scal, weights, ref_pos, ref_yaw, A, b, f_ext,
            xinit, max_iters_lane, mcfg, scfg,
        )
    if scfg.mu_superlin != 1.5:
        raise ValueError(
            "the CUDA kernel implements mu_superlin == 1.5 (mu * sqrt(mu)) "
            f"only, got {scfg.mu_superlin}"
        )
    N, _, B = Z.shape
    if B == 0 or N < 2:
        raise ValueError(f"need N >= 2 stages and B >= 1 lanes, got {N}, {B}")
    named = [("Z", Z, (N, NZ, B)), ("lam", lam, (N, NXB, B)),
             ("s", s, (N, NIN, B)), ("mu_d", mu_d, (N, NIN, B)),
             ("scal", scal, (4, B))]
    named += [(f, t, (N, B)) for f, t in zip(nlp.StageWeights._fields, weights)]
    named += [("ref_pos", ref_pos, (N, 3, B)), ("ref_yaw", ref_yaw, (N, B)),
              ("A", A, (N, NH, 3, B)), ("b", b, (N, NH, B)),
              ("f_ext", f_ext, (3, B)), ("xinit", xinit, (9, B)),
              ("max_iters_lane", max_iters_lane, (B,))]
    lib = _build.route(SOURCE, _bind, named)
    outs = [torch.empty_like(t) for t in (Z, lam, s, mu_d, scal)]
    _build.on_stream(Z.device, launch, lib, [t for _, t, _ in named], outs,
                     mcfg, scfg)
    LAUNCHES += 1
    return tuple(outs)


def launch(lib, ins, outs, mcfg: ModelConfig, scfg: SolverConfig, stream,
           max_lanes: int = MAX_LANES):
    """Launch the library's kernel on checked, contiguous lane-major tensors
    (ins: the 17 inputs of ipm_iteration_fused in order, outs: the 5
    outputs) on `stream`; raises on a refused launch."""
    Z = ins[0]
    N, _, B = Z.shape
    lanes, _, stride = launch_geometry(Z.dtype, N, max_lanes)
    if lib.ipm_lane_elements(N) > stride:
        raise RuntimeError("csrc/ipm_iteration.cu's lane layout outgrew "
                           "lane_elements()")
    struct, entry = _CONSTS[Z.dtype]
    consts = _consts(struct, mcfg, scfg)
    rc = getattr(lib, entry)(
        ctypes.addressof(consts), N, B, lanes.bit_length() - 1, stride,
        (ctypes.c_void_p * N_INPUTS)(*(t.data_ptr() for t in ins)),
        (ctypes.c_void_p * N_OUTPUTS)(*(t.data_ptr() for t in outs)),
        stream,
    )
    _build.check(rc, "ipm_iteration")
