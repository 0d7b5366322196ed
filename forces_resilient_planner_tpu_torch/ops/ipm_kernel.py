"""One whole monotone IPM iteration: CUDA kernel + plain PyTorch version.

Counterpart of forces_resilient_planner_tpu/ops/ipm_pallas.py.  The
kernel (csrc/ipm_iteration.cu) replaces the Pallas TPU kernel
`_iter_kernel` (ipm_pallas.py:218): per lane it linearizes the dynamics,
evaluates residuals and KKT errors, updates the barrier, factors and
backsolves the Riccati KKT system, takes fraction-to-boundary steps and
applies the NaN guard and the masked state update.

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
NZ, NXB, NU, NH = 17, 13, 4, 30
NIN = 64  # inequality rows per stage: 17 lb + 17 ub + 30 corridor
N_POINTERS = 23  # 17 inputs, 5 outputs, 1 scratch (see the C entry points)

# kernel launches, over all calls in this process
LAUNCHES = 0

# one scratch buffer per (device, dtype, N, B): ~55 KB per lane at f32
_scratch: dict = {}

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


def _bind(lib):
    lib.ipm_scratch_per_lane.argtypes = [ctypes.c_int]
    lib.ipm_scratch_per_lane.restype = ctypes.c_size_t
    for name in ("ipm_iteration_f32", "ipm_iteration_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * N_POINTERS
            + [ctypes.c_void_p]
        )
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


def _check_inputs(named, dtype, device):
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype or t.device != device:
            raise ValueError(
                f"{name}: {t.dtype} on {t.device}, expected {dtype} on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors only")


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
    if Z.device.type != "cuda":
        raise ValueError(f"no route for tensors on {Z.device}")
    if scfg.mu_superlin != 1.5:
        raise ValueError(
            "the CUDA kernel implements mu_superlin == 1.5 (mu * sqrt(mu)) "
            f"only, got {scfg.mu_superlin}"
        )
    if Z.dtype not in _CONSTS:
        raise ValueError(f"the CUDA kernel takes float32 or float64, not {Z.dtype}")
    N, _, B = Z.shape
    if B == 0 or N < 2:
        raise ValueError(f"need N >= 2 stages and B >= 1 lanes, got {N}, {B}")
    ins = [Z, lam, s, mu_d, scal, *weights, ref_pos, ref_yaw, A, b, f_ext,
           xinit, max_iters_lane]
    names = ["Z", "lam", "s", "mu_d", "scal", *nlp.StageWeights._fields,
             "ref_pos", "ref_yaw", "A", "b", "f_ext", "xinit",
             "max_iters_lane"]
    shapes = (
        [(N, NZ, B), (N, NXB, B), (N, NIN, B), (N, NIN, B), (4, B)]
        + [(N, B)] * 5
        + [(N, 3, B), (N, B), (N, NH, 3, B), (N, NH, B), (3, B), (9, B), (B,)]
    )
    _check_inputs(zip(names, ins, shapes), Z.dtype, Z.device)

    lib = _build.load(SOURCE, _bind)
    struct, entry = _CONSTS[Z.dtype]
    consts = _consts(struct, mcfg, scfg)
    key = (Z.device, Z.dtype, N, B)
    if key not in _scratch:
        _scratch[key] = torch.empty(
            lib.ipm_scratch_per_lane(N) * B, dtype=Z.dtype, device=Z.device
        )
    outs = [torch.empty_like(t) for t in (Z, lam, s, mu_d, scal)]
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = getattr(lib, entry)(
            ctypes.addressof(consts), N, B,
            *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in outs),
            _scratch[key].data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ipm_iteration kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return tuple(outs)
