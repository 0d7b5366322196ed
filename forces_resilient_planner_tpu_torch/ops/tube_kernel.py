"""Per-stage tube math over stage lanes: CUDA kernel + plain PyTorch version.

Counterpart of forces_resilient_planner_tpu/ops/tube_pallas.py.  The
kernel (csrc/tube_stage.cu) replaces the Pallas TPU kernel `_tube_kernel`
(tube_pallas.py:65): per stage lane it forms Phi = Jc + Bc K, the three
disturbance-channel Gramians and e^{Phi dt} by the scaled Taylor series
and doublings, the trace-normalized Qd and the ego ellipsoid Q1.

Route by device: on a CPU tensor `tube_stage_lanes` runs
`tube_stage_reference` (the formulas of tube/lyapunov.py); on a CUDA
tensor it launches the kernel or raises.  Unlike the JAX package there is
no batch-size gate: one lane on the card runs the kernel too.
"""
from __future__ import annotations

import ctypes

import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, TubeConfig
from forces_resilient_planner_tpu_torch.ops import _build
from forces_resilient_planner_tpu_torch.tube import lyapunov

SOURCE = "tube_stage.cu"
NX = 9

# kernel launches, over all calls in this process
LAUNCHES = 0

# the Taylor length each instantiation is launched with (= the plain
# path's lyapunov.taylor_n_terms; csrc/tube_stage.cu's TUBE_ENTRY lines)
N_TERMS = {torch.float32: 7, torch.float64: 12}

_ENTRY = {torch.float32: ("tube_stage_f32", ctypes.c_float),
          torch.float64: ("tube_stage_f64", ctypes.c_double)}


def _consts_struct(ctype):
    class TubeConsts(ctypes.Structure):
        # layout of TubeConsts<T> in csrc/tube_stage.cu
        _fields_ = [(name, ctype) for name in (
            "mass", "drag", "dt", "noise", "ego_r2", "ego_h2")] + [
            ("K", ctype * 36)]
    return TubeConsts


_STRUCTS = {dt: _consts_struct(ct) for dt, (_, ct) in _ENTRY.items()}


def _bind(lib):
    for name, ctype in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def tube_stage_reference(x: torch.Tensor, u: torch.Tensor, mcfg: ModelConfig,
                         tcfg: TubeConfig):
    """Plain PyTorch version: the per-stage branch of propagate_tubes_batch
    with the config gain tcfg.K.
    x (L, 9), u (L, 4) -> (Qd, Mp, Phi (L, 9, 9), Q1 (L, 3, 3))."""
    Kt = torch.as_tensor(tcfg.K, dtype=x.dtype, device=x.device)
    w = torch.full((3,), tcfg.ext_noise_bound, dtype=x.dtype, device=x.device)
    Phi = lyapunov.closed_loop_phi(x, u, Kt, mcfg)
    Qd, Mp = lyapunov.channel_Qd_fast(Phi, mcfg.dt, w)
    return Qd, Mp, Phi, lyapunov.ego_ellipsoid(x[:, 6:9], tcfg)


def tube_stage_lanes(x: torch.Tensor, u: torch.Tensor, mcfg: ModelConfig,
                     tcfg: TubeConfig):
    """Per-stage tube math over L stage lanes (config gain tcfg.K).
    Returns (Qd (L, 9, 9), Mp (L, 9, 9), Phi (L, 9, 9), Q1 (L, 3, 3))."""
    global LAUNCHES
    if x.device.type == "cpu":
        return tube_stage_reference(x, u, mcfg, tcfg)
    if x.device.type != "cuda":
        raise ValueError(f"no route for tensors on {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"the CUDA kernel takes float32 or float64, not {x.dtype}")
    L = x.shape[0]
    for name, t, shape in (("x", x, (L, NX)), ("u", u, (L, 4))):
        if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors only")
    if L == 0:
        raise ValueError("need L >= 1 stage lanes")
    Kt = torch.as_tensor(tcfg.K, dtype=torch.float64)
    if tuple(Kt.shape) != (4, NX):
        raise ValueError(f"tcfg.K: shape {tuple(Kt.shape)}, expected (4, 9)")
    lib = _build.load(SOURCE, _bind)
    entry, ctype = _ENTRY[x.dtype]
    consts = _STRUCTS[x.dtype](
        mass=mcfg.mass, drag=mcfg.drag_coeff, dt=mcfg.dt,
        noise=tcfg.ext_noise_bound, ego_r2=tcfg.ego_r ** 2,
        ego_h2=tcfg.ego_h ** 2, K=(ctype * 36)(*Kt.reshape(-1).tolist()),
    )
    outs = [x.new_empty((L, NX, NX)) for _ in range(3)] + [x.new_empty((L, 3, 3))]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            ctypes.addressof(consts), L, N_TERMS[x.dtype], x.data_ptr(),
            u.data_ptr(), *(t.data_ptr() for t in outs), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tube_stage kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return tuple(outs)
