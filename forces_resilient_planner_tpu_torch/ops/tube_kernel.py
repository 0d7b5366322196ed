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
    lib.tube_geometry.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.tube_geometry.restype = None


def launch_geometry(lib, dtype):
    """(stage lanes, threads, bytes of shared memory) per CTA of the
    kernel in `lib` at dtype: a team of 9 threads per stage lane."""
    lanes, threads = ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_size_t()
    lib.tube_geometry(torch.empty((), dtype=dtype).element_size(),
                      ctypes.byref(lanes), ctypes.byref(threads),
                      ctypes.byref(smem))
    return lanes.value, threads.value, smem.value


def launch(lib, x, u, mcfg: ModelConfig, tcfg: TubeConfig, stream):
    """One launch of the kernel in `lib` (the nvcc build, or the CPU build
    of the tests) on checked, contiguous x (L, 9), u (L, 4); returns (Qd,
    Mp, Phi, Q1), allocated like x.  Raises when the launch fails."""
    L = x.shape[0]
    entry, ctype = _ENTRY[x.dtype]
    Kt = torch.as_tensor(tcfg.K, dtype=torch.float64)
    consts = _STRUCTS[x.dtype](
        mass=mcfg.mass, drag=mcfg.drag_coeff, dt=mcfg.dt,
        noise=tcfg.ext_noise_bound, ego_r2=tcfg.ego_r ** 2,
        ego_h2=tcfg.ego_h ** 2, K=(ctype * 36)(*Kt.reshape(-1).tolist()),
    )
    outs = [x.new_empty((L, NX, NX)) for _ in range(3)] + [x.new_empty((L, 3, 3))]
    rc = getattr(lib, entry)(
        ctypes.addressof(consts), L, N_TERMS[x.dtype], x.data_ptr(),
        u.data_ptr(), *(t.data_ptr() for t in outs), stream,
    )
    if rc != 0:
        raise RuntimeError(f"tube_stage kernel launch failed: CUDA error {rc}")
    return tuple(outs)


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


# Operations of one lane, counted as corridor_kernel.OPS_PER counts them
# (the fewest that give the plain version's result bit for bit; a
# multiply-add counts 2), from the formulas of tube/lyapunov.py, which
# csrc/tube_stage.cu follows.  A full 9x9 product costs 9 mul + 8 add per
# entry, 1377.
PRODUCT = 81 * 17
# per doubling: 8 products (3 channels' M X and (M X) M^T, M_-^2, M_+^2)
# and the 3 channels' X += (M X) M^T
DOUBLING_OPS = 8 * PRODUCT + 3 * 81


def lane_operations(n_terms: int) -> int:
    """Operations of one lane before its doublings:
      Phi = Jc + Bc K: rows 3-5 (3 divisions, 27 products, 27 sums; rows
        0-2 and 6-8 are copies; the Jacobian blocks of Jc not counted)  57
      the scaling: |Phi dt|'s column sums (81 mul, 72 add), log2, ceil,
        Pu = (Phi dt) 2^-s (81)                                          236
      each of the 2 Horner chains, n_terms steps: the product with Pu
        (none in the first: the factor is I), 81 products with 1/m and
        9 sums with +-I                                 (n-1) 1377 + 90 n
      each of the 3 channel series, n_terms steps: the product Pu H (none
        for H_0 = e_c e_c^T, 225 for H_1, nonzero in one row and column
        only, then 1377); H = -(W + W^T)/m and X += H/(m+1) on the 45
        entries of a symmetric matrix (180); then X dt 2^-s (45)
                                                 225 + (n-2) 1377 + 180 n + 45
      the combine: X dt w^2 (243), the traces (24 add, 3 sqrt), their
        sum (2), Qd (81 x 3 divisions, 2 add, 1 mul)                    758
    The ego ellipsoid Q1 is not counted either: a lower bound."""
    n = n_terms
    horner = (n - 1) * PRODUCT + 90 * n
    series = 225 + (n - 2) * PRODUCT + 180 * n + 45
    return 57 + 236 + 2 * horner + 3 * series + 758


def tube_stage_operations(Phi: torch.Tensor, dt: float, n_terms: int) -> int:
    """Operations that the tube math of these lanes needs: lane_operations
    per lane and DOUBLING_OPS per doubling, each lane its own s from the
    1-norm of Phi dt.  A counting helper for the kernel's bound
    (chip_smoke.py); the main path never calls it."""
    norm1 = (Phi * dt).abs().sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1 / 0.5, min=1.0)))
    s = torch.nan_to_num(s, nan=0.0).clamp(0, lyapunov.MAX_DOUBLINGS)
    return (lane_operations(n_terms) * Phi.shape[0]
            + DOUBLING_OPS * int(s.sum().item()))


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
    with torch.cuda.device(x.device):
        outs = launch(lib, x, u, mcfg, tcfg,
                      torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES += 1
    return outs
