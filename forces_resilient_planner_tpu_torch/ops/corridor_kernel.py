"""All-stage corridor decomposition: CUDA kernel + plain PyTorch version.

Counterpart of forces_resilient_planner_tpu/ops/corridor_pallas.py.  The
kernel (csrc/corridor.cu) replaces the Pallas TPU kernel
`_corridor_kernel` (corridor_pallas.py:98): one decompose_segment per
(scenario, stage), with the scenario's obstacle cloud held in shared
memory across its stages.

Route by device: on a CPU tensor `decompose_stages_lanes` runs
`decompose_stages_reference` (corridor/decomp.py over the B N stage
lanes); on a CUDA tensor it launches the kernel or raises.  Unlike the JAX
package there is no batch-size gate: one scenario on the card runs the
kernel too.  The kernel does not compact obstacles: with the opt-in
CorridorConfig.max_active_obstacles below the cloud size it raises.
"""
from __future__ import annotations

import ctypes

import torch

from forces_resilient_planner_tpu_torch.config import CorridorConfig
from forces_resilient_planner_tpu_torch.corridor import decomp
from forces_resilient_planner_tpu_torch.ops import _build

SOURCE = "corridor.cu"
WALLS = 6

# kernel launches, over all calls in this process
LAUNCHES = 0

_ENTRY = {torch.float32: ("corridor_f32", ctypes.c_float),
          torch.float64: ("corridor_f64", ctypes.c_double)}


def _consts_struct(ctype):
    class CorrConsts(ctypes.Structure):
        # layout of CorrConsts<T> in csrc/corridor.cu
        _fields_ = [("bbox", ctype * 3), ("eps", ctype),
                    ("shrink_iters", ctypes.c_int),
                    ("max_planes", ctypes.c_int), ("nh", ctypes.c_int)]
    return CorrConsts


_STRUCTS = {dt: _consts_struct(ct) for dt, (_, ct) in _ENTRY.items()}


def _bind(lib):
    lib.corridor_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.corridor_smem_bytes.restype = ctypes.c_size_t
    for name, _ in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def decompose_stages_reference(p1, p2, obs, obs_mask, ccfg: CorridorConfig,
                               nh: int = 30):
    """Plain PyTorch version: decompose_segment on every (scenario, stage),
    the scenario's cloud broadcast over its stages.
    p1, p2 (B, N, 3), obs (B, M, 3), obs_mask (B, M) -> A (B, N, nh, 3),
    b (B, N, nh)."""
    r = decomp.decompose_segment(p1, p2, obs[:, None], obs_mask[:, None],
                                 ccfg, nh)
    return r.A, r.b


def decompose_stages_lanes(p1, p2, obs, obs_mask, ccfg: CorridorConfig,
                           nh: int = 30):
    """All-stage decomposition, batch-leading in and out.  Returns
    (A (B, N, nh, 3), b (B, N, nh)): max_obs_planes peel rows, 6 bbox
    walls, zero padding (decompose_segment's row layout)."""
    global LAUNCHES
    if p1.device.type == "cpu":
        return decompose_stages_reference(p1, p2, obs, obs_mask, ccfg, nh)
    if p1.device.type != "cuda":
        raise ValueError(f"no route for tensors on {p1.device}")
    if p1.dtype not in _ENTRY:
        raise ValueError(f"the CUDA kernel takes float32 or float64, not {p1.dtype}")
    B, N = p1.shape[0], p1.shape[1]
    M = obs.shape[1]
    for name, t, shape, dtype in (
        ("p1", p1, (B, N, 3), p1.dtype), ("p2", p2, (B, N, 3), p1.dtype),
        ("obs", obs, (B, M, 3), p1.dtype),
        ("obs_mask", obs_mask, (B, M), torch.bool),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != p1.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {dtype} on {p1.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors only")
    if B == 0 or N == 0 or M == 0:
        raise ValueError(f"need B, N, M >= 1, got {B}, {N}, {M}")
    if nh < ccfg.max_obs_planes + WALLS:
        raise ValueError(f"nh = {nh} < max_obs_planes + {WALLS}")
    k = ccfg.max_active_obstacles
    if k and k < M:
        raise ValueError(
            "the corridor kernel does not compact obstacles "
            f"(max_active_obstacles = {k} < M = {M}); compaction runs on "
            "CPU tensors only"
        )
    lib = _build.load(SOURCE, _bind)
    entry, ctype = _ENTRY[p1.dtype]
    consts = _STRUCTS[p1.dtype](
        bbox=(ctype * 3)(*(float(v) for v in ccfg.local_bbox)),
        eps=ccfg.epsilon, shrink_iters=ccfg.shrink_iters,
        max_planes=ccfg.max_obs_planes, nh=nh,
    )
    A = p1.new_empty((B, N, nh, 3))
    b = p1.new_empty((B, N, nh))
    with torch.cuda.device(p1.device):
        stream = torch.cuda.current_stream(p1.device).cuda_stream
        rc = getattr(lib, entry)(
            ctypes.addressof(consts), B, N, M, p1.data_ptr(), p2.data_ptr(),
            obs.data_ptr(), obs_mask.data_ptr(), A.data_ptr(), b.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"corridor kernel launch failed: CUDA error {rc} (one scenario "
            f"of M = {M} obstacles takes "
            f"{lib.corridor_smem_bytes(N, M, p1.element_size())} bytes of "
            "shared memory)"
        )
    LAUNCHES += 1
    return A, b
