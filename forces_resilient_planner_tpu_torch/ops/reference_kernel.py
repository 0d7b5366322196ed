"""Stage 1 of the step, the references: CUDA kernel + plain PyTorch version.

Replaces no Pallas kernel: on the TPU, XLA fused the jnp code of
forces_resilient_planner_tpu/engine/reference.py::sample_references.  The
kernel (csrc/reference.cu) does per robot, in one thread, what
engine/reference.py::sample_references_plain does over the batch: the
sample indices and fractions, the gathers from the kino path, the
sequential yaw low-pass and the stage-0 jump, bit for bit.

engine/reference.py::sample_references routes by device: a CPU tensor to
the plain version, any other to `sample_references_lanes`, which launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from forces_resilient_planner_tpu_torch.ops import _build

SOURCE = "reference.cu"

# kernel launches, over all calls in this process
LAUNCHES = 0

_ENTRY = {torch.float32: ("reference_f32", ctypes.c_float),
          torch.float64: ("reference_f64", ctypes.c_double)}


def _bind(lib):
    for name, ctype in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] * 4 + [ctype] * 2
                       + [ctypes.c_void_p] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def launch(lib, kino_path, kino_size, t_offset, last_yaw, pred_pos1, N: int,
           Ts: float, lookahead: int, stream):
    """One launch of the kernel in `lib` (the nvcc build, or the CPU build
    of the tests) on checked, contiguous inputs; returns (ref_pos (B, N, 3),
    ref_yaw (B, N), stage0_jump (B,)), allocated like kino_path.  Ts and
    1 / Ts are rounded to the dtype once, as torch rounds a Python scalar.
    Raises when the launch fails."""
    B, K = kino_path.shape[0], kino_path.shape[1]
    entry, ctype = _ENTRY[kino_path.dtype]
    ref_pos = kino_path.new_empty((B, N, 3))
    ref_yaw = kino_path.new_empty((B, N))
    jump = kino_path.new_empty((B,))
    rc = getattr(lib, entry)(
        B, K, N, lookahead, ctype(Ts), ctype(1.0 / Ts), kino_path.data_ptr(),
        kino_size.data_ptr(), t_offset.data_ptr(), last_yaw.data_ptr(),
        pred_pos1.data_ptr(), ref_pos.data_ptr(), ref_yaw.data_ptr(),
        jump.data_ptr(), stream,
    )
    _build.check(rc, "reference")
    return ref_pos, ref_yaw, jump


# Operations of the kernel, counted as ops/tube_kernel.py counts them from
# the plain version's formulas that csrc/reference.cu follows (floor, fmod,
# sqrt and atan2 count 1; a comparison, a select, a clamp and an absolute
# value 0).  A stage: the index time (2); _fma_small's products (2), its
# TwoSum and error (6) and its last two sums (2); the index's product with
# 1 / Ts and floor (2); the fraction's fmod and product (2); the
# interpolation (9); d = fwd - ref (3) and its norm (6); atan2 (1); the
# gap and the wrap (2); the low-pass (3)                                  40
STAGE_OPS = 40
# a robot: the split of Ts into hi + lo (4) and the stage-0 jump (9)       13
ROBOT_OPS = 13


def reference_operations(B: int, N: int) -> int:
    """Operations of the references of B robots of N stages.  A counting
    helper for the kernel's bound (chip_smoke.py, k23_probe.py); the main
    path never calls it."""
    return B * (N * STAGE_OPS + ROBOT_OPS)


def reference_bytes(B: int, K: int, N: int, itemsize: int,
                    lookahead: int = 5) -> int:
    """Bytes the kernel must move for B robots of N stages on paths of K
    samples: kino_size (8) and t_offset, last_yaw and pred_pos1 (5 values)
    read, the min(N + lookahead, K) samples of each path its stages reach
    read once, ref_pos, ref_yaw and the jump (4 N + 1 values) written.  A
    counting helper, as reference_operations."""
    samples = 3 * min(N + lookahead, K)
    return B * (8 + itemsize * (5 + samples + 4 * N + 1))


def sample_references_lanes(kino_path, kino_size, t_offset, last_yaw,
                            pred_pos1, N: int, Ts: float, lookahead: int = 5):
    """The references of B robots: kino_path (B, K, 3), kino_size (B,)
    int64, t_offset, last_yaw (B,), pred_pos1 (B, 3), on the card ->
    (ref_pos (B, N, 3), ref_yaw (B, N), stage0_jump (B,)); one launch of
    the kernel, counted in LAUNCHES."""
    global LAUNCHES
    B, K = kino_path.shape[0], kino_path.shape[1]
    if B == 0 or K == 0 or N < 1:
        raise ValueError(f"need B, K, N >= 1, got {B}, {K}, {N}")
    lib = _build.route(SOURCE, _bind, [
        ("kino_path", kino_path, (B, K, 3)),
        ("kino_size", kino_size, (B,), torch.int64),
        ("t_offset", t_offset, (B,)), ("last_yaw", last_yaw, (B,)),
        ("pred_pos1", pred_pos1, (B, 3))])
    out = _build.on_stream(kino_path.device, launch, lib, kino_path,
                           kino_size, t_offset, last_yaw, pred_pos1, N, Ts,
                           lookahead)
    LAUNCHES += 1
    return out
