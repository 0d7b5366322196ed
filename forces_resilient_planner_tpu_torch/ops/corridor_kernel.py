"""All-stage corridor decomposition: CUDA kernel + plain PyTorch version.

Counterpart of forces_resilient_planner_tpu/ops/corridor_pallas.py.  The
kernel (csrc/corridor.cu) replaces the Pallas TPU kernel
`_corridor_kernel` (corridor_pallas.py:98): one decompose_segment per
(scenario, stage), by one of two routes that `launch_geometry` picks from
(M, dtype, K = CorridorConfig.max_active_obstacles): the shared route
holds the scenario's cloud in shared memory across its stages (M up to
11,622 at f32 and 6,456 at f64, no compaction); the gathered route first
gathers each stage's bbox set, or with 0 < K < M its K nearest obstacles,
into a scratch list in global memory and decomposes from there (any M, in
chunks of scenarios).

Route by device: on a CPU tensor `decompose_stages_lanes` runs
`decompose_stages_reference` (corridor/decomp.py over the B N stage
lanes); on a CUDA tensor it launches the kernel or raises.  Unlike the JAX
package there is no batch-size gate (one scenario on the card runs the
kernel too), and the compaction runs on every route: the JAX package's
batched TPU path ignores max_active_obstacles (pipeline_batch.py:71-74),
so its result depends on the route; here the kernel computes what the
plain version computes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.config import CorridorConfig
from forces_resilient_planner_tpu_torch.corridor import decomp
from forces_resilient_planner_tpu_torch.ops import _build

SOURCE = "corridor.cu"
WALLS = 6

# the routes of csrc/corridor.cu by number, and kernel launches of each
# (a call on a route counts one), over all calls in this process
ROUTES = {1: "corridor", 2: "corridor_gathered"}
LAUNCHES = {name: 0 for name in ROUTES.values()}

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
    lib.corridor_geometry.argtypes = ([ctypes.c_int] * 7
                                      + [ctypes.c_void_p] * 5)
    lib.corridor_geometry.restype = None
    for name, _ in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 7 + [ctypes.c_size_t,
                                                  ctypes.c_void_p])
        fn.restype = ctypes.c_int


class Geometry(NamedTuple):
    route: int      # 1 shared, 2 gathered (ROUTES)
    lanes: int      # lanes per stage
    threads: int    # per CTA (one scenario) of the decomposition
    smem: int       # bytes of shared memory per CTA
    scratch: int    # bytes of global scratch the call needs


def compaction_k(ccfg: CorridorConfig, M: int) -> int:
    """The compaction's K, 0 when off (K = 0 or K >= M, as
    decompose_segment reads it)."""
    k = ccfg.max_active_obstacles
    return k if 0 < k < M else 0


def launch_geometry(lib, B: int, N: int, M: int, dtype, k: int = 0,
                    group: int = 0, route: int = 0) -> Geometry:
    """The launch of the kernel in `lib` for B scenarios of N stages of M
    obstacles, compacted to k (0: off); group 0 and route 0 are the
    kernel's own choices (the tests force 4, 8, 16 or 32 lanes per stage,
    or route 1 or 2)."""
    out = [ctypes.c_int() for _ in range(3)] + [ctypes.c_size_t()
                                                for _ in range(2)]
    lib.corridor_geometry(B, N, M, k,
                          torch.empty((), dtype=dtype).element_size(), group,
                          route, *(ctypes.byref(o) for o in out))
    return Geometry(*(o.value for o in out))


def launch(lib, p1, p2, obs, obs_mask, ccfg: CorridorConfig, nh: int, stream,
           group: int = 0, route: int = 0):
    """One launch of the kernel in `lib` (the nvcc build, or the CPU build
    of the tests) on checked, contiguous inputs; group and route: 0, as the
    wrapper passes, for the kernel's own choices, or forced (the tests).
    Returns (A, b), allocated like p1, and the Geometry launched.  Raises
    when the launch fails."""
    B, N, M = p1.shape[0], p1.shape[1], obs.shape[1]
    k = compaction_k(ccfg, M)
    geo = launch_geometry(lib, B, N, M, p1.dtype, k, group, route)
    entry, ctype = _ENTRY[p1.dtype]
    consts = _STRUCTS[p1.dtype](
        bbox=(ctype * 3)(*(float(v) for v in ccfg.local_bbox)),
        eps=ccfg.epsilon, shrink_iters=ccfg.shrink_iters,
        max_planes=ccfg.max_obs_planes, nh=nh,
    )
    A = p1.new_empty((B, N, nh, 3))
    b = p1.new_empty((B, N, nh))
    scratch = torch.empty(geo.scratch, dtype=torch.uint8, device=p1.device)
    rc = getattr(lib, entry)(
        ctypes.addressof(consts), B, N, M, k, group, route, p1.data_ptr(),
        p2.data_ptr(), obs.data_ptr(), obs_mask.data_ptr(), A.data_ptr(),
        b.data_ptr(), scratch.data_ptr() if geo.scratch else None,
        geo.scratch, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"corridor kernel launch failed: CUDA error {rc} (route "
            f"{ROUTES.get(geo.route, geo.route)}, M = {M}, K = {k}: {geo})")
    return A, b, geo


def decompose_stages_reference(p1, p2, obs, obs_mask, ccfg: CorridorConfig,
                               nh: int = 30):
    """Plain PyTorch version: decompose_segment on every (scenario, stage),
    the scenario's cloud broadcast over its stages.
    p1, p2 (B, N, 3), obs (B, M, 3), obs_mask (B, M) -> A (B, N, nh, 3),
    b (B, N, nh)."""
    r = decomp.decompose_segment(p1, p2, obs[:, None], obs_mask[:, None],
                                 ccfg, nh)
    return r.A, r.b


# Operations of one evaluation of each kind that corridor/decomp.py::
# decompose_segment's work dict counts: the fewest that give the plain
# version's result bit for bit (a multiply-add counts 2; a division, square
# root or transcendental 1; compares, selects and negations 0; a common
# subexpression once; an operand known to be 0 or 1 drops its operation).
# From the formulas of corridor/decomp.py, which csrc/corridor.cu follows:
OPS_PER = {
    # per segment, 227: v, d, |v| (15); the unit axis and the horizontal
    # one (9), the vertical one from their cross product with a zero
    # component (5); the 6 walls' offsets (50: the walls come in pairs of
    # opposite normals, the horizontal pair has a zero component); the seed
    # frame Ri (11: pitch from |v|'s partial sum, yaw, 4 cos/sin, 4 products
    # at roll 0); f (1); the sphere's C^-1 = I / f (3); the seed
    # ellipsoid's C^-1 (84, below, less Ri's zero entry); the peel's
    # C^-1 C^-T (30: symmetric); the walls' outward signs (19)
    "stages": 227,
    # per valid obstacle of each segment: the 3 wall axes' products with
    # it (the horizontal one has 2 terms) 13, then 6 offsets
    "bbox": 19,
    # per bbox-set obstacle: r = o - d (3, shared by every later distance
    # and pick), ||r / f|| (3 mul, 3 mul + 2 add, sqrt)
    "sphere": 12,
    # ||C^-1 r||: 9 mul + 6 add, 3 mul + 2 add, sqrt
    "dist": 21,
    # the C^-1 of a frame Rf and axes a (frame_Cinv) costs 95: Rf diag(a)
    # (9), C = (Rf diag(a)) Rf^T (45), the adjugate (27), the determinant
    # (5), 9 divisions; less where a column of Rf diag(a) and its partial
    # sums are those of the C^-1 before (same frame column and axis):
    # phase 2's reset ellipsoid: the last phase-1 round's first two
    # columns, 62
    "reset": 62,
    # per executed round: its scalar chain
    # phase 1: Ri^T pw (15), roll (atan2, cos, sin), Rf = Ri Rx (18:
    # column 0 is Ri's), Rf^T pw (10: its first entry is Ri^T pw's), the
    # middle axis (5), C^-1 (83: column 0 is the seed's)
    "shrink1": 134,
    # phase 2: Rf^T pw (15), the vertical axis (8), C^-1 (62: columns 0
    # and 1 are fixed)
    "shrink2": 85,
    # peel: the normal Mq (pw - d) (15), its norm (6) and unit (3), the row
    # (pw . n, n . d - c: 11)
    "peel": 35,
    # per remaining obstacle of a peel round: n . (o - pw)
    "halfspace": 8,
}


def decompose_stages_work(p1, p2, obs, obs_mask, ccfg: CorridorConfig):
    """The work that the decomposition of these inputs needs: the counts of
    corridor/decomp.py::decompose_segment's work dict (keys of OPS_PER),
    taken from the plain version's own loops on these inputs.  A counting
    helper for the kernel's bound (chip_smoke.py); the main path never
    calls it.  Same arguments as decompose_stages_reference (without nh)."""
    work = {k: 0 for k in OPS_PER}
    decomp.decompose_segment(p1, p2, obs[:, None], obs_mask[:, None], ccfg,
                             work=work)
    return work


def work_operations(work: dict) -> int:
    """Operations of the work counted by decompose_stages_work."""
    return sum(OPS_PER[k] * n for k, n in work.items())


def decompose_stages_lanes(p1, p2, obs, obs_mask, ccfg: CorridorConfig,
                           nh: int = 30):
    """All-stage decomposition, batch-leading in and out.  Returns
    (A (B, N, nh, 3), b (B, N, nh)): max_obs_planes peel rows, 6 bbox
    walls, zero padding (decompose_segment's row layout).  On a CUDA tensor
    the kernel runs by the route launch_geometry picks from (M, dtype, k),
    and the call counts one launch under that route in LAUNCHES."""
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
    lib = _build.load(SOURCE, _bind)
    with torch.cuda.device(p1.device):
        A, b, geo = launch(lib, p1, p2, obs, obs_mask, ccfg, nh,
                           torch.cuda.current_stream(p1.device).cuda_stream)
    LAUNCHES[ROUTES[geo.route]] += 1
    return A, b
