"""Safe-flight-corridor generation: ellipsoid decomposition (torch).

Port of forces_resilient_planner_tpu/corridor/decomp.py (DecompROS'
line-segment decomposition, decomp_util/line_segment.h:134-211,
decomp_util/decomp_base.h:63-83, decomp_geometry/{ellipsoid,polyhedron}.h)
with every function batched over leading lane dimensions: a segment is
(..., 3), its obstacle cloud (..., M, 3) with a (..., M) validity mask,
where the cloud's leading dimensions broadcast against the segment's (a
scenario's cloud serves all its N stages without a copy).  Every
data-dependent `while obstacles remain` loop is a fixed-trip masked loop
on (..., M) tensors; a lane whose loop has nothing left keeps its state.

This batched form is the plain version of the corridor kernel
(ops/corridor_kernel.py).  Its deviations from the reference are the JAX
package's (iteration caps, fixed-size obstacle buffers, bbox walls that
always survive); argmin ties go to the lowest obstacle index, and the
compaction keeps the k lowest scores in jax.lax.top_k's order (score, then
index).

Rounding.  On a voxel grid many obstacles sit at distances or plane
offsets that are equal in exact arithmetic, so the last bit decides an
argmin or a sign.  The comparisons' inputs are therefore rounded as the
jitted JAX function rounds them on XLA:CPU (utils/rounding.py): its dots
of length 3 (the ellipsoid's matrix products, the peel's normal and signed
distances, the rows' interior test, the bbox filter's wall products), its
norms and the compaction's squared distances as fused multiply-add
chains; the products that LLVM contracts in fused elementwise code (the
adjugate's cofactors, the ellipsoid distance, the shrink rounds'
1 - q^2) as fused multiply-adds; square roots correctly rounded and, at
float64 on the CPU, glibc's transcendentals.  Every other operation rounds
on its own, with no torch call that may contract on CUDA.  On
voxel-centre clouds with axis-aligned segments the sites that decide a row
are the signed distances, the ellipsoid matrix, the ellipsoid distance and
the compaction's order and squared distance
(tests/test_torch_corridor_routes.py).  Not matched, as no such tie turns
on them: the walls' own geometry (rounded op by op where XLA contracts
some), and a shrink round's |p| / sqrt(x), which XLA:CPU rewrites into
|p| * rsqrt(x) with the CPU's approximate reciprocal square root
(vrsqrt14pd and two Newton steps on AVX-512, so it depends on the
instruction set); the port divides.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.config import CorridorConfig
from forces_resilient_planner_tpu_torch.utils import rounding as rn
from forces_resilient_planner_tpu_torch.utils.rounding import dot3, fma

_BIG = 1e30


def _mm(A, B) -> torch.Tensor:
    """A @ B for (..., 3, 3) matrices, each entry a dot3 chain."""
    return torch.stack([
        torch.stack([dot3(A[..., i, :], B[..., :, j]) for j in range(3)], -1)
        for i in range(3)], -2)


def _mmt(A, B) -> torch.Tensor:
    """A @ B^T, each entry a dot3 chain."""
    return _mm(A, B.transpose(-1, -2))


def _frame_C(Rf, a0, a1, a2) -> torch.Tensor:
    """C = (Rf diag(a)) Rf^T; the first product is exact per entry
    (Rf_ij a_j: the dot's other terms are products with zeros)."""
    return _mmt(Rf * torch.stack([a0, a1, a2], -1)[..., None, :], Rf)


def _mv(M, v):
    """M @ v, each entry a dot3 chain."""
    return torch.stack([dot3(M[..., i, :], v) for i in range(3)], -1)


def _mtv(M, v):
    """M^T @ v, each entry a dot3 chain."""
    return torch.stack([dot3(M[..., :, i], v) for i in range(3)], -1)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of length 3 (a dot3 chain)."""
    return rn.sqrt(dot3(v, v))


def seed_rotation(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Line-aligned frame with zero roll (geometric_utils.h:27-35):
    Rz(yaw) Ry(pitch), dynamics/quadrotor.py::euler_to_rot at roll 0."""
    v = p2 - p1
    pitch = rn.atan2(-v[..., 2],
                     rn.sqrt(fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))
    yaw = rn.atan2(v[..., 1], v[..., 0])
    cp, sp = rn.cos(pitch), rn.sin(pitch)
    cy, sy = rn.cos(yaw), rn.sin(yaw)
    z = torch.zeros_like(cp)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * z - sy, cy * sp + sy * z], -1),
        torch.stack([cp * sy, cy + sy * sp * z, sy * sp - cy * z], -1),
        torch.stack([-sp, cp * z, cp], -1),
    ], -2)


class Ellipsoid(NamedTuple):
    C: torch.Tensor  # (..., 3, 3)
    d: torch.Tensor  # (..., 3)


def _xy_zw(x, y, z, w):
    return x * y - z * w


def _xy_zw_contracted(x, y, z, w):
    """x y - z w with the first product contracted, as LLVM contracts it."""
    return fma(x, y, -(z * w))


def _cofactors(A, contract: bool = False):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    xy_zw = _xy_zw_contracted if contract else _xy_zw
    co00 = xy_zw(e, i, f, h)
    co01 = -xy_zw(d, i, f, g)
    co02 = xy_zw(d, h, e, g)
    if contract:
        det = fma(c, co02, fma(a, co00, b * co01))
    else:
        det = a * co00 + b * co01 + c * co02
    return (a, b, c, d, e, f, g, h, i), (co00, co01, co02), det


def det3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (first-row cofactor expansion)."""
    return _cofactors(A)[2]


def inv3(A: torch.Tensor, contract: bool = False) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det), det clamped away from 0,
    rounded op by op (the tube's square root), or with contract=True as the
    jitted JAX inv3 (the decomposition)."""
    (a, b, c, d, e, f, g, h, i), (co00, co01, co02), det = _cofactors(
        A, contract)
    xy_zw = _xy_zw_contracted if contract else _xy_zw
    det = torch.where(torch.abs(det) < 1e-30,
                      torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        torch.stack([co00, -xy_zw(b, i, c, h), xy_zw(b, f, c, e)], dim=-1),
        torch.stack([co01, xy_zw(a, i, c, g), -xy_zw(a, f, c, d)], dim=-1),
        torch.stack([co02, -xy_zw(a, h, b, g), xy_zw(a, e, b, d)], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def ellipsoid_dist(E: Ellipsoid, pts: torch.Tensor) -> torch.Tensor:
    """||C^{-1}(p - d)|| (decomp_geometry/ellipsoid.h:19-21):
    E (..., 3, 3), pts (..., M, 3) -> (..., M)."""
    Ci = inv3(E.C, contract=True)
    r = [pts[..., k] - E.d[..., k, None] for k in range(3)]

    def row(i):
        c = [Ci[..., i, k, None] for k in range(3)]
        return fma(c[2], r[2], fma(c[0], r[0], c[1] * r[1]))

    q0, q1, q2 = row(0), row(1), row(2)
    return rn.sqrt(fma(q2, q2, fma(q0, q0, q1 * q1)))


def _closest_masked(dists: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lowest-index minimizer of dists over mask (argmin returns the first
    of equal minima)."""
    return torch.argmin(torch.where(mask, dists, torch.full_like(dists, _BIG)),
                        dim=-1)


def _pick(obs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """obs (..., M, 3) at idx (...) -> (..., 3), broadcasting obs."""
    shape = torch.broadcast_shapes(obs.shape[:-2], idx.shape)
    obs = obs.expand(shape + obs.shape[-2:])
    return torch.gather(
        obs, -2, idx.expand(shape)[..., None, None].expand(shape + (1, 3))
    )[..., 0, :]


def _count(work, key: str, sets: torch.Tensor) -> None:
    """work[key] += the number of True entries of sets."""
    work[key] = work.get(key, 0) + int(sets.sum())


def find_ellipsoid(
    p1: torch.Tensor, p2: torch.Tensor, obs: torch.Tensor,
    obs_mask: torch.Tensor, cfg: CorridorConfig, work: dict | None = None,
) -> Ellipsoid:
    """Sphere-seeded iterative axis shrink (line_segment.h:134-211, offset=0).

    work (a counting dict, None on every path that computes): adds the
    sets that the algorithm evaluates, as decompose_segment describes, and
    leaves work["known"], the obstacles whose distance under the returned
    ellipsoid the last round already took."""
    f = torch.clamp(0.5 * norm3(p1 - p2), min=1e-6)
    Ri = seed_rotation(p1, p2)
    d = 0.5 * (p1 + p2)
    eps = cfg.epsilon
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)

    dist0 = ellipsoid_dist(Ellipsoid(C=f[..., None, None] * eye, d=d), obs)
    inside0 = obs_mask & (dist0 <= 1.0)
    if work is not None:
        _count(work, "sphere", obs_mask)
        _count(work, "dist", inside0)            # the seed ellipsoid's
        known = inside0

    # ---- phase 1: shrink middle axis (b), re-rolling the frame ----------
    a0, a1, a2 = f, f, f
    Rf, inside = Ri, inside0
    for _ in range(cfg.shrink_iters):
        if not bool(inside.any()):               # every lane's set is empty:
            break                                # the rest change nothing
        dists = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a1), d), obs)
        any_in = inside.any(dim=-1)
        idx = _closest_masked(dists, inside)
        pw = _pick(obs, idx)
        p_loc = _mtv(Ri, pw - d)
        roll = rn.atan2(p_loc[..., 2], p_loc[..., 1])
        cr, sr = rn.cos(roll), rn.sin(roll)
        o, z = torch.ones_like(cr), torch.zeros_like(cr)
        Rx = torch.stack([
            torch.stack([o, z, z], -1),
            torch.stack([z, cr, -sr], -1),
            torch.stack([z, sr, cr], -1),
        ], -2)
        Rf_new = _mm(Ri, Rx)
        p_r = _mtv(Rf_new, pw - d)
        q = p_r[..., 0] / a0
        denom = fma(-q, q, torch.ones_like(q))
        b_new = torch.where(
            (p_r[..., 0] < a0) & (denom > 1e-12),
            torch.abs(p_r[..., 1]) / rn.sqrt(torch.clamp(denom, min=1e-12)),
            a1,
        )
        Rf = torch.where(any_in[..., None, None], Rf_new, Rf)
        a1 = torch.where(any_in, b_new, a1)
        new_d = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a1), d), obs)
        if work is not None:
            _count(work, "shrink1", any_in)
            _count(work, "dist", inside)
            known = torch.where(any_in[..., None], inside, known)
        inside = torch.where(any_in[..., None],
                             inside & (1.0 - new_d > eps), inside)

    # ---- phase 2: shrink vertical axis (c), frame fixed ------------------
    # reset with the old axes[2] (= f), re-filter from the initial inside set
    d2 = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a2), d), obs)
    inside = obs_mask & (d2 <= 1.0) & (dist0 <= 1.0)
    if work is not None:
        # a new ellipsoid only where phase 1 ran, i.e. the sphere set is not
        # empty; else it is the seed one
        _count(work, "reset", inside0.any(dim=-1))
        _count(work, "dist", inside0)
        known = inside0
    for _ in range(cfg.shrink_iters):
        if not bool(inside.any()):
            break
        dists = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a2), d), obs)
        any_in = inside.any(dim=-1)
        idx = _closest_masked(dists, inside)
        p_r = _mtv(Rf, _pick(obs, idx) - d)
        q0, q1 = p_r[..., 0] / a0, p_r[..., 1] / a1
        dd = fma(-q1, q1, fma(-q0, q0, torch.ones_like(q0)))
        c_new = torch.where(
            dd > eps,
            torch.abs(p_r[..., 2]) / rn.sqrt(torch.clamp(dd, min=1e-12)),
            a2,
        )
        a2 = torch.where(any_in, c_new, a2)
        new_d = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a2), d), obs)
        if work is not None:
            _count(work, "shrink2", any_in)
            _count(work, "dist", inside)
            known = torch.where(any_in[..., None], inside, known)
        inside = torch.where(any_in[..., None],
                             inside & (1.0 - new_d > eps), inside)
    if work is not None:
        work["known"] = known
    return Ellipsoid(C=_frame_C(Rf, a0, a1, a2), d=d)


class PlaneSet(NamedTuple):
    points: torch.Tensor   # (..., P, 3) plane anchor points
    normals: torch.Tensor  # (..., P, 3) outward normals
    valid: torch.Tensor    # (..., P) bool


def find_polyhedron(
    E: Ellipsoid, obs: torch.Tensor, obs_mask: torch.Tensor, max_planes: int,
    work: dict | None = None,
) -> PlaneSet:
    """Supporting-hyperplane peeling (decomp_base.h:63-83): each round takes
    the ellipsoid-closest remaining obstacle, adds the tangent plane there
    (normal C^{-1}C^{-T}(p-d), ellipsoid.h:52-57) and drops the obstacles
    with signed distance >= 0 (decomp_base.h:71-74 keeps < 0).

    work (a counting dict, None on every path that computes): adds the
    distances under E not in work.pop("known") (find_ellipsoid's), each
    executed round and the set it tests."""
    Ci = inv3(E.C, contract=True)
    Mq = _mmt(Ci, Ci)
    dists = ellipsoid_dist(E, obs)               # loop-invariant
    remain = obs_mask.expand(dists.shape)
    if work is not None:
        _count(work, "dist", remain & ~work.pop("known"))
    pts, ns, valid = [], [], []
    for _ in range(max_planes):
        any_left = remain.any(dim=-1)
        if not bool(any_left.any()):             # every lane's peel ended
            break
        if work is not None:
            _count(work, "peel", any_left)
            _count(work, "halfspace", remain)
        idx = _closest_masked(dists, remain)
        pw = _pick(obs, idx)
        n = _mv(Mq, pw - E.d)
        n = n / torch.clamp(norm3(n), min=1e-12)[..., None]
        sd = dot3(n[..., None, :], obs - pw[..., None, :])
        remain = torch.where(any_left[..., None], remain & (sd < 0), remain)
        gate = any_left[..., None]
        pts.append(torch.where(gate, pw, torch.zeros_like(pw)))
        ns.append(torch.where(gate, n, torch.zeros_like(n)))
        valid.append(any_left)
    for _ in range(max_planes - len(valid)):     # rounds that add no plane
        pts.append(dists.new_zeros(dists.shape[:-1] + (3,)))
        ns.append(pts[-1])
        valid.append(torch.zeros(dists.shape[:-1], dtype=torch.bool,
                                 device=dists.device))
    return PlaneSet(torch.stack(pts, -2), torch.stack(ns, -2),
                    torch.stack(valid, -1))


def local_bbox_planes(p1: torch.Tensor, p2: torch.Tensor, bbox) -> PlaneSet:
    """6 virtual walls aligned to the segment (line_segment.h:47-85)."""
    v = p2 - p1
    dirv = v / torch.clamp(norm3(v), min=1e-12)[..., None]
    z = torch.zeros_like(dirv[..., 0])
    dir_h = torch.stack([dirv[..., 1], -dirv[..., 0], z], -1)
    nh = norm3(dir_h)
    dir_h = torch.where(
        (nh < 1e-12)[..., None],
        torch.stack([-torch.ones_like(z), z, z], -1),
        dir_h / torch.clamp(nh, min=1e-12)[..., None],
    )
    # dirv x dir_h op by op (torch.linalg.cross's CUDA kernel may contract)
    d0, d1, d2 = dirv[..., 0], dirv[..., 1], dirv[..., 2]
    h0, h1, h2 = dir_h[..., 0], dir_h[..., 1], dir_h[..., 2]
    dir_v = torch.stack([d1 * h2 - d2 * h1, d2 * h0 - d0 * h2,
                         d0 * h1 - d1 * h0], -1)
    bb0, bb1, bb2 = (float(x) for x in bbox)
    pts = torch.stack([
        p1 + dir_h * bb1, p1 - dir_h * bb1, p2 + dirv * bb0,
        p1 - dirv * bb0, p1 + dir_v * bb2, p1 - dir_v * bb2,
    ], -2)
    ns = torch.stack([dir_h, -dir_h, dirv, -dirv, dir_v, -dir_v], -2)
    valid = torch.ones(ns.shape[:-1], dtype=torch.bool, device=ns.device)
    return PlaneSet(points=pts, normals=ns, valid=valid)


def _dot3(a, b):
    """a . b summed op by op: XLA:CPU's batched dot of one vector pair
    ("pj,pj->p") is not contracted."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def bbox_filter_obstacles(
    p1: torch.Tensor, p2: torch.Tensor, bbox, obs: torch.Tensor,
    obs_mask: torch.Tensor, eps: float,
) -> torch.Tensor:
    """set_obs keeps only points inside the local bbox (decomp_base.h:33-38;
    polyhedron.h inside() is epsilon-tolerant).  -> (..., M) bool."""
    ps = local_bbox_planes(p1, p2, bbox)
    off = _dot3(ps.normals, ps.points)                     # (..., 6)
    inside = obs_mask
    for k in range(0, 6, 2):
        # wall k + 1's normal is wall k's negated: its product with an
        # obstacle is the negation, bit for bit
        s = dot3(ps.normals[..., k, None, :], obs)
        inside = inside & (s - off[..., k, None] <= eps) \
            & (-s - off[..., k + 1, None] <= eps)
    return inside


def planes_to_constraints(planes: PlaneSet, interior: torch.Tensor, nh: int):
    """Outward-oriented A x <= b (polyhedron.h:98-147), padded to nh rows;
    invalid rows are zero (0 x <= 0 is feasible under the hu slack)."""
    n = planes.normals
    c = _dot3(planes.points, n)
    flip = dot3(n, interior[..., None, :]) - c > 0
    sgn = torch.where(flip, -1.0, 1.0).to(n.dtype)
    A = torch.where(planes.valid[..., None], n * sgn[..., None],
                    torch.zeros_like(n))
    b = torch.where(planes.valid, c * sgn, torch.zeros_like(c))
    P = A.shape[-2]
    if P < nh:
        A = torch.cat([A, A.new_zeros(A.shape[:-2] + (nh - P, 3))], dim=-2)
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (nh - P,))], dim=-1)
    return A[..., :nh, :], b[..., :nh]


class CorridorResult(NamedTuple):
    A: torch.Tensor            # (..., nh, 3)
    b: torch.Tensor            # (..., nh)
    ellipsoid_C: torch.Tensor  # (..., 3, 3)
    ellipsoid_d: torch.Tensor  # (..., 3)


def compact_obstacles(
    p1: torch.Tensor, p2: torch.Tensor, bbox, obs: torch.Tensor,
    obs_mask: torch.Tensor, k: int, eps: float,
):
    """Gather the k in-bbox obstacles closest to the segment midpoint
    (opt-in CorridorConfig.max_active_obstacles; overflow drops the
    farthest first), in jax.lax.top_k's order: the k lowest squared
    distances, equal ones by lower index.  -> (obs (..., k, 3),
    mask (..., k))."""
    mask = bbox_filter_obstacles(p1, p2, bbox, obs, obs_mask, eps)
    rel = obs - (0.5 * (p1 + p2))[..., None, :]
    score = torch.where(mask, dot3(rel, rel), torch.full_like(rel[..., 0],
                                                               float("inf")))
    score, idx = torch.sort(score, dim=-1, stable=True)
    score, idx = score[..., :k], idx[..., :k]
    shape = idx.shape[:-1]
    src = obs.expand(shape + obs.shape[-2:])
    picked = torch.gather(src, -2, idx[..., None].expand(shape + (k, 3)))
    return picked, score < float("inf")


def decompose_segment(
    p1: torch.Tensor, p2: torch.Tensor, obs: torch.Tensor,
    obs_mask: torch.Tensor, cfg: CorridorConfig, nh: int = 30,
    work: dict | None = None,
) -> CorridorResult:
    """Full line-segment decomposition -> padded (A, b) with nh rows.

    Row layout: [obstacle planes (max_obs_planes), bbox walls (6), zeros].

    work: None on every path that computes.  A dict (counting helpers, e.g.
    ops/corridor_kernel.py::decompose_stages_work) gets the number of
    evaluations the decomposition of these inputs needs, counted on the
    sets of the rounds that run (a round runs where its set is not empty),
    each key added to:
      stages     segments
      bbox       bbox tests: each segment's valid obstacles
      sphere     its bbox set: o - d and the distance under the sphere
      reset      segments whose sphere set is not empty: phase 2's reset
                 ellipsoid (else it is the seed one)
      dist       general ellipsoid distances: the seed ellipsoid and the
                 reset one over the sphere set, each shrink round's new
                 ellipsoid over the round's set, the peel's over the bbox
                 set less those the last round took under the same one
      shrink1, shrink2, peel   executed rounds
      halfspace  each executed peel round over its remaining set
    (compaction, max_active_obstacles, not counted)."""
    bbox = cfg.local_bbox
    k = cfg.max_active_obstacles
    if k and k < obs.shape[-2]:
        obs, mask = compact_obstacles(p1, p2, bbox, obs, obs_mask, k,
                                      cfg.epsilon)
    else:
        mask = bbox_filter_obstacles(p1, p2, bbox, obs, obs_mask, cfg.epsilon)
    if work is not None:
        _count(work, "stages", torch.ones(p1.shape[:-1], dtype=torch.bool))
        _count(work, "bbox",
               obs_mask.expand(p1.shape[:-1] + obs_mask.shape[-1:]))
    E = find_ellipsoid(p1, p2, obs, mask, cfg, work)
    obs_planes = find_polyhedron(E, obs, mask, cfg.max_obs_planes, work)
    walls = local_bbox_planes(p1, p2, bbox)
    planes = PlaneSet(
        points=torch.cat([obs_planes.points, walls.points], dim=-2),
        normals=torch.cat([obs_planes.normals, walls.normals], dim=-2),
        valid=torch.cat([obs_planes.valid, walls.valid], dim=-1),
    )
    A, b = planes_to_constraints(planes, 0.5 * (p1 + p2), nh)
    return CorridorResult(A=A, b=b, ellipsoid_C=E.C, ellipsoid_d=E.d)
