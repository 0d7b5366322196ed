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
always survive); argmin ties go to the lowest obstacle index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.config import CorridorConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import euler_to_rot
from forces_resilient_planner_tpu_torch.utils.lanes import norm3

_BIG = 1e30


def _diag3(a0, a1, a2) -> torch.Tensor:
    z = torch.zeros_like(a0)
    return torch.stack([
        torch.stack([a0, z, z], dim=-1),
        torch.stack([z, a1, z], dim=-1),
        torch.stack([z, z, a2], dim=-1),
    ], dim=-2)


def _frame_C(Rf, a0, a1, a2) -> torch.Tensor:
    """C = Rf diag(a) Rf^T."""
    return Rf @ _diag3(a0, a1, a2) @ Rf.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def seed_rotation(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Line-aligned frame with zero roll (geometric_utils.h:27-35)."""
    v = p2 - p1
    pitch = torch.atan2(-v[..., 2],
                        torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]))
    yaw = torch.atan2(v[..., 1], v[..., 0])
    return euler_to_rot(torch.stack([torch.zeros_like(pitch), pitch, yaw], -1))


class Ellipsoid(NamedTuple):
    C: torch.Tensor  # (..., 3, 3)
    d: torch.Tensor  # (..., 3)


def _cofactors(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    return (a, b, c, d, e, f, g, h, i), (co00, co01, co02), det


def det3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (first-row cofactor expansion)."""
    return _cofactors(A)[2]


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det), det clamped away from 0."""
    (a, b, c, d, e, f, g, h, i), (co00, co01, co02), det = _cofactors(A)
    det = torch.where(torch.abs(det) < 1e-30,
                      torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        torch.stack([co00, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co01, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co02, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def ellipsoid_dist(E: Ellipsoid, pts: torch.Tensor) -> torch.Tensor:
    """||C^{-1}(p - d)|| (decomp_geometry/ellipsoid.h:19-21):
    E (..., 3, 3), pts (..., M, 3) -> (..., M)."""
    Ci = inv3(E.C)
    r0 = pts[..., 0] - E.d[..., 0, None]
    r1 = pts[..., 1] - E.d[..., 1, None]
    r2 = pts[..., 2] - E.d[..., 2, None]
    q0 = Ci[..., 0, 0, None] * r0 + Ci[..., 0, 1, None] * r1 + Ci[..., 0, 2, None] * r2
    q1 = Ci[..., 1, 0, None] * r0 + Ci[..., 1, 1, None] * r1 + Ci[..., 1, 2, None] * r2
    q2 = Ci[..., 2, 0, None] * r0 + Ci[..., 2, 1, None] * r1 + Ci[..., 2, 2, None] * r2
    return torch.sqrt(q0 * q0 + q1 * q1 + q2 * q2)


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
        dists = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a1), d), obs)
        any_in = inside.any(dim=-1)
        idx = _closest_masked(dists, inside)
        pw = _pick(obs, idx)
        p_loc = _mtv(Ri, pw - d)
        roll = torch.atan2(p_loc[..., 2], p_loc[..., 1])
        cr, sr = torch.cos(roll), torch.sin(roll)
        o, z = torch.ones_like(cr), torch.zeros_like(cr)
        Rx = torch.stack([
            torch.stack([o, z, z], -1),
            torch.stack([z, cr, -sr], -1),
            torch.stack([z, sr, cr], -1),
        ], -2)
        Rf_new = Ri @ Rx
        p_r = _mtv(Rf_new, pw - d)
        denom = 1.0 - (p_r[..., 0] / a0) ** 2
        b_new = torch.where(
            (p_r[..., 0] < a0) & (denom > 1e-12),
            torch.abs(p_r[..., 1]) / torch.sqrt(torch.clamp(denom, min=1e-12)),
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
        dists = ellipsoid_dist(Ellipsoid(_frame_C(Rf, a0, a1, a2), d), obs)
        any_in = inside.any(dim=-1)
        idx = _closest_masked(dists, inside)
        p_r = _mtv(Rf, _pick(obs, idx) - d)
        dd = 1.0 - (p_r[..., 0] / a0) ** 2 - (p_r[..., 1] / a1) ** 2
        c_new = torch.where(
            dd > eps,
            torch.abs(p_r[..., 2]) / torch.sqrt(torch.clamp(dd, min=1e-12)),
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
    Ci = inv3(E.C)
    Mq = Ci @ Ci.transpose(-1, -2)
    dists = ellipsoid_dist(E, obs)               # loop-invariant
    remain = obs_mask.expand(dists.shape)
    if work is not None:
        _count(work, "dist", remain & ~work.pop("known"))
    pts, ns, valid = [], [], []
    for _ in range(max_planes):
        any_left = remain.any(dim=-1)
        if work is not None:
            _count(work, "peel", any_left)
            _count(work, "halfspace", remain)
        idx = _closest_masked(dists, remain)
        pw = _pick(obs, idx)
        n = _mv(Mq, pw - E.d)
        n = n / torch.clamp(norm3(n), min=1e-12)[..., None]
        rel = obs - pw[..., None, :]
        sd = n[..., None, 0] * rel[..., 0] + n[..., None, 1] * rel[..., 1] \
            + n[..., None, 2] * rel[..., 2]
        remain = torch.where(any_left[..., None], remain & (sd < 0), remain)
        gate = any_left[..., None]
        pts.append(torch.where(gate, pw, torch.zeros_like(pw)))
        ns.append(torch.where(gate, n, torch.zeros_like(n)))
        valid.append(any_left)
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
    dir_v = torch.linalg.cross(dirv, dir_h, dim=-1)
    bb0, bb1, bb2 = (float(x) for x in bbox)
    pts = torch.stack([
        p1 + dir_h * bb1, p1 - dir_h * bb1, p2 + dirv * bb0,
        p1 - dirv * bb0, p1 + dir_v * bb2, p1 - dir_v * bb2,
    ], -2)
    ns = torch.stack([dir_h, -dir_h, dirv, -dirv, dir_v, -dir_v], -2)
    valid = torch.ones(ns.shape[:-1], dtype=torch.bool, device=ns.device)
    return PlaneSet(points=pts, normals=ns, valid=valid)


def _dot3(a, b):
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
    for k in range(6):
        nk = ps.normals[..., k, :]
        sd = (nk[..., None, 0] * obs[..., 0] + nk[..., None, 1] * obs[..., 1]
              + nk[..., None, 2] * obs[..., 2]) - off[..., k, None]
        inside = inside & (sd <= eps)
    return inside


def planes_to_constraints(planes: PlaneSet, interior: torch.Tensor, nh: int):
    """Outward-oriented A x <= b (polyhedron.h:98-147), padded to nh rows;
    invalid rows are zero (0 x <= 0 is feasible under the hu slack)."""
    n = planes.normals
    c = _dot3(planes.points, n)
    flip = _dot3(n, interior[..., None, :]) - c > 0
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
    farthest first).  -> (obs (..., k, 3), mask (..., k))."""
    mask = bbox_filter_obstacles(p1, p2, bbox, obs, obs_mask, eps)
    rel = obs - (0.5 * (p1 + p2))[..., None, :]
    d2 = rel[..., 0] ** 2 + rel[..., 1] ** 2 + rel[..., 2] ** 2
    score = torch.where(mask, d2, torch.full_like(d2, float("inf")))
    neg, idx = torch.topk(-score, k, dim=-1)
    shape = idx.shape[:-1]
    src = obs.expand(shape + obs.shape[-2:])
    picked = torch.gather(src, -2, idx[..., None].expand(shape + (k, 3)))
    return picked, neg > -float("inf")


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
