"""Corridor geometry utilities: rotations, hyperplane queries, polyhedron
vertex/face enumeration.

TPU-native analog of the reference's header-only geometry layer
(DecompROS decomp_geometry/geometric_utils.h, ellipsoid.h, polyhedron.h).
These are host-side tools feeding visualization and analysis (the reference
uses them in the rviz plugins and `cal_vertices`,
geometric_utils.h:104-255), so they are plain NumPy; the device-side
corridor math lives in corridor/decomp.py.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def vec3_to_rotation(v: np.ndarray) -> np.ndarray:
    """Rotation matrix whose x-axis aligns with v, with zero roll.

    Reference: geometric_utils.h:27-35 (quaternion yaw*pitch composition);
    implemented here directly as R = Rz(yaw) @ Ry(pitch).
    """
    v = np.asarray(v, float)
    yaw = np.arctan2(v[1], v[0])
    pitch = np.arctan2(-v[2], np.linalg.norm(v[:2]))
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    return Rz @ Ry


def hyperplane_signed_dist(p: np.ndarray, n: np.ndarray, pts: np.ndarray):
    """Signed distance of pts to the plane through p with normal n
    (polyhedron.h:23-26; positive = outside along n)."""
    n = np.asarray(n, float)
    return (np.asarray(pts, float) - np.asarray(p, float)) @ (
        n / np.linalg.norm(n)
    )


def ellipsoid_closest_point(C: np.ndarray, d: np.ndarray, pts: np.ndarray):
    """Closest obstacle point in the ellipsoid metric ||C^-1 (p - d)||
    (ellipsoid.h:30-43) and its index."""
    Ci = np.linalg.inv(np.asarray(C, float))
    dist = np.linalg.norm((np.asarray(pts, float) - d) @ Ci.T, axis=-1)
    i = int(np.argmin(dist))
    return pts[i], i


def ellipsoid_supporting_hyperplane(C: np.ndarray, d: np.ndarray, p: np.ndarray):
    """Supporting hyperplane of the ellipsoid at boundary point p: normal
    C^-1 C^-T (p - d), normalized (ellipsoid.h:50-58)."""
    C = np.asarray(C, float)
    Ci = np.linalg.inv(C)
    n = Ci @ Ci.T @ (np.asarray(p, float) - np.asarray(d, float))
    return n / np.linalg.norm(n)


class PolyFaces(NamedTuple):
    vertices: np.ndarray          # (V, 3) unique polyhedron vertices
    faces: list                   # list of (k_i, 3) CCW-ordered face rings


def polyhedron_vertices(
    A: np.ndarray, b: np.ndarray, tol: float = 1e-7
) -> PolyFaces:
    """Enumerate vertices and face polygons of the bounded polyhedron
    {x : A x <= b}.

    The reference's `cal_vertices` (geometric_utils.h:104-255) clips each
    face in-plane against all other half-spaces; here we intersect all
    plane triplets (nh <= 30 => <= 4060 3x3 solves, vectorized), keep the
    points satisfying every constraint, then ring-sort each face's
    vertices around the face normal.  Rows with ~zero normal (masked
    corridor slots) are ignored.
    """
    A = np.asarray(A, float)
    b = np.asarray(b, float)
    norms = np.linalg.norm(A, axis=-1)
    keep = norms > 1e-9
    A, b, norms = A[keep], b[keep], norms[keep]
    A = A / norms[:, None]
    b = b / norms
    m = len(A)
    if m < 3:
        return PolyFaces(np.zeros((0, 3)), [])

    ii, jj, kk = np.array(
        [(i, j, k) for i in range(m) for j in range(i + 1, m)
         for k in range(j + 1, m)]
    ).T
    M = np.stack([A[ii], A[jj], A[kk]], axis=1)          # (T, 3, 3)
    rhs = np.stack([b[ii], b[jj], b[kk]], axis=1)        # (T, 3)
    det = np.linalg.det(M)
    ok = np.abs(det) > 1e-10
    pts = np.full((len(det), 3), np.nan)
    if ok.any():
        pts[ok] = np.linalg.solve(M[ok], rhs[ok][..., None])[..., 0]
    inside = ok & np.all(pts @ A.T <= b[None] + tol, axis=-1)
    cand = pts[inside]
    tri = np.stack([ii, jj, kk], axis=1)[inside]
    if len(cand) == 0:
        return PolyFaces(np.zeros((0, 3)), [])

    # dedupe vertices, tracking which planes each vertex lies on
    verts: list[np.ndarray] = []
    on_planes: list[set] = []
    for p, t in zip(cand, tri):
        for vi, v in enumerate(verts):
            if np.linalg.norm(p - v) < 1e-6:
                on_planes[vi] |= set(t)
                break
        else:
            verts.append(p)
            on_planes.append(set(t))
    V = np.asarray(verts)

    faces = []
    for f in range(m):
        idx = [vi for vi in range(len(V)) if f in on_planes[vi]]
        if len(idx) < 3:
            continue
        fv = V[idx]
        ctr = fv.mean(axis=0)
        n = A[f]
        # in-plane basis for angular sort
        t1 = np.cross(n, [0.0, 0.0, 1.0])
        if np.linalg.norm(t1) < 1e-6:
            t1 = np.cross(n, [0.0, 1.0, 0.0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        ang = np.arctan2((fv - ctr) @ t2, (fv - ctr) @ t1)
        faces.append(fv[np.argsort(ang)])
    return PolyFaces(V, faces)
