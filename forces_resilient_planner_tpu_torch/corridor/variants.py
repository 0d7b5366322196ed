"""Additional corridor decomposition variants (torch).

Port of forces_resilient_planner_tpu/corridor/variants.py, completing the
DecompROS surface: seed-point decomposition (decomp_util/seed_decomp.h)
and iterative path-simplifying decomposition
(decomp_util/iterative_decomp.h) beside the line-segment decomposition the
planner uses, on the same primitives (corridor/decomp.py).  No path of the
planner calls them, so they run the plain torch primitives on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forces_resilient_planner_tpu_torch.config import CorridorConfig
from forces_resilient_planner_tpu_torch.corridor.decomp import (
    CorridorResult,
    Ellipsoid,
    PlaneSet,
    decompose_segment,
    find_polyhedron,
    planes_to_constraints,
)


def seed_decompose(
    p: torch.Tensor,
    radius: float,
    obs: torch.Tensor,
    obs_mask: torch.Tensor,
    cfg: CorridorConfig,
    nh: int = 30,
) -> CorridorResult:
    """Seed-point decomposition (seed_decomp.h:29-33): a sphere of the given
    radius around p, supporting hyperplanes peeled off it, and the
    axis-aligned local bbox walls (seed_decomp.h:43-68)."""
    dtype, device = p.dtype, p.device
    bbox = torch.tensor(cfg.local_bbox, dtype=dtype, device=device)
    lo, hi = p - bbox, p + bbox
    mask = obs_mask & ((obs >= lo - cfg.epsilon)
                       & (obs <= hi + cfg.epsilon)).all(dim=-1)
    eye = torch.eye(3, dtype=dtype, device=device)
    E = Ellipsoid(C=radius * eye, d=p)
    obs_planes = find_polyhedron(E, obs, mask, cfg.max_obs_planes)
    wall_pts = torch.stack(
        [p + eye[1] * bbox[1], p - eye[1] * bbox[1],
         p + eye[0] * bbox[0], p - eye[0] * bbox[0],
         p + eye[2] * bbox[2], p - eye[2] * bbox[2]])
    wall_ns = torch.stack([eye[1], -eye[1], eye[0], -eye[0], eye[2], -eye[2]])
    planes = PlaneSet(
        points=torch.cat([obs_planes.points, wall_pts]),
        normals=torch.cat([obs_planes.normals, wall_ns]),
        valid=torch.cat([obs_planes.valid,
                         torch.ones(6, dtype=torch.bool, device=device)]),
    )
    A, b = planes_to_constraints(planes, p, nh)
    return CorridorResult(A=A, b=b, ellipsoid_C=E.C, ellipsoid_d=E.d)


class IterativeResult(NamedTuple):
    A: torch.Tensor           # (S, nh, 3) per final segment
    b: torch.Tensor           # (S, nh)
    path: torch.Tensor        # (S+1, 3) simplified path
    n_segments: torch.Tensor  # ()


def _simplify_mask(path: np.ndarray, A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """simplify() (iterative_decomp.h:74-93): drop waypoint i-1 when the
    current reference point is inside polyhedron i-1 with >0.1 clearance."""
    n = len(path)
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    ref = path[0]
    for i in range(2, n):
        Ai, bi = A[i - 1], b[i - 1]
        rows = np.linalg.norm(Ai, axis=-1) > 1e-9
        margin = bi[rows] - Ai[rows] @ ref
        if not (np.all(margin >= -1e-10) and margin.min() > 0.1):
            ref = path[i - 1]
            keep[i - 1] = True
    return keep


def iterative_decompose(
    path: np.ndarray,
    obs: torch.Tensor,
    obs_mask: torch.Tensor,
    cfg: CorridorConfig,
    iter_num: int = 5,
    downsample_res: float = 0.0,
    nh: int = 30,
) -> IterativeResult:
    """Iterative decomposition (iterative_decomp.h:36-52): decompose, drop
    redundant waypoints whose segment polytopes already cover them, repeat.

    The waypoint loop runs on the host (it changes the segment count); each
    round decomposes all its segments at once on obs's device.  Tensors of
    obs's dtype and device out."""
    dtype, device = obs.dtype, obs.device
    path = np.asarray(path, float)
    if downsample_res > 0 and len(path) >= 2:
        out = []
        for i in range(1, len(path)):
            d = np.linalg.norm(path[i] - path[i - 1])
            cnt = max(int(np.ceil(d / downsample_res)), 1)
            for j in range(cnt):
                out.append(path[i - 1] + j * (path[i] - path[i - 1]) / cnt)
        out.append(path[-1])
        path = np.asarray(out)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    for _ in range(iter_num + 1):
        res = decompose_segment(t(path[:-1]), t(path[1:]), obs, obs_mask,
                                cfg, nh)
        A, b = res.A.cpu().numpy(), res.b.cpu().numpy()
        new_path = path[_simplify_mask(path, A, b)]
        if len(new_path) == len(path):
            break
        path = new_path

    return IterativeResult(
        A=t(A), b=t(b), path=t(path),
        n_segments=torch.tensor(len(path) - 1, device=device),
    )
