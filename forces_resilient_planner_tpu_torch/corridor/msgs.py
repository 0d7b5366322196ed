"""Typed interchange records for corridor/tube geometry.

Analog of the reference's decomp_ros_msgs package (Ellipsoid.msg: d[3] +
E[9]; Polyhedron.msg: point+normal lists; the *Array wrappers), which is
how corridors and uncertainty ellipsoids travel between the planner, the
rviz plugins and loggers.  Here the transport is plain arrays + JSON:
framework outputs serialize losslessly for offline viewers
(utils/scene.py), parity dumps, and cross-process feeds.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from pathlib import Path

import numpy as np


@dataclass
class EllipsoidMsg:
    """d: center (3,), E: shape matrix (3, 3) — decomp_ros_msgs/Ellipsoid."""

    d: np.ndarray
    E: np.ndarray

    def to_dict(self):
        return {"d": np.asarray(self.d, float).tolist(),
                "E": np.asarray(self.E, float).reshape(9).tolist()}

    @classmethod
    def from_dict(cls, d):
        return cls(d=np.asarray(d["d"], float),
                   E=np.asarray(d["E"], float).reshape(3, 3))


@dataclass
class PolyhedronMsg:
    """Half-spaces as surface points + outward normals —
    decomp_ros_msgs/Polyhedron."""

    points: np.ndarray    # (m, 3)
    normals: np.ndarray   # (m, 3)

    def to_dict(self):
        return {"points": np.asarray(self.points, float).tolist(),
                "normals": np.asarray(self.normals, float).tolist()}

    @classmethod
    def from_dict(cls, d):
        return cls(points=np.asarray(d["points"], float),
                   normals=np.asarray(d["normals"], float))

    def to_constraints(self):
        """(A, b) with A x <= b, outward rows (polyhedron.h:98-147)."""
        n = np.asarray(self.normals, float)
        p = np.asarray(self.points, float)
        return n, np.sum(n * p, axis=-1)

    @classmethod
    def from_constraints(cls, A, b):
        """Rows of A x <= b -> point+normal form; zero rows (masked corridor
        slots) are dropped."""
        A = np.asarray(A, float)
        b = np.asarray(b, float)
        nn = np.linalg.norm(A, axis=-1)
        keep = nn > 1e-9
        A, b, nn = A[keep], b[keep], nn[keep]
        normals = A / nn[:, None]
        points = normals * (b / nn)[:, None]
        return cls(points=points, normals=normals)


@dataclass
class SceneMsg:
    """One solve's geometry bundle (PolyhedronArray + EllipsoidArray +
    trajectories), the framework's per-tick observability record."""

    polyhedra: list = field(default_factory=list)     # [PolyhedronMsg]
    ellipsoids: list = field(default_factory=list)    # [EllipsoidMsg]
    traj: np.ndarray | None = None                    # (N, 3)
    ref: np.ndarray | None = None                     # (N, 3)
    meta: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "polyhedra": [p.to_dict() for p in self.polyhedra],
            "ellipsoids": [e.to_dict() for e in self.ellipsoids],
            "traj": None if self.traj is None else np.asarray(self.traj, float).tolist(),
            "ref": None if self.ref is None else np.asarray(self.ref, float).tolist(),
            "meta": self.meta,
        })

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        return cls(
            polyhedra=[PolyhedronMsg.from_dict(p) for p in d["polyhedra"]],
            ellipsoids=[EllipsoidMsg.from_dict(e) for e in d["ellipsoids"]],
            traj=None if d["traj"] is None else np.asarray(d["traj"], float),
            ref=None if d["ref"] is None else np.asarray(d["ref"], float),
            meta=d["meta"],
        )

    def save(self, path):
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path):
        return cls.from_json(Path(path).read_text())
