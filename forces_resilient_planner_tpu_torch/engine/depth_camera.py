"""Synthetic depth camera: analytic ray-box renderer for closed-loop sims.

The reference consumes a RotorS-simulated depth image through the
depth+odom ApproximateTime sync (occ_map.cpp:218-312, 853-868); this module
is the framework's self-contained stand-in — it renders a metric depth
image of an axis-aligned-box scene from a camera pose, so closed-loop tests
can exercise the COMPLETE sensor path (depth -> shift filter -> raycast ->
corridors) without an external simulator.

Host-side NumPy on purpose: rendering emulates the sensor, it is not part
of the planner's device compute.
"""
from __future__ import annotations

import numpy as np


class BoxSceneCamera:
    """Pinhole depth camera over a set of axis-aligned boxes.

    boxes: (K, 2, 3) array of (min_corner, max_corner) per box.
    Depth convention matches projectDepthImage (occ_map.cpp:314-355):
    the image stores camera-frame z; pixels with no hit return 0
    (invalid, below depth_filter_mindist).
    """

    def __init__(self, boxes: np.ndarray, rows: int = 120, cols: int = 160,
                 fov_x_deg: float = 90.0, max_depth: float = 10.0):
        self.boxes = np.asarray(boxes, float).reshape(-1, 2, 3)
        self.rows, self.cols = rows, cols
        self.fx = cols / (2.0 * np.tan(np.deg2rad(fov_x_deg) / 2.0))
        self.fy = self.fx
        self.cx = (cols - 1) / 2.0
        self.cy = (rows - 1) / 2.0
        self.max_depth = max_depth
        u, v = np.meshgrid(np.arange(cols), np.arange(rows))
        # camera-frame ray directions with unit z: depth t == camera z
        self._dirs_c = np.stack(
            [(u - self.cx) / self.fx, (v - self.cy) / self.fy,
             np.ones_like(u, float)], axis=-1,
        )  # (rows, cols, 3)

    @property
    def intrinsics(self):
        return self.fx, self.fy, self.cx, self.cy

    def render(self, R_wc: np.ndarray, t_wc: np.ndarray) -> np.ndarray:
        """Depth image (rows, cols) from camera pose (R_wc, t_wc)."""
        d_w = self._dirs_c @ np.asarray(R_wc, float).T      # (r, c, 3)
        o = np.asarray(t_wc, float)
        depth = np.full((self.rows, self.cols), np.inf)
        for bmin, bmax in self.boxes:
            # slab test per pixel; zero-direction components handled by inf
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (bmin[None, None] - o) / d_w
                t2 = (bmax[None, None] - o) / d_w
            tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
            hit = (tmax >= np.maximum(tmin, 0.0)) & (tmin > 0.0)
            depth = np.where(hit & (tmin < depth), tmin, depth)
        depth = np.where(np.isfinite(depth) & (depth <= self.max_depth),
                         depth, 0.0)
        return depth

    def render_from_odom(self, odom9: np.ndarray, R_ic: np.ndarray,
                        t_ic: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Render from a 9-state odom sample [p, v, rpy] through the
        body->camera extrinsic.  Returns (depth, R_wc, t_wc)."""
        from forces_resilient_planner_tpu_torch.engine.planner import _rpy_to_rot

        st = np.asarray(odom9, float)
        R_wi = _rpy_to_rot(st[6:9])
        R_wc = R_wi @ np.asarray(R_ic, float)
        t_wc = st[0:3] + R_wi @ np.asarray(t_ic, float)
        return self.render(R_wc, t_wc), R_wc, t_wc
