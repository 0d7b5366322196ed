"""Occupancy mapping: log-odds voxel grid + batched raycasting (torch).

Port of forces_resilient_planner_tpu/mapping/occ_grid.py (occ_grid/src/
occ_map.cpp + raycast.cpp of the reference):
  - dense log-odds buffer, linear layout x*ny*nz + y*nz + z, initialised
    to clamp_min_log;
  - voxel state: -1 outside the map, 0 outside the local window or free,
    1 occupied iff log-odds > min_occupancy_log;
  - depth-image projection and the temporal-consistency shift filter;
  - Amanatides-Woo backward raycast, every ray stepped at once, with the
    batched hit/miss majority vote per voxel;
  - collision checks checkPosSurround / checkState.

The grid is a NamedTuple of tensors; its device and dtype are those of
its tensors.  The arithmetic is that of the JAX package's jitted callers
(the fleet, the planner): XLA turns a division by a constant into a
multiplication by its reciprocal, so pos_to_index and the raycast scale
by 1 / res; set_occupancy, which every caller of the JAX package runs
outside jit, divides by res.  Scatters that JAX writes with mode="drop" go through a
sentinel slot past the end that is sliced off.  Two behaviours of the JAX
package are kept as they are, because the port is held to it:
  - set_occupancy sends masked and out-of-map points to index -1 in every
    axis, which JAX normalises to the far-corner voxel (nx-1, ny-1, nz-1)
    before it drops anything, so a masked point maxes that voxel to
    clamp_max_log;
  - _raycast_voxels steps in floor(p / res) without the map origin, while
    pos_to_index subtracts it, so the miss votes land origin / res voxels
    away from the ray.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.config import MapConfig
from forces_resilient_planner_tpu_torch.utils.lanes import norm3


class OccGrid(NamedTuple):
    buffer: torch.Tensor      # (nx, ny, nz) float log odds
    local_min: torch.Tensor   # (3,) local-window bounds [m]
    local_max: torch.Tensor   # (3,)


def make_grid(cfg: MapConfig, dtype=torch.float32, *, device) -> OccGrid:
    origin = torch.tensor(cfg.origin, dtype=dtype, device=device)
    size = torch.tensor(cfg.size, dtype=dtype, device=device)
    return OccGrid(
        buffer=torch.full(cfg.grid_shape, cfg.clamp_min_log, dtype=dtype,
                          device=device),
        local_min=origin,
        local_max=origin + size,
    )


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def pos_to_index(pos: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    return torch.floor((pos - _vec(cfg.origin, pos)) * (1.0 / cfg.resolution)
                       ).to(torch.int32)


def in_map(idx: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    shape = torch.tensor(cfg.grid_shape, dtype=idx.dtype, device=idx.device)
    return ((idx >= 0) & (idx < shape)).all(dim=-1)


def flat_index(idx: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Linear voxel index x*ny*nz + y*nz + z of (..., 3) voxel indices."""
    _, ny, nz = cfg.grid_shape
    idx = idx.to(torch.int64)
    return idx[..., 0] * (ny * nz) + idx[..., 1] * nz + idx[..., 2]


def voxel_state(grid: OccGrid, pos: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """-1 outside map / 0 free (or outside local window) / 1 occupied."""
    idx = pos_to_index(pos, cfg)
    inside = in_map(idx, cfg)
    in_local = ((pos >= grid.local_min) & (pos <= grid.local_max)).all(dim=-1)
    hi = torch.tensor(cfg.grid_shape, dtype=idx.dtype, device=idx.device) - 1
    ic = torch.minimum(torch.clamp(idx, min=0), hi)
    occ = grid.buffer.reshape(-1)[flat_index(ic, cfg)] > cfg.min_occupancy_log
    state = (occ & in_local).to(torch.int32)
    return torch.where(inside, state, -1)


def set_occupancy(grid: OccGrid, points: torch.Tensor, mask: torch.Tensor,
                  cfg: MapConfig) -> OccGrid:
    """Global-map mode: mark voxels occupied (occ_map.cpp:84-93).  Masked
    and out-of-map points max the far-corner voxel, as in the JAX package
    (its index -1 wraps before mode="drop" applies)."""
    idx = torch.floor((points - _vec(cfg.origin, points)) / cfg.resolution
                      ).to(torch.int32)
    ok = mask & in_map(idx, cfg)
    corner = math.prod(cfg.grid_shape) - 1
    flat = torch.where(ok, flat_index(idx, cfg), corner)
    buf = grid.buffer.reshape(-1).clone()
    buf[flat] = torch.clamp(buf[flat], min=cfg.clamp_max_log)
    return grid._replace(buffer=buf.reshape(cfg.grid_shape))


def check_pos_surround(
    grid: OccGrid, pos: torch.Tensor, inflate_ratio: float,
    ego_r: float, ego_h: float, cfg: MapConfig,
) -> torch.Tensor:
    """True = free box around pos (checkPosSurround, occ_map.cpp:625-643);
    pos (..., 3) -> (...).  Any voxel state != 0 (occupied or outside
    map) collides."""
    xs = math.ceil(ego_r * inflate_ratio / cfg.resolution)
    zs = math.ceil(ego_h * inflate_ratio / cfg.resolution)
    ox = torch.arange(-xs, xs + 1, dtype=pos.dtype,
                      device=pos.device) * cfg.resolution
    oz = torch.arange(-zs, zs + 1, dtype=pos.dtype,
                      device=pos.device) * cfg.resolution
    dx, dy, dz = torch.meshgrid(ox, ox, oz, indexing="ij")
    offs = torch.stack([dx, dy, dz], dim=-1).reshape(-1, 3)
    pts = pos[..., None, :] + offs
    return (voxel_state(grid, pts, cfg) == 0).all(dim=-1)


def _line_samples(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """n points from a to b, (..., 3) -> (..., n, 3), with jnp.linspace's
    parameters i * (1 / (n - 1)) under jit and an exact endpoint."""
    t = torch.cat([
        torch.arange(n - 1, dtype=a.dtype, device=a.device) * (1.0 / (n - 1)),
        torch.ones(1, dtype=a.dtype, device=a.device),
    ])[:, None]
    return a[..., None, :] + t * (b - a)[..., None, :]


def check_state(
    grid: OccGrid, pos: torch.Tensor, vel: torch.Tensor, inflate_ratio: float,
    ego_r: float, ego_h: float, cfg: MapConfig,
    n_h: int = 12, n_v: int = 4,
) -> torch.Tensor:
    """Velocity-oriented two-line free check (checkState, occ_map.cpp:
    645-684): horizontal chord perpendicular to the horizontal velocity +
    vertical segment; True = free.  pos, vel (..., 3) -> (...)."""
    vx, vy = vel[..., 0], vel[..., 1]
    slow = torch.sqrt(vx * vx + vy * vy) < 1e-4
    vx = torch.where(slow, torch.ones_like(vx), vx)
    vy = torch.where(slow, torch.ones_like(vy), vy)
    cx, cy = vy, -vx
    n = torch.clamp(torch.sqrt(cx * cx + cy * cy), min=1e-12)
    cx = cx / n * ego_r * inflate_ratio
    cy = cy / n * ego_r * inflate_ratio
    cw3 = torch.stack([cx, cy, torch.zeros_like(cx)], dim=-1)
    h = _vec([0.0, 0.0, ego_h * inflate_ratio], pos)
    pts = torch.cat([
        _line_samples(pos + cw3, pos - cw3, n_h),
        _line_samples(pos + h, pos - h, n_v),
    ], dim=-2)
    return (voxel_state(grid, pts, cfg) == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# depth projection + raycast update
# ---------------------------------------------------------------------------
def project_depth(
    depth: torch.Tensor,       # (rows, cols) metric depth [m], <=0 invalid
    R_wc: torch.Tensor,        # (3, 3) camera-to-world rotation
    t_wc: torch.Tensor,        # (3,) camera position in world
    cfg: MapConfig,
    fx: float, fy: float, cx: float, cy: float,
):
    """Unproject depth pixels to world points (projectDepthImage,
    occ_map.cpp:314-439, skip_pixel + margin subsampling).
    Returns (points (M,3), valid (M,))."""
    rows, cols = depth.shape
    s = cfg.skip_pixel
    m = cfg.depth_filter_margin
    vs = torch.arange(m, rows - m, s, device=depth.device)
    us = torch.arange(m, cols - m, s, device=depth.device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d = depth[vv, uu]
    valid = (d >= cfg.depth_filter_mindist) & torch.isfinite(d)
    d_eff = torch.clamp(d, 0.0, cfg.depth_filter_maxdist)
    x = (uu.to(d.dtype) - cx) * d_eff / fx
    y = (vv.to(d.dtype) - cy) * d_eff / fy
    pc = torch.stack([x, y, d_eff], dim=-1).reshape(-1, 3)
    pw = pc @ R_wc.T + t_wc[None]
    return pw, valid.reshape(-1)


def _unit_mod(x: torch.Tensor) -> torch.Tensor:
    """jnp.mod(x, 1.0): the remainder with the divisor's sign."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0) & (r < 0), r + 1.0, r)


def _raycast_voxels(
    start: torch.Tensor, end: torch.Tensor, max_steps: int, cfg: MapConfig
):
    """Amanatides-Woo voxel traversal from start to end (world coords), the
    start voxel excluded (raycastProcess skips the projected point's voxel,
    occ_map.cpp:487-489); every ray of start (M, 3) at once, end (3,) or
    (M, 3).  One loop of max_steps over all rays, the axis of each step the
    first minimum of tmax (jnp.argmin).  Returns (voxels (M, S, 3) int32,
    valid (M, S))."""
    inv = 1.0 / cfg.resolution
    s = start * inv
    e = (end * inv).expand_as(s)
    x = torch.floor(s).to(torch.int32)
    x1 = torch.floor(e).to(torch.int32)
    d = e - s
    step = torch.sign(d).to(torch.int32)
    sv = _unit_mod(_unit_mod(s) + 1.0)
    inf = torch.full_like(d, math.inf)
    tmax = torch.where(d > 0, (1.0 - sv) / d,
                       torch.where(d < 0, sv / (-d), inf))
    tdelta = torch.where(step != 0,
                         torch.abs(1.0 / torch.where(d == 0, 1.0, d)), inf)
    alive = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)
    vox, valid = [], []
    for _ in range(max_steps):
        t0, t1, t2 = tmax.unbind(-1)
        axis = torch.where((t0 <= t1) & (t0 <= t2), 0,
                           torch.where(t1 <= t2, 1, 2))
        hot = torch.nn.functional.one_hot(axis, 3).bool()
        alive = alive & ~(x == x1).all(dim=-1)
        move = hot & alive[..., None]
        x = torch.where(move, x + step, x)
        tmax = torch.where(move, tmax + tdelta, tmax)
        vox.append(x)
        valid.append(alive)
    return torch.stack(vox, dim=-2), torch.stack(valid, dim=-1)


def raycast_update(
    grid: OccGrid,
    points: torch.Tensor,      # (M, 3) world-frame depth points
    point_valid: torch.Tensor, # (M,)
    t_wc: torch.Tensor,        # (3,) camera position
    cfg: MapConfig,
) -> OccGrid:
    """Batched log-odds update (raycastProcess, occ_map.cpp:441-533)."""
    dtype = grid.buffer.dtype
    shape = cfg.grid_shape
    n_total = math.prod(shape)
    max_steps = int(cfg.max_ray_length / cfg.resolution * 2 + 4)

    rel = points - t_wc[None]
    length = norm3(rel)
    too_short = length < cfg.min_ray_length
    too_long = length > cfg.max_ray_length
    dirn = rel / torch.clamp(length, min=1e-9)[:, None]
    end_pts = torch.where(
        too_long[:, None], t_wc[None] + dirn * cfg.max_ray_length, points
    )
    use = point_valid & ~too_short
    is_hit = use & ~too_long  # clipped rays mark their end as a miss

    # endpoint votes; n_total is the dropped sentinel slot
    end_idx = pos_to_index(end_pts, cfg)
    end_ok = use & in_map(end_idx, cfg)
    end_flat = torch.where(end_ok, flat_index(end_idx, cfg), n_total)

    # traversal votes (miss)
    vox, vvalid = _raycast_voxels(end_pts, t_wc, max_steps, cfg)
    vok = vvalid & use[:, None] & in_map(vox, cfg)
    vflat = torch.where(vok, flat_index(vox, cfg), n_total).reshape(-1)

    zeros = torch.zeros(n_total + 1, dtype=dtype, device=points.device)
    hits = zeros.index_add(0, end_flat, is_hit.to(dtype))
    total = zeros.index_add(0, end_flat, torch.ones_like(end_flat, dtype=dtype))
    total = total.index_add(0, vflat, torch.ones_like(vflat, dtype=dtype))
    hits, total = hits[:n_total], total[:n_total]

    log_update = torch.where(hits >= total - hits,
                             zeros.new_tensor(cfg.prob_hit_log),
                             zeros.new_tensor(cfg.prob_miss_log))
    buf = grid.buffer.reshape(-1)
    new_buf = torch.clamp(
        buf + torch.where(total > 0, log_update, 0.0),
        cfg.clamp_min_log, cfg.clamp_max_log,
    )
    return grid._replace(buffer=new_buf.reshape(shape))


def update_local_window(
    grid: OccGrid, cam_pos: torch.Tensor, sensor_range: torch.Tensor
) -> OccGrid:
    """Local map window follows the sensor (occ_map.cpp:273-274)."""
    return grid._replace(
        local_min=cam_pos - sensor_range, local_max=cam_pos + sensor_range
    )


def _axis_centers(n: int, o: float, cfg: MapConfig, like: torch.Tensor):
    """Voxel-center coordinate along one axis: (i + 0.5) * res + origin."""
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    return (i + 0.5) * cfg.resolution + o


def occupied_cloud(grid: OccGrid, cfg: MapConfig, max_points: int,
                   window_only: bool = True):
    """Extract occupied voxel centers as a fixed-size padded buffer + mask,
    occupied voxels first in index order (JAX's stable argsort(~occ)).

    window_only=True is the local_view_cloud (localOccVisCallback,
    occ_map.cpp:177-215: occupied voxels INSIDE the sensor-following
    window) — the cloud the reference feeds corridor generation
    (nmpc_solver.cpp:990-995).  window_only=False is the
    history_view_cloud (globalOccVisCallback, occ_map.cpp:150-175: the
    whole map).
    """
    nx, ny, nz = cfg.grid_shape
    buf = grid.buffer
    axes = [_axis_centers(n, o, cfg, buf)
            for n, o in zip(cfg.grid_shape, cfg.origin)]
    occ = buf > cfg.min_occupancy_log
    if window_only:
        w = [(c >= lo) & (c <= hi) for c, lo, hi in
             zip(axes, grid.local_min, grid.local_max)]
        occ = occ & w[0][:, None, None] & w[1][None, :, None] & w[2][None, None, :]
    occ = occ.reshape(-1)
    _, order = torch.sort((~occ).to(torch.uint8), stable=True)
    sel = order[:max_points]
    pts = torch.stack([axes[0][sel // (ny * nz)], axes[1][(sel // nz) % ny],
                       axes[2][sel % nz]], dim=-1)
    return pts, occ[sel]


def history_cloud(grid: OccGrid, cfg: MapConfig, max_points: int):
    """Whole-map occupied cloud (history_view_cloud analog,
    occ_map.cpp:150-175)."""
    return occupied_cloud(grid, cfg, max_points, window_only=False)


def project_depth_shift_filter(
    depth: torch.Tensor,       # current metric depth (rows, cols)
    R_wc: torch.Tensor, t_wc: torch.Tensor,
    last_depth: torch.Tensor,  # previous frame
    last_R_wc: torch.Tensor, last_t_wc: torch.Tensor,
    cfg: MapConfig,
    fx: float, fy: float, cx: float, cy: float,
):
    """Temporal-consistency ("shift") depth filter
    (projectDepthImage use_shift_filter branch, occ_map.cpp:357-430).

    Each unprojected point is reprojected into the previous camera frame; it
    is kept if the previous depth there agrees within
    depth_filter_tolerance, or if it reprojects outside the previous image
    (a newly-revealed point).  Returns (points (M,3), valid (M,)).
    """
    pw, valid = project_depth(depth, R_wc, t_wc, cfg, fx, fy, cx, cy)
    pc = (pw - last_t_wc[None]) @ last_R_wc      # R^T (p - t), row-wise
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    uu = pc[:, 0] * fx / safe_z + cx
    vv = pc[:, 1] * fy / safe_z + cy
    rows, cols = depth.shape
    in_img = (uu >= 0) & (uu < cols) & (vv >= 0) & (vv < rows) & (z > 0)
    # .to(int32) truncates toward zero, as JAX's astype does
    ui = torch.clamp(uu.to(torch.int32), 0, cols - 1)
    vi = torch.clamp(vv.to(torch.int32), 0, rows - 1)
    drift = torch.abs(last_depth[vi, ui] - z)
    consistent = drift < cfg.depth_filter_tolerance
    keep = valid & torch.where(in_img, consistent, True)
    return pw, keep
