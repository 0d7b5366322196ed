"""The plain reference of the NMPC step's stages before the solve:
references, disturbance tubes, the corridor decomposition with its reuse
rule, and the tube tightening, batched over robots, in plain PyTorch on
any device and dtype.

Frozen copy, taken at commit ad340bc, of the port's plain versions:
forces_resilient_planner_tpu_torch/engine/reference.py
(sample_references), tube/lyapunov.py (closed_loop_phi, gramian_channels,
channel_Qd_fast, ego_ellipsoid, sqrtm_psd_db, minkowski_sum, the stage
recursion of propagate_tubes_batch, tighten_corridor), corridor/decomp.py
(the line-segment decomposition) and engine/pipeline.py (corridor_seed2,
reuse_select).  Departure: every operation rounds on its own.  The port
emulates XLA:CPU's fused multiply-adds at the sites where voxel-grid ties
are decided; the reference computes in float64 and is compared with the
program's float32 rows by a tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.solver import continuous_jacobians, euler_to_rot

_PI = 3.1415926  # the reference's PI constant (nmpc_solver.cpp:3)
_BIG = 1e30
NX = 9


def norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# ---- references (engine/reference.py) ---------------------------------------

class References(NamedTuple):
    ref_pos: torch.Tensor   # (B, N, 3)
    ref_yaw: torch.Tensor   # (B, N)


def sample_references(kino_path, kino_size, t_offset, last_yaw, pred_pos1,
                      N, Ts, lookahead=5) -> References:
    """getCurTraj / calculate_yaw (nmpc_solver.cpp:109-142, 834-862)."""
    dtype, device = kino_path.dtype, kino_path.device
    B, K = kino_path.shape[0], kino_path.shape[1]
    size = kino_size.to(torch.int64)[:, None]
    i = torch.arange(N, dtype=dtype, device=device)
    index_time = i[None] * Ts + t_offset[:, None]
    kino_idx = torch.floor(index_time / Ts).to(torch.int64)
    frac = torch.remainder(index_time, Ts) / Ts
    last = torch.clamp(size - 1, min=0)
    rows = torch.arange(B, device=device)[:, None]

    def gather(idx):
        return kino_path[rows, torch.clamp(idx, 0, K - 1)]

    p0, p1 = gather(kino_idx), gather(kino_idx + 1)
    ref_pos = torch.where((kino_idx + 1 < size)[..., None],
                          p0 + frac[..., None] * (p1 - p0), gather(last))
    fwd_pos = gather(torch.where(kino_idx + lookahead < size,
                                 kino_idx + lookahead, last))
    y, yaws = last_yaw, []
    for n in range(N):
        d = fwd_pos[:, n] - ref_pos[:, n]
        yaw_t = torch.where(norm3(d) > 0.1, torch.atan2(d[:, 1], d[:, 0]), y)
        big = torch.abs(yaw_t - y) > _PI
        yaw_w = torch.where(big, torch.where(yaw_t > 0, yaw_t - 2 * _PI,
                                             yaw_t + 2 * _PI), yaw_t)
        y = 0.2 * y + 0.8 * yaw_w
        yaws.append(y)
    return References(ref_pos, torch.stack(yaws, dim=1))


# ---- tubes (tube/lyapunov.py) ------------------------------------------------

def _gramian_channels(Phi, t, w_bound, n_terms, max_doublings=4):
    dtype, device = Phi.dtype, Phi.device
    Pt = Phi * t
    norm1 = torch.amax(torch.sum(torch.abs(Pt), dim=-2), dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1 / 0.5, min=1.0)))
    s = torch.clamp(torch.nan_to_num(s, nan=0.0), 0, max_doublings)
    u_scale = 0.5 ** s
    Pu = Pt * u_scale[..., None, None]
    I = torch.eye(NX, dtype=dtype, device=device).expand(Phi.shape)
    Mm, Mp = I, I
    for m in range(n_terms, 0, -1):
        Mm = I - (Pu @ Mm) / m
        Mp = I + (Pu @ Mp) / m
    e = torch.eye(NX, dtype=dtype, device=device)[3:6]
    G = (e[:, :, None] * e[:, None, :]).expand(Phi.shape[:-2] + (3, NX, NX))
    Pu3 = Pu[..., None, :, :]
    H, X = G, G
    for m in range(1, n_terms + 1):
        PH = Pu3 @ H
        H = -(PH + PH.transpose(-1, -2)) / m
        X = X + H / (m + 1)
    X = X * (t * u_scale)[..., None, None, None]
    for k in range(max_doublings):
        live = (s > k)[..., None, None]
        MX = Mm[..., None, :, :] @ X
        X = torch.where(live[..., None, :, :],
                        X + MX @ Mm.transpose(-1, -2)[..., None, :, :], X)
        Mm = torch.where(live, Mm @ Mm, Mm)
        Mp = torch.where(live, Mp @ Mp, Mp)
    return X * (t * w_bound ** 2)[..., :, None, None], Mp


def _det_inv3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * co00 + b * co01 + c * co02
    safe = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                       det)
    adj = torch.stack([
        torch.stack([co00, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co01, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co02, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return det, adj / safe[..., None, None]


def _sqrtm_psd_db(Q, iters=12):
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    tr = torch.diagonal(Q, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    Y = Q + (1e-12 * tr + 1e-30) * eye
    Z = eye.expand(Q.shape)
    for _ in range(iters):
        g = torch.abs(_det_inv3(Y)[0] * _det_inv3(Z)[0]) ** (-1.0 / (2 * n))
        g = torch.nan_to_num(g, nan=1.0, posinf=1.0,
                             neginf=1.0)[..., None, None]
        Yn = 0.5 * (g * Y + _det_inv3(g * Z)[1])
        Z = 0.5 * (g * Z + _det_inv3(g * Y)[1])
        Y = Yn
    return 0.5 * (Y + Y.transpose(-1, -2))


def _minkowski_sum(Q1, Q2):
    t1 = torch.diagonal(Q1, dim1=-2, dim2=-1).sum(-1)
    t2 = torch.diagonal(Q2, dim1=-2, dim2=-1).sum(-1)
    beta = torch.sqrt(t1 / t2)[..., None, None]
    return (1.0 + 1.0 / beta) * Q1 + (1.0 + beta) * Q2


def tubes(Z_prev, m, tube):
    """Stage uncertainty sqrt matrices E (B, N, 3, 3) of the previous plans
    Z_prev (B, N, 17), getDistrEllipsoid (nmpc_solver.cpp:490-611)."""
    B, N = Z_prev.shape[0], Z_prev.shape[1]
    dtype, device = Z_prev.dtype, Z_prev.device
    x = Z_prev[..., 8:17].reshape(B * N, NX)
    u = Z_prev[..., 0:4].reshape(B * N, 4)
    K = torch.as_tensor(tube.K, dtype=dtype, device=device)
    Jc, Bc = continuous_jacobians(x, u, m)
    Phi = Jc + Bc @ K
    w = torch.full((3,), tube.ext_noise_bound, dtype=dtype, device=device)
    n_terms = 7 if dtype == torch.float32 else 12
    X, Mp = _gramian_channels(Phi, m.dt, w, n_terms)
    trX = torch.sqrt(torch.clamp(
        torch.diagonal(X, dim1=-2, dim2=-1).sum(-1), min=1e-30))
    Qd = trX.sum(-1)[..., None, None] * (X / trX[..., None, None]).sum(-3)
    R = euler_to_rot(x[:, 6:9])
    ego = torch.tensor([tube.ego_r ** 2, tube.ego_r ** 2, tube.ego_h ** 2],
                       dtype=dtype, device=device)
    Q1 = ((R * ego) @ R.transpose(-1, -2)).reshape(B, N, 3, 3)
    Qd, Mp = Qd.reshape(B, N, NX, NX), Mp.reshape(B, N, NX, NX)
    Q_init = ((tube.epsilon ** 2) * torch.eye(NX, dtype=dtype, device=device)
              ).expand(B, NX, NX)
    Q2 = []
    for i in range(N):
        Qu = _minkowski_sum(Q_init, Qd[:, i])
        Q2.append((Mp[:, i] @ Qu @ Mp[:, i].transpose(-1, -2))[:, 0:3, 0:3])
        Q_init = Qu
    Q2 = torch.stack(Q2, dim=1)
    Qcomb = torch.cat([Q1[:, 0:1], _minkowski_sum(Q1[:, 1:], Q2[:, :-1])],
                      dim=1)
    return _sqrtm_psd_db(Qcomb)


def tighten(A, b, E):
    """b_j - ||E a_j^T|| (forces_normal.cpp:111-136)."""
    return b - norm3(A @ E.transpose(-1, -2))


# ---- corridor decomposition (corridor/decomp.py) -----------------------------

def _frame_C(Rf, a0, a1, a2):
    return (Rf * torch.stack([a0, a1, a2], -1)[..., None, :]) @ \
        Rf.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _seed_rotation(p1, p2):
    v = p2 - p1
    pitch = torch.atan2(-v[..., 2], torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2))
    yaw = torch.atan2(v[..., 1], v[..., 0])
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(cp)
    return torch.stack([
        torch.stack([cy * cp, -sy, cy * sp], -1),
        torch.stack([cp * sy, cy, sy * sp], -1),
        torch.stack([-sp, z, cp], -1),
    ], -2)


def _ellipsoid_dist(C, d, pts):
    Ci = _det_inv3(C)[1]
    r = pts - d[..., None, :]
    q = (Ci[..., None, :, :] @ r[..., None])[..., 0]
    return torch.sqrt(dot3(q, q))


def _closest(dists, mask):
    # the sentinel held in range for a float16 control
    big = min(_BIG, torch.finfo(dists.dtype).max)
    return torch.argmin(torch.where(mask, dists, torch.full_like(dists, big)),
                        dim=-1)


def _pick(obs, idx):
    shape = torch.broadcast_shapes(obs.shape[:-2], idx.shape)
    obs = obs.expand(shape + obs.shape[-2:])
    return torch.gather(obs, -2, idx.expand(shape)[..., None, None].expand(
        shape + (1, 3)))[..., 0, :]


def _find_ellipsoid(p1, p2, obs, mask, cc):
    """Sphere-seeded iterative axis shrink (line_segment.h:134-211)."""
    f = torch.clamp(0.5 * norm3(p1 - p2), min=1e-6)
    Ri = _seed_rotation(p1, p2)
    d = 0.5 * (p1 + p2)
    eps = cc.epsilon
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
    dist0 = _ellipsoid_dist(f[..., None, None] * eye, d, obs)
    inside = mask & (dist0 <= 1.0)
    a0 = a1 = a2 = f
    Rf = Ri
    for _ in range(cc.shrink_iters):
        if not bool(inside.any()):
            break
        dists = _ellipsoid_dist(_frame_C(Rf, a0, a1, a1), d, obs)
        any_in = inside.any(dim=-1)
        pw = _pick(obs, _closest(dists, inside))
        p_loc = _mtv(Ri, pw - d)
        roll = torch.atan2(p_loc[..., 2], p_loc[..., 1])
        cr, sr = torch.cos(roll), torch.sin(roll)
        o, z = torch.ones_like(cr), torch.zeros_like(cr)
        Rx = torch.stack([torch.stack([o, z, z], -1),
                          torch.stack([z, cr, -sr], -1),
                          torch.stack([z, sr, cr], -1)], -2)
        Rf_new = Ri @ Rx
        p_r = _mtv(Rf_new, pw - d)
        q = p_r[..., 0] / a0
        denom = 1.0 - q * q
        b_new = torch.where((p_r[..., 0] < a0) & (denom > 1e-12),
                            torch.abs(p_r[..., 1])
                            / torch.sqrt(torch.clamp(denom, min=1e-12)), a1)
        Rf = torch.where(any_in[..., None, None], Rf_new, Rf)
        a1 = torch.where(any_in, b_new, a1)
        new_d = _ellipsoid_dist(_frame_C(Rf, a0, a1, a1), d, obs)
        inside = torch.where(any_in[..., None], inside & (1.0 - new_d > eps),
                             inside)
    d2 = _ellipsoid_dist(_frame_C(Rf, a0, a1, a2), d, obs)
    inside = mask & (d2 <= 1.0) & (dist0 <= 1.0)
    for _ in range(cc.shrink_iters):
        if not bool(inside.any()):
            break
        dists = _ellipsoid_dist(_frame_C(Rf, a0, a1, a2), d, obs)
        any_in = inside.any(dim=-1)
        p_r = _mtv(Rf, _pick(obs, _closest(dists, inside)) - d)
        q0, q1 = p_r[..., 0] / a0, p_r[..., 1] / a1
        dd = 1.0 - q0 * q0 - q1 * q1
        c_new = torch.where(dd > eps, torch.abs(p_r[..., 2])
                            / torch.sqrt(torch.clamp(dd, min=1e-12)), a2)
        a2 = torch.where(any_in, c_new, a2)
        new_d = _ellipsoid_dist(_frame_C(Rf, a0, a1, a2), d, obs)
        inside = torch.where(any_in[..., None], inside & (1.0 - new_d > eps),
                             inside)
    return _frame_C(Rf, a0, a1, a2), d


def _find_polyhedron(C, d, obs, mask, max_planes):
    """Supporting-hyperplane peeling (decomp_base.h:63-83)."""
    Ci = _det_inv3(C)[1]
    Mq = Ci @ Ci.transpose(-1, -2)
    dists = _ellipsoid_dist(C, d, obs)
    remain = mask.expand(dists.shape)
    pts, ns, valid = [], [], []
    for _ in range(max_planes):
        any_left = remain.any(dim=-1)
        pw = _pick(obs, _closest(dists, remain))
        n = _mv(Mq, pw - d)
        n = n / torch.clamp(norm3(n), min=1e-12)[..., None]
        sd = dot3(n[..., None, :], obs - pw[..., None, :])
        remain = torch.where(any_left[..., None], remain & (sd < 0), remain)
        gate = any_left[..., None]
        pts.append(torch.where(gate, pw, torch.zeros_like(pw)))
        ns.append(torch.where(gate, n, torch.zeros_like(n)))
        valid.append(any_left)
    return torch.stack(pts, -2), torch.stack(ns, -2), torch.stack(valid, -1)


def _bbox_planes(p1, p2, bbox):
    v = p2 - p1
    dirv = v / torch.clamp(norm3(v), min=1e-12)[..., None]
    z = torch.zeros_like(dirv[..., 0])
    dir_h = torch.stack([dirv[..., 1], -dirv[..., 0], z], -1)
    nh = norm3(dir_h)
    dir_h = torch.where((nh < 1e-12)[..., None],
                        torch.stack([-torch.ones_like(z), z, z], -1),
                        dir_h / torch.clamp(nh, min=1e-12)[..., None])
    dir_v = torch.linalg.cross(dirv, dir_h, dim=-1)
    b0, b1, b2 = (float(x) for x in bbox)
    pts = torch.stack([p1 + dir_h * b1, p1 - dir_h * b1, p2 + dirv * b0,
                       p1 - dirv * b0, p1 + dir_v * b2, p1 - dir_v * b2], -2)
    ns = torch.stack([dir_h, -dir_h, dirv, -dirv, dir_v, -dir_v], -2)
    return pts, ns


def decompose(p1, p2, obs, mask, cc, nh):
    """Line-segment decomposition -> (A (..., nh, 3), b (..., nh)): rows
    [obstacle planes (max_obs_planes), bbox walls (6), zeros], outward,
    A x <= b.  p1, p2 (..., 3); obs (..., M, 3), mask (..., M) broadcast
    against them."""
    wp, wn = _bbox_planes(p1, p2, cc.local_bbox)
    off = dot3(wn, wp)
    inside = mask
    for k in range(6):
        inside = inside & (dot3(wn[..., k, None, :], obs) - off[..., k, None]
                           <= cc.epsilon)
    C, d = _find_ellipsoid(p1, p2, obs, inside, cc)
    pp, pn, pv = _find_polyhedron(C, d, obs, inside, cc.max_obs_planes)
    pts = torch.cat([pp, wp], dim=-2)
    n = torch.cat([pn, wn], dim=-2)
    valid = torch.cat([pv, torch.ones(wn.shape[:-1], dtype=torch.bool,
                                      device=wn.device)], dim=-1)
    c = dot3(pts, n)
    flip = dot3(n, d[..., None, :]) - c > 0
    sgn = torch.where(flip, -1.0, 1.0).to(n.dtype)
    A = torch.where(valid[..., None], n * sgn[..., None], torch.zeros_like(n))
    b = torch.where(valid, c * sgn, torch.zeros_like(c))
    P = A.shape[-2]
    if P < nh:
        A = torch.cat([A, A.new_zeros(A.shape[:-2] + (nh - P, 3))], dim=-2)
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (nh - P,))], dim=-1)
    return A[..., :nh, :], b[..., :nh]


def corridors(refs: References, E, obs, mask, cfg):
    """Every stage's fresh decomposition around (ref_i, ref_i + 10 cm along
    the reference yaw) and the sequential reuse rule (getSikangConst,
    nmpc_solver.cpp:288-332): (A_sel (B, N, nh, 3), b_sel (B, N, nh))."""
    L = cfg.corridor.seed_len
    p1 = refs.ref_pos
    p2 = torch.stack([p1[..., 0] + L * torch.cos(refs.ref_yaw),
                      p1[..., 1] + L * torch.sin(refs.ref_yaw), p1[..., 2]], -1)
    A_all, b_all = decompose(p1, p2, obs[:, None], mask[:, None],
                             cfg.corridor, cfg.model.nh)
    infl = cfg.tube.reuse_inflation
    B, N = p1.shape[0], p1.shape[1]
    rows = torch.arange(B, device=p1.device)
    prev = torch.zeros(B, dtype=torch.int64, device=p1.device)
    sel = []
    for i in range(N):
        A_prev, b_prev = A_all[rows, prev], b_all[rows, prev]
        Ea = A_prev @ E[:, i].transpose(-1, -2)
        margin = dot3(A_prev, p1[:, i, None, :]) - (b_prev - infl * norm3(Ea))
        contained = torch.where(norm3(A_prev) > 1e-12, margin <= 0,
                                True).all(dim=-1)
        if i > 0:
            prev = torch.where(contained, prev, i)
        sel.append(prev)
    sel = torch.stack(sel, dim=1)
    return A_all[rows[:, None], sel], b_all[rows[:, None], sel]
