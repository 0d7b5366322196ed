"""The plain reference solve: the monotone primal-dual interior-point
method of the NMPC problem, lane-major (the batch on the last axis), in
plain PyTorch on any device and dtype.

Frozen copy, taken at commit ad340bc, of the port's plain solver path:
forces_resilient_planner_tpu_torch/solver/ipm_lanes.py (lane_step's
monotone branch, _init_state, _state_to_result, _run_lanes' loop),
solver/nlp.py (make_stage_weights, variable_bounds), solver/riccati.py
(lqr_factor_ll, lqr_solve_ll), ops/lqr_kernel.py (the plain K4 versions:
_assemble_qp_blocks, _aug_dynamics), dynamics/quadrotor.py (the RK2 step
and its analytic Jacobians), solver/problems.py (hover_warm_start) and
utils/lanes.py.  Departures: the predictor-corrector branch and the tiers
are left out (the configurations run the monotone path, and the tiers
give the single-phase result bit for bit), and the loop stops when every
lane is done or at max_iters, as the program's does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NXB, NU, NZ = 13, 4, 17


class StageWeights(NamedTuple):
    w_wp: torch.Tensor
    w_input: torch.Tensor
    w_rate: torch.Tensor
    w_vel: torch.Tensor
    w_uprev0: torch.Tensor


class Problem(NamedTuple):
    """One NLP per lane, batch-leading: xinit (B, 9), ref_pos (B, N, 3),
    ref_yaw (B, N), f_ext (B, 3), corridor_A (B, N, nh, 3), corridor_b
    (B, N, nh) tightened, weights (B, N) each."""
    xinit: torch.Tensor
    ref_pos: torch.Tensor
    ref_yaw: torch.Tensor
    f_ext: torch.Tensor
    corridor_A: torch.Tensor
    corridor_b: torch.Tensor
    weights: StageWeights


class Solution(NamedTuple):
    Z: torch.Tensor          # (B, N, 17)
    exit_code: torch.Tensor  # (B,) int32
    iters: torch.Tensor      # (B,) int32


# ---- fixed-order sums (utils/lanes.py) -------------------------------------

def sum_dim(x, dim):
    acc = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        acc = acc + x.select(dim, j)
    return acc


def lane_sum(x):
    x = x.reshape(-1, x.shape[-1])
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = x[0::2] + x[1::2]
    return x[0]


# ---- weights, bounds, warm start (solver/nlp.py, solver/problems.py) ------

def stage_weights(w, N, final, dtype, device) -> StageWeights:
    """Per-stage weight table of one profile (forces_normal.cpp:36-52)."""
    if final:
        w_wp = np.full(N, w.w_final_stage_wp)
        w_in = np.full(N, w.w_final_stage_input)
        w_wp[-1] = w.w_final_terminal_wp
        w_in[-1] = w.w_final_terminal_input
        w_vel = np.zeros(N)
        w_vel[-1] = w.final_brake_factor * w.w_final_terminal_wp
    else:
        w_wp = np.full(N, w.w_stage_wp)
        w_in = np.full(N, w.w_stage_input)
        w_wp[-1] = w.w_terminal_wp
        w_in[-1] = w.w_terminal_input
        w_vel = np.zeros(N)
    w_rate = np.full(N, w.w_input_rate)
    w_uprev0 = np.zeros(N)
    w_uprev0[0] = w.stage1_uprev_factor * w_in[0]
    return StageWeights(*(torch.as_tensor(a, dtype=dtype, device=device)
                          for a in (w_wp, w_in, w_rate, w_vel, w_uprev0)))


def variable_bounds(m, dtype, device):
    """(lb, ub) of shape (17,), mpc_generator_normal.m:28-46."""
    r = m.max_rate
    mx, my, mz = m.map_halfsize
    lb = [-r, -r, -r, m.min_thrust, -r, -r, -r, m.min_thrust, -mx, -my, 0.0,
          -m.max_vel, -m.max_vel, -m.max_vel, -m.max_tilt, -m.max_tilt,
          -m.max_yaw]
    ub = [r, r, r, m.max_thrust, r, r, r, m.max_thrust, mx, my, mz,
          m.max_vel, m.max_vel, m.max_vel, m.max_tilt, m.max_tilt, m.max_yaw]
    return (torch.tensor(lb, dtype=dtype, device=device),
            torch.tensor(ub, dtype=dtype, device=device))


def hover_warm_start(state, m, N):
    """Z0 (..., N, 17): zero rates, hover thrust, the state replicated
    (initMPCOutput, nmpc_solver.cpp:265-286)."""
    t = m.hover_thrust
    seed = torch.tensor([0.0, 0.0, 0.0, t, 0.0, 0.0, 0.0, t],
                        dtype=state.dtype, device=state.device)
    row = torch.cat([seed.expand(state.shape[:-1] + (8,)), state], dim=-1)
    return row[..., None, :].expand(state.shape[:-1] + (N, NZ)).contiguous()


# ---- dynamics (dynamics/quadrotor.py) --------------------------------------

def euler_to_rot(rpy):
    """ZYX rotation Rz(yaw) Ry(pitch) Rx(roll): (..., 3) -> (..., 3, 3)."""
    cr, sr = torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0])
    cp, sp = torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1])
    cy, sy = torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2])
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - cr * sy, cy * sp * cr + sy * sr],
                    -1),
        torch.stack([cp * sy, cy * cr + sy * sp * sr, sy * sp * cr - cy * sr],
                    -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def continuous_dynamics(x, u, f_ext, m):
    """xdot = f(x, u, f_ext), nonlinear_dynamics.m:20-40."""
    vel = x[..., 3:6]
    R = euler_to_rot(x[..., 6:9])
    drag = torch.tensor([m.drag_coeff, m.drag_coeff, 0.0], dtype=x.dtype,
                        device=x.device)
    v_body = sum_dim(R * vel[..., :, None], -2)
    drag_acc = sum_dim(R * (drag * v_body)[..., None, :], -1)
    g_vec = torch.zeros_like(vel)
    g_vec[..., 2] = m.g
    acc = R[..., :, 2] * (u[..., 3:4] / m.mass) + f_ext - g_vec - drag_acc
    return torch.cat([vel, acc, u[..., 0:3]], dim=-1)


def rk2_step(x, u, f_ext, m):
    """Heun RK2 (transit.m)."""
    k1 = continuous_dynamics(x, u, f_ext, m)
    k2 = continuous_dynamics(x + m.dt * k1, u, f_ext, m)
    return x + 0.5 * m.dt * (k1 + k2)


def _mm3(a, b):
    return sum_dim(a[..., :, :, None] * b[..., None, :, :], -2)


def _rot_factors(rpy):
    cr, sr = torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0])
    cp, sp = torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1])
    cy, sy = torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2])
    z, o = torch.zeros_like(cr), torch.ones_like(cr)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    return (mat([[o, z, z], [z, cr, -sr], [z, sr, cr]]),
            mat([[z, z, z], [z, -sr, -cr], [z, cr, -sr]]),
            mat([[cp, z, sp], [z, o, z], [-sp, z, cp]]),
            mat([[-sp, z, cp], [z, z, z], [-cp, z, -sp]]),
            mat([[cy, -sy, z], [sy, cy, z], [z, z, o]]),
            mat([[-sy, -cy, z], [cy, -sy, z], [z, z, z]]))


def continuous_jacobians(x, u, m):
    """Closed-form continuous-time Jacobians (Jc (..., 9, 9), Bc (..., 9, 4))."""
    dtype, device = x.dtype, x.device
    vel = x[..., 3:6]
    Rx, dRx, Ry, dRy, Rz, dRz = _rot_factors(x[..., 6:9])
    R = _mm3(Rz, _mm3(Ry, Rx))
    dRs = (_mm3(Rz, _mm3(Ry, dRx)), _mm3(Rz, _mm3(dRy, Rx)),
           _mm3(dRz, _mm3(Ry, Rx)))
    D = torch.tensor([m.drag_coeff, m.drag_coeff, 0.0], dtype=dtype,
                     device=device)
    RD = R * D[..., None, :]
    Rt = R.transpose(-1, -2)
    Tm = (u[..., 3] / m.mass)[..., None]
    cols = []
    for dR in dRs:
        dRDRt = _mm3(dR * D[..., None, :], Rt) + _mm3(RD, dR.transpose(-1, -2))
        cols.append(dR[..., :, 2] * Tm - sum_dim(dRDRt * vel[..., None, :], -1))
    shape = x.shape[:-1]
    eye3 = torch.eye(3, dtype=dtype, device=device).expand(shape + (3, 3))
    Jc = torch.zeros(shape + (9, 9), dtype=dtype, device=device)
    Jc[..., 0:3, 3:6] = eye3
    Jc[..., 3:6, 3:6] = -_mm3(RD, Rt)
    Jc[..., 3:6, 6:9] = torch.stack(cols, dim=-1)
    Bc = torch.zeros(shape + (9, 4), dtype=dtype, device=device)
    Bc[..., 3:6, 3] = R[..., :, 2] / m.mass
    Bc[..., 6:9, 0:3] = eye3
    return Jc, Bc


def rk2_jacobians(x, u, f_ext, m):
    """Heun-step Jacobians: A = I + dt/2 (J1 + J2 + dt J2 J1),
    B = dt/2 (B1 + B2 + dt J2 B1)."""
    dt = m.dt
    x_mid = x + dt * continuous_dynamics(x, u, f_ext, m)
    J1, B1 = continuous_jacobians(x, u, m)
    J2, B2 = continuous_jacobians(x_mid, u, m)
    eye9 = torch.eye(9, dtype=x.dtype, device=x.device)
    return (eye9 + 0.5 * dt * (J1 + J2 + dt * _mm3(J2, J1)),
            0.5 * dt * (B1 + B2 + dt * _mm3(J2, B1)))


# ---- Riccati factor and backsolve (solver/riccati.py, ops/lqr_kernel.py) --

def _mm_ll(a, b):
    return sum_dim(a[:, :, None, :] * b[None, :, :, :], 1)


def _mv_ll(a, v):
    return sum_dim(a * v[None, :, :], 1)


def _t_ll(a):
    return a.transpose(0, 1)


def _chol4(A):
    eps = torch.tensor(1e-30, dtype=A.dtype, device=A.device)
    l00 = torch.sqrt(torch.maximum(A[0, 0], eps))
    l10, l20, l30 = A[1, 0] / l00, A[2, 0] / l00, A[3, 0] / l00
    l11 = torch.sqrt(torch.maximum(A[1, 1] - l10 * l10, eps))
    l21 = (A[2, 1] - l20 * l10) / l11
    l31 = (A[3, 1] - l30 * l10) / l11
    l22 = torch.sqrt(torch.maximum(A[2, 2] - l20 * l20 - l21 * l21, eps))
    l32 = (A[3, 2] - l30 * l20 - l31 * l21) / l22
    l33 = torch.sqrt(torch.maximum(
        A[3, 3] - l30 * l30 - l31 * l31 - l32 * l32, eps))
    return torch.stack((l00, l10, l20, l30, l11, l21, l31, l22, l32, l33))


def _chol4_solve(f, Bm):
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = (
        f[i][None] for i in range(10))
    b0, b1, b2, b3 = Bm[0], Bm[1], Bm[2], Bm[3]
    y0 = b0 / l00
    y1 = (b1 - l10 * y0) / l11
    y2 = (b2 - l20 * y0 - l21 * y1) / l22
    y3 = (b3 - l30 * y0 - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00
    return torch.stack([x0, x1, x2, x3], dim=0)


class Factor(NamedTuple):
    P: torch.Tensor
    K: torch.Tensor
    cRh: torch.Tensor
    RiS: torch.Tensor
    cRt: torch.Tensor


def _qp_blocks(w, A, sigma, reg, rmax2):
    """W = H + J_g^T diag(sigma) J_g + reg I in the Riccati partition:
    Wp (N,13,13,B), Rp (N,4,4,B), Sp (N,4,13,B)."""
    N, _, _, B = A.shape
    dtype, device = A.dtype, A.device
    sig_u = sigma[:, 0:4] + sigma[:, 17:21]
    sig_up = sigma[:, 4:8] + sigma[:, 21:25]
    sig_x = sigma[:, 8:17] + sigma[:, 25:34]
    sc = sigma[:, 34:]
    w_rate = w.w_rate[:, None]
    r_diag = 2.0 * w_rate + sig_u + reg
    r_diag[:, 0:3] += 2.0 * w.w_input[:, None] / rmax2
    Rp = torch.zeros((N, NU, NU, B), dtype=dtype, device=device)
    for k in range(NU):
        Rp[:, k, k] = r_diag[:, k]
    x_diag = sig_x + reg
    x_diag[:, 0:3] += 2.0 * w.w_wp[:, None]
    x_diag[:, 3:6] += 2.0 * w.w_vel[:, None]
    x_diag[:, 8] += 24.0 * w.w_wp
    up_diag = 2.0 * w_rate + sig_up + reg
    up_diag[:, 0:3] += 2.0 * w.w_uprev0[:, None]
    Wp = torch.zeros((N, NXB, NXB, B), dtype=dtype, device=device)
    for k in range(9):
        Wp[:, k, k] = x_diag[:, k]
    for k in range(NU):
        Wp[:, 9 + k, 9 + k] = up_diag[:, k]
    for j in range(3):
        Asj = A[:, :, j] * sc
        for l in range(j, 3):
            blk = sum_dim(Asj * A[:, :, l], 1)
            Wp[:, j, l] += blk
            if l != j:
                Wp[:, l, j] += blk
    Sp = torch.zeros((N, NU, NXB, B), dtype=dtype, device=device)
    for k in range(NU):
        Sp[:, k, 9 + k] = -2.0 * w_rate[:, 0]
    return Wp, Rp, Sp


def _aug_dynamics(Ax, Bx):
    N1, _, _, B = Ax.shape
    Abar = torch.zeros((N1, NXB, NXB, B), dtype=Ax.dtype, device=Ax.device)
    Abar[:, :9, :9] = Ax
    Bbar = torch.zeros((N1, NXB, NU, B), dtype=Ax.dtype, device=Ax.device)
    Bbar[:, :9, :] = Bx
    for k in range(NU):
        Bbar[:, 9 + k, k] = 1.0
    return Abar, Bbar


def _factor(Q, R, S, A, B) -> Factor:
    N = Q.shape[0]
    cRt = _chol4(R[-1])
    RiS = _chol4_solve(cRt, S[-1])
    P = Q[-1] - _mm_ll(_t_ll(S[-1]), RiS)
    Ps, Ks, cRhs = [P], [], []
    for i in range(N - 2, -1, -1):
        AtP = _mm_ll(_t_ll(A[i]), P)
        BtP = _mm_ll(_t_ll(B[i]), P)
        Qh = Q[i] + _mm_ll(AtP, A[i])
        Rh = R[i] + _mm_ll(BtP, B[i])
        Sh = S[i] + _mm_ll(BtP, A[i])
        fh = _chol4(Rh)
        K = -_chol4_solve(fh, Sh)
        Pn = Qh + _mm_ll(_t_ll(Sh), K)
        P = 0.5 * (Pn + Pn.transpose(0, 1))
        Ps.append(P)
        Ks.append(K)
        cRhs.append(fh)
    return Factor(torch.stack(Ps[::-1]), torch.stack(Ks[::-1]),
                  torch.stack(cRhs[::-1]), RiS, cRt)


def _backsolve(fac: Factor, A, B, c, qx, qu, dx0):
    N = qx.shape[0]
    Riqu = _chol4_solve(fac.cRt, qu[-1][:, None])[:, 0]
    p = qx[-1] - _mv_ll(_t_ll(fac.RiS), qu[-1])
    ps, ks = [p], []
    for i in range(N - 2, -1, -1):
        Pc = p + _mv_ll(fac.P[i + 1], c[i])
        qxh = qx[i] + _mv_ll(_t_ll(A[i]), Pc)
        quh = qu[i] + _mv_ll(_t_ll(B[i]), Pc)
        ks.append(-_chol4_solve(fac.cRh[i], quh[:, None])[:, 0])
        p = qxh + _mv_ll(_t_ll(fac.K[i]), quh)
        ps.append(p)
    p_all = torch.stack(ps[::-1])
    ks = ks[::-1]
    P0 = fac.P[0]
    rhs = -(p[9:] + _mv_ll(_t_ll(P0[:9, 9:]), dx0))
    dtheta = _chol4_solve(_chol4(P0[9:, 9:]), rhs[:, None])[:, 0]
    dxb = torch.cat([dx0, dtheta], dim=0)
    dxbs, dus = [], []
    for i in range(N - 1):
        du = _mv_ll(fac.K[i], dxb) + ks[i]
        dxbs.append(dxb)
        dus.append(du)
        dxb = _mv_ll(A[i], dxb) + _mv_ll(B[i], du) + c[i]
    dxbs.append(dxb)
    dus.append(-(Riqu + _mv_ll(fac.RiS, dxb)))
    dxb_all = torch.stack(dxbs)
    nu_all = sum_dim(fac.P * dxb_all[:, None], 2) + p_all
    return dxb_all, torch.stack(dus), nu_all


# ---- the lane-major NLP pieces (solver/ipm_lanes.py) -----------------------

def _cost_gradient(Z, w, ref_pos, ref_yaw, rmax2):
    u, up = Z[:, 0:4], Z[:, 4:8]
    pos, vel = Z[:, 8:11], Z[:, 11:14]
    g_u = 2.0 * w.w_rate[:, None] * (u - up)
    g_u = torch.cat([g_u[:, 0:3] + 2.0 * (w.w_input[:, None] / rmax2)
                     * u[:, 0:3], g_u[:, 3:4]], dim=1)
    g_up = 2.0 * w.w_rate[:, None] * (up - u)
    g_up = torch.cat([g_up[:, 0:3] + 2.0 * w.w_uprev0[:, None] * up[:, 0:3],
                      g_up[:, 3:4]], dim=1)
    g_pos = 2.0 * w.w_wp[:, None] * (pos - ref_pos)
    g_vel = 2.0 * w.w_vel[:, None] * vel
    g_yaw = 24.0 * w.w_wp * (Z[:, 16] - ref_yaw)
    zero = torch.zeros_like(g_yaw)
    return torch.cat([g_u, g_up, g_pos, g_vel,
                      torch.stack([zero, zero, g_yaw], dim=1)], dim=1)


def _habs_z_max(Z, w, rmax2):
    u, up = Z[:, 0:4].abs(), Z[:, 4:8].abs()
    pos, vel = Z[:, 8:11].abs(), Z[:, 11:14].abs()
    r_u = 2.0 * w.w_rate[:, None] * (u + up)
    r_u = torch.cat([r_u[:, 0:3] + 2.0 * (w.w_input[:, None] / rmax2)
                     * u[:, 0:3], r_u[:, 3:4]], dim=1)
    r_up = 2.0 * w.w_rate[:, None] * (up + u)
    r_up = torch.cat([r_up[:, 0:3] + 2.0 * w.w_uprev0[:, None] * up[:, 0:3],
                      r_up[:, 3:4]], dim=1)
    r_pos = 2.0 * w.w_wp.abs()[:, None] * pos
    r_vel = 2.0 * w.w_vel.abs()[:, None] * vel
    r_yaw = 24.0 * w.w_wp * Z[:, 16].abs()
    rows = torch.cat([r_u, r_up, r_pos, r_vel, r_yaw[:, None]], dim=1)
    return rows.amax(dim=(0, 1))


def _corridor_mv(A, x):
    return (A[:, :, 0] * x[:, None, 0] + A[:, :, 1] * x[:, None, 1]
            + A[:, :, 2] * x[:, None, 2])


def _corridor_mtv(A, v):
    return torch.stack([sum_dim(A[:, :, j] * v, 1) for j in range(3)], dim=1)


def _ineq_residuals(Z, A, b, lb, ub, hu):
    return torch.cat([lb[None, :, None] - Z, Z - ub[None, :, None],
                      _corridor_mv(A, Z[:, 8:11]) - b - hu], dim=1)


def _ineq_jac_T_times(A, v):
    out = -v[:, 0:17] + v[:, 17:34]
    return torch.cat([out[:, 0:8], out[:, 8:11] + _corridor_mtv(A, v[:, 34:]),
                      out[:, 11:]], dim=1)


def _ineq_jac_times(A, dz):
    return torch.cat([-dz, dz, _corridor_mv(A, dz[:, 8:11])], dim=1)


def _eq_grad(Z, lam, Ax, Bx):
    lx, lu = lam[1:, :9], lam[1:, 9:]
    out = torch.zeros_like(Z)
    out[:-1, 0:4] += sum_dim(Bx * lx[:, :, None], 1) + lu
    out[:-1, 8:17] += sum_dim(Ax * lx[:, :, None], 1)
    out[1:, 8:17] += -lx
    out[1:, 4:8] += -lu
    out[0, 8:17] += lam[0, :9]
    return out


def _dyn_pieces(Z, f_ext_bl, m):
    x_bl = Z[:-1, 8:17].movedim(1, -1)
    u_bl = Z[:-1, 0:4].movedim(1, -1)
    xn = rk2_step(x_bl, u_bl, f_ext_bl[None], m)
    c = (torch.cat([xn.movedim(-1, 1), Z[:-1, 0:4]], dim=1)
         - torch.cat([Z[1:, 8:17], Z[1:, 4:8]], dim=1))
    Ax, Bx = rk2_jacobians(x_bl, u_bl, f_ext_bl[None], m)
    return c, Ax.movedim(1, -1), Bx.movedim(1, -1)


def _lane_step(st, p, m, s_cfg, max_iters):
    """One monotone iteration over every lane; lanes whose loop condition
    (~done & it < max_iters) is false keep their state."""
    Z, lam, s, mu_d, mu, it, done, err = st
    N = Z.shape[0]
    dtype, device = Z.dtype, Z.device
    w = p.weights
    Acor, bcor = p.corridor_A, p.corridor_b
    lb, ub = variable_bounds(m, dtype, device)
    hu = s_cfg.corridor_slack
    tol = max(s_cfg.tol_stat, s_cfg.tol_eq, s_cfg.tol_ineq, s_cfg.tol_comp)
    rmax2 = m.max_rate ** 2
    eps = torch.finfo(dtype).eps
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)

    grad_f = _cost_gradient(Z, w, p.ref_pos, p.ref_yaw, rmax2)
    g = _ineq_residuals(Z, Acor, bcor, lb, ub, hu)
    c, Ax, Bx = _dyn_pieces(Z, p.f_ext.T, m)
    r_stat = grad_f + _eq_grad(Z, lam, Ax, Bx) + _ineq_jac_T_times(Acor, mu_d)
    r_init = Z[0, 8:17] - p.xinit
    r_g = g + s
    r_c = s * mu_d - mu[None, None]
    mud_abs_sum = lane_sum(mu_d.abs())
    m_all = (lane_sum(lam.abs()) + mud_abs_sum) / (N * NXB + N * 64)
    s_d = torch.clamp(m_all, min=100.0) / 100.0
    s_c = torch.clamp(mud_abs_sum / (N * 64), min=100.0) / 100.0
    mag = (_habs_z_max(Z, w, rmax2) + lam.abs().amax(dim=(0, 1))
           + mu_d.abs().amax(dim=(0, 1)))
    stat_scale = torch.clamp(4.0 * eps * mag / 1e-4, min=1.0)
    stat = r_stat.abs().amax(dim=(0, 1)) / (s_d * stat_scale)
    eq = torch.maximum(c.abs().amax(dim=(0, 1)), r_init.abs().amax(dim=0))
    ineq = r_g.abs().amax(dim=(0, 1))
    comp = r_c.abs().amax(dim=(0, 1)) / s_c
    comp0 = (s * mu_d).abs().amax(dim=(0, 1)) / s_c
    err0 = torch.maximum(torch.maximum(stat, eq), torch.maximum(ineq, comp0))
    lane_done = err0 <= tol

    sigma = mu_d / s
    dx0 = p.xinit - Z[0, 8:17]
    Abar, Bbar = _aug_dynamics(Ax, Bx)
    fac = _factor(*_qp_blocks(w, Acor, sigma, s_cfg.reg, rmax2), Abar, Bbar)

    def direction(w_vec):
        q = grad_f + _ineq_jac_T_times(Acor, w_vec)
        dxb, du, nu = _backsolve(fac, Abar, Bbar, c,
                                 torch.cat([q[:, 8:17], q[:, 4:8]], dim=1),
                                 q[:, 0:4], dx0)
        dZ = torch.cat([du, dxb[:, 9:], dxb[:, :9]], dim=1)
        return dZ, -r_g - _ineq_jac_times(Acor, dZ), nu

    tau = s_cfg.frac_to_boundary

    def max_step(v, dv):
        ratio = torch.where(dv < 0, -tau * v / torch.clamp(dv, max=-1e-30),
                            inf)
        return torch.minimum(torch.ones_like(mu), ratio.amin(dim=(0, 1)))

    if s_cfg.mu_gate:
        err_mu = torch.maximum(torch.maximum(stat, eq),
                               torch.maximum(ineq, comp))
        shrink = err_mu <= s_cfg.mu_gate_factor * mu
    else:
        shrink = torch.ones_like(lane_done)
    mu_pow = (mu * torch.sqrt(mu) if s_cfg.mu_superlin == 1.5
              else mu ** s_cfg.mu_superlin)
    mu_n = torch.where(
        shrink & ~lane_done,
        torch.clamp(torch.minimum(s_cfg.kappa_mu * mu, mu_pow), min=tol / 20.0),
        mu)
    dZ, ds, nu = direction(mu_n[None, None] / s + sigma * r_g)
    dmu = mu_n[None, None] / s - sigma * ds - mu_d

    lam_plus = nu.clone()
    lam_plus[0, :9] = -nu[0, :9]
    lam_plus[0, 9:] = 0.0
    a_p = max_step(s, ds)[None, None]
    a_d = max_step(mu_d, dmu)[None, None]
    Z_n = Z + a_p * dZ
    s_n = s + a_p * ds
    mu_d_n = mu_d + a_d * dmu
    lam_n = lam + a_d * (lam_plus - lam)
    bad = ~(torch.isfinite(err0) & torch.isfinite(Z_n).all(dim=0).all(dim=0)
            & torch.isfinite(s_n).all(dim=0).all(dim=0))
    active = (~done) & (it < max_iters)
    upd = (active & ~(lane_done | bad))[None, None]
    return (torch.where(upd, Z_n, Z), torch.where(upd, lam_n, lam),
            torch.where(upd, s_n, s), torch.where(upd, mu_d_n, mu_d),
            torch.where(active, mu_n, mu), torch.where(active, it + 1, it),
            torch.where(active, lane_done | bad, done),
            torch.where(active, torch.where(bad & ~lane_done, inf, err0), err))


def solve(Z0, problem: Problem, m, s_cfg) -> Solution:
    """Solve every lane: Z0 (B, N, 17) and the problem batch-leading;
    exit codes as FORCESNLPsolver_normal.h:110-139 (1 optimal, 0 max
    iterations, -6 NaN guard, -7 inequalities violated past infeas_tol)."""
    if s_cfg.predictor_corrector:
        raise ValueError("the reference solves the monotone path only")
    lanes = (lambda a: a.movedim(0, -1).contiguous())
    p = Problem(*(lanes(a) for a in problem[:-1]),
                weights=StageWeights(*(lanes(a) for a in problem.weights)))
    Z0 = lanes(Z0)
    N, _, B = Z0.shape
    dtype, device = Z0.dtype, Z0.device
    lb, ub = variable_bounds(m, dtype, device)
    Zc = torch.clamp(Z0, (lb + 1e-3)[None, :, None], (ub - 1e-3)[None, :, None])
    g0 = _ineq_residuals(Zc, p.corridor_A, p.corridor_b, lb, ub,
                         s_cfg.corridor_slack)
    s0 = torch.clamp(-g0, min=1e-2)
    mu0 = torch.full((B,), s_cfg.mu_init, dtype=dtype, device=device)
    big = min(1e6, torch.finfo(dtype).max)   # in range for a float16 control
    st = (Zc, torch.zeros((N, NXB, B), dtype=dtype, device=device), s0,
          torch.clamp(mu0[None, None] / s0, 1e-6, big), mu0,
          torch.zeros((B,), dtype=torch.int32, device=device),
          torch.zeros((B,), dtype=torch.bool, device=device),
          torch.full((B,), float("inf"), dtype=dtype, device=device))
    while bool(((~st[6]) & (st[5] < s_cfg.max_iters)).any()):
        st = _lane_step(st, p, m, s_cfg, s_cfg.max_iters)
    Z, _, _, _, _, it, done, err = st
    g = _ineq_residuals(Z, p.corridor_A, p.corridor_b, lb, ub,
                        s_cfg.corridor_slack)
    stuck = g.amax(dim=(0, 1)) > s_cfg.infeas_tol
    finite = torch.isfinite(err)
    ec = torch.where(done & finite, 1, torch.where(
        stuck, -7, torch.where(done & ~finite, -6, 0))).to(torch.int32)
    return Solution(Z=Z.movedim(-1, 0), exit_code=ec, iters=it)
