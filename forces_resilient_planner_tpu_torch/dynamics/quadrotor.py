"""9-state quadrotor dynamics with external force and rotor drag (torch).

Port of forces_resilient_planner_tpu/dynamics/quadrotor.py (the reference
model: nonlinear_dynamics.m:20-40, Heun RK2 of transit.m).

State  x = [px py pz vx vy vz roll pitch yaw]
Input  u = [wx wy wz thrust]

Batch-leading layout: x (..., 9), u (..., 4), f_ext (..., 3).
"""
from __future__ import annotations

import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig
from forces_resilient_planner_tpu_torch.utils.lanes import sum_dim


def euler_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """ZYX rotation R = Rz(yaw) @ Ry(pitch) @ Rx(roll).  (..., 3) -> (..., 3, 3)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r00 = cy * cp
    r01 = cy * sp * sr - cr * sy
    r02 = cy * sp * cr + sy * sr
    r10 = cp * sy
    r11 = cy * cr + sy * sp * sr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def continuous_dynamics(
    x: torch.Tensor, u: torch.Tensor, f_ext: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """xdot = f(x, u, f_ext).  nonlinear_dynamics.m:20-40."""
    vel = x[..., 3:6]
    R = euler_to_rot(x[..., 6:9])
    z_b = R[..., :, 2]
    thrust = u[..., 3]
    drag = torch.tensor(
        [cfg.drag_coeff, cfg.drag_coeff, 0.0], dtype=x.dtype, device=x.device
    )
    # drag_acc = R diag(d) R^T v
    v_body = sum_dim(R * vel[..., :, None], -2)
    drag_acc = sum_dim(R * (drag * v_body)[..., None, :], -1)
    g_vec = torch.zeros_like(vel)
    g_vec[..., 2] = cfg.g
    acc = z_b * (thrust[..., None] / cfg.mass) + f_ext - g_vec - drag_acc
    return torch.cat([vel, acc, u[..., 0:3]], dim=-1)


def rk2_step(
    x: torch.Tensor, u: torch.Tensor, f_ext: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Heun RK2 discretization, exactly the FORCES client's RK2 (transit.m)."""
    k1 = continuous_dynamics(x, u, f_ext, cfg)
    k2 = continuous_dynamics(x + cfg.dt * k1, u, f_ext, cfg)
    return x + 0.5 * cfg.dt * (k1 + k2)


def ab_jacobians(
    x: torch.Tensor, u: torch.Tensor, f_ext: torch.Tensor, cfg: ModelConfig
):
    """Discrete-time Jacobians (A (9, 9), B (9, 4)) of rk2_step at one point,
    by forward-mode autodiff (the hand-derived updateMatrix,
    nmpc_solver.cpp:615-699).  The solver uses rk2_jacobians_analytic."""
    A = torch.func.jacfwd(lambda xx: rk2_step(xx, u, f_ext, cfg))(x)
    B = torch.func.jacfwd(lambda uu: rk2_step(x, uu, f_ext, cfg))(u)
    return A, B


def continuous_jacobians(
    x: torch.Tensor, u: torch.Tensor, f_ext: torch.Tensor, cfg: ModelConfig
):
    """Continuous-time (At (9, 9), Bt (9, 4)) of xdot = f(x, u) at one point,
    by forward-mode autodiff.  The tubes use continuous_jacobians_analytic."""
    At = torch.func.jacfwd(
        lambda xx: continuous_dynamics(xx, u, f_ext, cfg))(x)
    Bt = torch.func.jacfwd(
        lambda uu: continuous_dynamics(x, uu, f_ext, cfg))(u)
    return At, Bt


def thrust_world_acc(rpy: torch.Tensor, thrust: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """World-frame acceleration implied by attitude and thrust,
    R e3 T/m - g e3 (nmpc_solver.cpp:176-180, 925-931).  (..., 3)."""
    acc = euler_to_rot(rpy)[..., :, 2] * (thrust[..., None] / cfg.mass)
    g_vec = torch.zeros_like(acc)
    g_vec[..., 2] = cfg.g
    return acc - g_vec


def _mm3(a, b):
    """Batched small matmul as a broadcast sum (same form as the JAX code)."""
    return sum_dim(a[..., :, :, None] * b[..., None, :, :], -2)


def _rot_factors(rpy):
    cr, sr = torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0])
    cp, sp = torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1])
    cy, sy = torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2])
    z = torch.zeros_like(cr)
    o = torch.ones_like(cr)

    def m(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rx = m([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    dRx = m([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    Ry = m([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    dRy = m([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    Rz = m([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    dRz = m([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    return Rx, dRx, Ry, dRy, Rz, dRz


def continuous_jacobians_analytic(
    x: torch.Tensor, u: torch.Tensor, cfg: ModelConfig
):
    """Closed-form continuous-time Jacobians (Jc (..., 9, 9), Bc (..., 9, 4))."""
    dtype, device = x.dtype, x.device
    vel = x[..., 3:6]
    Rx, dRx, Ry, dRy, Rz, dRz = _rot_factors(x[..., 6:9])
    R = _mm3(Rz, _mm3(Ry, Rx))
    dR_r = _mm3(Rz, _mm3(Ry, dRx))
    dR_p = _mm3(Rz, _mm3(dRy, Rx))
    dR_y = _mm3(dRz, _mm3(Ry, Rx))

    D = torch.tensor(
        [cfg.drag_coeff, cfg.drag_coeff, 0.0], dtype=dtype, device=device
    )
    RD = R * D[..., None, :]                       # R @ diag(D)
    Rt = R.transpose(-1, -2)
    RDRt = _mm3(RD, Rt)
    Tm = (u[..., 3] / cfg.mass)[..., None]

    cols = []
    for dR in (dR_r, dR_p, dR_y):
        dRDRt = _mm3(dR * D[..., None, :], Rt) + _mm3(RD, dR.transpose(-1, -2))
        cols.append(dR[..., :, 2] * Tm - sum_dim(dRDRt * vel[..., None, :], -1))
    dv_drpy = torch.stack(cols, dim=-1)            # (..., 3, 3)

    shape = x.shape[:-1]
    eye3 = torch.eye(3, dtype=dtype, device=device).expand(shape + (3, 3))
    Jc = torch.zeros(shape + (9, 9), dtype=dtype, device=device)
    Jc[..., 0:3, 3:6] = eye3
    Jc[..., 3:6, 3:6] = -RDRt
    Jc[..., 3:6, 6:9] = dv_drpy
    Bc = torch.zeros(shape + (9, 4), dtype=dtype, device=device)
    Bc[..., 3:6, 3] = R[..., :, 2] / cfg.mass
    Bc[..., 6:9, 0:3] = eye3
    return Jc, Bc


def rk2_jacobians_analytic(
    x: torch.Tensor, u: torch.Tensor, f_ext: torch.Tensor, cfg: ModelConfig
):
    """Discrete Heun-step Jacobians via the chain rule:
        A = I + dt/2 (J1 + J2 + dt J2 J1)
        B = dt/2 (B1 + B2 + dt J2 B1)
    with J, B the continuous Jacobians at x and at the Euler midpoint."""
    dt = cfg.dt
    x_mid = x + dt * continuous_dynamics(x, u, f_ext, cfg)
    J1, B1 = continuous_jacobians_analytic(x, u, cfg)
    J2, B2 = continuous_jacobians_analytic(x_mid, u, cfg)
    eye9 = torch.eye(9, dtype=x.dtype, device=x.device)
    A = eye9 + 0.5 * dt * (J1 + J2 + dt * _mm3(J2, J1))
    B = 0.5 * dt * (B1 + B2 + dt * _mm3(J2, B1))
    return A, B
