"""Disturbance-tube propagation: forward reachable ellipsoids (torch).

Port of the main path of forces_resilient_planner_tpu/tube/lyapunov.py
(NMPCSolver::getDistrEllipsoid + setFORCESParams, nmpc_solver.cpp:484-611):

  - closed-loop Phi = Jc + Bc K with the feedback gain K (the fixed gain
    tcfg.K of nmpc_solver.cpp:28-31, 696, unless the caller passes one),
    Jc/Bc the continuous Jacobians;
  - per velocity disturbance channel the Gramian
    X_i = t w_i^2 int_0^t e^{-Phi s} e_i e_i^T e^{-Phi^T s} ds and
    Mp = e^{Phi t}, by a Taylor series at a 1-norm-scaled time and exact
    doublings (matmul only, no solve);
  - channel combination and stage recursion by the trace-normalized
    Minkowski-sum approximation (nmpc_solver.cpp:507-509, 601-603).

The per-stage part runs in ops/tube_kernel.py::tube_stage_lanes (the CUDA
kernel on a CUDA tensor, the formulas below on a CPU tensor); the O(N)
Minkowski recursion and the Denman-Beavers square root stay here.  The
oracle functions at the end (lyapunov_solve, lyapunov_gramian, channel_Qd,
sqrtm_psd) solve the same per-stage problem by other algorithms (a
Kronecker solve, Van Loan's block exponential, eigh); no path of the
planner calls them, the tests hold the fast path against them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, TubeConfig
from forces_resilient_planner_tpu_torch.corridor.decomp import det3, inv3
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import (
    continuous_jacobians_analytic,
    euler_to_rot,
)
from forces_resilient_planner_tpu_torch.utils.lanes import norm3

NX = 9
MAX_DOUBLINGS = 4


def taylor_n_terms(dtype) -> int:
    """Dtype-matched Taylor length of the scaled-norm <= 0.5 Gramian series:
    7 terms reach f32 precision, 12 reach f64 (the JAX package's counts,
    also the CUDA kernel's template argument)."""
    return 7 if dtype == torch.float32 else 12


def closed_loop_phi(x: torch.Tensor, u: torch.Tensor, K: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Phi = Jc + Bc K at (..., 9) / (..., 4) linearization points."""
    Jc, Bc = continuous_jacobians_analytic(x, u, cfg)
    return Jc + Bc @ K.to(x.dtype)


def gramian_channels(Phi: torch.Tensor, t: float, w_bound: torch.Tensor,
                     n_terms: int | None = None,
                     max_doublings: int = MAX_DOUBLINGS):
    """The three velocity-channel Gramians and e^{Phi t}, matmul only.

    Series with H_0 = e_i e_i^T, H_{m+1} = -(Pu H_m + (Pu H_m)^T) / (m+1),
    X(u) = u sum_m H_m / (m+1) at u = t / 2^s (s from the 1-norm of Phi t,
    at most max_doublings), then X(2u) = X(u) + M_u X(u) M_u^T and
    M_{2u} = M_u^2 under per-lane masks.
    Returns (X (..., 3, 9, 9) channel-ordered, Mp (..., 9, 9))."""
    dtype, device = Phi.dtype, Phi.device
    if n_terms is None:
        n_terms = taylor_n_terms(dtype)
    Pt = Phi * t
    norm1 = torch.amax(torch.sum(torch.abs(Pt), dim=-2), dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1 / 0.5, min=1.0)))
    s = torch.clamp(torch.nan_to_num(s, nan=0.0), 0, max_doublings)
    u_scale = 0.5 ** s
    Pu = Pt * u_scale[..., None, None]

    # Mm = e^{-Pu}, Mp = e^{+Pu}: shared Horner on the power series
    I = torch.eye(NX, dtype=dtype, device=device).expand(Phi.shape)
    Mm, Mp = I, I
    for m in range(n_terms, 0, -1):
        Mm = I - (Pu @ Mm) / m
        Mp = I + (Pu @ Mp) / m

    e = torch.eye(NX, dtype=dtype, device=device)[3:6]          # (3, 9)
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

    X = X * (t * w_bound ** 2)[..., :, None, None]
    return X, Mp


def channel_Qd_fast(Phi: torch.Tensor, t: float, w_bound: torch.Tensor):
    """Trace-normalized channel sum Qd and e^{Phi t}: (Qd, Mp)."""
    X, Mp = gramian_channels(Phi, t, w_bound)
    trX = torch.sqrt(torch.clamp(
        torch.diagonal(X, dim1=-2, dim2=-1).sum(-1), min=1e-30))
    Qd = trX.sum(-1)[..., None, None] * (X / trX[..., None, None]).sum(-3)
    return Qd, Mp


def ego_ellipsoid(rpy: torch.Tensor, tcfg: TubeConfig) -> torch.Tensor:
    """Q1 = R diag(r^2, r^2, h^2) R^T (setFORCESParams, nmpc_solver.cpp:503-513)."""
    R = euler_to_rot(rpy)
    ego = torch.tensor([tcfg.ego_r ** 2, tcfg.ego_r ** 2, tcfg.ego_h ** 2],
                       dtype=rpy.dtype, device=rpy.device)
    return (R * ego) @ R.transpose(-1, -2)


def sqrtm_psd_db(Q: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """3x3 PSD square root by determinant-scaled Denman-Beavers iteration
    with closed-form 3x3 inverses."""
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    tr = torch.diagonal(Q, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    Y = Q + (1e-12 * tr + 1e-30) * eye
    Z = eye.expand(Q.shape)
    for _ in range(iters):
        g = torch.abs(det3(Y) * det3(Z)) ** (-1.0 / (2 * n))
        g = torch.nan_to_num(g, nan=1.0, posinf=1.0, neginf=1.0)[..., None, None]
        Yn = 0.5 * (g * Y + inv3(g * Z))
        Z = 0.5 * (g * Z + inv3(g * Y))
        Y = Yn
    return 0.5 * (Y + Y.transpose(-1, -2))


def minkowski_sum(Q1: torch.Tensor, Q2: torch.Tensor) -> torch.Tensor:
    """Trace-normalized outer approximation of the Minkowski sum of two
    ellipsoid shape matrices (nmpc_solver.cpp:507-509)."""
    t1 = torch.diagonal(Q1, dim1=-2, dim2=-1).sum(-1)
    t2 = torch.diagonal(Q2, dim1=-2, dim2=-1).sum(-1)
    beta = torch.sqrt(t1 / t2)[..., None, None]
    return (1.0 + 1.0 / beta) * Q1 + (1.0 + beta) * Q2


class TubeResult(NamedTuple):
    E: torch.Tensor    # (B, N, 3, 3) stage uncertainty ellipsoid sqrt matrices
    Q2: torch.Tensor   # (B, N, 3, 3) propagated disturbance position ellipsoids
    Phi: torch.Tensor  # (B, N, 9, 9) closed-loop matrices (diagnostics)


def propagate_tubes_batch(
    Z_prev: torch.Tensor,      # (B, N, 17) previous MPC solutions
    mcfg: ModelConfig,
    tcfg: TubeConfig,
    K=None,                    # (4, 9) feedback gain; None: tcfg.K
) -> TubeResult:
    """Per-stage uncertainty ellipsoids E for corridor tightening.

    Stage recursion (setFORCESParams, nmpc_solver.cpp:490-520):
      Q_0 = Q1_0, Q_i = mink(Q1_i, Q2pos_{i-1}), E_i = sqrt(Q_i),
      Qu_i = mink(Qinit_i, Qd_i), Q2pos_i = (Mp_i Qu_i Mp_i^T)[0:3, 0:3],
      Qinit_{i+1} = Qu_i, Qinit_0 = eps^2 I.
    The per-stage math runs over the L = B N stage lanes in
    ops/tube_kernel.py::tube_stage_lanes with the gain K (a (4, 9) tensor or
    array, used as given on both routes), or the config gain tcfg.K when K
    is None."""
    from forces_resilient_planner_tpu_torch.ops import tube_kernel

    B, N = Z_prev.shape[0], Z_prev.shape[1]
    dtype, device = Z_prev.dtype, Z_prev.device
    x = Z_prev[..., 8:17].reshape(B * N, NX).contiguous()
    u = Z_prev[..., 0:4].reshape(B * N, 4).contiguous()
    Qd, Mp, Phi, Q1 = tube_kernel.tube_stage_lanes(x, u, mcfg, tcfg, K)
    Qd = Qd.reshape(B, N, NX, NX)
    Mp = Mp.reshape(B, N, NX, NX)
    Q1 = Q1.reshape(B, N, 3, 3)

    Q_init = ((tcfg.epsilon ** 2)
              * torch.eye(NX, dtype=dtype, device=device)).expand(B, NX, NX)
    Q2 = []
    for i in range(N):
        Qu = minkowski_sum(Q_init, Qd[:, i])
        Q2.append((Mp[:, i] @ Qu @ Mp[:, i].transpose(-1, -2))[:, 0:3, 0:3])
        Q_init = Qu
    Q2pos = torch.stack(Q2, dim=1)                               # (B, N, 3, 3)

    Qcomb = torch.cat(
        [Q1[:, 0:1], minkowski_sum(Q1[:, 1:], Q2pos[:, :-1])], dim=1
    )
    return TubeResult(E=sqrtm_psd_db(Qcomb), Q2=Q2pos,
                      Phi=Phi.reshape(B, N, NX, NX))


def propagate_tubes(Z_prev: torch.Tensor, mcfg: ModelConfig,
                    tcfg: TubeConfig, K=None) -> TubeResult:
    """One robot's tubes (Z_prev (N, 17)): B = 1 of propagate_tubes_batch,
    with the gain K (None: tcfg.K)."""
    r = propagate_tubes_batch(Z_prev[None], mcfg, tcfg, K)
    return TubeResult(*(a[0] for a in r))


def tighten_corridor(A: torch.Tensor, b: torch.Tensor,
                     E: torch.Tensor) -> torch.Tensor:
    """btilde_j = b_j - ||E a_j^T|| (forces_normal.cpp:111-136).
    A (..., nh, 3), b (..., nh), E (..., 3, 3) -> (..., nh); zero rows
    stay as they are."""
    Ea = A @ E.transpose(-1, -2)                                 # (..., nh, 3)
    return b - norm3(Ea)


# ---- oracle functions (JAX tube/lyapunov.py:51-100, 237-280) ---------------

def lyapunov_solve(Phi: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Solve Phi X + X Phi^T = W (n, n) by the Kronecker-vectorized system:
    with row-major vec the operator is kron(Phi, I) + kron(I, Phi)."""
    n = Phi.shape[-1]
    eye = torch.eye(n, dtype=Phi.dtype, device=Phi.device)
    Kmat = torch.kron(Phi, eye) + torch.kron(eye, Phi)
    return torch.linalg.solve(Kmat, W.reshape(-1)).reshape(n, n)


def lyapunov_gramian(Phi: torch.Tensor, C: torch.Tensor,
                     t: float) -> torch.Tensor:
    """X = int_0^t e^{-Phi s} C e^{-Phi^T s} ds, the unique solution of
    Phi X + X Phi^T = C - e^{-Phi t} C e^{-Phi^T t}, by Van Loan's block
    exponential: expm([[-Phi, C], [0, Phi^T]] t) = [[., F12], [0, F22]] with
    F12 = X e^{Phi^T t}, F22 = e^{Phi^T t}, so X = F12 F22^{-1}.
    Phi, C (..., n, n)."""
    n = Phi.shape[-1]
    PhiT = Phi.transpose(-1, -2)
    H = torch.cat([torch.cat([-Phi, C], dim=-1),
                   torch.cat([torch.zeros_like(Phi), PhiT], dim=-1)], dim=-2)
    F = torch.linalg.matrix_exp(H * t)
    F12, F22 = F[..., :n, n:], F[..., n:, n:]
    return torch.linalg.solve(F22.transpose(-1, -2),
                              F12.transpose(-1, -2)).transpose(-1, -2)


def sqrtm_psd(Q: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root by eigendecomposition
    (nmpc_solver.cpp:512-513), eigenvalues clipped at 0."""
    w, V = torch.linalg.eigh(Q)
    return (V * torch.sqrt(w.clamp(min=0.0))[..., None, :]) @ V.transpose(
        -1, -2)


def channel_Qd(Phi: torch.Tensor, t: float,
               w_bound: torch.Tensor) -> torch.Tensor:
    """Combined disturbance ellipsoid Qd (..., 9, 9) of the three velocity
    channels (D = [e_x e_y e_z] on the velocity rows, nmpc_solver.cpp:24-26),
    each Gramian by lyapunov_gramian."""
    trs, Xn = [], []
    for i in range(3):
        Nt = torch.zeros_like(Phi)
        Nt[..., 3 + i, 3 + i] = t * w_bound[i] ** 2
        X = lyapunov_gramian(Phi, Nt, t)
        trX = torch.sqrt(torch.clamp(
            torch.diagonal(X, dim1=-2, dim2=-1).sum(-1), min=1e-30))
        trs.append(trX)
        Xn.append(X / trX[..., None, None])
    return (trs[0] + trs[1] + trs[2])[..., None, None] * (Xn[0] + Xn[1]
                                                          + Xn[2])
