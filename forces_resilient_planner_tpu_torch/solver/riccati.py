"""Block-tridiagonal KKT solve via Riccati recursion, lane-major (torch).

Port of the lane-major half of forces_resilient_planner_tpu/solver/
riccati.py (lines 217-387).  Solves the equality-constrained QP of one
interior-point iteration

    min  sum_i 1/2 [dxb_i; du_i]^T [Q_i S_i^T; S_i R_i] [dxb_i; du_i]
              + qx_i^T dxb_i + qu_i^T du_i
    s.t. dxb_{i+1} = A_i dxb_i + B_i du_i + c_i        (i = 0..N-2)
         dxb_0 = [dx0_fixed; dtheta],  dtheta free

with the scenario batch on the trailing (lane) axis: (..., i, j, B).
The stage loops are Python loops over N (the JAX code's lax.scan).
lqr_factor_ll / lqr_solve_ll are the plain versions of the Riccati
kernels of ops/lqr_kernel.py; solve_lqr_batched is the public batched
solve through those kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from forces_resilient_planner_tpu_torch.utils.lanes import sum_dim


class LQRSolution(NamedTuple):
    dxb: torch.Tensor     # (N, 13, B)
    du: torch.Tensor      # (N, 4, B)
    nu: torch.Tensor      # (N, 13, B) costates
    dtheta: torch.Tensor  # (4, B) stage-0 u_prev step


class LQRFactor(NamedTuple):
    """Reusable Riccati factorization (everything that depends only on
    (Q, R, S, A, B), not on the right-hand side)."""

    P: torch.Tensor       # (N, 13, 13, B) cost-to-go Hessians
    K: torch.Tensor       # (N-1, 4, 13, B) feedback gains
    cRh: torch.Tensor     # (N-1, 10, B) packed Cholesky factors of Rh_i
    RiS: torch.Tensor     # (4, 13, B) terminal R^{-1} S
    cRt: torch.Tensor     # (10, B) packed terminal Cholesky of R_{N-1}


def _mm_ll(a, b):
    """(i, j, B) @ (j, k, B) -> (i, k, B) as a broadcast sum."""
    return sum_dim(a[:, :, None, :] * b[None, :, :, :], 1)


def _mv_ll(a, v):
    """(i, j, B) @ (j, B) -> (i, B)."""
    return sum_dim(a * v[None, :, :], 1)


def _t_ll(a):
    return a.transpose(0, 1)


def _chol4_ll(A):
    """Unrolled Cholesky of (4, 4, B) SPD stacks -> 10 packed factors."""
    eps = torch.tensor(1e-30, dtype=A.dtype, device=A.device)
    l00 = torch.sqrt(torch.maximum(A[0, 0], eps))
    l10 = A[1, 0] / l00
    l20 = A[2, 0] / l00
    l30 = A[3, 0] / l00
    l11 = torch.sqrt(torch.maximum(A[1, 1] - l10 * l10, eps))
    l21 = (A[2, 1] - l20 * l10) / l11
    l31 = (A[3, 1] - l30 * l10) / l11
    l22 = torch.sqrt(torch.maximum(A[2, 2] - l20 * l20 - l21 * l21, eps))
    l32 = (A[3, 2] - l30 * l20 - l31 * l21) / l22
    l33 = torch.sqrt(
        torch.maximum(A[3, 3] - l30 * l30 - l31 * l31 - l32 * l32, eps)
    )
    return (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33)


def chol4_solve_ll(f, Bm):
    """Forward/back substitution against packed factors f (10, B) (or the
    10-tuple of _chol4_ll); Bm of shape (4, k, B)."""
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = (f[i] for i in range(10))
    b0, b1, b2, b3 = Bm[0], Bm[1], Bm[2], Bm[3]
    y0 = b0 / l00[None]
    y1 = (b1 - l10[None] * y0) / l11[None]
    y2 = (b2 - l20[None] * y0 - l21[None] * y1) / l22[None]
    y3 = (b3 - l30[None] * y0 - l31[None] * y1 - l32[None] * y2) / l33[None]
    x3 = y3 / l33[None]
    x2 = (y2 - l32[None] * x3) / l22[None]
    x1 = (y1 - l21[None] * x2 - l31[None] * x3) / l11[None]
    x0 = (y0 - l10[None] * x1 - l20[None] * x2 - l30[None] * x3) / l00[None]
    return torch.stack([x0, x1, x2, x3], dim=0)


def spd_solve4_ll(A, Bm):
    """Solve A X = B with A (4, 4, B) SPD, B (4, k, B)."""
    return chol4_solve_ll(_chol4_ll(A), Bm)


def lqr_factor_ll(Q, R, S, A, B) -> LQRFactor:
    """Riccati factorization, lane-major (trailing batch axis).

    Q (N,13,13,Bn)  R (N,4,4,Bn)  S (N,4,13,Bn)
    A (N-1,13,13,Bn)  B (N-1,13,4,Bn)
    """
    N = Q.shape[0]
    cRt = torch.stack(_chol4_ll(R[-1]), dim=0)             # (10, Bn)
    RiS = chol4_solve_ll(cRt, S[-1])                       # (4, 13, Bn)
    P = Q[-1] - _mm_ll(_t_ll(S[-1]), RiS)
    Ps, Ks, cRhs = [P], [], []
    for i in range(N - 2, -1, -1):
        Ai, Bi = A[i], B[i]
        AtP = _mm_ll(_t_ll(Ai), P)
        BtP = _mm_ll(_t_ll(Bi), P)
        Qh = Q[i] + _mm_ll(AtP, Ai)
        Rh = R[i] + _mm_ll(BtP, Bi)
        Sh = S[i] + _mm_ll(BtP, Ai)
        fh = torch.stack(_chol4_ll(Rh), dim=0)             # (10, Bn)
        K = -chol4_solve_ll(fh, Sh)                        # (4, 13, Bn)
        Pn = Qh + _mm_ll(_t_ll(Sh), K)
        P = 0.5 * (Pn + Pn.transpose(0, 1))
        Ps.append(P)
        Ks.append(K)
        cRhs.append(fh)
    return LQRFactor(
        P=torch.stack(Ps[::-1]), K=torch.stack(Ks[::-1]),
        cRh=torch.stack(cRhs[::-1]), RiS=RiS, cRt=cRt,
    )


def lqr_solve_ll(fac: LQRFactor, A, B, c, qx, qu, dx0) -> LQRSolution:
    """Backsolve one RHS (qx, qu, c, dx0) against a stored factorization.

    p_i = qxh_i + K_i^T quh_i (K = -Rh^{-1} Sh, so Sh^T k = K^T quh); the
    costates come from the value-function identity nu_i = P_i dxb_i + p_i.
    """
    N = qx.shape[0]
    Riqu = chol4_solve_ll(fac.cRt, qu[-1][:, None])[:, 0]
    p = qx[-1] - _mv_ll(_t_ll(fac.RiS), qu[-1])
    ps, ks = [p], []
    for i in range(N - 2, -1, -1):
        Pc = p + _mv_ll(fac.P[i + 1], c[i])
        qxh = qx[i] + _mv_ll(_t_ll(A[i]), Pc)
        quh = qu[i] + _mv_ll(_t_ll(B[i]), Pc)
        ks.append(-chol4_solve_ll(fac.cRh[i], quh[:, None])[:, 0])
        p = qxh + _mv_ll(_t_ll(fac.K[i]), quh)
        ps.append(p)
    p_all = torch.stack(ps[::-1])                          # (N, 13, Bn)
    ks = ks[::-1]

    P0 = fac.P[0]
    rhs = -(p[9:] + _mv_ll(_t_ll(P0[:9, 9:]), dx0))
    dtheta = spd_solve4_ll(P0[9:, 9:], rhs[:, None])[:, 0]
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
    # costates: nu_i = P_i dxb_i + p_i (value-function gradient)
    nu_all = sum_dim(fac.P * dxb_all[:, None], 2) + p_all
    return LQRSolution(
        dxb=dxb_all, du=torch.stack(dus), nu=nu_all, dtheta=dtheta
    )


def solve_lqr_batched(Q, R, S, qx, qu, A, B, c, dx0) -> LQRSolution:
    """Lane-major batched LQR solve (factor + one backsolve), the public
    batched entry (JAX riccati.py:357-365).  Through ops/lqr_kernel.py:
    the CUDA kernels K5a and K5b on a CUDA tensor, lqr_factor_ll and
    lqr_solve_ll on a CPU tensor.

    Shapes (trailing batch Bn):
      Q (N,13,13,Bn)  R (N,4,4,Bn)  S (N,4,13,Bn)  qx (N,13,Bn)  qu (N,4,Bn)
      A (N-1,13,13,Bn)  B (N-1,13,4,Bn)  c (N-1,13,Bn)  dx0 (9,Bn)
    """
    # imported here: ops/lqr_kernel.py imports this module
    from forces_resilient_planner_tpu_torch.ops import lqr_kernel

    return lqr_kernel.solve_lqr_lanes(Q, R, S, qx, qu, A, B, c, dx0)


def solve_lqr_batch(Q, R, S, qx, qu, A, B, c, dx0) -> LQRSolution:
    """solve_lqr_batched with the batch LEADING on every input and output
    (Q (Bn, N, 13, 13), ..., dx0 (Bn, 9) -> dxb (Bn, N, 13), ...): the
    axis moves of the JAX package's custom_vmap rule (riccati.py:368-387)."""
    args = (Q, R, S, qx, qu, A, B, c, dx0)
    sol = solve_lqr_batched(*(a.movedim(0, -1).contiguous() for a in args))
    return LQRSolution(*(f.movedim(-1, 0) for f in sol))
