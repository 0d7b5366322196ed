"""High-accuracy CPU oracle for solver parity (torch).

Port of forces_resilient_planner_tpu/oracle/cpu_oracle.py.  Re-solves the
identical NLP (same RK2 dynamics, costs, bounds, corridor constraints,
tolerances) with scipy's SLSQP on the condensed control-space formulation:
an algorithm independent of the interior-point solver, so agreement
certifies the KKT point rather than the implementation.  This replaces
the expired FORCES Pro binaries as the parity reference (BASELINE.md: the
embedded license expired 2021-10-29, exit code -100).

Condensation: decision vector v = [uprev_0 (4), u_0..u_{N-1} (4N)]; states
come from the exact RK2 rollout from xinit, so the equality constraints
hold by construction and only inequalities remain.  The gradient and the
constraint Jacobian are the chain rule through the rollout with each
stage's Jacobians from torch.func; cost and rows come from solver/nlp.py's
per-lane functions.  Runs on the CPU at f64, whatever the device of the
parameters it is given.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize as sopt
import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, SolverConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import rk2_step
from forces_resilient_planner_tpu_torch.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu_torch.solver.nlp import NLPParams

F64 = torch.float64


def _rollout_Z(v: torch.Tensor, params: NLPParams,
               cfg: ModelConfig) -> torch.Tensor:
    """v (4 + 4N,) -> Z (N, 17) via the exact rollout."""
    N = cfg.N
    u = v[4:].reshape(N, 4)
    x, xs = params.xinit, []
    for i in range(N):
        xs.append(x)
        x = rk2_step(x, u[i], params.f_ext, cfg)
    uprev = torch.cat([v[None, :4], u[:-1]], dim=0)
    return torch.cat([u, uprev, torch.stack(xs)], dim=1)


class _Condensed:
    """Cost, its gradient, the constraints (>= 0 feasible) and their
    Jacobian of the condensed problem, as numpy functions of v.

    The derivatives are the chain rule through the rollout: each stage's
    RK2 Jacobians by torch.func (jacfwd, vmapped over the stages), the
    sensitivities dZ/dv by their recursion, then the exact gradient of the
    quadratic cost (nlp.cost_gradient) and the linear constraint rows
    (nlp.ineq_jac_times) applied to dZ/dv.  One differentiated step a stage
    instead of a differentiated N-step rollout: the same derivative, about
    ten times fewer dispatched operations.  The last point's Z and dZ/dv
    are kept (SLSQP asks for the cost and the constraints at each point;
    dZ/dv only where it asks for a gradient).  The stage Jacobians are
    autodiff, not the closed forms the interior-point solver uses, so the
    oracle shares no derivative code with it."""

    def __init__(self, params: NLPParams, mcfg: ModelConfig,
                 scfg: SolverConfig):
        p = ipm_lanes._map_params(lambda a: a.detach().to("cpu", F64), params)
        self.params, self.mcfg, self.hu = p, mcfg, scfg.corridor_slack
        self.H = nlp.stage_hessians(p.weights, mcfg, F64)
        self.lb, self.ub = nlp.variable_bounds(mcfg, F64, device="cpu")
        self._stage_jac = torch.func.vmap(torch.func.jacfwd(
            lambda x, u: rk2_step(x, u, p.f_ext, mcfg), argnums=(0, 1)))
        self._key = self._Z = self._dZ = None

    def _at(self, v, derivative=False):
        v = np.asarray(v, float)
        key = v.tobytes()
        if key != self._key:
            self._key, self._dZ = key, None
            self._Z = _rollout_Z(torch.as_tensor(v), self.params, self.mcfg)
        if derivative and self._dZ is None:
            self._dZ = self._sensitivities(self._Z)
        return self._Z, self._dZ

    def _sensitivities(self, Z):
        """dZ/dv (N, 17, 4 + 4N)."""
        N = self.mcfg.N
        nv = 4 + 4 * N
        A, B = self._stage_jac(Z[:-1, nlp.IX], Z[:-1, nlp.IU])
        eye = torch.eye(nv, dtype=F64)
        du = eye[4:].reshape(N, 4, nv)                      # du_i/dv
        dup = torch.cat([eye[None, :4], du[:-1]], dim=0)    # duprev_i/dv
        dx = [torch.zeros((9, nv), dtype=F64)]
        for i in range(N - 1):
            dx.append(A[i] @ dx[i] + B[i] @ du[i])
        return torch.cat([du, dup, torch.stack(dx)], dim=1)

    def value(self, v):
        Z, _ = self._at(v)
        return float(nlp.cost_value(Z, self.params, self.H))

    def grad(self, v):
        Z, dZ = self._at(v, derivative=True)
        return torch.einsum("nk,nkv->v",
                            nlp.cost_gradient(Z, self.params, self.H),
                            dZ).numpy()

    def cons(self, v):
        Z, _ = self._at(v)
        return -nlp.inequality_residuals(
            Z, self.params, self.lb, self.ub, self.hu).reshape(-1).numpy()

    def cons_jac(self, v):
        _, dZ = self._at(v, derivative=True)
        J = torch.func.vmap(lambda dz: nlp.ineq_jac_times(self.params, dz))(
            dZ.permute(2, 0, 1))                            # (nv, N, 64)
        return -J.reshape(J.shape[0], -1).T.numpy()

    def v_bounds(self):
        N = self.mcfg.N
        return (np.tile(self.lb[:4].numpy(), N + 1),
                np.tile(self.ub[:4].numpy(), N + 1))

    def Z(self, v):
        return self._at(v)[0].numpy()


def solve_oracle(
    params: NLPParams,
    mcfg: ModelConfig,
    scfg: SolverConfig,
    v0: np.ndarray | None = None,
    maxiter: int = 500,
    ftol: float = 1e-14,
):
    """Returns (Z (N, 17) numpy, scipy result): SLSQP on the condensed
    problem from v0 (default: zero rates, hover thrust)."""
    prob = _Condensed(params, mcfg, scfg)
    nv = 4 + 4 * mcfg.N
    if v0 is None:
        v0 = np.zeros(nv)
        v0[3::4] = mcfg.hover_thrust
    lbv, ubv = prob.v_bounds()
    v0 = np.clip(v0, lbv + 1e-6, ubv - 1e-6)
    res = sopt.minimize(
        prob.value,
        v0,
        jac=prob.grad,
        method="SLSQP",
        bounds=list(zip(lbv, ubv)),
        constraints=[{"type": "ineq", "fun": prob.cons,
                      "jac": prob.cons_jac}],
        options={"maxiter": maxiter, "ftol": ftol},
    )
    return prob.Z(res.x), res


def kkt_certificate(
    v: np.ndarray,
    params: NLPParams,
    mcfg: ModelConfig,
    scfg: SolverConfig,
    active_tol: float = 1e-6,
):
    """Independent KKT residuals (feas, stat) at a condensed-space point v.

    SLSQP often stops with status 8 ("positive directional derivative for
    linesearch") at the optimum when ftol is below what the condensed f64
    objective resolves, so this checks the point itself:
      feas = max inequality violation (>= 0 convention)
      stat = inf-norm of grad_f - J_act^T mu - lam_lb + lam_ub minimized
             over nonnegative multipliers (NNLS), one-sided at active
             bounds.
    A point with feas <~ 1e-8 and stat <~ 1e-5 * scale is a KKT point
    whatever the SLSQP status."""
    prob = _Condensed(params, mcfg, scfg)
    v = np.asarray(v, float)
    g = prob.grad(v)
    c = prob.cons(v)
    J = prob.cons_jac(v)
    feas = float(np.maximum(-c, 0.0).max())

    lbv, ubv = prob.v_bounds()
    at_lb = v < lbv + 1e-8
    at_ub = v > ubv - 1e-8
    active = np.abs(c) < active_tol

    cols = []
    if active.any():
        cols.append(J[active].T)                       # (nv, n_act)
    if at_lb.any():
        cols.append(np.eye(len(v))[:, at_lb])          # +lam_lb columns
    if at_ub.any():
        cols.append(-np.eye(len(v))[:, at_ub])         # -lam_ub columns
    if cols:
        A = np.concatenate(cols, axis=1)
        mu, _ = sopt.nnls(A, g)
        r = g - A @ mu
    else:
        r = g
    r_eff = np.where(at_lb, np.minimum(r, 0.0), r)
    r_eff = np.where(at_ub, np.maximum(r_eff, 0.0), r_eff)
    return feas, float(np.abs(r_eff).max())
