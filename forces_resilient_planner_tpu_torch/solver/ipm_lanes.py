"""Lane-major batched interior-point NMPC solver (torch).

Port of forces_resilient_planner_tpu/solver/ipm_lanes.py: the same
single-loop primal-dual IPM with Gauss-Newton stage Hessians and a Riccati
KKT solve, with the scenario batch on the MINOR (lane) axis of every
array: Z is (N, 17, B), corridor rows (N, nh, 3, B), multipliers (N, 64, B).

The JAX while_loop becomes a host loop that reads one flag from the device
per iteration.  Every monotone iteration with 30 corridor rows goes
through ops/ipm_kernel.py::ipm_iteration_fused, which runs the hand-written
CUDA kernel K1 on a CUDA tensor and the plain PyTorch step (`lane_step`
below) on a CPU tensor.  The Mehrotra predictor-corrector branch and
corridors with other than 30 rows run `lane_step` itself, whose Riccati
factor and backsolves go through ops/lqr_kernel.py: the CUDA kernels K4a
(one factor) and K4b (one backsolve per right-hand side: two per
predictor-corrector iteration, one per monotone one) on a CUDA tensor,
their plain versions on a CPU tensor.

Reference anchors are those of the JAX solver (FORCES PDIP_NLP,
mpc_generator_normal.m:51-79; exit codes FORCESNLPsolver_normal.h:110-139).
"""
from __future__ import annotations

import torch

from forces_resilient_planner_tpu_torch.config import ModelConfig, SolverConfig
from forces_resilient_planner_tpu_torch.dynamics.quadrotor import (
    rk2_jacobians_analytic,
    rk2_step,
)
from forces_resilient_planner_tpu_torch.ops import lqr_kernel
from forces_resilient_planner_tpu_torch.solver import nlp
from forces_resilient_planner_tpu_torch.solver.ipm import SolveResult
from forces_resilient_planner_tpu_torch.solver.nlp import NLPParams, NXB
from forces_resilient_planner_tpu_torch.utils import trace
from forces_resilient_planner_tpu_torch.utils.lanes import lane_sum, sum_dim

# host-loop iterations stepped by _run_lanes, over all calls (a run's
# kernel-launch count must equal its growth on the CUDA path)
STEPS = 0


# ---------------------------------------------------------------------------
# lane-major NLP pieces (Z: (N, 17, B))
# ---------------------------------------------------------------------------

def _cost_gradient(Z, w: nlp.StageWeights, ref_pos, ref_yaw, rmax2):
    """grad f = H z + g_lin, written from the Hessian's sparsity.
    w_* are (N, B); ref_pos (N, 3, B); ref_yaw (N, B)."""
    u, up = Z[:, 0:4], Z[:, 4:8]
    pos, vel = Z[:, 8:11], Z[:, 11:14]
    g_u = 2.0 * w.w_rate[:, None] * (u - up)
    g_u = torch.cat(
        [g_u[:, 0:3] + 2.0 * (w.w_input[:, None] / rmax2) * u[:, 0:3],
         g_u[:, 3:4]], dim=1)
    g_up = 2.0 * w.w_rate[:, None] * (up - u)
    g_up = torch.cat(
        [g_up[:, 0:3] + 2.0 * w.w_uprev0[:, None] * up[:, 0:3],
         g_up[:, 3:4]], dim=1)
    g_pos = 2.0 * w.w_wp[:, None] * (pos - ref_pos)
    g_vel = 2.0 * w.w_vel[:, None] * vel
    g_yaw = 24.0 * w.w_wp * (Z[:, 16] - ref_yaw)
    zero = torch.zeros_like(g_yaw)
    g_rpy = torch.stack([zero, zero, g_yaw], dim=1)
    return torch.cat([g_u, g_up, g_pos, g_vel, g_rpy], dim=1)


def _habs_z_max(Z, w: nlp.StageWeights, rmax2):
    """max |H| |z| over stages/rows, per lane (the f32 stationarity
    precision floor: sum of |H_ij| |z_j| per row)."""
    u, up = Z[:, 0:4].abs(), Z[:, 4:8].abs()
    pos, vel = Z[:, 8:11].abs(), Z[:, 11:14].abs()
    r_u = 2.0 * w.w_rate[:, None] * (u + up)
    r_u = torch.cat(
        [r_u[:, 0:3] + 2.0 * (w.w_input[:, None] / rmax2) * u[:, 0:3],
         r_u[:, 3:4]], dim=1)
    r_up = 2.0 * w.w_rate[:, None] * (up + u)
    r_up = torch.cat(
        [r_up[:, 0:3] + 2.0 * w.w_uprev0[:, None] * up[:, 0:3],
         r_up[:, 3:4]], dim=1)
    r_pos = 2.0 * w.w_wp.abs()[:, None] * pos
    r_vel = 2.0 * w.w_vel.abs()[:, None] * vel
    r_yaw = 24.0 * w.w_wp * Z[:, 16].abs()
    rows = torch.cat([r_u, r_up, r_pos, r_vel, r_yaw[:, None]], dim=1)
    return rows.amax(dim=(0, 1))


def _corridor_mv(A, x):
    """(N, nh, 3, B) @ (N, 3, B) -> (N, nh, B), unrolled over xyz."""
    return (
        A[:, :, 0] * x[:, None, 0]
        + A[:, :, 1] * x[:, None, 1]
        + A[:, :, 2] * x[:, None, 2]
    )


def _corridor_mtv(A, v):
    """(N, nh, 3, B)^T @ (N, nh, B) -> (N, 3, B)."""
    return torch.stack([sum_dim(A[:, :, j] * v, 1) for j in range(3)], dim=1)


def _ineq_residuals(Z, A, b, lb, ub, hu):
    g_lb = lb[None, :, None] - Z
    g_ub = Z - ub[None, :, None]
    g_cor = _corridor_mv(A, Z[:, 8:11]) - b - hu
    return torch.cat([g_lb, g_ub, g_cor], dim=1)            # (N, 64, B)


def _ineq_jac_T_times(A, v):
    out = -v[:, 0:17] + v[:, 17:34]
    return torch.cat(
        [out[:, 0:8], out[:, 8:11] + _corridor_mtv(A, v[:, 34:]), out[:, 11:]],
        dim=1)


def _ineq_jac_times(A, dz):
    return torch.cat([-dz, dz, _corridor_mv(A, dz[:, 8:11])], dim=1)


def _eq_grad(Z, lam, Ax, Bx):
    """J_eq^T lam; Ax (N-1, 9, 9, B), Bx (N-1, 9, 4, B), lam (N, 13, B)."""
    lx, lu = lam[1:, :9], lam[1:, 9:]                       # (N-1, ., B)
    BtL = sum_dim(Bx * lx[:, :, None], 1)                      # (N-1, 4, B)
    AtL = sum_dim(Ax * lx[:, :, None], 1)                      # (N-1, 9, B)
    out = torch.zeros_like(Z)
    out[:-1, 0:4] += BtL + lu
    out[:-1, 8:17] += AtL
    out[1:, 8:17] += -lx
    out[1:, 4:8] += -lu
    out[0, 8:17] += lam[0, :9]
    return out


def _xbar_cat(vx, vt):
    """[x-part (N, 9, B), theta-part (N, 4, B)] -> (N, 13, B)."""
    return torch.cat([vx, vt], dim=1)


def _dyn_pieces(Z, f_ext_bl, mcfg: ModelConfig):
    """Equality residuals + RK2 Jacobians for a lane-major Z (N, 17, B),
    via the batch-leading dynamics module.  f_ext_bl: (B, 3)."""
    x_bl = Z[:-1, 8:17].movedim(1, -1)                      # (N-1, B, 9)
    u_bl = Z[:-1, 0:4].movedim(1, -1)
    xn = rk2_step(x_bl, u_bl, f_ext_bl[None], mcfg)         # (N-1, B, 9)
    F = torch.cat([xn.movedim(-1, 1), Z[:-1, 0:4]], dim=1)
    Enext = torch.cat([Z[1:, 8:17], Z[1:, 4:8]], dim=1)
    c = F - Enext                                           # (N-1, 13, B)
    Ax, Bx = rk2_jacobians_analytic(x_bl, u_bl, f_ext_bl[None], mcfg)
    return c, Ax.movedim(1, -1), Bx.movedim(1, -1)         # (N-1, 9, ., B)


# ---------------------------------------------------------------------------
# state, one iteration, the host loop
# ---------------------------------------------------------------------------

def _init_state(Z0, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig):
    """Initial IPM state tuple (all lane-major, trailing batch B):
    (Z, lam, s, mu_d, mu, it, done, err)."""
    N, _, B = Z0.shape
    dtype, device = Z0.dtype, Z0.device
    lb, ub = nlp.variable_bounds(mcfg, dtype, device=device)
    margin = 1e-3
    Zc = torch.clamp(
        Z0, (lb + margin)[None, :, None], (ub - margin)[None, :, None]
    )
    g0 = _ineq_residuals(
        Zc, params.corridor_A, params.corridor_b, lb, ub, scfg.corridor_slack
    )
    s0 = torch.clamp(-g0, min=1e-2)
    mu0 = torch.full((B,), scfg.mu_init, dtype=dtype, device=device)
    mu_d0 = torch.clamp(mu0[None, None] / s0, 1e-6, 1e6)
    return (
        Zc,
        torch.zeros((N, NXB, B), dtype=dtype, device=device),
        s0, mu_d0, mu0,
        torch.zeros((B,), dtype=torch.int32, device=device),
        torch.zeros((B,), dtype=torch.bool, device=device),
        torch.full((B,), float("inf"), dtype=dtype, device=device),
    )


def _state_to_result(st, params: NLPParams, mcfg: ModelConfig,
                     scfg: SolverConfig) -> SolveResult:
    """Final state -> SolveResult with the reference's exit-code families
    (FORCESNLPsolver_normal.h:110-139): 1 OPTIMAL, 0 MAXITREACHED,
    -6 BADFUNCEVAL (NaN guard tripped; last finite iterate kept),
    -7 NOPROGRESS (stopped with the inequalities still violated by more
    than scfg.infeas_tol: the primal-infeasibility certificate)."""
    Z, lam, s, mu_d, _, it, done, err = st
    lb, ub = nlp.variable_bounds(mcfg, Z.dtype, device=Z.device)
    g = _ineq_residuals(
        Z, params.corridor_A, params.corridor_b, lb, ub, scfg.corridor_slack
    )
    violation = g.amax(dim=(0, 1))                          # (B,)
    finite = torch.isfinite(err)
    stuck = violation > scfg.infeas_tol
    exit_code = torch.where(
        done & finite, 1,
        torch.where(stuck, -7, torch.where(done & ~finite, -6, 0)),
    ).to(torch.int32)
    return SolveResult(
        Z=Z.movedim(-1, 0), lam=lam.movedim(-1, 0),
        s=s.movedim(-1, 0), mu_d=mu_d.movedim(-1, 0),
        exit_code=exit_code, iters=it, kkt_error=err,
    )


def lane_step(st, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig,
              max_iters, plain: bool = False):
    """One IPM iteration over every lane.

    st = (Z, lam, s, mu_d, mu, it, done, err); max_iters is an int or a
    (B,) tensor.  Lanes whose own loop condition (~done & it < max_iters)
    is false keep their state: exact vmap(while_loop) semantics, lane by
    lane.  Monotone barrier schedule, or Mehrotra predictor-corrector when
    scfg.predictor_corrector.  The Riccati factor and backsolves go
    through the K4 wrappers of ops/lqr_kernel.py (kernels on a CUDA
    tensor); plain=True takes their plain versions on any device, so the
    whole step is plain PyTorch (K1's plain version).
    """
    Z, lam, s, mu_d, mu, it, done, err = st
    N = Z.shape[0]
    dtype, device = Z.dtype, Z.device
    w = params.weights
    Acor, bcor = params.corridor_A, params.corridor_b
    lb, ub = nlp.variable_bounds(mcfg, dtype, device=device)
    hu = scfg.corridor_slack
    tol = max(scfg.tol_stat, scfg.tol_eq, scfg.tol_ineq, scfg.tol_comp)
    rmax2 = mcfg.max_rate ** 2
    eps = torch.finfo(dtype).eps
    tol_ref = 1e-4
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)

    # ---- residuals, dynamics linearization, KKT errors ----
    grad_f = _cost_gradient(Z, w, params.ref_pos, params.ref_yaw, rmax2)
    g = _ineq_residuals(Z, Acor, bcor, lb, ub, hu)
    c, Ax, Bx = _dyn_pieces(Z, params.f_ext.T, mcfg)

    r_stat = grad_f + _eq_grad(Z, lam, Ax, Bx) + _ineq_jac_T_times(Acor, mu_d)
    r_init = Z[0, 8:17] - params.xinit                      # (9, B)
    r_g = g + s
    r_c = s * mu_d - mu[None, None]
    s_max = 100.0
    mud_abs_sum = lane_sum(mu_d.abs())
    m_all = (lane_sum(lam.abs()) + mud_abs_sum) / (N * NXB + N * 64)
    s_d = torch.clamp(m_all, min=s_max) / s_max
    s_c = torch.clamp(mud_abs_sum / (N * 64), min=s_max) / s_max
    mag = (
        _habs_z_max(Z, w, rmax2)
        + lam.abs().amax(dim=(0, 1))
        + mu_d.abs().amax(dim=(0, 1))
    )
    stat_scale = torch.clamp(4.0 * eps * mag / tol_ref, min=1.0)
    stat = r_stat.abs().amax(dim=(0, 1)) / (s_d * stat_scale)
    eq = torch.maximum(c.abs().amax(dim=(0, 1)), r_init.abs().amax(dim=0))
    ineq = r_g.abs().amax(dim=(0, 1))
    comp = r_c.abs().amax(dim=(0, 1)) / s_c
    comp0 = (s * mu_d).abs().amax(dim=(0, 1)) / s_c
    err0 = torch.maximum(torch.maximum(stat, eq), torch.maximum(ineq, comp0))
    lane_done = err0 <= tol

    # ---- one Riccati factorization, replayed for every RHS ----
    if plain:
        factor = lqr_kernel.lqr_factor_fused_reference
        backsolve = lqr_kernel.lqr_backsolve_fused_reference
    else:
        factor = lqr_kernel.lqr_factor_fused_lanes
        backsolve = lqr_kernel.lqr_backsolve_fused_lanes
    sigma = mu_d / s
    dx0 = params.xinit - Z[0, 8:17]
    Ax, Bx = Ax.contiguous(), Bx.contiguous()
    fac = factor(*w, sigma, Acor, Ax, Bx, scfg.reg, rmax2)

    def direction(w_vec):
        q = grad_f + _ineq_jac_T_times(Acor, w_vec)
        sol = backsolve(
            fac, Ax, Bx, c, _xbar_cat(q[:, 8:17], q[:, 4:8]),
            q[:, 0:4].contiguous(), dx0,
        )
        dZ = torch.cat([sol.du, sol.dxb[:, 9:], sol.dxb[:, :9]], dim=1)
        ds = -r_g - _ineq_jac_times(Acor, dZ)
        return dZ, ds, sol.nu

    tau = scfg.frac_to_boundary

    def max_step(v, dv):
        ratio = torch.where(
            dv < 0, -tau * v / torch.clamp(dv, max=-1e-30), inf
        )
        return torch.minimum(torch.ones_like(mu), ratio.amin(dim=(0, 1)))

    if scfg.predictor_corrector:
        # ---- Mehrotra predictor-corrector (ipm_lanes.py:405-428) ----
        dZ_aff, ds_aff, _ = direction(sigma * r_g)
        dmu_aff = -mu_d - sigma * ds_aff
        a_p_aff = max_step(s, ds_aff)[None, None]
        a_d_aff = max_step(mu_d, dmu_aff)[None, None]
        m_ineq = N * s.shape[1]
        mu_avg = lane_sum(s * mu_d) / m_ineq
        mu_aff = lane_sum(
            (s + a_p_aff * ds_aff) * (mu_d + a_d_aff * dmu_aff)
        ) / m_ineq
        sig_c = torch.clamp(
            (mu_aff / torch.clamp(mu_avg, min=1e-30)) ** 3, scfg.sigma_min, 1.0
        )
        mu_n = torch.where(
            lane_done, mu,
            torch.minimum(
                torch.clamp(sig_c * mu_avg, min=tol / 20.0),
                torch.clamp(mu, min=tol),
            ),
        )
        corr = (mu_n[None, None] - ds_aff * dmu_aff) / s
        dZ, ds, nu = direction(corr + sigma * r_g)
        mu_d_new_full = corr - sigma * ds
    else:
        if scfg.mu_gate:
            err_mu = torch.maximum(
                torch.maximum(stat, eq), torch.maximum(ineq, comp)
            )
            shrink = err_mu <= scfg.mu_gate_factor * mu
        else:
            shrink = torch.ones_like(lane_done)
        mu_pow = (
            mu * torch.sqrt(mu) if scfg.mu_superlin == 1.5
            else mu ** scfg.mu_superlin
        )
        mu_n = torch.where(
            shrink & ~lane_done,
            torch.clamp(torch.minimum(scfg.kappa_mu * mu, mu_pow), min=tol / 20.0),
            mu,
        )
        dZ, ds, nu = direction(mu_n[None, None] / s + sigma * r_g)
        mu_d_new_full = mu_n[None, None] / s - sigma * ds
    dmu = mu_d_new_full - mu_d

    lam_plus = nu.clone()
    lam_plus[0, :9] = -nu[0, :9]
    lam_plus[0, 9:] = 0.0

    a_p = max_step(s, ds)[None, None]                        # (1, 1, B)
    a_d = max_step(mu_d, dmu)[None, None]
    Z_n = Z + a_p * dZ
    s_n = s + a_p * ds
    mu_d_n = mu_d + a_d * dmu
    lam_n = lam + a_d * (lam_plus - lam)

    bad = ~(
        torch.isfinite(err0)
        & torch.isfinite(Z_n).all(dim=0).all(dim=0)
        & torch.isfinite(s_n).all(dim=0).all(dim=0)
    )
    # a lane moves only when it is active (its own loop condition holds)
    # and neither converged nor tripped the NaN guard this iteration
    active = (~done) & (it < max_iters)                      # (B,)
    upd = (active & ~(lane_done | bad))[None, None]
    return (
        torch.where(upd, Z_n, Z),
        torch.where(upd, lam_n, lam),
        torch.where(upd, s_n, s),
        torch.where(upd, mu_d_n, mu_d),
        torch.where(active, mu_n, mu),
        torch.where(active, it + 1, it),
        torch.where(active, lane_done | bad, done),
        torch.where(active, torch.where(bad & ~lane_done, inf, err0), err),
    )


def _run_lanes(st0, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig,
               max_iters: int):
    """Step the lane-major IPM from an arbitrary state until every lane is
    done or at max_iters (resumable: the tiered solver continues compacted
    sub-batches from mid-solve state).  One device->host read per step."""
    global STEPS
    from forces_resilient_planner_tpu_torch.ops import ipm_kernel

    Z = st0[0]
    N, _, B = Z.shape
    fused = (
        not scfg.predictor_corrector
        and params.corridor_A.shape[1] == ipm_kernel.NH
    )
    if fused:
        mi_lane = torch.full(
            (B,), float(max_iters), dtype=Z.dtype, device=Z.device
        )
        w = params.weights

        def step(st):
            Z, lam, s, mu_d, mu, it, done, err = st
            scal = torch.stack([mu, it.to(Z.dtype), done.to(Z.dtype), err])
            Zn, lamn, sn, mudn, scaln = ipm_kernel.ipm_iteration_fused(
                Z, lam, s, mu_d, scal, w, params.ref_pos, params.ref_yaw,
                params.corridor_A, params.corridor_b, params.f_ext,
                params.xinit, mi_lane, mcfg, scfg,
            )
            return (
                Zn, lamn, sn, mudn, scaln[0],
                scaln[1].to(torch.int32), scaln[2] > 0.5, scaln[3],
            )
    else:
        def step(st):
            return lane_step(st, params, mcfg, scfg, max_iters)

    st = st0
    while True:
        with trace.span("solver.read"):
            more = bool(((~st[6]) & (st[5] < max_iters)).any())
        if not more:
            return st
        st = step(st)
        STEPS += 1


def solve_lanes(Z0, params: NLPParams, mcfg: ModelConfig,
                scfg: SolverConfig) -> SolveResult:
    """Lane-major batched IPM (Z0 (N, 17, B), lane-major params).  Returns
    batch-LEADING SolveResult fields (Z (B, N, 17), ...)."""
    st = _run_lanes(
        _init_state(Z0, params, mcfg, scfg), params, mcfg, scfg,
        scfg.max_iters,
    )
    return _state_to_result(st, params, mcfg, scfg)


def _map_params(fn, params: NLPParams) -> NLPParams:
    return NLPParams(
        *(fn(a) for a in params[:-1]),
        weights=nlp.StageWeights(*(fn(a) for a in params.weights)),
    )


def lanes_params(params: NLPParams) -> NLPParams:
    """Batch-leading NLPParams (B, ...) -> contiguous lane-major (..., B)."""
    return _map_params(lambda a: a.movedim(0, -1).contiguous(), params)


def solve_batch_lanes(Z0, params: NLPParams, mcfg: ModelConfig,
                      scfg: SolverConfig) -> SolveResult:
    """Batch-leading in/out (Z0 (B, N, 17)) wrapper of solve_lanes."""
    return solve_lanes(
        Z0.movedim(0, -1).contiguous(), lanes_params(params), mcfg, scfg
    )


# ---------------------------------------------------------------------------
# tiered solve: full-batch phase + compacted tail phases + safety net
# ---------------------------------------------------------------------------

def _take_lanes(a, idx):
    return a.index_select(-1, idx).contiguous()


def _put_lanes(a, idx, sub):
    return a.index_copy(a.dim() - 1, idx, sub)


def _compact_order(done):
    """Lane order with the unconverged lanes first (stable)."""
    return torch.argsort(done.to(torch.int8), stable=True)


def solve_lanes_tiered(Z0, params: NLPParams, mcfg: ModelConfig,
                       scfg: SolverConfig, phase1_iters: int,
                       tail_lanes: int) -> SolveResult:
    """Two-tier lane-major IPM: the one-level schedule of
    solve_lanes_multitier (phase 1 capped at scfg.max_iters, as there)."""
    return solve_lanes_multitier(Z0, params, mcfg, scfg,
                                 ((phase1_iters, tail_lanes),))


def solve_lanes_multitier(Z0, params: NLPParams, mcfg: ModelConfig,
                          scfg: SolverConfig, schedule) -> SolveResult:
    """Multi-level tiered lane-major IPM.

    schedule = ((iter_cap_0, tail_lanes_1), (iter_cap_1, tail_lanes_2), ...):
    the full batch runs to iter_cap_0, the unconverged minority is
    compacted into tail_lanes_1 lanes and run to iter_cap_1, and so on; the
    last level runs to scfg.max_iters.  Every cap is at most
    scfg.max_iters.  Lanes that overflow a level are finished by the final
    full-batch safety-net phase (free when nothing overflows: its loop
    condition is false on entry), so results equal the single-phase
    solver's.  The empty schedule is the single-phase solve itself (no
    tail).
    """
    schedule = tuple(
        (min(cap, scfg.max_iters), lanes) for cap, lanes in schedule
    )
    st = _run_lanes(
        _init_state(Z0, params, mcfg, scfg), params, mcfg, scfg,
        schedule[0][0] if schedule else scfg.max_iters,
    )
    if not schedule:
        return _state_to_result(st, params, mcfg, scfg)

    def level(st, params, i):
        idx = _compact_order(st[6])[:schedule[i][1]]
        sub_st = tuple(_take_lanes(a, idx) for a in st)
        sub_params = _map_params(lambda a: _take_lanes(a, idx), params)
        next_cap = (
            schedule[i + 1][0] if i + 1 < len(schedule) else scfg.max_iters
        )
        sub_st = _run_lanes(sub_st, sub_params, mcfg, scfg, next_cap)
        if i + 1 < len(schedule):
            sub_st = level(sub_st, sub_params, i + 1)
        return tuple(_put_lanes(a, idx, b) for a, b in zip(st, sub_st))

    with trace.span("solver.tail"):
        merged = level(st, params, 0)
        merged = _run_lanes(merged, params, mcfg, scfg, scfg.max_iters)
    return _state_to_result(merged, params, mcfg, scfg)


def _round_lanes(B: int, frac: float) -> int:
    return min(B, max(128, int(round(B * frac / 128.0)) * 128))


def solve_batch_lanes_tiered(Z0, params: NLPParams, mcfg: ModelConfig,
                             scfg: SolverConfig) -> SolveResult:
    """Batch-leading wrapper for the tiered solver: one call of
    solve_lanes_multitier with the schedule the config gives.

    scfg.tiers, when non-empty, gives a multi-level ((iter_cap, frac), ...)
    schedule (frac = fraction of the FULL batch, rounded to 128 lanes);
    otherwise scfg.tier_phase1 / scfg.tier_frac give one level
    (tier_phase1 <= 0: the empty schedule, a single phase)."""
    B = Z0.shape[0]
    with trace.span("solver"):
        if scfg.tiers:
            schedule = tuple(
                (cap, _round_lanes(B, frac)) for cap, frac in scfg.tiers
            )
        elif scfg.tier_phase1 > 0:
            schedule = ((scfg.tier_phase1, _round_lanes(B, scfg.tier_frac)),)
        else:
            schedule = ()
        return solve_lanes_multitier(
            Z0.movedim(0, -1).contiguous(), lanes_params(params), mcfg, scfg,
            schedule,
        )
