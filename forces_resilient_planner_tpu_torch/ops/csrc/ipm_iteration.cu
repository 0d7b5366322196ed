// One whole monotone interior-point iteration per scenario lane (Hopper).
//
// Replaces forces_resilient_planner_tpu/ops/ipm_pallas.py::_iter_kernel
// (the Pallas TPU kernel behind ipm_iteration_fused).  It computes, per
// lane: the RK2 dynamics residual and Jacobians of every stage, the cost
// gradient, the 64 inequality rows per stage, the scaled KKT errors, the
// gated barrier update, the right-hand side, the Riccati factor on the
// 13-wide augmented state (packed 4x4 Cholesky factors), the backsolve and
// forward rollout, the fraction-to-boundary step lengths, the NaN guard
// and the masked state update.  The plain PyTorch version of the same step
// is ops/ipm_kernel.py::ipm_iteration_reference (= solver/ipm_lanes.py::
// lane_step); the NaN guard follows it (finiteness of the stepped Z and s).
//
// Design (right and simple first):
//  * one thread per scenario lane, b = blockIdx.x*blockDim.x + threadIdx.x,
//    32 threads per block, no lane padding (guard b < B);
//  * every tensor is lane-minor, element [(stage*rows + r)*B + b], so the
//    32 lanes of a warp load and store neighbouring addresses (coalesced);
//  * the per-lane stage stacks (sigma, r_g, grad f, qx, qu, P, K, packed
//    Cholesky factors, p, k, dZ, ds, dmu, nu, Ax, Bx, c: 13,826 values at
//    N = 20, 55 KB at f32) fit neither registers nor shared memory, so
//    they live in one global scratch buffer in the same lane-minor layout,
//    allocated once per batch shape by the wrapper; per-stage temporaries
//    (13x13 blocks) are thread-local arrays;
//  * every model and solver constant arrives in the IterConsts argument;
//  * templated on T (float on the main path, double for tight checks);
//    constants are written T(...) so f32 arithmetic is never promoted;
//  * IEEE semantics: build without fast math; max/min propagate NaN like
//    jnp.maximum / jnp.min so the NaN guard trips as in the reference.
//
// What bounds it: one warp per block means at most one warp per SM at
// B = 4096 (128 blocks on 132 SMs; the 1024- and 256-lane tiers use 32
// and 8 blocks), so the scratch and local-memory traffic (tens of KB per
// lane per iteration) is latency-bound with almost no memory-level
// parallelism.  Raising occupancy (several lanes' stacks in shared memory,
// more warps per SM) and keeping P in registers are later work.
#include "riccati.cuh"

namespace frp {

constexpr int NZ = 17;   // stage variables [u(4), u_prev(4), x(9)]
constexpr int NIN = 64;  // inequality rows: 17 lb + 17 ub + 30 corridor
constexpr int THREADS = 32;

template <typename T>
struct IterConsts {
  T mass, g, drag, dt, rmax2, hu, tol, mu_floor, tol_ref, tau,
      mu_gate_factor, kappa_mu, reg;
  T lb[NZ];
  T ub[NZ];
  int mu_gate;
};

// ---- dynamics (dynamics/quadrotor.py; ipm_pallas.py:100-215) -------------
// (rot_blocks and cont_jac are in common.cuh; the lane views, chol4,
// assemble_stage and aug_dyn, shared with lqr.cu, in riccati.cuh)
// continuous dynamics xdot (9) (nonlinear_dynamics.m:20-40)
template <typename T>
__device__ void xdot(const T* x, const T* u, const T* f, const T* R,
                     const IterConsts<T>& c, T* out) {
  const T* vel = x + 3;
  const T thrust_m = u[3] / c.mass;
  // v_body = R^T v; drag_acc = R diag(d, d, 0) v_body
  const T vb0 = R[0] * vel[0] + R[3] * vel[1] + R[6] * vel[2];
  const T vb1 = R[1] * vel[0] + R[4] * vel[1] + R[7] * vel[2];
  const T dv[3] = {c.drag * vb0, c.drag * vb1, T(0)};
  for (int i = 0; i < 3; ++i) {
    const T drag = R[3 * i] * dv[0] + R[3 * i + 1] * dv[1] + R[3 * i + 2] * dv[2];
    const T ge3 = i == 2 ? c.g : T(0);
    out[i] = vel[i];
    out[3 + i] = R[3 * i + 2] * thrust_m + f[i] - ge3 - drag;
    out[6 + i] = u[i];
  }
}

// one stage's equality residual c (13) and RK2 Jacobians Ax (9x9), Bx (9x4)
template <typename T>
__device__ __noinline__ void dyn_stage(const T* x, const T* u, const T* f,
                                       const T* x_next, const T* th_next,
                                       const IterConsts<T>& c, T* cres,
                                       T* Ax, T* Bx) {
  const T dt = c.dt, hdt = T(0.5) * c.dt;
  T R[9], k1[9], k2[9], xm[9];
  rot_blocks(x + 6, R, static_cast<T*>(nullptr));
  xdot(x, u, f, R, c, k1);
  for (int k = 0; k < 9; ++k) xm[k] = x[k] + dt * k1[k];
  rot_blocks(xm + 6, R, static_cast<T*>(nullptr));
  xdot(xm, u, f, R, c, k2);
  for (int k = 0; k < 9; ++k) cres[k] = (x[k] + hdt * (k1[k] + k2[k])) - x_next[k];
  for (int k = 0; k < 4; ++k) cres[9 + k] = u[k] - th_next[k];

  T J1[81], J2[81], B1[36], B2[36], JJ[81], JB[36];
  cont_jac(x, u, c.mass, c.drag, J1, B1);
  cont_jac(xm, u, c.mass, c.drag, J2, B2);
  mm<9, 9, 9>(J2, J1, JJ);
  mm<9, 9, 4>(J2, B1, JB);
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) {
      const int k = 9 * i + j;
      Ax[k] = (i == j ? T(1) : T(0)) + hdt * (J1[k] + J2[k] + dt * JJ[k]);
    }
  for (int k = 0; k < 36; ++k) Bx[k] = hdt * (B1[k] + B2[k] + dt * JB[k]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ipm_iteration_kernel(
    const IterConsts<T> cst, const int N, const int B,
    const T* __restrict__ Z_, const T* __restrict__ lam_,
    const T* __restrict__ s_, const T* __restrict__ mud_,
    const T* __restrict__ scal_, const T* __restrict__ wwp_,
    const T* __restrict__ win_, const T* __restrict__ wrt_,
    const T* __restrict__ wvl_, const T* __restrict__ wup_,
    const T* __restrict__ refp_, const T* __restrict__ refy_,
    const T* __restrict__ A_, const T* __restrict__ bcor_,
    const T* __restrict__ fext_, const T* __restrict__ xinit_,
    const T* __restrict__ maxit_, T* __restrict__ Zn_,
    T* __restrict__ lamn_, T* __restrict__ sn_, T* __restrict__ mudn_,
    T* __restrict__ scaln_, T* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t LB = static_cast<size_t>(B);
  const Lane<const T> Z{Z_ + b, LB}, lam{lam_ + b, LB}, s{s_ + b, LB},
      mud{mud_ + b, LB}, scal{scal_ + b, LB}, wwp{wwp_ + b, LB},
      win{win_ + b, LB}, wrt{wrt_ + b, LB}, wvl{wvl_ + b, LB},
      wup{wup_ + b, LB}, refp{refp_ + b, LB}, refy{refy_ + b, LB},
      A{A_ + b, LB}, bcor{bcor_ + b, LB};
  const Lane<T> Zn{Zn_ + b, LB}, lamn{lamn_ + b, LB}, sn{sn_ + b, LB},
      mudn{mudn_ + b, LB}, scaln{scaln_ + b, LB};

  // scratch stacks, same order and sizes as ipm_scratch_per_lane()
  const size_t n = static_cast<size_t>(N), n1 = n - 1;
  size_t off = 0;
  auto take = [&](size_t count) {
    Lane<T> v{scratch + off * LB + b, LB};
    off += count;
    return v;
  };
  const Lane<T> sig_s = take(n * NIN), rg_s = take(n * NIN),
                gf_s = take(n * NZ), qx_s = take(n * NXB), qu_s = take(n * NU),
                P_s = take(n * NXB * NXB), K_s = take(n1 * NU * NXB),
                cRh_s = take(n1 * 10), RiS_s = take(NU * NXB),
                cRt_s = take(10), p_s = take(n * NXB), k_s = take(n1 * NU),
                dZ_s = take(n * NZ), ds_s = take(n * NIN),
                dmu_s = take(n * NIN), nu_s = take(n * NXB),
                Ax_s = take(n1 * NX * NX), Bx_s = take(n1 * NX * NU),
                c_s = take(n1 * NXB);

  const T inf = std::numeric_limits<T>::infinity();
  const T eps = std::numeric_limits<T>::epsilon();
  const T mu = scal[0], it = scal[1], done_in = scal[2], err_in = scal[3];
  const bool active = !(done_in > T(0.5)) && (it < maxit_[b]);
  T f[3], xinit[9];
  ld(Lane<const T>{fext_ + b, LB}, 0, f, 3);
  ld(Lane<const T>{xinit_ + b, LB}, 0, xinit, 9);

  // ---- phase 0: dynamics linearization -----------------------------------
  for (int i = 0; i < N - 1; ++i) {
    T zi[NZ], zn[NZ], cres[NXB], Ax[81], Bx[36];
    ld(Z, size_t(i) * NZ, zi, NZ);
    ld(Z, size_t(i + 1) * NZ, zn, NZ);
    dyn_stage(zi + 8, zi, f, zn + 8, zn + 4, cst, cres, Ax, Bx);
    st(c_s, size_t(i) * NXB, cres, NXB);
    st(Ax_s, size_t(i) * 81, Ax, 81);
    st(Bx_s, size_t(i) * 36, Bx, 36);
  }

  // ---- phase 1: gradient, residuals, sigma, error accumulators ----------
  const T ninf = -inf;
  T ineq_max = ninf, comp_max = ninf, comp0_max = ninf, habs_max = ninf;
  T lam_abs_sum = T(0), mud_abs_sum = T(0), lam_abs_max = ninf,
    mud_abs_max = ninf, eq_max = ninf;
  for (int i = 0; i < N; ++i) {
    T zi[NZ];
    ld(Z, size_t(i) * NZ, zi, NZ);
    const T* u = zi;
    const T* up = zi + 4;
    const T* pos = zi + 8;
    const T* vel = zi + 11;
    const T yaw = zi[16];
    const T wp = wwp[i], wr = wrt[i], wv = wvl[i], wu = wup[i], wi = win[i];

    T gf[NZ];
    for (int k = 0; k < 4; ++k) {
      gf[k] = T(2) * wr * (u[k] - up[k]);
      gf[4 + k] = T(2) * wr * (up[k] - u[k]);
      if (k < 3) {
        gf[k] = gf[k] + T(2) * (wi / cst.rmax2) * u[k];
        gf[4 + k] = gf[4 + k] + T(2) * wu * up[k];
      }
    }
    for (int k = 0; k < 3; ++k) {
      gf[8 + k] = T(2) * wp * (pos[k] - refp[size_t(i) * 3 + k]);
      gf[11 + k] = T(2) * wv * vel[k];
    }
    gf[14] = T(0);
    gf[15] = T(0);
    gf[16] = T(24) * wp * (yaw - refy[i]);
    st(gf_s, size_t(i) * NZ, gf, NZ);

    // |H| |z| row maxima (f32 stationarity floor)
    for (int k = 0; k < 4; ++k) {
      const T au = t_abs(u[k]), aup = t_abs(up[k]);
      T ru = T(2) * wr * (au + aup), rup = T(2) * wr * (aup + au);
      if (k < 3) {
        ru = ru + T(2) * (wi / cst.rmax2) * au;
        rup = rup + T(2) * wu * aup;
      }
      habs_max = nmax(habs_max, nmax(ru, rup));
    }
    for (int k = 0; k < 3; ++k) {
      habs_max = nmax(habs_max, T(2) * t_abs(wp) * t_abs(pos[k]));
      habs_max = nmax(habs_max, T(2) * t_abs(wv) * t_abs(vel[k]));
    }
    habs_max = nmax(habs_max, T(24) * wp * t_abs(yaw));

    // inequality rows g = [lb - z, z - ub, A p - b - hu]
    T g[NIN], Ai[NH * 3];
    ld(A, size_t(i) * NH * 3, Ai, NH * 3);
    for (int k = 0; k < NZ; ++k) {
      g[k] = cst.lb[k] - zi[k];
      g[NZ + k] = zi[k] - cst.ub[k];
    }
    for (int k = 0; k < NH; ++k)
      g[34 + k] = (Ai[3 * k] * pos[0] + Ai[3 * k + 1] * pos[1] +
                   Ai[3 * k + 2] * pos[2]) -
                  bcor[size_t(i) * NH + k] - cst.hu;
    for (int k = 0; k < NIN; ++k) {
      const size_t e = size_t(i) * NIN + k;
      const T si = s[e], mdi = mud[e];
      const T rg = g[k] + si;
      rg_s[e] = rg;
      sig_s[e] = mdi / si;
      ineq_max = nmax(ineq_max, t_abs(rg));
      const T smd = si * mdi;
      comp_max = nmax(comp_max, t_abs(smd - mu));
      comp0_max = nmax(comp0_max, t_abs(smd));
      mud_abs_sum += t_abs(mdi);
      mud_abs_max = nmax(mud_abs_max, t_abs(mdi));
    }
    for (int k = 0; k < NXB; ++k) {
      const T l = lam[size_t(i) * NXB + k];
      lam_abs_sum += t_abs(l);
      lam_abs_max = nmax(lam_abs_max, t_abs(l));
    }
    if (i < N - 1)
      for (int k = 0; k < NXB; ++k)
        eq_max = nmax(eq_max, t_abs(c_s[size_t(i) * NXB + k]));
  }
  for (int k = 0; k < NX; ++k) eq_max = nmax(eq_max, t_abs(Z[8 + k] - xinit[k]));

  // ---- phase 2: stationarity grad f + J_eq^T lam + J_g^T mu_d -----------
  T stat_max = ninf;
  for (int i = 0; i < N; ++i) {
    T r[NZ], md[NIN], Ai[NH * 3];
    ld(gf_s, size_t(i) * NZ, r, NZ);
    ld(mud, size_t(i) * NIN, md, NIN);
    ld(A, size_t(i) * NH * 3, Ai, NH * 3);
    for (int k = 0; k < NZ; ++k) r[k] = r[k] - md[k] + md[NZ + k];
    for (int j = 0; j < 3; ++j) {
      T acc = Ai[j] * md[34];
      for (int k = 1; k < NH; ++k) acc += Ai[3 * k + j] * md[34 + k];
      r[8 + j] += acc;
    }
    if (i < N - 1) {
      T lx[NX], lu[NU], Ax[81], Bx[36], AtL[NX], BtL[NU];
      ld(lam, size_t(i + 1) * NXB, lx, NX);
      ld(lam, size_t(i + 1) * NXB + NX, lu, NU);
      ld(Ax_s, size_t(i) * 81, Ax, 81);
      ld(Bx_s, size_t(i) * 36, Bx, 36);
      mtv<NU, NX>(Bx, lx, BtL);
      mtv<NX, NX>(Ax, lx, AtL);
      for (int k = 0; k < NU; ++k) r[k] = r[k] + BtL[k] + lu[k];
      for (int k = 0; k < NX; ++k) r[8 + k] += AtL[k];
    }
    if (i > 0) {
      for (int k = 0; k < NU; ++k) r[4 + k] -= lam[size_t(i) * NXB + NX + k];
      for (int k = 0; k < NX; ++k) r[8 + k] -= lam[size_t(i) * NXB + k];
    } else {
      for (int k = 0; k < NX; ++k) r[8 + k] += lam[k];
    }
    for (int k = 0; k < NZ; ++k) stat_max = nmax(stat_max, t_abs(r[k]));
  }

  // ---- phase 3: scaled errors, convergence, barrier update --------------
  const T m_eq = T(N * NXB), m_in = T(N * NIN), s_max = T(100);
  const T m_all = (lam_abs_sum + mud_abs_sum) / (m_eq + m_in);
  const T s_d = nmax(s_max, m_all) / s_max;
  const T s_c = nmax(s_max, mud_abs_sum / m_in) / s_max;
  const T mag = habs_max + lam_abs_max + mud_abs_max;
  const T stat_scale = nmax(T(1), T(4) * eps * mag / cst.tol_ref);
  const T stat = stat_max / (s_d * stat_scale);
  const T comp = comp_max / s_c;
  const T comp0 = comp0_max / s_c;
  const T err0 = nmax(nmax(stat, eq_max), nmax(ineq_max, comp0));
  const bool lane_done = err0 <= cst.tol;
  const bool shrink =
      cst.mu_gate ? (nmax(nmax(stat, eq_max), nmax(ineq_max, comp)) <=
                     cst.mu_gate_factor * mu)
                  : true;
  // mu ** 1.5 as mu * sqrt(mu) (the wrapper requires mu_superlin == 1.5)
  const T mu_pow = mu * t_sqrt(mu);
  const T mu_n = (shrink && !lane_done)
                     ? nmax(cst.mu_floor, nmin(cst.kappa_mu * mu, mu_pow))
                     : mu;

  // ---- phase 4: RHS q = grad f + J_g^T (mu_n / s + sigma r_g) ----------
  for (int i = 0; i < N; ++i) {
    T q[NZ], wv[NIN], Ai[NH * 3];
    ld(gf_s, size_t(i) * NZ, q, NZ);
    ld(A, size_t(i) * NH * 3, Ai, NH * 3);
    for (int k = 0; k < NIN; ++k) {
      const size_t e = size_t(i) * NIN + k;
      wv[k] = mu_n / s[e] + sig_s[e] * rg_s[e];
    }
    for (int k = 0; k < NZ; ++k) q[k] = q[k] - wv[k] + wv[NZ + k];
    for (int j = 0; j < 3; ++j) {
      T acc = Ai[j] * wv[34];
      for (int k = 1; k < NH; ++k) acc += Ai[3 * k + j] * wv[34 + k];
      q[8 + j] += acc;
    }
    for (int k = 0; k < NX; ++k) qx_s[size_t(i) * NXB + k] = q[8 + k];
    for (int k = 0; k < NU; ++k) {
      qx_s[size_t(i) * NXB + NX + k] = q[4 + k];
      qu_s[size_t(i) * NU + k] = q[k];
    }
  }

  // ---- phase 5: Riccati factor ------------------------------------------
  T P[NXB * NXB];
  {
    const int i = N - 1;
    T sg[NIN], Ai[NH * 3], Q[NXB * NXB], R[NU * NU], S[NU * NXB];
    T fR[10], RiS[NU * NXB], StR[NXB * NXB];
    ld(sig_s, size_t(i) * NIN, sg, NIN);
    ld(A, size_t(i) * NH * 3, Ai, NH * 3);
    assemble_stage<NH>(sg, Ai, wwp[i], win[i], wrt[i], wvl[i], wup[i], cst, Q, R, S);
    chol4(R, fR);
    chol4_solve<NXB>(fR, S, RiS);
    mtm<NXB, NU, NXB>(S, RiS, StR);
    for (int k = 0; k < NXB * NXB; ++k) P[k] = Q[k] - StR[k];
    st(cRt_s, 0, fR, 10);
    st(RiS_s, 0, RiS, NU * NXB);
    st(P_s, size_t(i) * NXB * NXB, P, NXB * NXB);
  }
  for (int i = N - 2; i >= 0; --i) {
    T sg[NIN], Ai[NH * 3], Q[NXB * NXB], R[NU * NU], S[NU * NXB];
    T Ax[81], Bx[36], Abar[NXB * NXB], Bbar[NXB * NU];
    T AtP[NXB * NXB], BtP[NU * NXB], tmp[NXB * NXB], fh[10], Kg[NU * NXB];
    ld(sig_s, size_t(i) * NIN, sg, NIN);
    ld(A, size_t(i) * NH * 3, Ai, NH * 3);
    assemble_stage<NH>(sg, Ai, wwp[i], win[i], wrt[i], wvl[i], wup[i], cst, Q, R, S);
    ld(Ax_s, size_t(i) * 81, Ax, 81);
    ld(Bx_s, size_t(i) * 36, Bx, 36);
    aug_dyn(Ax, Bx, Abar, Bbar);
    mtm<NXB, NXB, NXB>(Abar, P, AtP);
    mtm<NU, NXB, NXB>(Bbar, P, BtP);
    mm<NXB, NXB, NXB>(AtP, Abar, tmp);
    for (int k = 0; k < NXB * NXB; ++k) Q[k] += tmp[k];          // Qh
    mm<NU, NXB, NU>(BtP, Bbar, tmp);
    for (int k = 0; k < NU * NU; ++k) R[k] += tmp[k];            // Rh
    mm<NU, NXB, NXB>(BtP, Abar, tmp);
    for (int k = 0; k < NU * NXB; ++k) S[k] += tmp[k];           // Sh
    chol4(R, fh);
    chol4_solve<NXB>(fh, S, Kg);
    for (int k = 0; k < NU * NXB; ++k) Kg[k] = -Kg[k];
    mtm<NXB, NU, NXB>(S, Kg, tmp);
    for (int k = 0; k < NXB * NXB; ++k) Q[k] += tmp[k];          // Pn
    for (int r = 0; r < NXB; ++r)
      for (int col = 0; col < NXB; ++col)
        P[r * NXB + col] = T(0.5) * (Q[r * NXB + col] + Q[col * NXB + r]);
    st(K_s, size_t(i) * NU * NXB, Kg, NU * NXB);
    st(cRh_s, size_t(i) * 10, fh, 10);
    st(P_s, size_t(i) * NXB * NXB, P, NXB * NXB);
  }

  // ---- phase 6: backsolve, forward rollout, directions, step ratios -----
  T RiS[NU * NXB], Riqu[NU], p0[NXB];
  {
    T cRt[10], quN[NU], qxN[NXB], t13[NXB];
    ld(RiS_s, 0, RiS, NU * NXB);
    ld(cRt_s, 0, cRt, 10);
    ld(qu_s, size_t(N - 1) * NU, quN, NU);
    ld(qx_s, size_t(N - 1) * NXB, qxN, NXB);
    chol4_solve<1>(cRt, quN, Riqu);
    mtv<NXB, NU>(RiS, quN, t13);
    for (int k = 0; k < NXB; ++k) p0[k] = qxN[k] - t13[k];
    st(p_s, size_t(N - 1) * NXB, p0, NXB);
  }
  for (int i = N - 2; i >= 0; --i) {
    T Pn[NXB * NXB], ci[NXB], Pc[NXB], Ax[81], Bx[36], Abar[NXB * NXB];
    T Bbar[NXB * NU], qxh[NXB], quh[NU], t13[NXB], t4[NU], fh[10], kv[NU];
    T Kg[NU * NXB];
    ld(P_s, size_t(i + 1) * NXB * NXB, Pn, NXB * NXB);
    ld(c_s, size_t(i) * NXB, ci, NXB);
    mv<NXB, NXB>(Pn, ci, t13);
    for (int k = 0; k < NXB; ++k) Pc[k] = p0[k] + t13[k];
    ld(Ax_s, size_t(i) * 81, Ax, 81);
    ld(Bx_s, size_t(i) * 36, Bx, 36);
    aug_dyn(Ax, Bx, Abar, Bbar);
    mtv<NXB, NXB>(Abar, Pc, t13);
    for (int k = 0; k < NXB; ++k) qxh[k] = qx_s[size_t(i) * NXB + k] + t13[k];
    mtv<NU, NXB>(Bbar, Pc, t4);
    for (int k = 0; k < NU; ++k) quh[k] = qu_s[size_t(i) * NU + k] + t4[k];
    ld(cRh_s, size_t(i) * 10, fh, 10);
    chol4_solve<1>(fh, quh, kv);
    for (int k = 0; k < NU; ++k) kv[k] = -kv[k];
    st(k_s, size_t(i) * NU, kv, NU);
    ld(K_s, size_t(i) * NU * NXB, Kg, NU * NXB);
    mtv<NXB, NU>(Kg, quh, t13);
    for (int k = 0; k < NXB; ++k) p0[k] = qxh[k] + t13[k];
    st(p_s, size_t(i) * NXB, p0, NXB);
  }
  T dxb[NXB];
  {
    T P0[NXB * NXB], Ptt[NU * NU], fP[10], rhs[NU];
    ld(P_s, 0, P0, NXB * NXB);
    for (int k = 0; k < NX; ++k) dxb[k] = xinit[k] - Z[8 + k];
    for (int k = 0; k < NU; ++k) {
      T acc = P0[NX + k] * dxb[0];
      for (int j = 1; j < NX; ++j) acc += P0[j * NXB + NX + k] * dxb[j];
      rhs[k] = -(p0[NX + k] + acc);
      for (int l = 0; l < NU; ++l) Ptt[k * NU + l] = P0[(NX + k) * NXB + NX + l];
    }
    chol4(Ptt, fP);
    chol4_solve<1>(fP, rhs, dxb + NX);
  }

  const T tau = cst.tau;
  T ap = T(1), ad = T(1);
  for (int i = 0; i < N; ++i) {
    T du[NU], Pi[NXB * NXB], nu[NXB], dz[NZ], Ai[NH * 3];
    if (i < N - 1) {
      T Kg[NU * NXB];
      ld(K_s, size_t(i) * NU * NXB, Kg, NU * NXB);
      mv<NU, NXB>(Kg, dxb, du);
      for (int k = 0; k < NU; ++k) du[k] += k_s[size_t(i) * NU + k];
    } else {
      mv<NU, NXB>(RiS, dxb, du);
      for (int k = 0; k < NU; ++k) du[k] = -(Riqu[k] + du[k]);
    }
    ld(P_s, size_t(i) * NXB * NXB, Pi, NXB * NXB);
    mv<NXB, NXB>(Pi, dxb, nu);
    for (int k = 0; k < NXB; ++k) nu[k] += p_s[size_t(i) * NXB + k];
    st(nu_s, size_t(i) * NXB, nu, NXB);
    for (int k = 0; k < NU; ++k) {
      dz[k] = du[k];
      dz[4 + k] = dxb[NX + k];
    }
    for (int k = 0; k < NX; ++k) dz[8 + k] = dxb[k];
    st(dZ_s, size_t(i) * NZ, dz, NZ);
    ld(A, size_t(i) * NH * 3, Ai, NH * 3);
    for (int k = 0; k < NIN; ++k) {
      const size_t e = size_t(i) * NIN + k;
      T jdz;
      if (k < NZ) jdz = -dz[k];
      else if (k < 2 * NZ) jdz = dz[k - NZ];
      else {
        const int h = k - 2 * NZ;
        jdz = Ai[3 * h] * dz[8] + Ai[3 * h + 1] * dz[9] + Ai[3 * h + 2] * dz[10];
      }
      const T si = s[e], mdi = mud[e];
      const T ds = -rg_s[e] - jdz;
      const T dmu = mu_n / si - sig_s[e] * ds - mdi;
      ds_s[e] = ds;
      dmu_s[e] = dmu;
      const T rp = ds < T(0) ? (-tau * si) / nmin(ds, T(-1e-30)) : inf;
      const T rd = dmu < T(0) ? (-tau * mdi) / nmin(dmu, T(-1e-30)) : inf;
      ap = nmin(ap, rp);
      ad = nmin(ad, rd);
    }
    if (i < N - 1) {
      T Ax[81], Bx[36], Abar[NXB * NXB], Bbar[NXB * NU], a13[NXB], b13[NXB];
      ld(Ax_s, size_t(i) * 81, Ax, 81);
      ld(Bx_s, size_t(i) * 36, Bx, 36);
      aug_dyn(Ax, Bx, Abar, Bbar);
      mv<NXB, NXB>(Abar, dxb, a13);
      mv<NXB, NU>(Bbar, du, b13);
      for (int k = 0; k < NXB; ++k)
        dxb[k] = a13[k] + b13[k] + c_s[size_t(i) * NXB + k];
    }
  }

  // ---- phase 7: NaN guard and masked state update -----------------------
  bool finite = t_finite(err0);
  for (int i = 0; i < N && finite; ++i) {
    for (int k = 0; k < NZ; ++k) {
      const size_t e = size_t(i) * NZ + k;
      finite = finite && t_finite(Z[e] + ap * dZ_s[e]);
    }
    for (int k = 0; k < NIN; ++k) {
      const size_t e = size_t(i) * NIN + k;
      finite = finite && t_finite(s[e] + ap * ds_s[e]);
    }
  }
  const bool bad = !finite;
  const bool upd = active && !(lane_done || bad);
  for (int i = 0; i < N; ++i) {
    for (int k = 0; k < NZ; ++k) {
      const size_t e = size_t(i) * NZ + k;
      Zn[e] = upd ? Z[e] + ap * dZ_s[e] : Z[e];
    }
    for (int k = 0; k < NIN; ++k) {
      const size_t e = size_t(i) * NIN + k;
      sn[e] = upd ? s[e] + ap * ds_s[e] : s[e];
      mudn[e] = upd ? mud[e] + ad * dmu_s[e] : mud[e];
    }
    for (int k = 0; k < NXB; ++k) {
      const size_t e = size_t(i) * NXB + k;
      T lp = nu_s[e];
      if (i == 0) lp = k < NX ? -lp : T(0);
      lamn[e] = upd ? lam[e] + ad * (lp - lam[e]) : lam[e];
    }
  }
  scaln[0] = active ? mu_n : mu;
  scaln[1] = active ? it + T(1) : it;
  scaln[2] = active ? ((lane_done || bad) ? T(1) : T(0)) : done_in;
  scaln[3] = active ? ((bad && !lane_done) ? inf : err0) : err_in;
}

template <typename T>
int launch(const IterConsts<T>* c, int N, int B, const T* Z, const T* lam,
           const T* s, const T* mud, const T* scal, const T* wwp,
           const T* win, const T* wrt, const T* wvl, const T* wup,
           const T* refp, const T* refy, const T* A, const T* bcor,
           const T* fext, const T* xinit, const T* maxit, T* Zn, T* lamn,
           T* sn, T* mudn, T* scaln, T* scratch, cudaStream_t stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  ipm_iteration_kernel<T><<<blocks, THREADS, 0, stream>>>(
      *c, N, B, Z, lam, s, mud, scal, wwp, win, wrt, wvl, wup, refp, refy, A,
      bcor, fext, xinit, maxit, Zn, lamn, sn, mudn, scaln, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using frp::IterConsts;
using namespace frp;

extern "C" {

// scratch values per lane for horizon N (the order of `take` above)
size_t ipm_scratch_per_lane(int N) {
  const size_t n = static_cast<size_t>(N), n1 = n - 1;
  return n * (4 * NIN + 2 * NZ + 3 * NXB + NU + NXB * NXB) +
         n1 * (NU * NXB + 10 + NU + NX * NX + NX * NU + NXB) + NU * NXB + 10;
}

#define IPM_ENTRY(NAME, T)                                                   \
  int NAME(const IterConsts<T>* c, int N, int B, const T* Z, const T* lam,   \
           const T* s, const T* mud, const T* scal, const T* wwp,            \
           const T* win, const T* wrt, const T* wvl, const T* wup,           \
           const T* refp, const T* refy, const T* A, const T* bcor,          \
           const T* fext, const T* xinit, const T* maxit, T* Zn, T* lamn,    \
           T* sn, T* mudn, T* scaln, T* scratch, cudaStream_t stream) {      \
    return launch<T>(c, N, B, Z, lam, s, mud, scal, wwp, win, wrt, wvl, wup, \
                     refp, refy, A, bcor, fext, xinit, maxit, Zn, lamn, sn,  \
                     mudn, scaln, scratch, stream);                          \
  }

IPM_ENTRY(ipm_iteration_f32, float)
IPM_ENTRY(ipm_iteration_f64, double)

}  // extern "C"
