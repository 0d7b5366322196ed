// Riccati factor and backsolve of the IPM's KKT system, one lane per thread
// (Hopper).
//
// Replaces the four Pallas TPU kernels of forces_resilient_planner_tpu/ops/
// lqr_pallas.py:
//   K4a _lqr_factor_fused_kernel (:269)  lqr_factor_fused_f32/f64
//   K4b _lqr_solve_fused_kernel  (:316)  lqr_backsolve_fused_f32/f64
//   K5a _lqr_factor_kernel       (:100)  lqr_factor_f32/f64
//   K5b _lqr_solve_kernel        (:132)  lqr_backsolve_f32/f64
// One factor sweep and one backsolve, each templated on T and on a stage
// loader: the fused loaders (K4) assemble the barrier-weighted stage QP
// blocks from the weight tables, the sigmas and the corridor rows, and the
// augmented dynamics [[Ax, 0], [0, 0]], [[Bx], [I4]] from the 9x9 / 9x4 RK2
// Jacobians, with the device code of riccati.cuh; the block loaders
// (K5) read pre-assembled Q/R/S/A/B from global memory.  The plain PyTorch
// versions are ops/lqr_kernel.py::*_reference (solver/riccati.py::
// lqr_factor_ll / lqr_solve_ll, the K4 ones after the assembly of
// ipm_lanes.lane_step).
//
// Design (right and simple first):
//  * one thread per lane, b = blockIdx.x*blockDim.x + threadIdx.x, no lane
//    padding (guard b < B); every tensor lane-minor, element
//    [(stage*rows + r)*B + b], so a warp's loads and stores coalesce;
//  * the factor writes its outputs (P, K, packed Cholesky factors) as it
//    sweeps and needs no scratch; the backsolve keeps its p (N x 13) and k
//    ((N-1) x 4) stacks in a lane-minor global scratch buffer that the
//    wrapper allocates once per shape (lqr_backsolve_scratch_per_lane);
//    per-stage 13x13 temporaries are thread-local arrays;
//  * IEEE semantics (no fast math), NaN-propagating nmax/nmin;
//  * THREADS = 32 per block: 4096 lanes are 128 blocks, one warp on each of
//    128 of the 132 SMs, so every warp has an SM's L1 to itself for its
//    local-memory temporaries (the per-thread arrays exceed the 255
//    registers); wider blocks would put 2-4 warps on 32-64 SMs.
//
// What bounds it: per lane and stage the factor does ~6.6k multiply-adds on
// 13x13 blocks held in thread-local memory; with one warp per SM the sweep
// is bound by the latency of those local loads and stores, not by device
// memory (at N = 20 the factor writes 4,620 values per lane, 76 MB at
// B = 4096 f32: ~25 us of the card's 3.35 TB/s).  Built with -fmad=false
// (ops/_build.py), so every product and sum rounds as in the plain version.
//
// ptxas (sm_90a, CUDA 12.8), registers / stack / spill stores / loads:
//   f32: K4a 255 / 4,736 B / 1,064 / 1,080 B; K4b 255 / 0 / 0 / 0;
//        K5a 168 / 5,088 B / 4,860 / 5,396 B; K5b 255 / 8 B / 16 / 16 B
//   f64: K4a 255 / 10,624 B / 6,608 / 7,744 B; K4b 255 / 8 B / 16 / 8 B;
//        K5a 168 / 10,592 B / 13,124 / 15,980 B; K5b 254 / 16 B / 24 / 16 B
// At B = 4096, N = 20, f32, on an NVIDIA H100 80GB HBM3 at 700 W: K4a
// 0.90 ms, K4b 0.22 ms, K5a 1.24 ms, K5b 0.27 ms per call.
#include "riccati.cuh"

namespace frp {

constexpr int THREADS = 32;

// ---- stage loaders -------------------------------------------------------
// qp.blocks(i, Q, R, S): stage i's QP blocks; dyn.blocks(i, A, B): stage
// i's 13x13 / 13x4 dynamics.

template <typename T>
struct FusedConsts {
  T reg, rmax2;
  int nh;  // corridor rows, 1..NH (assemble_stage reads it)
};

// K4: Q/R/S assembled from the weights, sigma (N, 34 + nh) and the
// corridor rows (N, nh, 3)
template <typename T>
struct FusedQP {
  Lane<const T> wwp, win, wrt, wvl, wup, sig, A;
  FusedConsts<T> c;
  __device__ void blocks(int i, T* Q, T* R, T* S) const {
    const int ns = 34 + c.nh;
    T sg[34 + NH], Ai[NH * 3];
    ld(sig, size_t(i) * ns, sg, ns);
    ld(A, size_t(i) * c.nh * 3, Ai, c.nh * 3);
    assemble_stage(sg, Ai, wwp[i], win[i], wrt[i], wvl[i], wup[i], c, Q,
                      R, S);
  }
};

// K4: the augmented dynamics from Ax (N-1, 9, 9), Bx (N-1, 9, 4)
template <typename T>
struct FusedDyn {
  Lane<const T> Ax, Bx;
  __device__ void blocks(int i, T* Abar, T* Bbar) const {
    T ax[NX * NX], bx[NX * NU];
    ld(Ax, size_t(i) * NX * NX, ax, NX * NX);
    ld(Bx, size_t(i) * NX * NU, bx, NX * NU);
    aug_dyn(ax, bx, Abar, Bbar);
  }
};

// K5: pre-assembled Q (N, 13, 13), R (N, 4, 4), S (N, 4, 13)
template <typename T>
struct BlockQP {
  Lane<const T> Q, R, S;
  __device__ void blocks(int i, T* q, T* r, T* s) const {
    ld(Q, size_t(i) * NXB * NXB, q, NXB * NXB);
    ld(R, size_t(i) * NU * NU, r, NU * NU);
    ld(S, size_t(i) * NU * NXB, s, NU * NXB);
  }
};

// K5: pre-assembled A (N-1, 13, 13), B (N-1, 13, 4)
template <typename T>
struct BlockDyn {
  Lane<const T> A, B;
  __device__ void blocks(int i, T* a, T* b) const {
    ld(A, size_t(i) * NXB * NXB, a, NXB * NXB);
    ld(B, size_t(i) * NXB * NU, b, NXB * NU);
  }
};

// the stored factorization (solver/riccati.py::LQRFactor)
template <typename P>
struct Factor {
  Lane<P> P_, K, cRh, RiS, cRt;  // (N,13,13) (N-1,4,13) (N-1,10) (4,13) (10)
};

// ---- the factor sweep (riccati.lqr_factor_ll) -----------------------------
template <typename T, typename QP, typename Dyn>
__device__ void factor_sweep(const QP& qp, const Dyn& dyn, const int N,
                             const Factor<T>& f) {
  T P[NXB * NXB];
  {
    T Q[NXB * NXB], R[NU * NU], S[NU * NXB], fR[10], RiS[NU * NXB];
    T StR[NXB * NXB];
    qp.blocks(N - 1, Q, R, S);
    chol4(R, fR);
    chol4_solve<NXB>(fR, S, RiS);
    mtm<NXB, NU, NXB>(S, RiS, StR);
    for (int k = 0; k < NXB * NXB; ++k) P[k] = Q[k] - StR[k];
    st(f.cRt, 0, fR, 10);
    st(f.RiS, 0, RiS, NU * NXB);
    st(f.P_, size_t(N - 1) * NXB * NXB, P, NXB * NXB);
  }
  for (int i = N - 2; i >= 0; --i) {
    T Q[NXB * NXB], R[NU * NU], S[NU * NXB], Abar[NXB * NXB], Bbar[NXB * NU];
    T AtP[NXB * NXB], BtP[NU * NXB], tmp[NXB * NXB], fh[10], Kg[NU * NXB];
    qp.blocks(i, Q, R, S);
    dyn.blocks(i, Abar, Bbar);
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
    st(f.K, size_t(i) * NU * NXB, Kg, NU * NXB);
    st(f.cRh, size_t(i) * 10, fh, 10);
    st(f.P_, size_t(i) * NXB * NXB, P, NXB * NXB);
  }
}

// ---- the backsolve (riccati.lqr_solve_ll) ---------------------------------
// p_s (N x 13) and k_s ((N-1) x 4) are the lane's scratch stacks.
template <typename T, typename Dyn>
__device__ void backsolve(const Dyn& dyn, const int N,
                          const Factor<const T>& f, const Lane<const T>& c,
                          const Lane<const T>& qx, const Lane<const T>& qu,
                          const Lane<const T>& dx0, const Lane<T>& dxb_o,
                          const Lane<T>& du_o, const Lane<T>& nu_o,
                          const Lane<T>& dth_o, const Lane<T>& p_s,
                          const Lane<T>& k_s) {
  T RiS[NU * NXB], Riqu[NU], p0[NXB];
  {
    T cRt[10], quN[NU], qxN[NXB], t13[NXB];
    ld(f.RiS, 0, RiS, NU * NXB);
    ld(f.cRt, 0, cRt, 10);
    ld(qu, size_t(N - 1) * NU, quN, NU);
    ld(qx, size_t(N - 1) * NXB, qxN, NXB);
    chol4_solve<1>(cRt, quN, Riqu);
    mtv<NXB, NU>(RiS, quN, t13);
    for (int k = 0; k < NXB; ++k) p0[k] = qxN[k] - t13[k];
    st(p_s, size_t(N - 1) * NXB, p0, NXB);
  }
  for (int i = N - 2; i >= 0; --i) {
    T Pn[NXB * NXB], ci[NXB], Pc[NXB], Abar[NXB * NXB], Bbar[NXB * NU];
    T qxh[NXB], quh[NU], t13[NXB], t4[NU], fh[10], kv[NU], Kg[NU * NXB];
    ld(f.P_, size_t(i + 1) * NXB * NXB, Pn, NXB * NXB);
    ld(c, size_t(i) * NXB, ci, NXB);
    mv<NXB, NXB>(Pn, ci, t13);
    for (int k = 0; k < NXB; ++k) Pc[k] = p0[k] + t13[k];
    dyn.blocks(i, Abar, Bbar);
    mtv<NXB, NXB>(Abar, Pc, t13);
    for (int k = 0; k < NXB; ++k) qxh[k] = qx[size_t(i) * NXB + k] + t13[k];
    mtv<NU, NXB>(Bbar, Pc, t4);
    for (int k = 0; k < NU; ++k) quh[k] = qu[size_t(i) * NU + k] + t4[k];
    ld(f.cRh, size_t(i) * 10, fh, 10);
    chol4_solve<1>(fh, quh, kv);
    for (int k = 0; k < NU; ++k) kv[k] = -kv[k];
    st(k_s, size_t(i) * NU, kv, NU);
    ld(f.K, size_t(i) * NU * NXB, Kg, NU * NXB);
    mtv<NXB, NU>(Kg, quh, t13);
    for (int k = 0; k < NXB; ++k) p0[k] = qxh[k] + t13[k];
    st(p_s, size_t(i) * NXB, p0, NXB);
  }
  // stage-0 free u_prev (dtheta): minimize over it with x fixed to dx0
  T dxb[NXB];
  {
    T P0[NXB * NXB], Ptt[NU * NU], fP[10], rhs[NU];
    ld(f.P_, 0, P0, NXB * NXB);
    ld(dx0, 0, dxb, NX);
    for (int k = 0; k < NU; ++k) {
      T acc = P0[NX + k] * dxb[0];
      for (int j = 1; j < NX; ++j) acc += P0[j * NXB + NX + k] * dxb[j];
      rhs[k] = -(p0[NX + k] + acc);
      for (int l = 0; l < NU; ++l) Ptt[k * NU + l] = P0[(NX + k) * NXB + NX + l];
    }
    chol4(Ptt, fP);
    chol4_solve<1>(fP, rhs, dxb + NX);
    st(dth_o, 0, dxb + NX, NU);
  }
  // forward rollout; costates nu_i = P_i dxb_i + p_i
  for (int i = 0; i < N; ++i) {
    T du[NU], Pi[NXB * NXB], nu[NXB];
    if (i < N - 1) {
      T Kg[NU * NXB];
      ld(f.K, size_t(i) * NU * NXB, Kg, NU * NXB);
      mv<NU, NXB>(Kg, dxb, du);
      for (int k = 0; k < NU; ++k) du[k] += k_s[size_t(i) * NU + k];
    } else {
      mv<NU, NXB>(RiS, dxb, du);
      for (int k = 0; k < NU; ++k) du[k] = -(Riqu[k] + du[k]);
    }
    ld(f.P_, size_t(i) * NXB * NXB, Pi, NXB * NXB);
    mv<NXB, NXB>(Pi, dxb, nu);
    for (int k = 0; k < NXB; ++k) nu[k] += p_s[size_t(i) * NXB + k];
    st(dxb_o, size_t(i) * NXB, dxb, NXB);
    st(du_o, size_t(i) * NU, du, NU);
    st(nu_o, size_t(i) * NXB, nu, NXB);
    if (i < N - 1) {
      T Abar[NXB * NXB], Bbar[NXB * NU], a13[NXB], b13[NXB];
      dyn.blocks(i, Abar, Bbar);
      mv<NXB, NXB>(Abar, dxb, a13);
      mv<NXB, NU>(Bbar, du, b13);
      for (int k = 0; k < NXB; ++k)
        dxb[k] = a13[k] + b13[k] + c[size_t(i) * NXB + k];
    }
  }
}

// ---- kernels ---------------------------------------------------------------
template <typename P>
__device__ __forceinline__ Lane<P> lane(P* p, int b, int B) {
  return Lane<P>{p + b, static_cast<size_t>(B)};
}

template <typename T>
__device__ __forceinline__ Factor<T> factor_out(T* P, T* K, T* cRh, T* RiS,
                                                T* cRt, int b, int B) {
  return Factor<T>{lane(P, b, B), lane(K, b, B), lane(cRh, b, B),
                   lane(RiS, b, B), lane(cRt, b, B)};
}

template <typename T>
__device__ __forceinline__ Factor<const T> factor_in(
    const T* P, const T* K, const T* cRh, const T* RiS, const T* cRt, int b,
    int B) {
  return Factor<const T>{lane(P, b, B), lane(K, b, B),
                         lane(cRh, b, B), lane(RiS, b, B),
                         lane(cRt, b, B)};
}

// K4a
template <typename T>
__global__ void __launch_bounds__(THREADS) lqr_factor_fused_kernel(
    const FusedConsts<T> c, const int N, const int B,
    const T* __restrict__ wwp, const T* __restrict__ win,
    const T* __restrict__ wrt, const T* __restrict__ wvl,
    const T* __restrict__ wup, const T* __restrict__ sig,
    const T* __restrict__ A, const T* __restrict__ Ax,
    const T* __restrict__ Bx, T* __restrict__ P, T* __restrict__ K,
    T* __restrict__ cRh, T* __restrict__ RiS, T* __restrict__ cRt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const FusedQP<T> qp{lane(wwp, b, B), lane(win, b, B),
                      lane(wrt, b, B), lane(wvl, b, B),
                      lane(wup, b, B), lane(sig, b, B),
                      lane(A, b, B), c};
  const FusedDyn<T> dyn{lane(Ax, b, B), lane(Bx, b, B)};
  factor_sweep<T>(qp, dyn, N, factor_out(P, K, cRh, RiS, cRt, b, B));
}

// K5a
template <typename T>
__global__ void __launch_bounds__(THREADS) lqr_factor_kernel(
    const int N, const int B, const T* __restrict__ Q,
    const T* __restrict__ R, const T* __restrict__ S,
    const T* __restrict__ A, const T* __restrict__ Bm, T* __restrict__ P,
    T* __restrict__ K, T* __restrict__ cRh, T* __restrict__ RiS,
    T* __restrict__ cRt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const BlockQP<T> qp{lane(Q, b, B), lane(R, b, B), lane(S, b, B)};
  const BlockDyn<T> dyn{lane(A, b, B), lane(Bm, b, B)};
  factor_sweep<T>(qp, dyn, N, factor_out(P, K, cRh, RiS, cRt, b, B));
}

// K4b (Dyn = FusedDyn, d0/d1 = Ax/Bx) and K5b (Dyn = BlockDyn, d0/d1 = A/B)
template <typename T, template <typename> class Dyn>
__global__ void __launch_bounds__(THREADS) lqr_backsolve_kernel(
    const int N, const int B, const T* __restrict__ P,
    const T* __restrict__ K, const T* __restrict__ cRh,
    const T* __restrict__ RiS, const T* __restrict__ cRt,
    const T* __restrict__ d0, const T* __restrict__ d1,
    const T* __restrict__ c, const T* __restrict__ qx,
    const T* __restrict__ qu, const T* __restrict__ dx0,
    T* __restrict__ dxb, T* __restrict__ du, T* __restrict__ nu,
    T* __restrict__ dth, T* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Dyn<T> dyn{lane(d0, b, B), lane(d1, b, B)};
  const Lane<T> p_s = lane(scratch, b, B);
  const Lane<T> k_s = lane(scratch + size_t(N) * NXB * B, b, B);
  backsolve<T>(dyn, N, factor_in(P, K, cRh, RiS, cRt, b, B),
               lane(c, b, B), lane(qx, b, B), lane(qu, b, B),
               lane(dx0, b, B), lane(dxb, b, B), lane(du, b, B),
               lane(nu, b, B), lane(dth, b, B), p_s, k_s);
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

}  // namespace frp

using namespace frp;

extern "C" {

// backsolve scratch values per lane for horizon N: p (N x 13), k ((N-1) x 4)
size_t lqr_backsolve_scratch_per_lane(int N) {
  return static_cast<size_t>(N) * NXB + static_cast<size_t>(N - 1) * NU;
}

#define LQR_ENTRIES(SUF, T)                                                    \
  int lqr_factor_fused_##SUF(int N, int B, int nh, T reg, T rmax2,             \
                             const T* wwp, const T* win, const T* wrt,         \
                             const T* wvl, const T* wup, const T* sig,         \
                             const T* A, const T* Ax, const T* Bx, T* P,       \
                             T* K, T* cRh, T* RiS, T* cRt,                     \
                             cudaStream_t stream) {                            \
    const FusedConsts<T> c{reg, rmax2, nh};                                    \
    lqr_factor_fused_kernel<T><<<blocks_for(B), THREADS, 0, stream>>>(         \
        c, N, B, wwp, win, wrt, wvl, wup, sig, A, Ax, Bx, P, K, cRh, RiS,      \
        cRt);                                                                  \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int lqr_factor_##SUF(int N, int B, const T* Q, const T* R, const T* S,       \
                       const T* A, const T* Bm, T* P, T* K, T* cRh, T* RiS,    \
                       T* cRt, cudaStream_t stream) {                          \
    lqr_factor_kernel<T><<<blocks_for(B), THREADS, 0, stream>>>(               \
        N, B, Q, R, S, A, Bm, P, K, cRh, RiS, cRt);                            \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int lqr_backsolve_fused_##SUF(int N, int B, const T* P, const T* K,          \
                                const T* cRh, const T* RiS, const T* cRt,      \
                                const T* Ax, const T* Bx, const T* c,          \
                                const T* qx, const T* qu, const T* dx0,        \
                                T* dxb, T* du, T* nu, T* dth, T* scratch,      \
                                cudaStream_t stream) {                         \
    lqr_backsolve_kernel<T, FusedDyn><<<blocks_for(B), THREADS, 0, stream>>>(  \
        N, B, P, K, cRh, RiS, cRt, Ax, Bx, c, qx, qu, dx0, dxb, du, nu, dth,   \
        scratch);                                                              \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int lqr_backsolve_##SUF(int N, int B, const T* P, const T* K,                \
                          const T* cRh, const T* RiS, const T* cRt,            \
                          const T* A, const T* Bm, const T* c, const T* qx,    \
                          const T* qu, const T* dx0, T* dxb, T* du, T* nu,     \
                          T* dth, T* scratch, cudaStream_t stream) {           \
    lqr_backsolve_kernel<T, BlockDyn><<<blocks_for(B), THREADS, 0, stream>>>(  \
        N, B, P, K, cRh, RiS, cRt, A, Bm, c, qx, qu, dx0, dxb, du, nu, dth,    \
        scratch);                                                              \
    return static_cast<int>(cudaGetLastError());                               \
  }

LQR_ENTRIES(f32, float)
LQR_ENTRIES(f64, double)

}  // extern "C"
