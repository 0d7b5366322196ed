// Riccati factor and backsolve of the IPM's KKT system (Hopper).
//
// Replaces the four Pallas TPU kernels of forces_resilient_planner_tpu/ops/
// lqr_pallas.py:
//   K4a _lqr_factor_fused_kernel (:269)  lqr_factor_fused_f32/f64
//   K4b _lqr_solve_fused_kernel  (:316)  lqr_backsolve_fused_f32/f64
//   K5a _lqr_factor_kernel       (:100)  lqr_factor_f32/f64
//   K5b _lqr_solve_kernel        (:132)  lqr_backsolve_f32/f64
// The plain PyTorch versions are ops/lqr_kernel.py::*_reference
// (solver/riccati.py::lqr_factor_ll / lqr_solve_ll, the K4 ones after the
// stage QP assembly and the augmented dynamics of _assemble_qp_blocks /
// _aug_dynamics).  Every kernel is built with -fmad=false (ops/_build.py)
// and sums in the plain version's order, so that each product and sum
// rounds as there: on the same inputs the kernels match their plain
// versions bit for bit (the CPU build of tests/test_torch_lqr_kernel.py).
//
// K4 (the predictor-corrector's factor and backsolve, PR 6 design):
//  * a team of one warp per lane, MAX_LANES = 8 lanes per CTA at
//    consecutive b (ops/lqr_kernel.py::launch_geometry).  Each lane's
//    working set lives in dynamic shared memory (fac_layout / solve_layout
//    below, mirrored by lqr_kernel.lane_elements); no global scratch;
//  * the CTA moves data lane-minor, neighbouring threads on neighbouring b:
//    K4a's prologue assembles every stage's QP blocks at once, one thread a
//    (lane, stage), as their QA = 24 distinct values (Q's diagonal, the
//    corridor block's 6 sums over the nh rows in the plain version's order,
//    R's diagonal, S's -2 w_rate), so the corridor sums leave the serial
//    path; each stage's inputs are copied in with cp.async one stage
//    ahead, and each stage's outputs are written out from shared memory
//    after one CTA barrier a stage;
//  * K4a keeps the dynamics in shared memory as G = [Abar | Bbar] (13 x
//    17), its zero and identity blocks written once, Ax and Bx copied into
//    it each stage; K4b reads Ax and Bx through g_of, which gives the same
//    entries.  Every product multiplies through the zero blocks as the
//    plain version does (0 * inf = NaN on the same lanes, which trips
//    lane_step's NaN guard) and every thread runs one instruction stream;
//  * K4a's recursion gives each thread one output column of 9 rows: AtP /
//    BtP (= G^T P), then Qh / Sh / Rh (= [Q;S;R] + [AtP;BtP] G), their sums
//    advancing together (9 independent chains), each in the plain version's
//    order; K = -Rh^{-1} Sh one column a thread; P = sym(Qh + Sh^T K) as 91
//    (r <= c) pairs over the warp, in place of Qh; __syncwarp between
//    dependent products.  P_{i+1} and Qh / P_i take turns in two buffers;
//  * K4b keeps the lane's p and k stacks in shared memory and reads P, K
//    and the dynamics again in the forward pass (the same bytes as the
//    backward pass, partly from L2): the backward pass gives P_{i+1} c,
//    [Abar^T; Bbar^T] Pc and K^T quh one row a thread, the forward pass du
//    beside the costates P_i dxb_i + p_i, then Abar dxb + Bbar du; dxb_i
//    and du_i leave the lane after their stage;
//  * the packed 4x4 Cholesky factors keep their divisions (no reciprocal
//    diagonal as in ipm_iteration.cu): bit-equality with the plain version
//    is worth more here, where P is ill-conditioned late in a solve;
//  * a lane's result depends neither on its slot in the CTA nor on B.
//
// K5 (the batched LQR of solve_lqr_batched, PR 3 design): one thread per
// lane, 32 lanes per block, per-stage 13x13 temporaries in thread-local
// arrays; the backsolve keeps its p and k stacks in a lane-minor global
// scratch buffer (lqr_backsolve_scratch_per_lane).
//
// What bounds them: bytes.  At N = 20, B = 4096, f32, K4a reads 5,403
// values a lane and writes 4,620 (0.049 ms of the card's 3.35 TB/s), K4b
// reads 7,439 and writes 604 (0.039 ms); their arithmetic (0.4 and 0.1
// GFLOP) is an order below.  In practice each lane's serial recursion over
// the stages sets the time: K4a takes 0.14 ms for one lane alone and 0.29
// ms for 4096 (32 lanes an SM in one wave), K4b 0.17-0.18 ms at 4096
// (tools/k4_phase_probe.py splits the cycles by phase).
//
// ptxas (sm_90a, CUDA 12.8), registers / stack / spill stores / loads:
//   f32: K4a 64 / 0 / 0 / 0; K4b 64 / 0 / 0 / 0;
//        K5a 168 / 5,088 B / 4,860 / 5,396 B; K5b 255 / 8 B / 16 / 16 B
//   f64: K4a 128 / 0 / 0 / 0; K4b 104 / 0 / 0 / 0;
//        K5a 168 / 10,592 B / 13,124 / 15,980 B; K5b 254 / 16 B / 24 / 16 B
// At B = 4096, N = 20, f32, on an NVIDIA H100 80GB HBM3 at 700 W: K4a
// 0.29 ms (0.90 with PR 3's thread per lane), K4b 0.17-0.18 ms (0.22), K5a
// 1.23 ms, K5b 0.27 ms per call (PERF.md).
#include "riccati.cuh"

namespace frp {

constexpr int THREADS = 32;    // K5: lanes (threads) per block
constexpr int WARP = 32;       // K4: threads per lane
constexpr int MAX_LANES = 8;   // K4: lanes per CTA (ops/lqr_kernel.py)
// K4's CTAs an SM is built to hold: 4 at f32 (32 lanes an SM, so 4096
// lanes in one wave, at 64 registers), 2 at f64
template <typename T>
struct K4Ctas {
  static constexpr int min = sizeof(T) == 4 ? 4 : 2;
};

// ---- phase clocks (tools/k4_phase_probe.py builds with FRP_K4_CLOCKS) ------
// the cycles block 0's first lane spends in each phase, summed over stages
#ifdef FRP_K4_CLOCKS
constexpr int K4_PHASES = 16;
__device__ long long k4_cycles[K4_PHASES];
__device__ __forceinline__ void k4_clock(int k) {
  __shared__ long long last;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long now = clock64();
    if (k > 0) k4_cycles[k] += now - last;
    last = now;
  }
}
#define K4_CLOCK(k) k4_clock(k)
#else
#define K4_CLOCK(k) \
  do {              \
  } while (0)
#endif

// ===========================================================================
// K5: one thread per lane (PR 3)
// ===========================================================================

// pre-assembled Q (N, 13, 13), R (N, 4, 4), S (N, 4, 13)
template <typename T>
struct BlockQP {
  Lane<const T> Q, R, S;
  __device__ void blocks(int i, T* q, T* r, T* s) const {
    ld(Q, size_t(i) * NXB * NXB, q, NXB * NXB);
    ld(R, size_t(i) * NU * NU, r, NU * NU);
    ld(S, size_t(i) * NU * NXB, s, NU * NXB);
  }
};

// pre-assembled A (N-1, 13, 13), B (N-1, 13, 4)
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

// the factor sweep (riccati.lqr_factor_ll)
template <typename T>
__device__ void factor_sweep(const BlockQP<T>& qp, const BlockDyn<T>& dyn,
                             const int N, const Factor<T>& f) {
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

// the backsolve (riccati.lqr_solve_ll); p_s (N x 13) and k_s ((N-1) x 4)
// are the lane's scratch stacks
template <typename T>
__device__ void backsolve(const BlockDyn<T>& dyn, const int N,
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

template <typename P>
__device__ __forceinline__ Lane<P> lane(P* p, int b, int B) {
  return Lane<P>{p + b, static_cast<size_t>(B)};
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
  factor_sweep<T>(qp, dyn, N,
                  Factor<T>{lane(P, b, B), lane(K, b, B), lane(cRh, b, B),
                            lane(RiS, b, B), lane(cRt, b, B)});
}

// K5b
template <typename T>
__global__ void __launch_bounds__(THREADS) lqr_backsolve_kernel(
    const int N, const int B, const T* __restrict__ P,
    const T* __restrict__ K, const T* __restrict__ cRh,
    const T* __restrict__ RiS, const T* __restrict__ cRt,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ c, const T* __restrict__ qx,
    const T* __restrict__ qu, const T* __restrict__ dx0,
    T* __restrict__ dxb, T* __restrict__ du, T* __restrict__ nu,
    T* __restrict__ dth, T* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const BlockDyn<T> dyn{lane(A, b, B), lane(Bm, b, B)};
  const Lane<T> p_s = lane(scratch, b, B);
  const Lane<T> k_s = lane(scratch + size_t(N) * NXB * B, b, B);
  backsolve<T>(dyn, N,
               Factor<const T>{lane(P, b, B), lane(K, b, B), lane(cRh, b, B),
                               lane(RiS, b, B), lane(cRt, b, B)},
               lane(c, b, B), lane(qx, b, B), lane(qu, b, B),
               lane(dx0, b, B), lane(dxb, b, B), lane(du, b, B),
               lane(nu, b, B), lane(dth, b, B), p_s, k_s);
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// ===========================================================================
// K4: a warp per lane (PR 6)
// ===========================================================================

constexpr int NN = NXB * NXB;
constexpr int QA = NXB + 6 + NU + 1;   // a stage's distinct QP values
constexpr int GC = NXB + NU;           // G = [Abar | Bbar]: 17 columns
constexpr int GN = NXB * GC;
constexpr int ABR = NXB + NU + 1;      // rows of [AtP; BtP] and a zero row
constexpr int NPAIR = NXB * (NXB + 1) / 2;
constexpr int PAIRS = (NPAIR + WARP - 1) / WARP;   // (r <= c) pairs a thread

// ---- one lane's shared-memory layouts (elements of T) ----------------------
// ops/lqr_kernel.py::lane_elements mirrors both totals.
struct FacLayout {
  int qa, G, P, AB, Sh, Rh, K, cR, RiS, cRt, total;
};

__host__ __device__ inline FacLayout fac_layout(int N) {
  FacLayout L;
  int off = 0;
  auto take = [&](int count) { const int o = off; off += count; return o; };
  L.qa = take(N * QA);       // every stage's QP values
  L.G = take(2 * GN);        // the dynamics of two stages, in turns
  L.P = take(2 * NN);        // P_{i+1} and Qh, then P_i, in turns
  L.AB = take(ABR * NXB);    // [Abar^T P; Bbar^T P]
  L.Sh = take(NU * NXB);
  L.Rh = take(NU * NU);
  L.K = take(2 * NU * NXB);  // K_i, in turns
  L.cR = take(2 * 10);       // the packed Cholesky factor of Rh_i, in turns
  L.RiS = take(NU * NXB);
  L.cRt = take(10);
  L.total = off;
  return L;
}

// K4b's stage block: P, Ax, Bx, c, [qx; qu], K, cRh of one stage
constexpr int SB_P = 0, SB_AX = NN, SB_BX = SB_AX + NX * NX;
constexpr int SB_C = SB_BX + NX * NU, SB_Q = SB_C + NXB;
constexpr int SB_K = SB_Q + NXB + NU, SB_CR = SB_K + NU * NXB;
constexpr int SB = SB_CR + 10;

struct SolveLayout {
  int p, kk, dx, du, blk, Pc, qh, RiS, Riqu, total;
};

__host__ __device__ inline SolveLayout solve_layout(int N) {
  SolveLayout L;
  int off = 0;
  auto take = [&](int count) { const int o = off; off += count; return o; };
  L.p = take(N * NXB);       // p, then the costates nu
  L.kk = take((N - 1) * NU);
  L.dx = take(3 * NXB);      // dxb_i, in turns of three
  L.du = take(2 * NU);       // du_i, in turns
  L.blk = take(2 * SB);      // two stages' inputs, in turns
  L.Pc = take(NXB);
  L.qh = take(NXB + NU);     // qxh, quh
  L.RiS = take(NU * NXB);
  L.Riqu = take(NU);
  L.total = off;
  return L;
}

// ---- the CTA: copies between lane-minor tensors and the lanes' memory ------
struct Cta {
  int b0, B, lg, stride;     // first lane, lanes in all, log2 lanes per CTA
};

template <typename T>
__device__ __forceinline__ T* smem_lanes() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// rows [0, rows) of every lane: src[r * B + b] -> lane memory + off + r,
// neighbouring threads on neighbouring lanes
template <typename T>
__device__ __forceinline__ void get_rows(T* sm, const Cta& c, int off,
                                         const T* __restrict__ src, int rows) {
  const int l = threadIdx.x & ((1 << c.lg) - 1);
  if (c.b0 + l >= c.B) return;
  T* d = sm + l * c.stride + off;
  src += c.b0 + l;
  for (int r = threadIdx.x >> c.lg; r < rows; r += WARP)
    copy_async(d + r, src + size_t(r) * c.B);
}

// lane memory + off + r -> dst[r * B + b], rows [0, rows)
template <typename T>
__device__ __forceinline__ void put_rows(const T* sm, const Cta& c, int off,
                                         T* __restrict__ dst, int rows) {
  const int l = threadIdx.x & ((1 << c.lg) - 1);
  if (c.b0 + l >= c.B) return;
  const T* s = sm + l * c.stride + off;
  dst += c.b0 + l;
  for (int r = threadIdx.x >> c.lg; r < rows; r += WARP)
    dst[size_t(r) * c.B] = s[r];
}

// stage i's Ax (9x9) and Bx (9x4) into G = [Abar | Bbar] at off
template <typename T>
__device__ __forceinline__ void get_dyn(T* sm, const Cta& c, int off,
                                        const T* __restrict__ Ax,
                                        const T* __restrict__ Bx, int i) {
  const int l = threadIdx.x & ((1 << c.lg) - 1);
  if (c.b0 + l >= c.B) return;
  T* d = sm + l * c.stride + off;
  const size_t b = c.b0 + l;
  for (int r = threadIdx.x >> c.lg; r < NX * NX + NX * NU; r += WARP) {
    if (r < NX * NX)
      copy_async(d + (r / NX) * GC + r % NX,
                 Ax + (size_t(i) * NX * NX + r) * c.B + b);
    else
      copy_async(d + ((r - NX * NX) / NU) * GC + NXB + (r - NX * NX) % NU,
                 Bx + (size_t(i) * NX * NU + r - NX * NX) * c.B + b);
  }
}

// G's constant entries: Abar's zero blocks and Bbar's identity
template <typename T>
__device__ __forceinline__ void g_constants(T* G, int t) {
  for (int e = t; e < GN; e += WARP) {
    const int j = e / GC, col = e % GC;
    if (j >= NX || (col >= NX && col < NXB))
      G[e] = (j >= NX && col == NXB + j - NX) ? T(1) : T(0);
  }
}

// ---- the stage QP blocks from their QA values -----------------------------
// qa: Q's diagonal (13), the corridor block's sums for l >= j (6), R's
// diagonal (4), S's value -2 w_rate
template <typename T>
__device__ __forceinline__ T q_of(const T* qa, int r, int c) {
  T v = r == c ? qa[r] : T(0);
  if (r < 3 && c < 3) {
    const int j = r < c ? r : c, l = r < c ? c : r;
    v += qa[NXB + 3 * j - (j * (j - 1)) / 2 + (l - j)];
  }
  return v;
}
template <typename T>
__device__ __forceinline__ T r_of(const T* qa, int r, int c) {
  return r == c ? qa[NXB + 6 + r] : T(0);
}
template <typename T>
__device__ __forceinline__ T s_of(const T* qa, int r, int c) {
  return c == NX + r ? qa[QA - 1] : T(0);
}

// stage i's QA values for one lane (ops/lqr_kernel.py::_assemble_qp_blocks,
// term for term): sig (34 + nh rows), A (nh x 3 rows), the weights, each
// element at [row * B] of its lane-minor view
template <typename T>
struct FusedConsts {
  T reg, rmax2;
  int nh;    // corridor rows, 1..NH
};

template <typename T>
__device__ __forceinline__ void assemble_qa(const T* __restrict__ sig,
                                            const T* __restrict__ A,
                                            const T wwp, const T win,
                                            const T wrt, const T wvl,
                                            const T wup, const size_t B,
                                            const FusedConsts<T>& c, T* qa) {
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    T xd = (sig[(8 + k) * B] + sig[(25 + k) * B]) + c.reg;
    if (k < 3) xd += T(2) * wwp;
    else if (k < 6) xd += T(2) * wvl;
    else if (k == 8) xd += T(24) * wwp;
    qa[k] = xd;
  }
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    T up = T(2) * wrt + (sig[(4 + k) * B] + sig[(21 + k) * B]) + c.reg;
    if (k < 3) up += T(2) * wup;
    qa[NX + k] = up;
    T r = T(2) * wrt + (sig[k * B] + sig[(17 + k) * B]) + c.reg;
    if (k < 3) r += T(2) * win / c.rmax2;
    qa[NXB + 6 + k] = r;
  }
  qa[QA - 1] = -T(2) * wrt;
  // corridor 3x3 position block: sum_k (A_kj sc_k) A_kl for l >= j
  T acc[6];
  {
    const T sc = sig[34 * B];
    const T a[3] = {A[0], A[B], A[2 * B]};
#pragma unroll
    for (int j = 0, n = 0; j < 3; ++j)
#pragma unroll
      for (int l = j; l < 3; ++l, ++n) acc[n] = (a[j] * sc) * a[l];
  }
  // unrolled so that several rows' global loads are in flight at once
#pragma unroll 5
  for (int k = 1; k < c.nh; ++k) {
    const T sc = sig[(34 + k) * B];
    const T a[3] = {A[3 * k * B], A[(3 * k + 1) * B], A[(3 * k + 2) * B]};
#pragma unroll
    for (int j = 0, n = 0; j < 3; ++j)
#pragma unroll
      for (int l = j; l < 3; ++l, ++n) acc[n] += (a[j] * sc) * a[l];
  }
#pragma unroll
  for (int n = 0; n < 6; ++n) qa[NXB + n] = acc[n];
}

// ---- K4a: one stage of the recursion, on the lane's warp -------------------
// The (r <= c) pair p of P's upper triangle, row-major, as r * 16 + c.
__device__ __forceinline__ int tri_pair(int p) {
  int r = 0;
  while (p >= NXB - r) {
    p -= NXB - r;
    ++r;
  }
  return r * 16 + r + p;
}

// terminal stage N-1: RiS = R^{-1} S, P = Q - S^T RiS into Pn, cRt
template <typename T>
__device__ __forceinline__ void factor_terminal(T* m, const FacLayout& Lo,
                                                int N, T* Pn, int t) {
  const T* qa = m + Lo.qa + (N - 1) * QA;
  T R[NU * NU], fR[10];
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int c = 0; c < NU; ++c) R[r * NU + c] = r_of(qa, r, c);
  chol4(R, fR);
  if (t < NXB) {
    T col[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) col[k] = s_of(qa, k, t);
    chol4_solve<1>(fR, col, col);
#pragma unroll
    for (int k = 0; k < NU; ++k) m[Lo.RiS + k * NXB + t] = col[k];
  } else if (t == NXB) {
#pragma unroll
    for (int k = 0; k < 10; ++k) m[Lo.cRt + k] = fR[k];
  }
  __syncwarp();
  if (t < NXB) {
    const int r = t;
    const T* RiS = m + Lo.RiS;
    T acc[NXB];
    {
      const T s0 = s_of(qa, 0, r);
#pragma unroll
      for (int col = 0; col < NXB; ++col) acc[col] = s0 * RiS[col];
    }
#pragma unroll
    for (int j = 1; j < NU; ++j) {
      const T sj = s_of(qa, j, r);
#pragma unroll
      for (int col = 0; col < NXB; ++col) acc[col] += sj * RiS[j * NXB + col];
    }
#pragma unroll
    for (int col = 0; col < NXB; ++col)
      Pn[r * NXB + col] = q_of(qa, r, col) - acc[col];
  }
}

// stage i < N-1 with P_{i+1} in Pf and the dynamics in G; leaves Qh, then
// P_i in Pn, K_i in Kg and the packed factor of Rh_i in cR.  Qh = Q + Abar^T P Abar,
// Rh = R + Bbar^T P Bbar, Sh = S + Bbar^T P Abar, K = -Rh^{-1} Sh,
// P_i = sym(Qh + Sh^T K), each sum in the plain version's order.
template <typename T>
__device__ __forceinline__ void factor_stage(T* m, const FacLayout& Lo,
                                             const T* qa, const T* G,
                                             const T* Pf, T* Pn, T* Kg, T* cR,
                                             const int* pairs, int t) {
  T* AB = m + Lo.AB;
  T* Qh = Pn;
  T* Sh = m + Lo.Sh;
  T* Rh = m + Lo.Rh;
  // [AtP; BtP] = G^T P: column c, rows R0..R0+8 (threads 0-25; the rest,
  // and row 17, which reads past G's row, compute sums that they do not
  // store)
  {
    const int c = t < 2 * NXB ? t % NXB : 0;
    const int R0 = t < NXB ? 0 : 9;
    T acc[9];
    {
      const T p0 = Pf[c];
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q] = G[R0 + q] * p0;
    }
#pragma unroll
    for (int j = 1; j < NXB; ++j) {
      const T pj = Pf[j * NXB + c];
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q] += G[j * GC + R0 + q] * pj;
    }
    if (t < 2 * NXB) {
#pragma unroll
      for (int q = 0; q < 9; ++q)
        if (R0 + q < NXB + NU) AB[(R0 + q) * NXB + c] = acc[q];
    }
  }
  __syncwarp();
  K4_CLOCK(3);
  // [Qh; Sh] column c (threads 0-25: rows R0..R0+8 of [AtP; BtP] times G's
  // column c) and Rh column k (threads 26-29: rows 8-16, of which 13-16
  // are kept, times G's column 13 + k); each output = its Q, S or R value +
  // the row times the column
  {
    const int col = t < 2 * NXB ? t % NXB : (t < 2 * NXB + NU ? t - NXB : 0);
    const int R0 = t < NXB ? 0 : (t < 2 * NXB ? 9 : 8);
    T acc[9];
    {
      const T g0 = G[col];
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q] = AB[(R0 + q) * NXB] * g0;
    }
#pragma unroll
    for (int j = 1; j < NXB; ++j) {
      const T gj = G[j * GC + col];
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q] += AB[(R0 + q) * NXB + j] * gj;
    }
    if (t < 2 * NXB + NU) {
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int r = R0 + q;
        if (r >= NXB + NU) continue;
        if (col >= NXB) {
          if (r >= NXB)
            Rh[(r - NXB) * NU + col - NXB] =
                r_of(qa, r - NXB, col - NXB) + acc[q];
        } else if (r >= NXB)
          Sh[(r - NXB) * NXB + col] = s_of(qa, r - NXB, col) + acc[q];
        else
          Qh[r * NXB + col] = q_of(qa, r, col) + acc[q];
      }
    }
  }
  __syncwarp();
  K4_CLOCK(4);
  // K = -Rh^{-1} Sh, one column a thread; the factor of Rh
  {
    T fh[10];
    chol4(Rh, fh);
    if (t < NXB) {
      T col[NU];
#pragma unroll
      for (int k = 0; k < NU; ++k) col[k] = Sh[k * NXB + t];
      chol4_solve<1>(fh, col, col);
#pragma unroll
      for (int k = 0; k < NU; ++k) Kg[k * NXB + t] = -col[k];
    } else if (t == NXB) {
#pragma unroll
      for (int k = 0; k < 10; ++k) cR[k] = fh[k];
    }
  }
  __syncwarp();
  K4_CLOCK(5);
  // P_i = 0.5 (Pn + Pn^T), Pn = Qh + Sh^T K, one (r <= c) pair at a time:
  // the pair reads and writes its own two entries of Qh only
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    if (t + WARP * k < NPAIR) {
      const int r = pairs[k] >> 4, c = pairs[k] & 15;
      T a = Sh[r] * Kg[c];
      T b = Sh[c] * Kg[r];
#pragma unroll
      for (int j = 1; j < NU; ++j) {
        a += Sh[j * NXB + r] * Kg[j * NXB + c];
        b += Sh[j * NXB + c] * Kg[j * NXB + r];
      }
      const T v = T(0.5) * ((Qh[r * NXB + c] + a) + (Qh[c * NXB + r] + b));
      Pn[r * NXB + c] = v;
      Pn[c * NXB + r] = v;
    }
  }
  K4_CLOCK(6);
}

template <typename T>
struct FusedFactorArgs {
  const T* in[9];    // w_wp, w_input, w_rate, w_vel, w_uprev0, sigma, A, Ax, Bx
  T* out[5];         // P, K, cRh, RiS, cRt
};

// K4a
template <typename T>
__global__ void __launch_bounds__(WARP * MAX_LANES, K4Ctas<T>::min)
lqr_factor_fused_kernel(
    const FusedConsts<T> cst, const int N, const int B, const int lanes_log2,
    const int stride, const FusedFactorArgs<T> a) {
  T* sm = smem_lanes<T>();
  const Cta cta{static_cast<int>(blockIdx.x) << lanes_log2, B, lanes_log2,
                stride};
  const int slot = threadIdx.x / WARP, t = threadIdx.x % WARP;
  const bool active = cta.b0 + slot < B;
  const FacLayout Lo = fac_layout(N);
  T* m = sm + slot * stride;
  const T* __restrict__ Ax = a.in[7];
  const T* __restrict__ Bx = a.in[8];
  K4_CLOCK(0);

  // G's constants in both buffers, AB's zero row, the stage-(N-2)
  // dynamics on their way
  g_constants(m + Lo.G, t);
  g_constants(m + Lo.G + GN, t);
  if (t < NXB) m[Lo.AB + (NXB + NU) * NXB + t] = T(0);
  get_dyn(sm, cta, Lo.G, Ax, Bx, N - 2);
  int pairs[PAIRS];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k)
    pairs[k] = t + WARP * k < NPAIR ? tri_pair(t + WARP * k) : 0;

  // prologue: every (lane, stage)'s QA values, neighbouring threads on
  // neighbouring lanes
  {
    const int L = 1 << lanes_log2, ns = 34 + cst.nh;
    for (int task = threadIdx.x; task < L * N; task += blockDim.x) {
      const int l = task & (L - 1), i = task >> lanes_log2;
      const size_t b = cta.b0 + l;
      if (cta.b0 + l >= B) continue;
      const size_t e = size_t(i) * B + b;
      assemble_qa(a.in[5] + size_t(i) * ns * B + b,
                  a.in[6] + size_t(i) * cst.nh * 3 * B + b, a.in[0][e],
                  a.in[1][e], a.in[2][e], a.in[3][e], a.in[4][e], size_t(B),
                  cst, sm + l * stride + Lo.qa + i * QA);
    }
  }
  __syncthreads();
  K4_CLOCK(1);
  if (active) factor_terminal(m, Lo, N, m + Lo.P, t);
  copy_async_wait();
  __syncthreads();
  put_rows(sm, cta, Lo.P, a.out[0] + size_t(N - 1) * NN * B, NN);
  put_rows(sm, cta, Lo.RiS, a.out[3], NU * NXB);
  put_rows(sm, cta, Lo.cRt, a.out[4], 10);
  K4_CLOCK(2);

  for (int i = N - 2, s = 0; i >= 0; --i, s ^= 1) {
    // buffers of this stage: G[s], P_{i+1} in P[s], P_i into P[1-s], K[s]
    if (i > 0) get_dyn(sm, cta, Lo.G + (s ^ 1) * GN, Ax, Bx, i - 1);
    K4_CLOCK(9);
    if (active)
      factor_stage(m, Lo, m + Lo.qa + i * QA, m + Lo.G + s * GN,
                   m + Lo.P + s * NN, m + Lo.P + (s ^ 1) * NN,
                   m + Lo.K + s * NU * NXB, m + Lo.cR + s * 10, pairs, t);
    copy_async_wait();
    __syncthreads();
    K4_CLOCK(7);
    put_rows(sm, cta, Lo.P + (s ^ 1) * NN, a.out[0] + size_t(i) * NN * B, NN);
    put_rows(sm, cta, Lo.K + s * NU * NXB, a.out[1] + size_t(i) * NU * NXB * B,
             NU * NXB);
    put_rows(sm, cta, Lo.cR + s * 10, a.out[2] + size_t(i) * 10 * B, 10);
    K4_CLOCK(8);
  }
}

// ---- K4b: the backsolve on the lane's warp ---------------------------------
template <typename T>
struct FusedSolveArgs {
  const T* in[11];   // P, K, cRh, RiS, cRt, Ax, Bx, c, qx, qu, dx0
  T* out[4];         // dxb, du, nu, dtheta
};

// Abar = [[Ax, 0], [0, 0]] and Bbar = [[Bx], [I4]]: the entry (j, col) of
// [Abar | Bbar] (13 x 17), zeros and ones included
template <typename T>
__device__ __forceinline__ T g_of(const T* Ax, const T* Bx, int j, int col) {
  if (j < NX) {
    if (col < NX) return Ax[j * NX + col];
    return col < NXB ? T(0) : Bx[j * NU + col - NXB];
  }
  return col == NXB + j - NX ? T(1) : T(0);
}

// the solve's stage loads, in the order the stages are taken: n < N-1 the
// backward stage N-2-n (P_{i+1}, the dynamics, c, qx, qu, K, cRh of stage
// i), then the forward stage n-(N-1) (P_i and, for i < N-1, the dynamics,
// c and K of stage i)
template <typename T>
__device__ __forceinline__ void get_stage(T* sm, const Cta& c, int off,
                                          const FusedSolveArgs<T>& a, int N,
                                          int n) {
  const bool backward = n < N - 1;
  const int i = backward ? N - 2 - n : n - (N - 1);
  const size_t B = c.B;
  get_rows(sm, c, off + SB_P, a.in[0] + size_t(backward ? i + 1 : i) * NN * B,
           NN);
  if (i == N - 1) return;
  get_rows(sm, c, off + SB_AX, a.in[5] + size_t(i) * NX * NX * B, NX * NX);
  get_rows(sm, c, off + SB_BX, a.in[6] + size_t(i) * NX * NU * B, NX * NU);
  get_rows(sm, c, off + SB_C, a.in[7] + size_t(i) * NXB * B, NXB);
  get_rows(sm, c, off + SB_K, a.in[1] + size_t(i) * NU * NXB * B, NU * NXB);
  if (!backward) return;
  get_rows(sm, c, off + SB_Q, a.in[8] + size_t(i) * NXB * B, NXB);
  get_rows(sm, c, off + SB_Q + NXB, a.in[9] + size_t(i) * NU * B, NU);
  get_rows(sm, c, off + SB_CR, a.in[2] + size_t(i) * 10 * B, 10);
}

// backward stage i: Pc = p_{i+1} + P_{i+1} c, [qxh; quh] = [qx; qu] +
// [Abar^T; Bbar^T] Pc, k_i = -Rh^{-1} quh, p_i = qxh + K^T quh
template <typename T>
__device__ __forceinline__ void backward_stage(T* m, const SolveLayout& Lo,
                                               const T* blk, int i, int t) {
  T* Pc = m + Lo.Pc;
  T* qh = m + Lo.qh;
  const T* P = blk + SB_P;
  const T* c = blk + SB_C;
  if (t < NXB) {
    T acc = P[t * NXB] * c[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += P[t * NXB + j] * c[j];
    Pc[t] = m[Lo.p + (i + 1) * NXB + t] + acc;
  }
  __syncwarp();
  if (t < NXB + NU) {
    const T* Ax = blk + SB_AX;
    const T* Bx = blk + SB_BX;
    T acc = g_of(Ax, Bx, 0, t) * Pc[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += g_of(Ax, Bx, j, t) * Pc[j];
    qh[t] = blk[SB_Q + t] + acc;
  }
  __syncwarp();
  const T* quh = qh + NXB;
  if (t < NXB) {
    const T* K = blk + SB_K;
    T acc = K[t] * quh[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc += K[j * NXB + t] * quh[j];
    m[Lo.p + i * NXB + t] = qh[t] + acc;
  } else if (t == NXB) {
    T kv[NU];
    chol4_solve<1>(blk + SB_CR, quh, kv);
#pragma unroll
    for (int k = 0; k < NU; ++k) m[Lo.kk + i * NU + k] = -kv[k];
  }
}

// stage-0 free u_prev (dtheta): minimize over it with x fixed to dx0; dx
// gets dxb_0 = [dx0, dtheta]
template <typename T>
__device__ __forceinline__ void initial_step(T* m, const SolveLayout& Lo,
                                             const T* P0, const T* dx0,
                                             size_t B, T* dx, int t) {
  if (t < NX) dx[t] = dx0[t * B];
  __syncwarp();
  if (t == 0) {
    T rhs[NU], Ptt[NU * NU], fP[10], x[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      T acc = P0[NX + k] * dx[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc += P0[j * NXB + NX + k] * dx[j];
      rhs[k] = -(m[Lo.p + NX + k] + acc);
#pragma unroll
      for (int l = 0; l < NU; ++l) Ptt[k * NU + l] = P0[(NX + k) * NXB + NX + l];
    }
    chol4(Ptt, fP);
    chol4_solve<1>(fP, rhs, x);
#pragma unroll
    for (int k = 0; k < NU; ++k) dx[NX + k] = x[k];
  }
  __syncwarp();
}

// forward stage i, dxb_i in dx: du_i (threads 0-3) beside the costates
// nu_i = P_i dxb_i + p_i (threads 16-28, in place of p_i); then dxb_{i+1}
// = (Abar dxb + Bbar du) + c into dxn (threads 0-12)
template <typename T>
__device__ __forceinline__ void forward_stage(T* m, const SolveLayout& Lo,
                                              const T* blk, int N, int i,
                                              const T* dx, T* du, T* dxn,
                                              int t) {
  if (t < NU) {
    const T* Kr = i < N - 1 ? blk + SB_K + t * NXB : m + Lo.RiS + t * NXB;
    T acc = Kr[0] * dx[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += Kr[j] * dx[j];
    du[t] = i < N - 1 ? acc + m[Lo.kk + i * NU + t]
                      : -(m[Lo.Riqu + t] + acc);
  } else if (t >= 16 && t < 16 + NXB) {
    const int k = t - 16;
    const T* P = blk + SB_P + k * NXB;
    T acc = P[0] * dx[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += P[j] * dx[j];
    m[Lo.p + i * NXB + k] = acc + m[Lo.p + i * NXB + k];
  }
  __syncwarp();
  if (i < N - 1 && t < NXB) {
    const T* Ax = blk + SB_AX;
    const T* Bx = blk + SB_BX;
    T acc = g_of(Ax, Bx, t, 0) * dx[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += g_of(Ax, Bx, t, j) * dx[j];
    T bu = g_of(Ax, Bx, t, NXB) * du[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) bu += g_of(Ax, Bx, t, NXB + j) * du[j];
    dxn[t] = (acc + bu) + blk[SB_C + t];
  }
}

// K4b
template <typename T>
__global__ void __launch_bounds__(WARP * MAX_LANES, K4Ctas<T>::min)
lqr_backsolve_fused_kernel(const int N, const int B, const int lanes_log2,
                           const int stride, const FusedSolveArgs<T> a) {
  T* sm = smem_lanes<T>();
  const Cta cta{static_cast<int>(blockIdx.x) << lanes_log2, B, lanes_log2,
                stride};
  const int slot = threadIdx.x / WARP, t = threadIdx.x % WARP;
  const bool active = cta.b0 + slot < B;
  const size_t b = size_t(cta.b0) + slot;
  const SolveLayout Lo = solve_layout(N);
  T* m = sm + slot * stride;
  const int loads = 2 * N - 1;   // N-1 backward stages, N forward
  K4_CLOCK(0);

  get_stage(sm, cta, Lo.blk, a, N, 0);
  // terminal stage: p_{N-1} = qx - RiS^T qu, Riqu = R^{-1} qu; RiS kept
  if (active) {
    const T* qu = a.in[9] + size_t(N - 1) * NU * B + b;
    T quN[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) quN[k] = qu[size_t(k) * B];
    for (int e = t; e < NU * NXB; e += WARP)
      m[Lo.RiS + e] = a.in[3][size_t(e) * B + b];
    __syncwarp();
    if (t < NXB) {
      const T* RiS = m + Lo.RiS;
      T acc = RiS[t] * quN[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) acc += RiS[j * NXB + t] * quN[j];
      m[Lo.p + (N - 1) * NXB + t] =
          a.in[8][(size_t(N - 1) * NXB + t) * B + b] - acc;
    } else if (t == NXB) {
      T cRt[10], x[NU];
#pragma unroll
      for (int k = 0; k < 10; ++k) cRt[k] = a.in[4][size_t(k) * B + b];
      chol4_solve<1>(cRt, quN, x);
#pragma unroll
      for (int k = 0; k < NU; ++k) m[Lo.Riqu + k] = x[k];
    }
  }
  copy_async_wait();
  __syncthreads();
  K4_CLOCK(10);

  for (int n = 0; n < loads; ++n) {
    if (n + 1 < loads)
      get_stage(sm, cta, Lo.blk + ((n + 1) % 2) * SB, a, N, n + 1);
    const T* blk = m + Lo.blk + (n % 2) * SB;
    const int i = n - (N - 1);   // the forward stage, from n = N-1 on
    K4_CLOCK(14);
    if (active) {
      if (i < 0) {
        backward_stage(m, Lo, blk, N - 2 - n, t);
        K4_CLOCK(11);
      } else {
        T* dx = m + Lo.dx + (i % 3) * NXB;
        if (i == 0) initial_step(m, Lo, blk + SB_P, a.in[10] + b, size_t(B), dx, t);
        forward_stage(m, Lo, blk, N, i, dx, m + Lo.du + (i % 2) * NU,
                      m + Lo.dx + ((i + 1) % 3) * NXB, t);
        K4_CLOCK(12);
      }
    }
    copy_async_wait();
    __syncthreads();
    K4_CLOCK(13);
    if (i >= 0) {   // dxb_i, du_i (and dtheta) are final: out
      put_rows(sm, cta, Lo.dx + (i % 3) * NXB,
               a.out[0] + size_t(i) * NXB * B, NXB);
      put_rows(sm, cta, Lo.du + (i % 2) * NU, a.out[1] + size_t(i) * NU * B,
               NU);
      if (i == 0) put_rows(sm, cta, Lo.dx + NX, a.out[3], NU);
    }
  }
  put_rows(sm, cta, Lo.p, a.out[2], N * NXB);
  K4_CLOCK(15);
}

// the shared-memory opt-in of a kernel above 48 KB: the largest size asked
// for so far on each device (set[dev] bytes)
template <typename F>
int opt_in(F kernel, size_t smem, int* set) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int>(smem) > set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    set[dev] = static_cast<int>(smem);
  }
  return 0;
}

// K4a and K4b launch `lanes` lanes a CTA, `stride` values of T apart
template <typename T>
int launch_factor_fused(const FusedConsts<T>& c, int N, int B, int lanes_log2,
                        int stride, const T* const* ins, T* const* outs,
                        cudaStream_t stream) {
  static int set[64] = {};
  const int lanes = 1 << lanes_log2;
  if (N < 2 || B < 1 || lanes > MAX_LANES || fac_layout(N).total > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(lanes) * stride * sizeof(T);
  const int rc = opt_in(lqr_factor_fused_kernel<T>, smem, set);
  if (rc != 0) return rc;
  FusedFactorArgs<T> args;
  for (int k = 0; k < 9; ++k) args.in[k] = ins[k];
  for (int k = 0; k < 5; ++k) args.out[k] = outs[k];
  const int blocks = (B + lanes - 1) / lanes;
  lqr_factor_fused_kernel<T><<<blocks, WARP * lanes, smem, stream>>>(
      c, N, B, lanes_log2, stride, args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backsolve_fused(int N, int B, int lanes_log2, int stride,
                           const T* const* ins, T* const* outs,
                           cudaStream_t stream) {
  static int set[64] = {};
  const int lanes = 1 << lanes_log2;
  if (N < 2 || B < 1 || lanes > MAX_LANES || solve_layout(N).total > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(lanes) * stride * sizeof(T);
  const int rc = opt_in(lqr_backsolve_fused_kernel<T>, smem, set);
  if (rc != 0) return rc;
  FusedSolveArgs<T> args;
  for (int k = 0; k < 11; ++k) args.in[k] = ins[k];
  for (int k = 0; k < 4; ++k) args.out[k] = outs[k];
  const int blocks = (B + lanes - 1) / lanes;
  lqr_backsolve_fused_kernel<T><<<blocks, WARP * lanes, smem, stream>>>(
      N, B, lanes_log2, stride, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using namespace frp;

extern "C" {

// backsolve scratch values per lane for horizon N (K5b): p (N x 13), k
// ((N-1) x 4)
size_t lqr_backsolve_scratch_per_lane(int N) {
  return static_cast<size_t>(N) * NXB + static_cast<size_t>(N - 1) * NU;
}

#ifdef FRP_K4_CLOCKS
// the phase cycles of the launches since the last call (then zeroed)
int lqr_phase_cycles(long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, k4_cycles, sizeof(k4_cycles));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  static const long long zero[K4_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k4_cycles, zero, sizeof(zero)));
}
#endif

// values of T per lane of K4a's (backsolve = 0) or K4b's shared-memory
// layout (ops/lqr_kernel.py::lane_elements computes the same)
int lqr_fused_lane_elements(int N, int backsolve) {
  return backsolve ? solve_layout(N).total : fac_layout(N).total;
}

#define LQR_ENTRIES(SUF, T)                                                    \
  int lqr_factor_fused_##SUF(int N, int B, int nh, T reg, T rmax2,             \
                             int lanes_log2, int stride, const T* const* ins,  \
                             T* const* outs, cudaStream_t stream) {            \
    if (nh < 1 || nh > NH) return static_cast<int>(cudaErrorInvalidValue);     \
    return launch_factor_fused<T>(FusedConsts<T>{reg, rmax2, nh}, N, B,        \
                                  lanes_log2, stride, ins, outs, stream);      \
  }                                                                            \
  int lqr_backsolve_fused_##SUF(int N, int B, int lanes_log2, int stride,      \
                                const T* const* ins, T* const* outs,           \
                                cudaStream_t stream) {                         \
    return launch_backsolve_fused<T>(N, B, lanes_log2, stride, ins, outs,      \
                                     stream);                                  \
  }                                                                            \
  int lqr_factor_##SUF(int N, int B, const T* Q, const T* R, const T* S,       \
                       const T* A, const T* Bm, T* P, T* K, T* cRh, T* RiS,    \
                       T* cRt, cudaStream_t stream) {                          \
    lqr_factor_kernel<T><<<blocks_for(B), THREADS, 0, stream>>>(               \
        N, B, Q, R, S, A, Bm, P, K, cRh, RiS, cRt);                            \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int lqr_backsolve_##SUF(int N, int B, const T* P, const T* K,                \
                          const T* cRh, const T* RiS, const T* cRt,            \
                          const T* A, const T* Bm, const T* c, const T* qx,    \
                          const T* qu, const T* dx0, T* dxb, T* du, T* nu,     \
                          T* dth, T* scratch, cudaStream_t stream) {           \
    lqr_backsolve_kernel<T><<<blocks_for(B), THREADS, 0, stream>>>(            \
        N, B, P, K, cRh, RiS, cRt, A, Bm, c, qx, qu, dx0, dxb, du, nu, dth,    \
        scratch);                                                              \
    return static_cast<int>(cudaGetLastError());                               \
  }

LQR_ENTRIES(f32, float)
LQR_ENTRIES(f64, double)

}  // extern "C"
