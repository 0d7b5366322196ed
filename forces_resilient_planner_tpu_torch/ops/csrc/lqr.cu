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
// K4 (the predictor-corrector's factor and backsolve) and K5 (the batched
// LQR of solve_lqr_batched) share one design and run one recursion each,
// on two stage sources: K4 assembles the stage QP blocks and the augmented
// dynamics Abar = [[Ax, 0], [0, 0]], Bbar = [[Bx], [I4]] on chip, K5 reads
// full Q (13x13), R (4x4), S (4x13), A (13x13) and B (13x4) blocks.
//  * a team of one warp per lane, MAX_LANES = 8 lanes per CTA at
//    consecutive b (ops/lqr_kernel.py::launch_geometry).  Each lane's
//    working set lives in dynamic shared memory (fac_layout / solve_layout
//    below, mirrored by lqr_kernel.lane_elements); no global scratch;
//  * the CTA moves data lane-minor, neighbouring threads on neighbouring b
//    (get_rows / put_rows): each stage's inputs are copied in with cp.async
//    one stage ahead, and each stage's outputs are written out from shared
//    memory after one CTA barrier a stage.  K4a's prologue assembles every
//    stage's QP blocks at once, one thread a (lane, stage), as their QA =
//    24 distinct values (Q's diagonal, the corridor block's 6 sums over the
//    nh rows in the plain version's order, R's diagonal, S's -2 w_rate), so
//    the corridor sums leave the serial path; K5a streams two stages' [Q;
//    R; S] (237 values) in turns;
//  * the factor keeps the dynamics in shared memory as G = [A | B] (13 x
//    17), copied in each stage (K4a: Ax and Bx, Abar's zero and Bbar's
//    identity blocks written once); the backsolve reads them through its
//    stage block's g(), which for K4b gives Abar's and Bbar's constant
//    entries.  Every product multiplies through every entry, zeros
//    included, as the plain version does (0 * inf = NaN on the same lanes,
//    which trips lane_step's NaN guard) and every thread runs one
//    instruction stream;
//  * the factor's recursion (factor_stage, one body for K4a and K5a) gives
//    each thread one output column of 9 rows: AtP / BtP (= G^T P), then Qh
//    / Sh / Rh (= [Q;S;R] + [AtP;BtP] G), their sums advancing together (9
//    independent chains), each in the plain version's order; K = -Rh^{-1}
//    Sh one column a thread; P = sym(Qh + Sh^T K) as 91 (r <= c) pairs over
//    the warp, in place of Qh; __syncwarp between dependent products.
//    P_{i+1} and Qh / P_i take turns in two buffers;
//  * the backsolve (one kernel template for K4b and K5b) keeps the lane's
//    p and k stacks in shared memory and reads P, K and the dynamics again
//    in the forward pass (the same bytes as the backward pass, partly from
//    L2): the backward pass gives P_{i+1} c, [A^T; B^T] Pc and K^T quh one
//    row a thread, the forward pass du beside the costates P_i dxb_i + p_i,
//    then A dxb + B du; dxb_i and du_i leave the lane after their stage;
//  * the packed 4x4 Cholesky factors keep their divisions (no reciprocal
//    diagonal as in ipm_iteration.cu): bit-equality with the plain version
//    is worth more here, where P is ill-conditioned late in a solve;
//  * a lane's result depends neither on its slot in the CTA nor on B.
//
// What bounds them: bytes.  At N = 20, B = 4096, f32, K4a reads 5,403
// values a lane and writes 4,620 (0.049 ms of the card's 3.35 TB/s), K4b
// reads 7,439 and writes 604 (0.039 ms); K5a reads 8,939 and writes 4,620
// (0.066 ms), K5b 9,415 and 604 (0.049 ms); their arithmetic (0.1-0.4
// GFLOP) is an order below.  In practice each lane's serial recursion over
// the stages sets the time: K4a takes 0.11 ms for one lane alone and 0.28-
// 0.29 ms for 4096 (32 lanes an SM in one wave), K5a 0.08 and 0.25 ms, K4b
// and K5b 0.17-0.18 ms at 4096 (tools/k4_phase_probe.py splits the cycles
// by phase).  The stage blocks are copied 4 bytes a thread: 16 bytes a
// thread through a staging tile (one more CTA barrier a stage) made K5b 4%
// faster at B = 4096 but up to 50% slower at B = 1 and 256, and K4b slower
// (PERF.md).
//
// ptxas (sm_90a, CUDA 12.8), registers, with 0 bytes of stack and spills:
//   f32: K4a 64, K4b 64, K5a 64, K5b 64 (4 CTAs an SM);
//   f64: K4a 126, K4b 102, K5a 122, K5b 112
// At B = 4096, N = 20, f32, on an NVIDIA H100 80GB HBM3 at 700 W: K4a
// 0.28-0.29 ms, K4b 0.17 ms, K5a 0.25 ms, K5b 0.18 ms per call (a thread
// per lane took 0.90, 0.22, 1.23 and 0.27 ms; PERF.md).
#include "riccati.cuh"

namespace frp {

constexpr int WARP = 32;           // threads per lane
constexpr int MAX_LANES_LOG2 = 3;  // 8 lanes per CTA (ops/lqr_kernel.py)
constexpr int MAX_LANES = 1 << MAX_LANES_LOG2;
// the CTAs an SM is built to hold: 4 at f32 (32 lanes an SM, so 4096
// lanes in one wave, at 64 registers), 2 at f64
template <typename T>
struct CtasPerSm {
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

constexpr int NN = NXB * NXB;
constexpr int QA = NXB + 6 + NU + 1;          // K4: a stage's distinct QP values
constexpr int QRS = NN + NU * NU + NU * NXB;  // K5: a stage's [Q; R; S]
constexpr int GC = NXB + NU;           // G = [A | B]: 17 columns
constexpr int GN = NXB * GC;
constexpr int ABR = NXB + NU + 1;      // rows of [AtP; BtP] and a zero row
constexpr int NPAIR = NXB * (NXB + 1) / 2;
constexpr int PAIRS = (NPAIR + WARP - 1) / WARP;   // (r <= c) pairs a thread

// a launch's inputs and outputs, in the order of the C entry points
template <typename T, int NI, int NO>
struct Args {
  const T* in[NI];
  T* out[NO];
};

// ---- one lane's shared-memory layouts (elements of T) ----------------------
// ops/lqr_kernel.py::lane_elements mirrors the totals.
struct FacLayout {
  int qp, G, P, AB, Sh, Rh, K, cR, RiS, cRt, total;
};

// K4a (blocks = false) or K5a (blocks = true); the region whose size
// depends on N comes last, so that the others sit at constant offsets
__host__ __device__ inline FacLayout fac_layout(int N, bool blocks) {
  FacLayout L;
  int off = 0;
  auto take = [&](int count) { const int o = off; off += count; return o; };
  L.G = take(2 * GN);        // the dynamics of two stages, in turns
  L.P = take(2 * NN);        // P_{i+1} and Qh, then P_i, in turns
  L.AB = take(ABR * NXB);    // [A^T P; B^T P]
  L.Sh = take(NU * NXB);
  L.Rh = take(NU * NU);
  L.K = take(2 * NU * NXB);  // K_i, in turns
  L.cR = take(2 * 10);       // the packed Cholesky factor of Rh_i, in turns
  L.RiS = take(NU * NXB);
  L.cRt = take(10);
  // K4a: every stage's QP values; K5a: two stages' [Q; R; S], in turns
  L.qp = take(blocks ? 2 * QRS : N * QA);
  L.total = off;
  return L;
}

// A backsolve's stage block: P, the dynamics, c, [qx; qu], K, cRh of one
// stage.  K4b (FULL = false) holds Ax (9x9) and Bx (9x4), K5b A (13x13) and
// B (13x4).
template <bool FULL>
struct Block {
  static constexpr int AN = FULL ? NN : NX * NX;
  static constexpr int BN = FULL ? NXB * NU : NX * NU;
  static constexpr int P = 0, A = NN, B = A + AN, C = B + BN, Q = C + NXB;
  static constexpr int K = Q + NXB + NU, CR = K + NU * NXB, size = CR + 10;

  // the entry (j, col) of [A | B] (13 x 17); for K4b of [Abar | Bbar],
  // zeros and ones included
  template <typename T>
  __device__ __forceinline__ static T g(const T* blk, int j, int col) {
    if constexpr (FULL) {
      return col < NXB ? blk[A + j * NXB + col] : blk[B + j * NU + col - NXB];
    } else {
      if (j < NX) {
        if (col < NX) return blk[A + j * NX + col];
        return col < NXB ? T(0) : blk[B + j * NU + col - NXB];
      }
      return col == NXB + j - NX ? T(1) : T(0);
    }
  }
};

struct SolveLayout {
  int p, kk, dx, du, blk, Pc, qh, RiS, Riqu, total;
};

// K4b (block = Block<false>::size) or K5b (Block<true>::size); the stacks,
// whose size depends on N, come last
__host__ __device__ inline SolveLayout solve_layout(int N, int block) {
  SolveLayout L;
  int off = 0;
  auto take = [&](int count) { const int o = off; off += count; return o; };
  L.dx = take(3 * NXB);      // dxb_i, in turns of three
  L.du = take(2 * NU);       // du_i, in turns
  L.blk = take(2 * block);   // two stages' inputs, in turns
  L.Pc = take(NXB);
  L.qh = take(NXB + NU);     // qxh, quh
  L.RiS = take(NU * NXB);
  L.Riqu = take(NU);
  L.p = take(N * NXB);       // p, then the costates nu
  L.kk = take((N - 1) * NU);
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

// stage i's dynamics into G = [A | B] at off: K4a's Ax (9x9) and Bx (9x4)
// (ND = NX), K5a's A (13x13) and B (13x4) (ND = NXB)
template <int ND, typename T>
__device__ __forceinline__ void get_dyn(T* sm, const Cta& c, int off,
                                        const T* __restrict__ A,
                                        const T* __restrict__ Bm, int i) {
  const int l = threadIdx.x & ((1 << c.lg) - 1);
  if (c.b0 + l >= c.B) return;
  T* d = sm + l * c.stride + off;
  const size_t b = c.b0 + l;
  for (int r = threadIdx.x >> c.lg; r < ND * ND + ND * NU; r += WARP) {
    if (r < ND * ND)
      copy_async(d + (r / ND) * GC + r % ND,
                 A + (size_t(i) * ND * ND + r) * c.B + b);
    else
      copy_async(d + ((r - ND * ND) / NU) * GC + NXB + (r - ND * ND) % NU,
                 Bm + (size_t(i) * ND * NU + r - ND * ND) * c.B + b);
  }
}

// ---- a stage's QP blocks: K4a's from its QA values, K5a's as given ---------
// qa: Q's diagonal (13), the corridor block's sums for l >= j (6), R's
// diagonal (4), S's value -2 w_rate
template <typename T>
struct QaStage {
  const T* qa;
  __device__ __forceinline__ T Q(int r, int c) const {
    T v = r == c ? qa[r] : T(0);
    if (r < 3 && c < 3) {
      const int j = r < c ? r : c, l = r < c ? c : r;
      v += qa[NXB + 3 * j - (j * (j - 1)) / 2 + (l - j)];
    }
    return v;
  }
  __device__ __forceinline__ T R(int r, int c) const {
    return r == c ? qa[NXB + 6 + r] : T(0);
  }
  __device__ __forceinline__ T S(int r, int c) const {
    return c == NX + r ? qa[QA - 1] : T(0);
  }
};

// v: the stage's [Q; R; S], row-major
template <typename T>
struct QrsStage {
  const T* v;
  __device__ __forceinline__ T Q(int r, int c) const { return v[r * NXB + c]; }
  __device__ __forceinline__ T R(int r, int c) const {
    return v[NN + r * NU + c];
  }
  __device__ __forceinline__ T S(int r, int c) const {
    return v[NN + NU * NU + r * NXB + c];
  }
};

// G's constant entries for K4a: Abar's zero blocks and Bbar's identity
template <typename T>
__device__ __forceinline__ void g_constants(T* G, int t) {
  for (int e = t; e < GN; e += WARP) {
    const int j = e / GC, col = e % GC;
    if (j >= NX || (col >= NX && col < NXB))
      G[e] = (j >= NX && col == NXB + j - NX) ? T(1) : T(0);
  }
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

// ---- the factor: one stage of the recursion, on the lane's warp ------------
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
template <typename T, typename QP>
__device__ __forceinline__ void factor_terminal(T* m, const FacLayout& Lo,
                                                const QP& qp, T* Pn, int t) {
  T R[NU * NU], fR[10];
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int c = 0; c < NU; ++c) R[r * NU + c] = qp.R(r, c);
  chol4(R, fR);
  if (t < NXB) {
    T col[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) col[k] = qp.S(k, t);
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
      const T s0 = qp.S(0, r);
#pragma unroll
      for (int col = 0; col < NXB; ++col) acc[col] = s0 * RiS[col];
    }
#pragma unroll
    for (int j = 1; j < NU; ++j) {
      const T sj = qp.S(j, r);
#pragma unroll
      for (int col = 0; col < NXB; ++col) acc[col] += sj * RiS[j * NXB + col];
    }
#pragma unroll
    for (int col = 0; col < NXB; ++col)
      Pn[r * NXB + col] = qp.Q(r, col) - acc[col];
  }
}

// stage i < N-1 with P_{i+1} in Pf and the dynamics in G; leaves Qh, then
// P_i in Pn, K_i in Kg and the packed factor of Rh_i in cR.  Qh = Q + A^T P
// A, Rh = R + B^T P B, Sh = S + B^T P A, K = -Rh^{-1} Sh, P_i = sym(Qh +
// Sh^T K), each sum in the plain version's order.
template <typename T, typename QP>
__device__ __forceinline__ void factor_stage(T* m, const FacLayout& Lo,
                                             const QP& qp, const T* G,
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
            Rh[(r - NXB) * NU + col - NXB] = qp.R(r - NXB, col - NXB) + acc[q];
        } else if (r >= NXB)
          Sh[(r - NXB) * NXB + col] = qp.S(r - NXB, col) + acc[q];
        else
          Qh[r * NXB + col] = qp.Q(r, col) + acc[q];
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

// The factor from its terminal stage down to stage 0, once the CTA has
// passed a barrier behind the terminal stage's QP blocks and stage N-2's
// (its dynamics in, or on their way to, G's first buffer).  fetch(i, b)
// issues stage i's copies into buffer b; qp(i, b) is stage i's QP blocks,
// from buffer b (b = 1 for the terminal stage).  a.out: P, K, cRh, RiS,
// cRt.
template <typename T, typename Io, typename Fetch, typename QpOf>
__device__ __forceinline__ void factor_sweep(T* sm, const Cta& cta,
                                             const FacLayout& Lo, int N,
                                             const Io& a, const Fetch& fetch,
                                             const QpOf& qp) {
  const int slot = threadIdx.x / WARP, t = threadIdx.x % WARP;
  const bool active = cta.b0 + slot < cta.B;
  T* m = sm + slot * cta.stride;
  const size_t B = cta.B;
  int pairs[PAIRS];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k)
    pairs[k] = t + WARP * k < NPAIR ? tri_pair(t + WARP * k) : 0;

  if (active) factor_terminal(m, Lo, qp(N - 1, 1), m + Lo.P, t);
  copy_async_wait();
  __syncthreads();
  put_rows(sm, cta, Lo.P, a.out[0] + size_t(N - 1) * NN * B, NN);
  put_rows(sm, cta, Lo.RiS, a.out[3], NU * NXB);
  put_rows(sm, cta, Lo.cRt, a.out[4], 10);
  K4_CLOCK(2);

  for (int i = N - 2, s = 0; i >= 0; --i, s ^= 1) {
    // buffers of this stage: G[s], P_{i+1} in P[s], P_i into P[1-s], K[s]
    if (i > 0) fetch(i - 1, s ^ 1);
    K4_CLOCK(9);
    if (active)
      factor_stage(m, Lo, qp(i, s), m + Lo.G + s * GN, m + Lo.P + s * NN,
                   m + Lo.P + (s ^ 1) * NN, m + Lo.K + s * NU * NXB,
                   m + Lo.cR + s * 10, pairs, t);
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

__device__ __forceinline__ Cta cta_of(int B, int lanes_log2, int stride) {
  return Cta{static_cast<int>(blockIdx.x) << lanes_log2, B, lanes_log2,
             stride};
}

// K4a.  a.in: w_wp, w_input, w_rate, w_vel, w_uprev0, sigma, A, Ax, Bx
template <typename T>
__global__ void __launch_bounds__(WARP * MAX_LANES, CtasPerSm<T>::min)
lqr_factor_fused_kernel(const int N, const int B, const int lanes_log2,
                        const int stride, const Args<T, 9, 5> a,
                        const FusedConsts<T> cst) {
  T* sm = smem_lanes<T>();
  const Cta cta = cta_of(B, lanes_log2, stride);
  const int t = threadIdx.x % WARP;
  const FacLayout Lo = fac_layout(N, false);
  T* m = sm + (threadIdx.x / WARP) * stride;
  const T* __restrict__ Ax = a.in[7];
  const T* __restrict__ Bx = a.in[8];
  K4_CLOCK(0);

  // G's constants in both buffers, AB's zero row, the stage-(N-2)
  // dynamics on their way
  g_constants(m + Lo.G, t);
  g_constants(m + Lo.G + GN, t);
  if (t < NXB) m[Lo.AB + (NXB + NU) * NXB + t] = T(0);
  get_dyn<NX>(sm, cta, Lo.G, Ax, Bx, N - 2);

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
                  cst, sm + l * stride + Lo.qp + i * QA);
    }
  }
  __syncthreads();
  K4_CLOCK(1);
  factor_sweep<T>(
      sm, cta, Lo, N, a,
      [&](int i, int buf) { get_dyn<NX>(sm, cta, Lo.G + buf * GN, Ax, Bx, i); },
      [&](int i, int) { return QaStage<T>{m + Lo.qp + i * QA}; });
}

// K5a.  a.in: Q, R, S, A, B
template <typename T>
__global__ void __launch_bounds__(WARP * MAX_LANES, CtasPerSm<T>::min)
lqr_factor_kernel(const int N, const int B, const int lanes_log2,
                  const int stride, const Args<T, 5, 5> a) {
  T* sm = smem_lanes<T>();
  const Cta cta = cta_of(B, lanes_log2, stride);
  const int t = threadIdx.x % WARP;
  const FacLayout Lo = fac_layout(N, true);
  T* m = sm + (threadIdx.x / WARP) * stride;
  K4_CLOCK(0);

  // stage i's [Q; R; S] into buffer buf
  const auto get_qrs = [&](int i, int buf) {
    const int off = Lo.qp + buf * QRS;
    get_rows(sm, cta, off, a.in[0] + size_t(i) * NN * B, NN);
    get_rows(sm, cta, off + NN, a.in[1] + size_t(i) * NU * NU * B, NU * NU);
    get_rows(sm, cta, off + NN + NU * NU, a.in[2] + size_t(i) * NU * NXB * B,
             NU * NXB);
  };
  const auto fetch = [&](int i, int buf) {
    get_qrs(i, buf);
    get_dyn<NXB>(sm, cta, Lo.G + buf * GN, a.in[3], a.in[4], i);
  };
  // AB's zero row; the terminal stage's blocks into buffer 1, stage N-2's
  // into buffer 0
  if (t < NXB) m[Lo.AB + (NXB + NU) * NXB + t] = T(0);
  get_qrs(N - 1, 1);
  fetch(N - 2, 0);
  copy_async_wait();
  __syncthreads();
  K4_CLOCK(1);
  factor_sweep<T>(sm, cta, Lo, N, a, fetch, [&](int, int buf) {
    return QrsStage<T>{m + Lo.qp + buf * QRS};
  });
}

// ---- the backsolve on the lane's warp (K4b and K5b) ------------------------
// the solve's stage loads, in the order the stages are taken: n < N-1 the
// backward stage N-2-n (P_{i+1}, the dynamics, c, qx, qu, K, cRh of stage
// i), then the forward stage n-(N-1) (P_i and, for i < N-1, the dynamics,
// c and K of stage i).  a.in: P, K, cRh, RiS, cRt, A, B, c, qx, qu, dx0
template <bool FULL, typename T>
__device__ __forceinline__ void get_stage(T* sm, const Cta& c, int off,
                                          const Args<T, 11, 4>& a, int N,
                                          int n) {
  using S = Block<FULL>;
  const bool backward = n < N - 1;
  const int i = backward ? N - 2 - n : n - (N - 1);
  const size_t B = c.B;
  get_rows(sm, c, off + S::P, a.in[0] + size_t(backward ? i + 1 : i) * NN * B,
           NN);
  if (i == N - 1) return;
  get_rows(sm, c, off + S::A, a.in[5] + size_t(i) * S::AN * B, S::AN);
  get_rows(sm, c, off + S::B, a.in[6] + size_t(i) * S::BN * B, S::BN);
  get_rows(sm, c, off + S::C, a.in[7] + size_t(i) * NXB * B, NXB);
  get_rows(sm, c, off + S::K, a.in[1] + size_t(i) * NU * NXB * B, NU * NXB);
  if (!backward) return;
  get_rows(sm, c, off + S::Q, a.in[8] + size_t(i) * NXB * B, NXB);
  get_rows(sm, c, off + S::Q + NXB, a.in[9] + size_t(i) * NU * B, NU);
  get_rows(sm, c, off + S::CR, a.in[2] + size_t(i) * 10 * B, 10);
}

// backward stage i: Pc = p_{i+1} + P_{i+1} c, [qxh; quh] = [qx; qu] +
// [A^T; B^T] Pc, k_i = -Rh^{-1} quh, p_i = qxh + K^T quh
template <bool FULL, typename T>
__device__ __forceinline__ void backward_stage(T* m, const SolveLayout& Lo,
                                               const T* blk, int i, int t) {
  using S = Block<FULL>;
  T* Pc = m + Lo.Pc;
  T* qh = m + Lo.qh;
  const T* P = blk + S::P;
  const T* c = blk + S::C;
  if (t < NXB) {
    T acc = P[t * NXB] * c[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += P[t * NXB + j] * c[j];
    Pc[t] = m[Lo.p + (i + 1) * NXB + t] + acc;
  }
  __syncwarp();
  if (t < NXB + NU) {
    T acc = S::g(blk, 0, t) * Pc[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += S::g(blk, j, t) * Pc[j];
    qh[t] = blk[S::Q + t] + acc;
  }
  __syncwarp();
  const T* quh = qh + NXB;
  if (t < NXB) {
    const T* K = blk + S::K;
    T acc = K[t] * quh[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc += K[j * NXB + t] * quh[j];
    m[Lo.p + i * NXB + t] = qh[t] + acc;
  } else if (t == NXB) {
    T kv[NU];
    chol4_solve<1>(blk + S::CR, quh, kv);
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
// = (A dxb + B du) + c into dxn (threads 0-12)
template <bool FULL, typename T>
__device__ __forceinline__ void forward_stage(T* m, const SolveLayout& Lo,
                                              const T* blk, int N, int i,
                                              const T* dx, T* du, T* dxn,
                                              int t) {
  using S = Block<FULL>;
  if (t < NU) {
    const T* Kr = i < N - 1 ? blk + S::K + t * NXB : m + Lo.RiS + t * NXB;
    T acc = Kr[0] * dx[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += Kr[j] * dx[j];
    du[t] = i < N - 1 ? acc + m[Lo.kk + i * NU + t]
                      : -(m[Lo.Riqu + t] + acc);
  } else if (t >= 16 && t < 16 + NXB) {
    const int k = t - 16;
    const T* P = blk + S::P + k * NXB;
    T acc = P[0] * dx[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += P[j] * dx[j];
    m[Lo.p + i * NXB + k] = acc + m[Lo.p + i * NXB + k];
  }
  __syncwarp();
  if (i < N - 1 && t < NXB) {
    T acc = S::g(blk, t, 0) * dx[0];
#pragma unroll
    for (int j = 1; j < NXB; ++j) acc += S::g(blk, t, j) * dx[j];
    T bu = S::g(blk, t, NXB) * du[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) bu += S::g(blk, t, NXB + j) * du[j];
    dxn[t] = (acc + bu) + blk[S::C + t];
  }
}

// K4b (FULL = false) and K5b (FULL = true).  a.out: dxb, du, nu, dtheta
template <typename T, bool FULL>
__global__ void __launch_bounds__(WARP * MAX_LANES, CtasPerSm<T>::min)
lqr_backsolve_kernel(const int N, const int B, const int lanes_log2,
                     const int stride, const Args<T, 11, 4> a) {
  T* sm = smem_lanes<T>();
  const Cta cta = cta_of(B, lanes_log2, stride);
  const int slot = threadIdx.x / WARP, t = threadIdx.x % WARP;
  const bool active = cta.b0 + slot < B;
  const size_t b = size_t(cta.b0) + slot;
  constexpr int SB = Block<FULL>::size;
  const SolveLayout Lo = solve_layout(N, SB);
  T* m = sm + slot * stride;
  const int loads = 2 * N - 1;   // N-1 backward stages, N forward
  K4_CLOCK(0);

  get_stage<FULL>(sm, cta, Lo.blk, a, N, 0);
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
      get_stage<FULL>(sm, cta, Lo.blk + ((n + 1) % 2) * SB, a, N, n + 1);
    const T* blk = m + Lo.blk + (n % 2) * SB;
    const int i = n - (N - 1);   // the forward stage, from n = N-1 on
    K4_CLOCK(14);
    if (active) {
      if (i < 0) {
        backward_stage<FULL>(m, Lo, blk, N - 2 - n, t);
        K4_CLOCK(11);
      } else {
        T* dx = m + Lo.dx + (i % 3) * NXB;
        if (i == 0)
          initial_step(m, Lo, blk + Block<FULL>::P, a.in[10] + b, size_t(B),
                       dx, t);
        forward_stage<FULL>(m, Lo, blk, N, i, dx, m + Lo.du + (i % 2) * NU,
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

// a launch of 2^lanes_log2 lanes a CTA, `stride` values of T apart, each
// lane `elements` values of its layout; `set` is the kernel's own opt-in
// record
template <typename T, typename Kernel, typename... Rest>
int launch_lanes(Kernel kernel, int* set, int elements, int N, int B,
                 int lanes_log2, int stride, cudaStream_t stream,
                 Rest... rest) {
  if (N < 2 || B < 1 || lanes_log2 < 0 || lanes_log2 > MAX_LANES_LOG2 ||
      elements > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = 1 << lanes_log2;
  const size_t smem = size_t(lanes) * stride * sizeof(T);
  const int rc = opt_in(kernel, smem, set);
  if (rc != 0) return rc;
  const int blocks = (B + lanes - 1) / lanes;
  kernel<<<blocks, WARP * lanes, smem, stream>>>(N, B, lanes_log2, stride,
                                                 rest...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NI, int NO>
Args<T, NI, NO> args_of(const T* const* ins, T* const* outs) {
  Args<T, NI, NO> a;
  for (int k = 0; k < NI; ++k) a.in[k] = ins[k];
  for (int k = 0; k < NO; ++k) a.out[k] = outs[k];
  return a;
}

}  // namespace frp

using namespace frp;

extern "C" {

#ifdef FRP_K4_CLOCKS
// the phase cycles of the launches since the last call (then zeroed)
int lqr_phase_cycles(long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, k4_cycles, sizeof(k4_cycles));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  static const long long zero[K4_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k4_cycles, zero, sizeof(zero)));
}
#endif

// values of T per lane of a kernel's shared-memory layout: the factor
// (backsolve = 0) or the backsolve, of K4 (blocks = 0) or K5
// (ops/lqr_kernel.py::lane_elements computes the same)
int lqr_lane_elements(int N, int backsolve, int blocks) {
  if (!backsolve) return fac_layout(N, blocks != 0).total;
  return solve_layout(N, blocks ? Block<true>::size : Block<false>::size)
      .total;
}

// every entry: N, B[, nh, reg, rmax2], lanes_log2, stride, the inputs and
// the outputs (device pointers, in the order of the Args comments above),
// the stream
#define LQR_ENTRIES(SUF, T)                                                    \
  int lqr_factor_fused_##SUF(int N, int B, int nh, T reg, T rmax2,             \
                             int lanes_log2, int stride, const T* const* ins,  \
                             T* const* outs, cudaStream_t stream) {            \
    static int set[64] = {};                                                   \
    if (nh < 1 || nh > NH) return static_cast<int>(cudaErrorInvalidValue);     \
    return launch_lanes<T>(lqr_factor_fused_kernel<T>, set,                    \
                           fac_layout(N, false).total, N, B, lanes_log2,       \
                           stride, stream, args_of<T, 9, 5>(ins, outs),        \
                           FusedConsts<T>{reg, rmax2, nh});                    \
  }                                                                            \
  int lqr_backsolve_fused_##SUF(int N, int B, int lanes_log2, int stride,      \
                                const T* const* ins, T* const* outs,           \
                                cudaStream_t stream) {                         \
    static int set[64] = {};                                                   \
    return launch_lanes<T>(lqr_backsolve_kernel<T, false>, set,                \
                           solve_layout(N, Block<false>::size).total, N, B,    \
                           lanes_log2, stride, stream,                         \
                           args_of<T, 11, 4>(ins, outs));                      \
  }                                                                            \
  int lqr_factor_##SUF(int N, int B, int lanes_log2, int stride,               \
                       const T* const* ins, T* const* outs,                    \
                       cudaStream_t stream) {                                  \
    static int set[64] = {};                                                   \
    return launch_lanes<T>(lqr_factor_kernel<T>, set,                          \
                           fac_layout(N, true).total, N, B, lanes_log2,        \
                           stride, stream, args_of<T, 5, 5>(ins, outs));       \
  }                                                                            \
  int lqr_backsolve_##SUF(int N, int B, int lanes_log2, int stride,            \
                          const T* const* ins, T* const* outs,                 \
                          cudaStream_t stream) {                               \
    static int set[64] = {};                                                   \
    return launch_lanes<T>(lqr_backsolve_kernel<T, true>, set,                 \
                           solve_layout(N, Block<true>::size).total, N, B,     \
                           lanes_log2, stride, stream,                         \
                           args_of<T, 11, 4>(ins, outs));                      \
  }

LQR_ENTRIES(f32, float)
LQR_ENTRIES(f64, double)

}  // extern "C"
