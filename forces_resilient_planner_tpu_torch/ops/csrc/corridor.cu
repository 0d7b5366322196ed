// Safe-flight-corridor decomposition of every (scenario, stage) (Hopper).
//
// Replaces forces_resilient_planner_tpu/ops/corridor_pallas.py::
// _corridor_kernel (the Pallas TPU kernel behind decompose_stages_lanes).
// Per stage segment (p1, p2) against its scenario's obstacle cloud it runs
// corridor/decomp.py::decompose_segment: the bbox filter of the cloud (or,
// with CorridorConfig.max_active_obstacles = K below the cloud size, the K
// in-bbox obstacles nearest the segment's midpoint), the sphere-seeded
// ellipsoid shrink (shrink_iters rounds re-rolling the frame about the
// segment, then shrink_iters rounds on the vertical axis), the
// supporting-hyperplane peel (max_planes rounds), the 6 bbox walls and the
// outward-oriented rows A x <= b.  Row layout: max_planes peel rows (zero
// when the peel ran out), the 6 walls, zeros up to nh.  The plain PyTorch
// version is ops/corridor_kernel.py::decompose_stages_reference (the
// batched corridor/decomp.py).
//
// Arithmetic: the plain version's, operation for operation and in its
// order.  The file is built with -fmad=false (ops/_build.py), so every
// product and sum rounds on its own, except where the plain version
// emulates a fused multiply-add (utils/rounding.py::fma, which rounds as
// the jitted JAX function does on XLA:CPU): there __fma_rn.  Those sites
// are the dot3 chains fma(a2, b2, fma(a1, b1, a0 b0)) (matrix products,
// norms, the bbox tests, the peel's normal and signed distances, the rows'
// interior test, the compaction's squared distance), the contracted
// adjugate and the ellipsoid distance, and the shrink rounds' 1 - q^2.
// On a voxel grid many obstacles tie in exact arithmetic and the last bit
// decides an argmin or a sign; with the same operations the kernel
// decides each as the plain version does.  Argmin ties go to the lowest key (obstacle
// index, or list position after the compaction), as there.
//
// What bounds it: per stage the bbox filter of the cloud, then up to
// 1 + 16 + 1 + 16 + 1 + 24 rounds, each a serial scalar chain (frame,
// C^{-1}, plane, argmin) and a pass over the round's set; on the main
// path's data the sets are a few dozen obstacles, so the instructions of
// the chains and of the loops' bookkeeping, not the obstacle arithmetic,
// set the time (PERF.md).
//
// Two routes, chosen per call from (M, dtype, K) by corridor_route:
//
// The shared route (clouds that fit, no compaction), one CTA per scenario:
//  * its cloud is staged once into shared memory as (x, y, z, mask)
//    records (one 16-byte load per obstacle at f32) and serves all its
//    stages, as the TPU kernel keeps it VMEM-resident across the stage
//    loop;
//  * a group of G lanes per stage (G = 8: 4 stages per warp; wider at a
//    large M, below); every loop of a warp runs the largest trip count of
//    its groups, with each group's own lanes predicated, so the warp stays
//    converged and one instruction serves its 32 / G stages: the rounds
//    run while any group of the warp has a non-empty set, the passes to the
//    warp's longest list; ballots, shuffles and barriers are warp-wide, a
//    group reads its own bits, and the argmin is a segmented shuffle of
//    width G on (distance, key) that breaks ties to the lower key;
//  * compacted candidate lists: pass 0 writes the stage's bbox list as
//    indices in shared memory (ballot and popc prefix: ascending, so the
//    lowest-index tie rule holds lane by lane); the sphere test, phase 1,
//    phase 2's restart and the peel loop over that list or over a working
//    list that each round compacts in place to the obstacles that stay;
//  * the wall tests use the sign symmetry of the 6 walls: 3 dot products
//    per obstacle, the negated wall's value is the negation, bit for bit;
//  * shared memory: the cloud (4 M values) and per group two lists of M
//    16-bit indices (so M <= 65,535); a CTA gives every stage its own
//    group where that fits a Hopper CTA's 227 KB (else it runs its stages
//    in turns), so a CTA takes 4 M values and 4 M bytes per stage (96 M
//    bytes at N = 20, f32); at one warp of one group a CTA needs 4 M
//    values + 4 M bytes, so the route holds M <= 11,622 at f32 and
//    M <= 6,456 at f64.  The lanes per stage adapt: the narrowest group of
//    8, 16 or 32 lanes at which an SM still holds MIN_RESIDENT_WARPS warps
//    of such CTAs, else 32 (N = 20 f32: 8 lanes up to M = 512, 16 at 1024,
//    32 at 2048; at M = 256, 20 groups in 5 warps, 24.6 KB a CTA).  Wider
//    groups share the chains among fewer stages but bring more warps to
//    hide the loops' latency, which is what a large cloud needs
//    (PERF.md); the opt-in to more than 48 KB is set once per device.
//
// The gathered route (every other cloud, and every compaction), in chunks
// of scenarios whose scratch fits SCRATCH_BUDGET bytes:
//  * a gather pass, a warp per stage over the cloud in global memory,
//    writes the stage's list of obstacle indices (32-bit) into the scratch:
//    its bbox set in index order (a pure reindexing, so the lowest-index
//    tie rule is unchanged), or with the compaction the K lowest
//    (squared distance to the midpoint, index) in jax.lax.top_k's order,
//    kept sorted by a warp-wide insertion;
//  * the decomposition kernel above then runs with keys that are
//    positions in that list: obstacles are read from global memory through
//    the list, the working lists live in the scratch, and no shared memory
//    is staged; its lanes per stage come from the list's capacity.
#include "common.cuh"

namespace frp {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 24;                  // per CTA
// CTAs of at most SMALL_WARPS warps run a build capped at 64 registers a
// thread (4 such CTAs an SM), wider ones a build of MAX_WARPS at 80
constexpr int SMALL_WARPS = 8;
constexpr int MIN_RESIDENT_WARPS = 16;         // per SM, for the group width
constexpr size_t SMEM_MAX = 232448;            // a CTA's most on Hopper
constexpr size_t SMEM_SM = 233472;             // an SM's
constexpr size_t SMEM_RESERVED = 1024;         // per CTA, by the system
constexpr int SM_WARPS = 64;                   // an SM's most
constexpr int SHARED_MAX_M = 65535;            // the shared route's 16-bit lists
constexpr int GATHER_WARPS = 4;                // stages per CTA of the gather pass
// the gathered route's scratch per chunk of scenarios (at least one)
constexpr size_t SCRATCH_BUDGET = size_t(256) << 20;

// the routes by number (0 in a launch: the kernel chooses)
enum Route : int { ROUTE_SHARED = 1, ROUTE_GATHERED = 2 };

template <typename T>
struct CorrConsts {
  T bbox[3];
  T eps;
  int shrink_iters, max_planes, nh;
};

// ---- the plain version's arithmetic ------------------------------------
__device__ __forceinline__ float t_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double t_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// a . b as the plain version's dot3: fma(a2, b2, fma(a1, b1, a0 b0))
template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return t_fma(a2, b2, t_fma(a1, b1, a0 * b0));
}

// x y - z w with the first product contracted
template <typename T>
__device__ __forceinline__ T xy_zw(T x, T y, T z, T w) {
  return t_fma(x, y, -(z * w));
}

// the contracted adjugate inverse (decomp.py::inv3(..., contract=True))
template <typename T>
__device__ __forceinline__ void inv3(const T* A, T* out) {
  const T a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5],
          g = A[6], h = A[7], i = A[8];
  const T co00 = xy_zw(e, i, f, h);
  const T co01 = -xy_zw(d, i, f, g);
  const T co02 = xy_zw(d, h, e, g);
  T det = t_fma(c, co02, t_fma(a, co00, b * co01));
  if (t_abs(det) < T(1e-30)) det = T(1e-30);
  const T adj[9] = {co00, -xy_zw(b, i, c, h), xy_zw(b, f, c, e),
                    co01, xy_zw(a, i, c, g),  -xy_zw(a, f, c, d),
                    co02, -xy_zw(a, h, b, g), xy_zw(a, e, b, d)};
  for (int k = 0; k < 9; ++k) out[k] = adj[k] / det;
}

// out = A B, out = A^T v, out = A v: each entry a dot3 chain
template <typename T>
__device__ __forceinline__ void mm3(const T* A, const T* B, T* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = dot3(A[3 * i], A[3 * i + 1], A[3 * i + 2], B[j],
                            B[3 + j], B[6 + j]);
}
template <typename T>
__device__ __forceinline__ void mtv3(const T* A, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = dot3(A[i], A[3 + i], A[6 + i], v[0], v[1], v[2]);
}
template <typename T>
__device__ __forceinline__ void mv3(const T* A, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = dot3(A[3 * i], A[3 * i + 1], A[3 * i + 2], v[0], v[1], v[2]);
}

// C^{-1} for C = (Rf diag(a)) Rf^T
template <typename T>
__device__ __forceinline__ void frame_Cinv(const T* Rf, T a0, T a1, T a2, T* Ci) {
  const T ax[3] = {a0, a1, a2};
  T RD[9], C[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) RD[3 * i + j] = Rf[3 * i + j] * ax[j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = dot3(RD[3 * i], RD[3 * i + 1], RD[3 * i + 2],
                          Rf[3 * j], Rf[3 * j + 1], Rf[3 * j + 2]);
  inv3(C, Ci);
}

// ||C^{-1}(o - d)|| (decomp.py::ellipsoid_dist)
template <typename T>
__device__ __forceinline__ T ell_dist(const T* Ci, const T* d, T ox, T oy,
                                      T oz) {
  const T r0 = ox - d[0], r1 = oy - d[1], r2 = oz - d[2];
  const T q0 = t_fma(Ci[2], r2, t_fma(Ci[0], r0, Ci[1] * r1));
  const T q1 = t_fma(Ci[5], r2, t_fma(Ci[3], r0, Ci[4] * r1));
  const T q2 = t_fma(Ci[8], r2, t_fma(Ci[6], r0, Ci[7] * r1));
  return t_sqrt(t_fma(q2, q2, t_fma(q0, q0, q1 * q1)));
}

// lowest-key argmin over each group of G lanes of a converged warp;
// every lane of a group returns its group's winner
template <typename T>
__device__ __forceinline__ void group_argmin(T& d, int& i, int G) {
  for (int off = G / 2; off > 0; off >>= 1) {
    const T od = __shfl_xor_sync(FULL, d, off, G);
    const int oi = __shfl_xor_sync(FULL, i, off, G);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// R = Rz(yaw) Ry(pitch) Rx(roll) (dynamics/quadrotor.py::euler_to_rot)
template <typename T>
__device__ __forceinline__ void euler_rot(T roll, T pitch, T yaw, T* R) {
  const T cr = t_cos(roll), sr = t_sin(roll);
  const T cp = t_cos(pitch), sp = t_sin(pitch);
  const T cy = t_cos(yaw), sy = t_sin(yaw);
  R[0] = cy * cp;
  R[1] = cy * sp * sr - cr * sy;
  R[2] = cy * sp * cr + sy * sr;
  R[3] = cp * sy;
  R[4] = cy * cr + sy * sp * sr;
  R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp;
  R[7] = cp * sr;
  R[8] = cp * cr;
}

// the segment's local box (line_segment.h:47-85): its axes dh (horizontal),
// dv (along the segment), dw (vertical) and the 6 walls' offsets n . pt
template <typename T>
struct Walls {
  T dh[3], dv[3], dw[3], off[6];
};

// wall w: its point and normal; walls 2q and 2q + 1 share axis q (dh, dv,
// dw), the odd one negated
template <typename T>
__device__ __forceinline__ void wall(int w, const T* p1, const T* p2,
                                     const Walls<T>& W, const T* bbox, T* pt,
                                     T* n) {
  const int ax = w >> 1;
  const bool neg = (w & 1) != 0;
  const T half = ax == 0 ? bbox[1] : (ax == 1 ? bbox[0] : bbox[2]);
  for (int k = 0; k < 3; ++k) {
    const T dir = ax == 0 ? W.dh[k] : (ax == 1 ? W.dv[k] : W.dw[k]);
    const T base = w == 2 ? p2[k] : p1[k];
    pt[k] = neg ? base - dir * half : base + dir * half;
    n[k] = neg ? -dir : dir;
  }
}

template <typename T>
__device__ __forceinline__ void make_walls(const T* p1, const T* p2,
                                           const T* bbox, Walls<T>& W) {
  const T v[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};
  const T nvc = nmax(t_sqrt(dot3(v[0], v[1], v[2], v[0], v[1], v[2])), T(1e-12));
  for (int k = 0; k < 3; ++k) W.dv[k] = v[k] / nvc;
  T hx = W.dv[1], hy = -W.dv[0];
  const T nhh = t_sqrt(dot3(hx, hy, T(0), hx, hy, T(0)));
  if (nhh < T(1e-12)) {
    hx = T(-1);
    hy = T(0);
  } else {
    const T nhc = nmax(nhh, T(1e-12));
    hx = hx / nhc;
    hy = hy / nhc;
  }
  W.dh[0] = hx;
  W.dh[1] = hy;
  W.dh[2] = T(0);
  W.dw[0] = W.dv[1] * W.dh[2] - W.dv[2] * W.dh[1];
  W.dw[1] = W.dv[2] * W.dh[0] - W.dv[0] * W.dh[2];
  W.dw[2] = W.dv[0] * W.dh[1] - W.dv[1] * W.dh[0];
  for (int w = 0; w < 6; ++w) {
    T pt[3], wn[3];
    wall(w, p1, p2, W, bbox, pt, wn);
    W.off[w] = wn[0] * pt[0] + wn[1] * pt[1] + wn[2] * pt[2];
  }
}

// obstacle (x, y, z) inside the local box (decomp.py::
// bbox_filter_obstacles): the walls in pairs, wall 2q + 1's normal is
// wall 2q's negated
template <typename T>
__device__ __forceinline__ bool in_box(const Walls<T>& W, T eps, T x, T y,
                                       T z) {
  const T sh = dot3(W.dh[0], W.dh[1], W.dh[2], x, y, z);
  const T sv = dot3(W.dv[0], W.dv[1], W.dv[2], x, y, z);
  const T sw = dot3(W.dw[0], W.dw[1], W.dw[2], x, y, z);
  return sh - W.off[0] <= eps && -sh - W.off[1] <= eps &&
         sv - W.off[2] <= eps && -sv - W.off[3] <= eps &&
         sw - W.off[4] <= eps && -sw - W.off[5] <= eps;
}

// one outward-oriented row: c = pt . n, flip when n . interior - c > 0
template <typename T>
__device__ __forceinline__ void put_row(T* A, T* b, const T* pt, const T* n, const T* d) {
  const T c = pt[0] * n[0] + pt[1] * n[1] + pt[2] * n[2];
  const bool flip = dot3(n[0], n[1], n[2], d[0], d[1], d[2]) - c > T(0);
  const T sgn = flip ? T(-1) : T(1);
  A[0] = n[0] * sgn;
  A[1] = n[1] * sgn;
  A[2] = n[2] * sgn;
  *b = c * sgn;
}

// shared memory of one CTA of the shared route with NG groups: cloud and
// lists
template <typename T>
__host__ __device__ size_t corridor_smem_groups(int NG, int M) {
  return 4 * static_cast<size_t>(M) * sizeof(T) +
         4 * static_cast<size_t>(NG) * M;
}

// obstacle m of the cloud's (x, y, z, mask) records: one 16-byte load at
// f32, two at f64
__device__ __forceinline__ void ld_obs(const float* cl, int m, float& x,
                                       float& y, float& z, float& w) {
  const float4 v = reinterpret_cast<const float4*>(cl)[m];
  x = v.x;
  y = v.y;
  z = v.z;
  w = v.w;
}
__device__ __forceinline__ void ld_obs(const double* cl, int m, double& x,
                                       double& y, double& z, double& w) {
  const double2 a = reinterpret_cast<const double2*>(cl)[2 * m];
  const double2 b = reinterpret_cast<const double2*>(cl)[2 * m + 1];
  x = a.x;
  y = a.y;
  z = b.x;
  w = b.y;
}

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// ---- the gathered route's lists ----------------------------------------
// A warp per stage (s0 + s of the B N stages): count_[s] and list_[s cap ..]
// receive the stage's bbox set in index order (K = 0), or the K lowest
// (squared distance to the midpoint, index) of it in that order, with their
// scores in score_[s cap ..]
template <typename T>
__global__ void __launch_bounds__(32 * GATHER_WARPS) corridor_gather(
    const CorrConsts<T> c, const int N, const int M, const int K,
    const int cap, const size_t s0, const int stages,
    const T* __restrict__ p1_, const T* __restrict__ p2_,
    const T* __restrict__ obs_, const unsigned char* __restrict__ mask_,
    int* __restrict__ count_, int* __restrict__ list_, T* __restrict__ score_) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
  if (s >= stages) return;                       // the whole warp
  const unsigned below = (1u << lane) - 1u;
  const size_t sn = s0 + s;
  const size_t sb = sn / N;
  const T p1[3] = {p1_[sn * 3], p1_[sn * 3 + 1], p1_[sn * 3 + 2]};
  const T p2[3] = {p2_[sn * 3], p2_[sn * 3 + 1], p2_[sn * 3 + 2]};
  Walls<T> W;
  make_walls(p1, p2, c.bbox, W);
  const T mid[3] = {T(0.5) * (p1[0] + p2[0]), T(0.5) * (p1[1] + p2[1]),
                    T(0.5) * (p1[2] + p2[2])};
  const T* cl = obs_ + sb * 3 * M;
  const unsigned char* mk = mask_ + sb * M;
  int* L = list_ + static_cast<size_t>(s) * cap;
  T* S = score_ + static_cast<size_t>(s) * cap;
  int cnt = 0;
  for (int base = 0; base < M; base += 32) {
    const int m = base + lane;
    bool in = false;
    T sc = T(0);
    if (m < M && mk[m] != 0) {
      const T x = cl[3 * static_cast<size_t>(m)];
      const T y = cl[3 * static_cast<size_t>(m) + 1];
      const T z = cl[3 * static_cast<size_t>(m) + 2];
      in = in_box(W, c.eps, x, y, z);
      const T r0 = x - mid[0], r1 = y - mid[1], r2 = z - mid[2];
      sc = dot3(r0, r1, r2, r0, r1, r2);
    }
    if (K == 0) {
      const unsigned bits = __ballot_sync(FULL, in);
      if (in) L[cnt + __popc(bits & below)] = m;
      cnt += __popc(bits);
      continue;
    }
    // the compaction: insert this chunk's candidates in index order into
    // the sorted list; a candidate no better than the list's worst now
    // cannot be better later (the worst only falls)
    unsigned bits = __ballot_sync(FULL, in && (cnt < K || sc < S[K - 1]));
    while (bits != 0) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1u;
      const T sj = __shfl_sync(FULL, sc, j);
      const int mj = __shfl_sync(FULL, m, j);
      if (cnt == K && !(sj < S[K - 1])) continue;  // uniform over the warp
      // first entry above sj: equal scores stay before (lower index)
      int pos = 0;
      if (lane == 0) {
        int lo = 0, hi = cnt;
        while (lo < hi) {
          const int md = (lo + hi) / 2;
          if (S[md] <= sj) lo = md + 1;
          else hi = md;
        }
        pos = lo;
      }
      pos = __shfl_sync(FULL, pos, 0);
      // entries pos .. end - 1 move up by one, the top chunk first
      const int end = cnt < K ? cnt : K - 1;
      for (int top = end; top > pos; top -= 32) {
        const int e = top - 1 - lane;
        T sv = T(0);
        int lv = 0;
        if (e >= pos) {
          sv = S[e];
          lv = L[e];
        }
        __syncwarp();
        if (e >= pos) {
          S[e + 1] = sv;
          L[e + 1] = lv;
        }
        __syncwarp();
      }
      if (lane == 0) {
        S[pos] = sj;
        L[pos] = mj;
      }
      __syncwarp();
      if (cnt < K) ++cnt;
    }
  }
  if (lane == 0) count_[s] = cnt;
}

// ---- the decomposition -------------------------------------------------
// One CTA per scenario b0 + blockIdx.x.  GATHERED: keys are positions in
// the stage's list (count_, list_ of the gather pass; working lists in
// work_), obstacles read from global memory; else keys are obstacle
// indices into the cloud staged in shared memory.
template <typename T, int WARPS, bool GATHERED>
__global__ void __launch_bounds__(32 * WARPS, WARPS == SMALL_WARPS ? 4 : 1) corridor_kernel(
    const CorrConsts<T> c, const int N, const int M, const int G,
    const int b0, const int cap,
    const T* __restrict__ p1_, const T* __restrict__ p2_,
    const T* __restrict__ obs_, const unsigned char* __restrict__ mask_,
    const int* __restrict__ count_, const int* __restrict__ list_,
    int* __restrict__ work_, T* __restrict__ A_, T* __restrict__ b_) {
  unsigned char* smem = dynamic_smem();
  const int NG = blockDim.x / G;
  T* cloud = reinterpret_cast<T*>(smem);         // (x, y, z, mask) records
  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / G;                 // stage group in the CTA
  const int lig = lane % G;                      // lane in the group
  const unsigned low = G == 32 ? FULL : (1u << G) - 1u;
  const int gshift = G * (lane / G);
  const unsigned below = (1u << lig) - 1u;
  unsigned short* L0 = reinterpret_cast<unsigned short*>(cloud + 4 * M) +
                       static_cast<size_t>(2 * g) * M;  // the bbox list
  unsigned short* Wl = L0 + M;                   // the working list
  const size_t sb = static_cast<size_t>(b0) + blockIdx.x;
  const T* ob = obs_ + sb * 3 * M;
  const int none = GATHERED ? cap : M;           // no key

  if (!GATHERED) {
    for (int k = threadIdx.x; k < 4 * M; k += blockDim.x) {
      const int m = k / 4, j = k % 4;
      cloud[k] = j < 3 ? ob[3 * m + j]
                       : (mask_[sb * M + m] != 0 ? T(1) : T(0));
    }
    __syncthreads();
  }

  // the group's bits of a warp-wide ballot
  auto gbits = [&](bool pred) {
    return (__ballot_sync(FULL, pred) >> gshift) & low;
  };
  // the largest count over the warp's groups: every loop of the warp runs
  // that many trips, so its groups stay converged and each instruction
  // serves all of them
  auto wmax = [&](int v) {
    return static_cast<int>(__reduce_max_sync(FULL, static_cast<unsigned>(v)));
  };

  const T inf = std::numeric_limits<T>::infinity();
  const T eps = c.eps;
  const int iters = (N + NG - 1) / NG;           // the same for every group
  for (int it = 0; it < iters; ++it) {
    const bool live = g + it * NG < N;           // else a copy of stage N - 1
    const int n = live ? g + it * NG : N - 1;
    const size_t sn = sb * N + n;
    const size_t sl = (sb - b0) * N + n;         // the stage in the chunk
    const int* Lg = GATHERED ? list_ + sl * cap : nullptr;
    int* Wg = GATHERED ? work_ + sl * cap : nullptr;
    // obstacle of key p; the bbox list's entry p; the working list
    auto load = [&](int p, T& x, T& y, T& z) {
      if (GATHERED) {
        const size_t m = static_cast<size_t>(Lg[p]);
        x = ob[3 * m];
        y = ob[3 * m + 1];
        z = ob[3 * m + 2];
      } else {
        T w;
        ld_obs(cloud, p, x, y, z, w);
      }
    };
    auto base_key = [&](int p) { return GATHERED ? p : static_cast<int>(L0[p]); };
    auto wget = [&](int p) { return GATHERED ? Wg[p] : static_cast<int>(Wl[p]); };
    auto wset = [&](int p, int key) {
      if (GATHERED) Wg[p] = key;
      else Wl[p] = static_cast<unsigned short>(key);
    };

    const T p1[3] = {p1_[sn * 3], p1_[sn * 3 + 1], p1_[sn * 3 + 2]};
    const T p2[3] = {p2_[sn * 3], p2_[sn * 3 + 1], p2_[sn * 3 + 2]};
    T* A_out = A_ + sn * c.nh * 3;
    T* b_out = b_ + sn * c.nh;
    const T v[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};
    const T d[3] = {T(0.5) * (p1[0] + p2[0]), T(0.5) * (p1[1] + p2[1]),
                    T(0.5) * (p1[2] + p2[2])};
    Walls<T> W;
    make_walls(p1, p2, c.bbox, W);

    // ---- seed frame and initial sphere ------------------------------------
    const T nv = t_sqrt(dot3(v[0], v[1], v[2], v[0], v[1], v[2]));
    const T f = nmax(T(0.5) * nv, T(1e-6));
    T Ri[9];
    euler_rot(T(0), t_atan2(-v[2], t_sqrt(t_fma(v[1], v[1], v[0] * v[0]))),
              t_atan2(v[1], v[0]), Ri);
    T Ci0[9], Ci[9];
    {
      const T C0[9] = {f, T(0), T(0), T(0), f, T(0), T(0), T(0), f};
      inv3(C0, Ci0);
    }
    frame_Cinv(Ri, f, f, f, Ci);

    // pass 0: the bbox list, ascending (ballot and popc prefix)
    int n0 = 0;
    if (GATHERED) {
      n0 = count_[sl];
    } else {
      for (int base = 0; base < M; base += G) {
        const int m = base + lig;
        bool in = false;
        if (m < M) {
          T x, y, z, w;
          ld_obs(cloud, m, x, y, z, w);
          in = w != T(0) && in_box(W, eps, x, y, z);
        }
        const unsigned bb = gbits(in);
        if (in) L0[n0 + __popc(bb & below)] = static_cast<unsigned short>(m);
        n0 += __popc(bb);
      }
      __syncwarp();
    }
    const int n0max = wmax(n0);

    // the sphere test over the bbox list: phase 1's set and its first
    // argmin (ellipsoid Ri diag(f) Ri^T)
    T bd = inf;
    int bi = none, nw = 0;
    for (int base = 0; base < n0max; base += G) {
      const int p = base + lig;
      bool in_s = false;
      int m = 0;
      if (p < n0) {
        m = base_key(p);
        T x, y, z;
        load(m, x, y, z);
        in_s = ell_dist(Ci0, d, x, y, z) <= T(1);
        if (in_s) {
          const T dist = ell_dist(Ci, d, x, y, z);
          if (dist < bd) {
            bd = dist;
            bi = m;
          }
        }
      }
      const unsigned bs = gbits(in_s);
      if (in_s) wset(nw + __popc(bs & below), m);
      nw += __popc(bs);
    }
    __syncwarp();
    group_argmin(bd, bi, G);

    // one shrink round's pass over the working list of the groups whose
    // round runs (act): each obstacle's distance under Ci, kept while
    // 1 - dist > eps (compacted in place), the argmin over those kept
    auto shrink_pass = [&](bool act) {
      const int ne = act ? nw : 0;
      const int nmaxw = wmax(ne);
      bd = inf;
      bi = none;
      int cnt = 0;
      for (int base = 0; base < nmaxw; base += G) {
        const int p = base + lig;
        bool keep = false;
        int m = 0;
        if (p < ne) {
          m = wget(p);
          T x, y, z;
          load(m, x, y, z);
          const T dist = ell_dist(Ci, d, x, y, z);
          keep = T(1) - dist > eps;
          if (keep && dist < bd) {
            bd = dist;
            bi = m;
          }
        }
        const unsigned bk = gbits(keep);
        __syncwarp();                            // this chunk's reads done
        if (keep) wset(cnt + __popc(bk & below), m);
        cnt += __popc(bk);
      }
      if (act) nw = cnt;
      __syncwarp();
      group_argmin(bd, bi, G);
    };

    // ---- phase 1: shrink the middle axis, re-rolling the frame ------------
    T a0 = f, a1 = f, a2 = f;
    T Rf[9];
    for (int k = 0; k < 9; ++k) Rf[k] = Ri[k];
    for (int r = 0; r < c.shrink_iters; ++r) {
      const bool act = bi < none;                // this group's set not empty
      if (!__any_sync(FULL, act)) break;
      if (act) {
        T bx, by, bz;
        load(bi, bx, by, bz);
        const T pw[3] = {bx - d[0], by - d[1], bz - d[2]};
        T pl[3];
        mtv3(Ri, pw, pl);
        const T roll = t_atan2(pl[2], pl[1]);
        const T cr = t_cos(roll), sr = t_sin(roll);
        const T Rx[9] = {T(1), T(0), T(0), T(0), cr, -sr, T(0), sr, cr};
        mm3(Ri, Rx, Rf);
        T pr[3];
        mtv3(Rf, pw, pr);
        const T q = pr[0] / a0;
        const T denom = t_fma(-q, q, T(1));
        if (pr[0] < a0 && denom > T(1e-12))
          a1 = t_abs(pr[1]) / t_sqrt(nmax(denom, T(1e-12)));
        frame_Cinv(Rf, a0, a1, a1, Ci);
      }
      shrink_pass(act);
    }

    // ---- phase 2: shrink the vertical axis, frame fixed --------------------
    // restart from the sphere set (pass 0's test, again, on the bbox list),
    // filtered by the reset ellipsoid
    frame_Cinv(Rf, a0, a1, a2, Ci);
    bd = inf;
    bi = none;
    nw = 0;
    for (int base = 0; base < n0max; base += G) {
      const int p = base + lig;
      bool keep = false;
      int m = 0;
      if (p < n0) {
        m = base_key(p);
        T x, y, z;
        load(m, x, y, z);
        if (ell_dist(Ci0, d, x, y, z) <= T(1)) {
          const T dist = ell_dist(Ci, d, x, y, z);
          if (dist <= T(1)) {
            keep = true;
            if (dist < bd) {
              bd = dist;
              bi = m;
            }
          }
        }
      }
      const unsigned bk = gbits(keep);
      if (keep) wset(nw + __popc(bk & below), m);
      nw += __popc(bk);
    }
    __syncwarp();
    group_argmin(bd, bi, G);
    for (int r = 0; r < c.shrink_iters; ++r) {
      const bool act = bi < none;
      if (!__any_sync(FULL, act)) break;
      if (act) {
        T bx, by, bz;
        load(bi, bx, by, bz);
        const T pw[3] = {bx - d[0], by - d[1], bz - d[2]};
        T pr[3];
        mtv3(Rf, pw, pr);
        const T q0 = pr[0] / a0, q1 = pr[1] / a1;
        const T dd = t_fma(-q1, q1, t_fma(-q0, q0, T(1)));
        if (dd > eps) a2 = t_abs(pr[2]) / t_sqrt(nmax(dd, T(1e-12)));
        frame_Cinv(Rf, a0, a1, a2, Ci);
      }
      shrink_pass(act);
    }

    // ---- supporting-hyperplane peel (decomp_base.h:63-83) -------------------
    // the working list restarts as the bbox list; the ellipsoid is fixed
    frame_Cinv(Rf, a0, a1, a2, Ci);
    T Mq[9];                                     // C^{-1} C^{-T}
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Mq[3 * i + j] = dot3(Ci[3 * i], Ci[3 * i + 1], Ci[3 * i + 2],
                             Ci[3 * j], Ci[3 * j + 1], Ci[3 * j + 2]);
    bd = inf;
    bi = none;
    for (int base = 0; base < n0max; base += G) {
      const int p = base + lig;
      if (p < n0) {
        const int m = base_key(p);
        T x, y, z;
        load(m, x, y, z);
        const T dist = ell_dist(Ci, d, x, y, z);
        wset(p, m);
        if (dist < bd) {
          bd = dist;
          bi = m;
        }
      }
    }
    nw = n0;
    __syncwarp();
    group_argmin(bd, bi, G);
    int r = 0;                                   // this group's peel rows
    for (int k = 0; k < c.max_planes; ++k) {
      const bool act = bi < none;
      if (!__any_sync(FULL, act)) break;
      T pw[3] = {T(0), T(0), T(0)}, nrm[3] = {T(0), T(0), T(0)};
      if (act) {
        load(bi, pw[0], pw[1], pw[2]);
        const T rel[3] = {pw[0] - d[0], pw[1] - d[1], pw[2] - d[2]};
        mv3(Mq, rel, nrm);
        const T nn = nmax(
            t_sqrt(dot3(nrm[0], nrm[1], nrm[2], nrm[0], nrm[1], nrm[2])),
            T(1e-12));
        for (int q = 0; q < 3; ++q) nrm[q] = nrm[q] / nn;
        if (live && lig == 0) put_row(A_out + 3 * r, b_out + r, pw, nrm, d);
      }
      const int ne = act ? nw : 0;
      const int nmaxw = wmax(ne);
      bd = inf;
      bi = none;
      int cnt = 0;
      for (int base = 0; base < nmaxw; base += G) {
        const int p = base + lig;
        bool keep = false;
        int m = 0;
        if (p < ne) {
          m = wget(p);
          T x, y, z;
          load(m, x, y, z);
          const T sd = dot3(nrm[0], nrm[1], nrm[2], x - pw[0], y - pw[1],
                            z - pw[2]);
          keep = sd < T(0);
          if (keep) {
            const T dist = ell_dist(Ci, d, x, y, z);
            if (dist < bd) {
              bd = dist;
              bi = m;
            }
          }
        }
        const unsigned bk = gbits(keep);
        __syncwarp();                            // this chunk's reads done
        if (keep) wset(cnt + __popc(bk & below), m);
        cnt += __popc(bk);
      }
      if (act) {
        nw = cnt;
        ++r;
      }
      __syncwarp();
      group_argmin(bd, bi, G);
    }

    // ---- rows: unused peel rows zero, walls, zero padding -------------------
    if (live) {
      for (int k = r + lig; k < c.max_planes; k += G) {
        A_out[3 * k] = T(0);
        A_out[3 * k + 1] = T(0);
        A_out[3 * k + 2] = T(0);
        b_out[k] = T(0);
      }
      for (int w = lig; w < 6; w += G) {
        const int k = c.max_planes + w;
        T pt[3], wn[3];
        wall(w, p1, p2, W, c.bbox, pt, wn);
        put_row(A_out + 3 * k, b_out + k, pt, wn, d);
      }
      for (int k = c.max_planes + 6 + lig; k < c.nh; k += G) {
        A_out[3 * k] = T(0);
        A_out[3 * k + 1] = T(0);
        A_out[3 * k + 2] = T(0);
        b_out[k] = T(0);
      }
    }
    __syncwarp();                                // lists free for the next stage
  }
}

// ---- geometry -----------------------------------------------------------
// warps per CTA of the shared route: enough for every stage to have its own
// group, fewer when the CTA would not fit, at least one
template <typename T>
int corridor_warps(int N, int M, int G) {
  const int per_warp = 32 / G;
  int w = (N + per_warp - 1) / per_warp;
  if (w > MAX_WARPS) w = MAX_WARPS;
  while (w > 1 && corridor_smem_groups<T>(w * per_warp, M) > SMEM_MAX) --w;
  return w;
}

template <typename T>
size_t corridor_smem(int N, int M, int G) {
  return corridor_smem_groups<T>(corridor_warps<T>(N, M, G) * (32 / G), M);
}

// the shared route holds the cloud and one group of 32 lanes, and M fits
// its 16-bit lists
template <typename T>
bool shared_fits(int M) {
  return M <= SHARED_MAX_M && corridor_smem_groups<T>(1, M) <= SMEM_MAX;
}

// the route for M obstacles with compaction to K (0: off): the shared
// route where the cloud fits and nothing is compacted, else the gathered
// one; `route` 1 or 2 forces one (a test hook)
template <typename T>
int corridor_route(int route, int M, int K) {
  if (route == ROUTE_SHARED || route == ROUTE_GATHERED) return route;
  return (K > 0 && K < M) || !shared_fits<T>(M) ? ROUTE_GATHERED : ROUTE_SHARED;
}

// a gathered stage's list capacity: K with the compaction, else M
inline int gathered_cap(int M, int K) { return K > 0 && K < M ? K : M; }

// lanes per stage: `group` when it is 4, 8, 16 or 32 (a test hook), else
// for the shared route the narrowest of 8 and 16 at which an SM holds
// MIN_RESIDENT_WARPS warps of these CTAs, else 32; for the gathered route
// from the list's capacity, as the shared route chooses at N = 20, f32
template <typename T>
int corridor_group(int group, int route, int N, int M, int K) {
  if (group == 4 || group == 8 || group == 16 || group == 32) return group;
  if (route == ROUTE_GATHERED) {
    const int cap = gathered_cap(M, K);
    return cap <= 512 ? 8 : (cap <= 1024 ? 16 : 32);
  }
  for (int G = 8; G < 32; G *= 2) {
    const int w = corridor_warps<T>(N, M, G);
    const size_t smem = corridor_smem<T>(N, M, G);
    if (smem > SMEM_MAX) continue;
    int ctas = static_cast<int>(SMEM_SM / (smem + SMEM_RESERVED));
    if (ctas > SM_WARPS / w) ctas = SM_WARPS / w;
    if (ctas * w >= MIN_RESIDENT_WARPS) return G;
  }
  return 32;
}

// the gathered route's scratch of one stage: its count, list, working list
// and (with the compaction) scores
template <typename T>
size_t stage_scratch(int M, int K) {
  const size_t cap = static_cast<size_t>(gathered_cap(M, K));
  return sizeof(int) * (1 + 2 * cap) + (K > 0 && K < M ? sizeof(T) * cap : 0);
}

// scenarios per chunk of the gathered route: as many as SCRATCH_BUDGET
// holds, at least one, at most B
template <typename T>
int chunk_scenarios(int B, int N, int M, int K) {
  const size_t per = static_cast<size_t>(N) * stage_scratch<T>(M, K);
  size_t c = SCRATCH_BUDGET / per;
  if (c < 1) c = 1;
  return c > static_cast<size_t>(B) ? B : static_cast<int>(c);
}

struct Geometry {
  int route, lanes, threads;
  size_t smem, scratch;
};

template <typename T>
Geometry corridor_geometry_t(int B, int N, int M, int K, int group, int route) {
  Geometry g;
  g.route = corridor_route<T>(route, M, K);
  g.lanes = corridor_group<T>(group, g.route, N, M, K);
  if (g.route == ROUTE_SHARED) {
    g.threads = 32 * corridor_warps<T>(N, M, g.lanes);
    g.smem = corridor_smem<T>(N, M, g.lanes);
    g.scratch = 0;
  } else {
    const int per_warp = 32 / g.lanes;
    int w = (N + per_warp - 1) / per_warp;
    if (w > MAX_WARPS) w = MAX_WARPS;
    g.threads = 32 * w;
    g.smem = 0;
    g.scratch = static_cast<size_t>(chunk_scenarios<T>(B, N, M, K)) * N *
                    stage_scratch<T>(M, K) + 16;   // + alignment of the lists
  }
  return g;
}

// the opt-in to the card's largest shared memory, once per device, dtype
// and build (at namespace scope: one per library, even where two builds of
// this file share a process)
static bool opted[2][2][64] = {};

template <typename T, bool GATHERED>
int launch_decomposition(const CorrConsts<T>* c, const Geometry& g, int Bc,
                         int b0, int N, int M, int cap, const T* p1,
                         const T* p2, const T* obs, const unsigned char* mask,
                         const int* count, const int* list, int* work, T* A,
                         T* b, cudaStream_t stream) {
  const bool wide = g.threads > 32 * SMALL_WARPS;
  const auto kernel = wide ? corridor_kernel<T, MAX_WARPS, GATHERED>
                           : corridor_kernel<T, SMALL_WARPS, GATHERED>;
  if (!GATHERED) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
    bool& done = opted[sizeof(T) == 8][wide][dev];
    if (!done) {
      int most = 0;
      err = cudaDeviceGetAttribute(&most,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
      done = true;
    }
  }
  kernel<<<Bc, g.threads, g.smem, stream>>>(*c, N, M, g.lanes, b0, cap, p1, p2, obs, mask, count, list, work, A, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_corridor(const CorrConsts<T>* c, int B, int N, int M, int K,
                    int group, int route, const T* p1, const T* p2,
                    const T* obs, const unsigned char* mask, T* A, T* b,
                    void* scratch, size_t scratch_bytes, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || K < 0 || c->nh < c->max_planes + 6)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = corridor_geometry_t<T>(B, N, M, K, group, route);
  if (g.route == ROUTE_SHARED) {
    if (!shared_fits<T>(M) || (K > 0 && K < M))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_decomposition<T, false>(c, g, B, 0, N, M, M, p1, p2, obs,
                                          mask, nullptr, nullptr, nullptr, A,
                                          b, stream);
  }
  if (scratch == nullptr || scratch_bytes < g.scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kc = K > 0 && K < M ? K : 0;
  const int cap = gathered_cap(M, K);
  const int chunk = chunk_scenarios<T>(B, N, M, K);
  // scratch: scores (T, compaction only), then counts, lists, working lists
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const size_t stages_max = static_cast<size_t>(chunk) * N;
  T* score = reinterpret_cast<T*>(base);
  size_t off = Kc > 0 ? sizeof(T) * stages_max * cap : 0;
  off = (off + 15) / 16 * 16;
  int* count = reinterpret_cast<int*>(base + off);
  int* list = count + stages_max;
  int* work = list + stages_max * cap;
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int Bc = B - b0 < chunk ? B - b0 : chunk;
    const int stages = Bc * N;
    corridor_gather<T><<<(stages + GATHER_WARPS - 1) / GATHER_WARPS, 32 * GATHER_WARPS, 0, stream>>>(*c, N, M, Kc, cap, static_cast<size_t>(b0) * N, stages, p1, p2, obs, mask, count, list, score);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    err = launch_decomposition<T, true>(c, g, Bc, b0, N, M, cap, p1, p2, obs,
                                        mask, count, list, work, A, b, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace frp

using frp::CorrConsts;

extern "C" {

// the launch geometry for B scenarios of N stages of M obstacles compacted
// to K (0: off; elem_bytes 4 or 8; group 0 for the kernel's choice of lanes
// per stage, route 0 for its choice of route): the route (1 shared, 2
// gathered), lanes per stage, threads and bytes of shared memory per CTA
// of the decomposition, bytes of scratch the call needs
void corridor_geometry(int B, int N, int M, int K, int elem_bytes, int group,
                       int route, int* route_out, int* lanes, int* threads,
                       size_t* smem, size_t* scratch) {
  const frp::Geometry g =
      elem_bytes == 8
          ? frp::corridor_geometry_t<double>(B, N, M, K, group, route)
          : frp::corridor_geometry_t<float>(B, N, M, K, group, route);
  *route_out = g.route;
  *lanes = g.lanes;
  *threads = g.threads;
  *smem = g.smem;
  *scratch = g.scratch;
}

#define CORRIDOR_ENTRY(NAME, T)                                               \
  int NAME(const CorrConsts<T>* c, int B, int N, int M, int K, int group,     \
           int route, const T* p1, const T* p2, const T* obs,                 \
           const unsigned char* mask, T* A, T* b, void* scratch,              \
           size_t scratch_bytes, cudaStream_t stream) {                       \
    return frp::launch_corridor<T>(c, B, N, M, K, group, route, p1, p2, obs,  \
                                   mask, A, b, scratch, scratch_bytes,        \
                                   stream);                                   \
  }

CORRIDOR_ENTRY(corridor_f32, float)
CORRIDOR_ENTRY(corridor_f64, double)

}  // extern "C"
