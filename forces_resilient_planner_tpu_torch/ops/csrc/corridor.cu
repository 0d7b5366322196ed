// Safe-flight-corridor decomposition of every (scenario, stage) (Hopper).
//
// Replaces forces_resilient_planner_tpu/ops/corridor_pallas.py::
// _corridor_kernel (the Pallas TPU kernel behind decompose_stages_lanes).
// Per stage segment (p1, p2) against its scenario's obstacle cloud it runs
// corridor/decomp.py::decompose_segment: the bbox filter of the cloud, the
// sphere-seeded ellipsoid shrink (shrink_iters rounds re-rolling the frame
// about the segment, then shrink_iters rounds on the vertical axis), the
// supporting-hyperplane peel (max_planes rounds), the 6 bbox walls and the
// outward-oriented rows A x <= b.  Row layout: max_planes peel rows (zero
// when the peel ran out), the 6 walls, zeros up to nh.  The plain PyTorch
// version is ops/corridor_kernel.py::decompose_stages_reference (the
// batched corridor/decomp.py); the arithmetic follows it formula for
// formula (atan2 frames, adjugate inverses), and argmin ties go to the
// lowest obstacle index as there.
//
// What bounds it: per stage the bbox filter of the cloud, then up to
// 1 + 16 + 1 + 16 + 1 + 24 rounds, each a serial scalar chain (frame,
// C^{-1}, plane, argmin) and a pass over the round's set; on the main
// path's data the sets are a few dozen obstacles, so the instructions of
// the chains and of the loops' bookkeeping, not the obstacle arithmetic,
// set the time (PERF.md).  Design:
//  * one CTA per scenario: its cloud is staged once into shared memory as
//    (x, y, z, mask) records (one 16-byte load per obstacle at f32) and
//    serves all its stages, as the TPU kernel keeps it VMEM-resident across
//    the stage loop;
//  * a group of G lanes per stage (G = 8: 4 stages per warp; wider at a
//    large M, below); every loop of a warp runs the largest trip count of
//    its groups, with each group's own lanes predicated, so the warp stays
//    converged and one instruction serves its 32 / G stages: the rounds run while any group of the warp has
//    a non-empty set, the passes to the warp's longest list; ballots,
//    shuffles and barriers are warp-wide, a group reads its own bits, and
//    the argmin is a segmented shuffle of width G on (distance, index) that
//    breaks ties to the lower index;
//  * compacted candidate lists: pass 0 writes the stage's bbox list as
//    indices in shared memory (ballot and popc prefix: ascending, so the
//    lowest-index tie rule holds lane by lane); the sphere test, phase 1,
//    phase 2's restart and the peel loop over that list or over a working
//    list that each round compacts in place to the obstacles that stay;
//  * the wall tests use the sign symmetry of the 6 walls: 3 dot products
//    per obstacle, the negated wall's value is the negation, bit for bit;
//  * the inverses keep the plain version's adjugate with 9 divisions: the
//    f64 rows agree with the plain version only where the reset ellipsoid's
//    `dist <= 1` of the obstacle that set the axis decides alike; the
//    peel's unit normal is a product with 1 / |n|;
//  * shared memory: the cloud (4 M values) and per group two lists of M
//    16-bit indices; a CTA gives every stage its own group where that fits
//    a Hopper CTA's 227 KB (else it runs its stages in turns), so a CTA
//    takes 4 M values and 4 M bytes per stage (96 M bytes at N = 20, f32)
//    and an SM holds few CTAs at a large M.  The lanes per stage adapt: the narrowest group of 8, 16 or
//    32 lanes at which an SM still holds MIN_RESIDENT_WARPS warps of such
//    CTAs, else 32 (N = 20 f32: 8 lanes up to M = 512, 16 at 1024, 32 at
//    2048; at M = 256, 20 groups in 5 warps, 24.6 KB a CTA).  Wider groups
//    share the chains among fewer stages but bring more warps to hide the
//    loops' latency, which is what a large cloud needs (PERF.md); the
//    opt-in to more than 48 KB is set once per device.
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

template <typename T>
struct CorrConsts {
  T bbox[3];
  T eps;
  int shrink_iters, max_planes, nh;
};

template <typename T>
__device__ __forceinline__ void inv3(const T* A, T* out) {
  const T a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5],
          g = A[6], h = A[7], i = A[8];
  const T co00 = e * i - f * h;
  const T co01 = -(d * i - f * g);
  const T co02 = d * h - e * g;
  T det = a * co00 + b * co01 + c * co02;
  if (t_abs(det) < T(1e-30)) det = T(1e-30);
  const T adj[9] = {co00, -(b * i - c * h), b * f - c * e,
                    co01, a * i - c * g,    -(a * f - c * d),
                    co02, -(a * h - b * g), a * e - b * d};
  for (int k = 0; k < 9; ++k) out[k] = adj[k] / det;
}

// C^{-1} for C = Rf diag(a0, a1, a2) Rf^T
template <typename T>
__device__ __forceinline__ void frame_Cinv(const T* Rf, T a0, T a1, T a2, T* Ci) {
  const T ax[3] = {a0, a1, a2};
  T C[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T acc = (Rf[i * 3] * ax[0]) * Rf[j * 3];
      for (int k = 1; k < 3; ++k) acc += (Rf[i * 3 + k] * ax[k]) * Rf[j * 3 + k];
      C[i * 3 + j] = acc;
    }
  inv3(C, Ci);
}

// ||C^{-1}(o - d)||
template <typename T>
__device__ __forceinline__ T ell_dist(const T* Ci, const T* d, T ox, T oy,
                                      T oz) {
  const T r0 = ox - d[0], r1 = oy - d[1], r2 = oz - d[2];
  const T q0 = Ci[0] * r0 + Ci[1] * r1 + Ci[2] * r2;
  const T q1 = Ci[3] * r0 + Ci[4] * r1 + Ci[5] * r2;
  const T q2 = Ci[6] * r0 + Ci[7] * r1 + Ci[8] * r2;
  return t_sqrt(q0 * q0 + q1 * q1 + q2 * q2);
}

// lowest-index argmin over each group of G lanes of a converged warp;
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

// wall w of the segment's local box (line_segment.h:47-85): its point and
// normal; walls 2q and 2q + 1 share axis q (dh, dv, dw), the odd one negated
template <typename T>
__device__ __forceinline__ void wall(int w, const T* p1, const T* p2,
                                     const T* dh, const T* dv, const T* dw,
                                     const T* bbox, T* pt, T* n) {
  const int ax = w >> 1;
  const bool neg = (w & 1) != 0;
  const T half = ax == 0 ? bbox[1] : (ax == 1 ? bbox[0] : bbox[2]);
  for (int k = 0; k < 3; ++k) {
    const T dir = ax == 0 ? dh[k] : (ax == 1 ? dv[k] : dw[k]);
    const T base = w == 2 ? p2[k] : p1[k];
    pt[k] = neg ? base - dir * half : base + dir * half;
    n[k] = neg ? -dir : dir;
  }
}

// one outward-oriented row: c = pt . n, flip when n . interior - c > 0
template <typename T>
__device__ __forceinline__ void put_row(T* A, T* b, const T* pt, const T* n, const T* d) {
  const T c = pt[0] * n[0] + pt[1] * n[1] + pt[2] * n[2];
  const bool flip = (n[0] * d[0] + n[1] * d[1] + n[2] * d[2]) - c > T(0);
  const T sgn = flip ? T(-1) : T(1);
  A[0] = n[0] * sgn;
  A[1] = n[1] * sgn;
  A[2] = n[2] * sgn;
  *b = c * sgn;
}

// shared memory of one CTA with NG groups: cloud, distances, lists, mask,
// flags
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

template <typename T, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, WARPS == SMALL_WARPS ? 4 : 1) corridor_kernel(
    const CorrConsts<T> c, const int N, const int M, const int G,
    const T* __restrict__ p1_, const T* __restrict__ p2_,
    const T* __restrict__ obs_, const unsigned char* __restrict__ mask_,
    T* __restrict__ A_, T* __restrict__ b_) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const size_t sb = blockIdx.x;

  for (int k = threadIdx.x; k < 4 * M; k += blockDim.x) {
    const int m = k / 4, j = k % 4;
    cloud[k] = j < 3 ? obs_[sb * 3 * M + 3 * m + j]
                     : (mask_[sb * M + m] != 0 ? T(1) : T(0));
  }
  __syncthreads();

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
    const T p1[3] = {p1_[sn * 3], p1_[sn * 3 + 1], p1_[sn * 3 + 2]};
    const T p2[3] = {p2_[sn * 3], p2_[sn * 3 + 1], p2_[sn * 3 + 2]};
    T* A_out = A_ + sn * c.nh * 3;
    T* b_out = b_ + sn * c.nh;
    const T v[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};
    const T d[3] = {T(0.5) * (p1[0] + p2[0]), T(0.5) * (p1[1] + p2[1]),
                    T(0.5) * (p1[2] + p2[2])};

    // ---- local bbox walls (line_segment.h:47-85) -----------------------
    const T nv = t_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    const T nvc = nmax(nv, T(1e-12));
    const T dv[3] = {v[0] / nvc, v[1] / nvc, v[2] / nvc};
    T hx = dv[1], hy = -dv[0];
    const T nhh = t_sqrt(hx * hx + hy * hy + T(0) * T(0));
    if (nhh < T(1e-12)) {
      hx = T(-1);
      hy = T(0);
    } else {
      const T nhc = nmax(nhh, T(1e-12));
      hx = hx / nhc;
      hy = hy / nhc;
    }
    const T dh[3] = {hx, hy, T(0)};
    const T dw[3] = {dv[1] * dh[2] - dv[2] * dh[1],
                     dv[2] * dh[0] - dv[0] * dh[2],
                     dv[0] * dh[1] - dv[1] * dh[0]};
    T woff[6];
    for (int w = 0; w < 6; ++w) {
      T pt[3], wn[3];
      wall(w, p1, p2, dh, dv, dw, c.bbox, pt, wn);
      woff[w] = wn[0] * pt[0] + wn[1] * pt[1] + wn[2] * pt[2];
    }

    // ---- seed frame and initial sphere ------------------------------------
    const T f = nmax(T(0.5) * nv, T(1e-6));
    T Ri[9];
    euler_rot(T(0), t_atan2(-v[2], t_sqrt(v[0] * v[0] + v[1] * v[1])),
              t_atan2(v[1], v[0]), Ri);
    T Ci0[9], Ci[9];
    {
      const T C0[9] = {f, T(0), T(0), T(0), f, T(0), T(0), T(0), f};
      inv3(C0, Ci0);
    }
    frame_Cinv(Ri, f, f, f, Ci);

    // pass 0: the bbox list, ascending (ballot and popc prefix)
    int n0 = 0;
    for (int base = 0; base < M; base += G) {
      const int m = base + lig;
      bool in_box = false;
      if (m < M) {
        T x, y, z, w;
        ld_obs(cloud, m, x, y, z, w);
        // the walls in pairs: wall 2q + 1's normal is wall 2q's negated
        const T sh = dh[0] * x + dh[1] * y + dh[2] * z;
        const T sv = dv[0] * x + dv[1] * y + dv[2] * z;
        const T sw = dw[0] * x + dw[1] * y + dw[2] * z;
        in_box = w != T(0) && sh - woff[0] <= eps && -sh - woff[1] <= eps &&
                 sv - woff[2] <= eps && -sv - woff[3] <= eps &&
                 sw - woff[4] <= eps && -sw - woff[5] <= eps;
      }
      const unsigned bb = gbits(in_box);
      if (in_box) L0[n0 + __popc(bb & below)] = static_cast<unsigned short>(m);
      n0 += __popc(bb);
    }
    __syncwarp();
    const int n0max = wmax(n0);

    // the sphere test over the bbox list: phase 1's set and its first
    // argmin (ellipsoid Ri diag(f) Ri^T)
    T bd = inf;
    int bi = M, nw = 0;
    for (int base = 0; base < n0max; base += G) {
      const int p = base + lig;
      bool in_s = false;
      int m = 0;
      if (p < n0) {
        m = L0[p];
        T x, y, z, w;
        ld_obs(cloud, m, x, y, z, w);
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
      if (in_s) Wl[nw + __popc(bs & below)] = static_cast<unsigned short>(m);
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
      bi = M;
      int cnt = 0;
      for (int base = 0; base < nmaxw; base += G) {
        const int p = base + lig;
        bool keep = false;
        int m = 0;
        if (p < ne) {
          m = Wl[p];
          T x, y, z, w;
          ld_obs(cloud, m, x, y, z, w);
          const T dist = ell_dist(Ci, d, x, y, z);
          keep = T(1) - dist > eps;
          if (keep && dist < bd) {
            bd = dist;
            bi = m;
          }
        }
        const unsigned bk = gbits(keep);
        __syncwarp();                            // this chunk's reads done
        if (keep) Wl[cnt + __popc(bk & below)] = static_cast<unsigned short>(m);
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
      const bool act = bi < M;                   // this group's set not empty
      if (!__any_sync(FULL, act)) break;
      if (act) {
        T bx, by, bz, bw;
        ld_obs(cloud, bi, bx, by, bz, bw);
        const T pw[3] = {bx - d[0], by - d[1], bz - d[2]};
        T pl[3];
        mtv<3, 3>(Ri, pw, pl);
        const T roll = t_atan2(pl[2], pl[1]);
        const T cr = t_cos(roll), sr = t_sin(roll);
        const T Rx[9] = {T(1), T(0), T(0), T(0), cr, -sr, T(0), sr, cr};
        mm<3, 3, 3>(Ri, Rx, Rf);
        T pr[3];
        mtv<3, 3>(Rf, pw, pr);
        const T q = pr[0] / a0;
        const T denom = T(1) - q * q;
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
    bi = M;
    nw = 0;
    for (int base = 0; base < n0max; base += G) {
      const int p = base + lig;
      bool keep = false;
      int m = 0;
      if (p < n0) {
        m = L0[p];
        T x, y, z, w;
        ld_obs(cloud, m, x, y, z, w);
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
      if (keep) Wl[nw + __popc(bk & below)] = static_cast<unsigned short>(m);
      nw += __popc(bk);
    }
    __syncwarp();
    group_argmin(bd, bi, G);
    for (int r = 0; r < c.shrink_iters; ++r) {
      const bool act = bi < M;
      if (!__any_sync(FULL, act)) break;
      if (act) {
        T bx, by, bz, bw;
        ld_obs(cloud, bi, bx, by, bz, bw);
        const T pw[3] = {bx - d[0], by - d[1], bz - d[2]};
        T pr[3];
        mtv<3, 3>(Rf, pw, pr);
        const T q0 = pr[0] / a0, q1 = pr[1] / a1;
        const T dd = T(1) - q0 * q0 - q1 * q1;
        if (dd > eps) a2 = t_abs(pr[2]) / t_sqrt(nmax(dd, T(1e-12)));
        frame_Cinv(Rf, a0, a1, a2, Ci);
      }
      shrink_pass(act);
    }

    // ---- supporting-hyperplane peel (decomp_base.h:63-83) -------------------
    // the working list restarts as the bbox list; the ellipsoid is fixed
    frame_Cinv(Rf, a0, a1, a2, Ci);
    T Mq[9];
    mmt<3, 3, 3>(Ci, Ci, Mq);                 // C^{-1} C^{-T}
    bd = inf;
    bi = M;
    for (int base = 0; base < n0max; base += G) {
      const int p = base + lig;
      if (p < n0) {
        const int m = L0[p];
        T x, y, z, w;
        ld_obs(cloud, m, x, y, z, w);
        const T dist = ell_dist(Ci, d, x, y, z);
        Wl[p] = static_cast<unsigned short>(m);
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
      const bool act = bi < M;
      if (!__any_sync(FULL, act)) break;
      T pw[3] = {T(0), T(0), T(0)}, nrm[3] = {T(0), T(0), T(0)};
      if (act) {
        T bw;
        ld_obs(cloud, bi, pw[0], pw[1], pw[2], bw);
        const T rel[3] = {pw[0] - d[0], pw[1] - d[1], pw[2] - d[2]};
        mv<3, 3>(Mq, rel, nrm);
        const T nn = nmax(
            t_sqrt(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2]),
            T(1e-12));
        const T rn = T(1) / nn;
        for (int q = 0; q < 3; ++q) nrm[q] = nrm[q] * rn;
        if (live && lig == 0) put_row(A_out + 3 * r, b_out + r, pw, nrm, d);
      }
      const int ne = act ? nw : 0;
      const int nmaxw = wmax(ne);
      bd = inf;
      bi = M;
      int cnt = 0;
      for (int base = 0; base < nmaxw; base += G) {
        const int p = base + lig;
        bool keep = false;
        int m = 0;
        if (p < ne) {
          m = Wl[p];
          T x, y, z, w;
          ld_obs(cloud, m, x, y, z, w);
          const T sd = nrm[0] * (x - pw[0]) + nrm[1] * (y - pw[1]) +
                       nrm[2] * (z - pw[2]);
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
        if (keep) Wl[cnt + __popc(bk & below)] = static_cast<unsigned short>(m);
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
        wall(w, p1, p2, dh, dv, dw, c.bbox, pt, wn);
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

// warps per CTA: enough for every stage to have its own group, fewer when
// the CTA would not fit, at least one
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

// lanes per stage: `group` when it is 4, 8, 16 or 32 (a test hook), else
// the narrowest of 8 and 16 at which an SM holds MIN_RESIDENT_WARPS warps
// of these CTAs, else 32
template <typename T>
int corridor_group(int group, int N, int M) {
  if (group == 4 || group == 8 || group == 16 || group == 32) return group;
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

// the opt-in to the card's largest shared memory, once per device, dtype
// and build (at namespace scope: one per library, even where two builds of
// this file share a process)
static bool opted[2][2][64] = {};

template <typename T>
int launch_corridor(const CorrConsts<T>* c, int B, int N, int M, int group,
                    const T* p1, const T* p2, const T* obs,
                    const unsigned char* mask, T* A, T* b,
                    cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || M > 65535 || c->nh < c->max_planes + 6)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = corridor_group<T>(group, N, M);
  const size_t smem = corridor_smem<T>(N, M, G);
  const int warps = corridor_warps<T>(N, M, G);
  const bool wide = warps > SMALL_WARPS;
  const auto kernel = wide ? corridor_kernel<T, MAX_WARPS>
                           : corridor_kernel<T, SMALL_WARPS>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  bool& done = opted[sizeof(T) == 8][wide][dev];
  if (!done) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  kernel<<<B, 32 * warps, smem, stream>>>(*c, N, M, G, p1, p2, obs, mask, A, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using frp::CorrConsts;

extern "C" {

// the launch geometry for N stages of M obstacles (elem_bytes 4 or 8, group
// 0 for the kernel's choice of lanes per stage): lanes per stage, threads and bytes of
// shared memory per CTA
void corridor_geometry(int N, int M, int elem_bytes, int group, int* lanes,
                       int* threads, size_t* smem) {
  if (elem_bytes == 8) {
    *lanes = frp::corridor_group<double>(group, N, M);
    *threads = 32 * frp::corridor_warps<double>(N, M, *lanes);
    *smem = frp::corridor_smem<double>(N, M, *lanes);
  } else {
    *lanes = frp::corridor_group<float>(group, N, M);
    *threads = 32 * frp::corridor_warps<float>(N, M, *lanes);
    *smem = frp::corridor_smem<float>(N, M, *lanes);
  }
}

#define CORRIDOR_ENTRY(NAME, T)                                               \
  int NAME(const CorrConsts<T>* c, int B, int N, int M, int group,            \
           const T* p1, const T* p2, const T* obs, const unsigned char* mask, \
           T* A, T* b, cudaStream_t stream) {                                 \
    return frp::launch_corridor<T>(c, B, N, M, group, p1, p2, obs, mask, A,  \
                                   b, stream);                                \
  }

CORRIDOR_ENTRY(corridor_f32, float)
CORRIDOR_ENTRY(corridor_f64, double)

}  // extern "C"
