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
// Design (right and simple first):
//  * one CTA per scenario: its cloud is staged once into shared memory
//    (structure of arrays, 3 M values) and stays there for all its stages,
//    as the TPU kernel keeps it VMEM-resident across the stage loop;
//  * one warp per stage (W warps, each looping over N / W stages); each lane
//    owns the obstacles m = lane, lane + 32, ...; the per-obstacle flags
//    (bbox-inside, initial-sphere-inside, inside/remain) are one byte per
//    obstacle in the warp's own shared-memory row;
//  * every round's argmin is a warp-shuffle reduction on (distance, index)
//    that breaks ties to the lower index; all lanes then hold the winner
//    and carry the same scalar state (frame, axes, plane), so the warp
//    never diverges outside the obstacle loops;
//  * the distances of the next round's argmin are the ones that update the
//    inside set this round (the same ellipsoid), so each round is one pass
//    over the lane's obstacles; a loop whose set is empty is a no-op for
//    all later rounds and stops early;
//  * shared memory is 3 M sizeof(T) + W M bytes (f64 at M = 2048, W = 10:
//    68 KB), above 48 KB only after cudaFuncSetAttribute opts in.
// What bounds it: ~60 passes over M obstacles per stage at ~30 flops per
// obstacle; with shared-memory operands that is ALU and latency bound; a
// CTA of W warps per scenario gives B CTAs (4096 at the bench shape).
#include "common.cuh"

namespace frp {

constexpr int MAX_WARPS = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned char F_BBOX = 1, F_SPHERE = 2, F_IN = 4;

template <typename T>
struct CorrConsts {
  T bbox[3];
  T eps;
  int shrink_iters, max_planes, nh;
};

template <typename T>
__device__ void inv3(const T* A, T* out) {
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
__device__ void frame_Cinv(const T* Rf, T a0, T a1, T a2, T* Ci) {
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

// warp-wide lowest-index argmin; every lane returns the winner
template <typename T>
__device__ __forceinline__ void warp_argmin(T& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T od = __shfl_xor_sync(FULL, d, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// R = Rz(yaw) Ry(pitch) Rx(roll) (dynamics/quadrotor.py::euler_to_rot)
template <typename T>
__device__ void euler_rot(T roll, T pitch, T yaw, T* R) {
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

// one outward-oriented row: c = pt . n, flip when n . interior - c > 0
template <typename T>
__device__ void put_row(T* A, T* b, const T* pt, const T* n, const T* d) {
  const T c = pt[0] * n[0] + pt[1] * n[1] + pt[2] * n[2];
  const bool flip = (n[0] * d[0] + n[1] * d[1] + n[2] * d[2]) - c > T(0);
  const T sgn = flip ? T(-1) : T(1);
  A[0] = n[0] * sgn;
  A[1] = n[1] * sgn;
  A[2] = n[2] * sgn;
  *b = c * sgn;
}

template <typename T>
__global__ void __launch_bounds__(32 * MAX_WARPS) corridor_kernel(
    const CorrConsts<T> c, const int N, const int M,
    const T* __restrict__ p1_, const T* __restrict__ p2_,
    const T* __restrict__ obs_, const unsigned char* __restrict__ mask_,
    T* __restrict__ A_, T* __restrict__ b_) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ox = reinterpret_cast<T*>(smem);
  T* oy = ox + M;
  T* oz = oy + M;
  const int W = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* flags = reinterpret_cast<unsigned char*>(oz + M) + warp * M;
  const size_t sb = blockIdx.x;

  for (int k = threadIdx.x; k < 3 * M; k += blockDim.x) {
    const T v = obs_[sb * 3 * M + k];
    const int m = k / 3, j = k % 3;
    (j == 0 ? ox : (j == 1 ? oy : oz))[m] = v;
  }
  __syncthreads();

  const T inf = std::numeric_limits<T>::infinity();
  const T eps = c.eps;
  for (int n = warp; n < N; n += W) {
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
    T wpt[6][3], wn[6][3], woff[6];
    for (int k = 0; k < 3; ++k) {
      wpt[0][k] = p1[k] + dh[k] * c.bbox[1];
      wpt[1][k] = p1[k] - dh[k] * c.bbox[1];
      wpt[2][k] = p2[k] + dv[k] * c.bbox[0];
      wpt[3][k] = p1[k] - dv[k] * c.bbox[0];
      wpt[4][k] = p1[k] + dw[k] * c.bbox[2];
      wpt[5][k] = p1[k] - dw[k] * c.bbox[2];
      wn[0][k] = dh[k];
      wn[1][k] = -dh[k];
      wn[2][k] = dv[k];
      wn[3][k] = -dv[k];
      wn[4][k] = dw[k];
      wn[5][k] = -dw[k];
    }
    for (int w = 0; w < 6; ++w)
      woff[w] = wn[w][0] * wpt[w][0] + wn[w][1] * wpt[w][1] + wn[w][2] * wpt[w][2];

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

    // pass 0: flags, and the first phase-1 argmin (ellipsoid Ri diag(f) Ri^T)
    T bd = inf;
    int bi = M;
    for (int m = lane; m < M; m += 32) {
      const T x = ox[m], y = oy[m], z = oz[m];
      bool in_box = mask_[sb * M + m] != 0;
      for (int w = 0; w < 6; ++w)
        in_box = in_box &&
                 ((wn[w][0] * x + wn[w][1] * y + wn[w][2] * z) - woff[w] <= eps);
      const bool sph = ell_dist(Ci0, d, x, y, z) <= T(1);
      unsigned char fl = (in_box ? F_BBOX : 0) | (sph ? F_SPHERE : 0);
      if (in_box && sph) {
        fl |= F_IN;
        const T dist = ell_dist(Ci, d, x, y, z);
        if (dist < bd) {
          bd = dist;
          bi = m;
        }
      }
      flags[m] = fl;
    }
    warp_argmin(bd, bi);

    // ---- phase 1: shrink the middle axis, re-rolling the frame ------------
    T a0 = f, a1 = f, a2 = f;
    T Rf[9];
    for (int k = 0; k < 9; ++k) Rf[k] = Ri[k];
    for (int r = 0; r < c.shrink_iters && bi < M; ++r) {
      const T pw[3] = {ox[bi] - d[0], oy[bi] - d[1], oz[bi] - d[2]};
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
      bd = inf;
      bi = M;
      for (int m = lane; m < M; m += 32) {
        if (!(flags[m] & F_IN)) continue;
        const T dist = ell_dist(Ci, d, ox[m], oy[m], oz[m]);
        if (T(1) - dist > eps) {
          if (dist < bd) {
            bd = dist;
            bi = m;
          }
        } else {
          flags[m] &= ~F_IN;
        }
      }
      warp_argmin(bd, bi);
    }

    // ---- phase 2: shrink the vertical axis, frame fixed --------------------
    // restart from the initial sphere's set, filtered by the reset ellipsoid
    frame_Cinv(Rf, a0, a1, a2, Ci);
    bd = inf;
    bi = M;
    for (int m = lane; m < M; m += 32) {
      unsigned char fl = flags[m] & (F_BBOX | F_SPHERE);
      if (fl == (F_BBOX | F_SPHERE)) {
        const T dist = ell_dist(Ci, d, ox[m], oy[m], oz[m]);
        if (dist <= T(1)) {
          fl |= F_IN;
          if (dist < bd) {
            bd = dist;
            bi = m;
          }
        }
      }
      flags[m] = fl;
    }
    warp_argmin(bd, bi);
    for (int r = 0; r < c.shrink_iters && bi < M; ++r) {
      const T pw[3] = {ox[bi] - d[0], oy[bi] - d[1], oz[bi] - d[2]};
      T pr[3];
      mtv<3, 3>(Rf, pw, pr);
      const T q0 = pr[0] / a0, q1 = pr[1] / a1;
      const T dd = T(1) - q0 * q0 - q1 * q1;
      if (dd > eps) a2 = t_abs(pr[2]) / t_sqrt(nmax(dd, T(1e-12)));
      frame_Cinv(Rf, a0, a1, a2, Ci);
      bd = inf;
      bi = M;
      for (int m = lane; m < M; m += 32) {
        if (!(flags[m] & F_IN)) continue;
        const T dist = ell_dist(Ci, d, ox[m], oy[m], oz[m]);
        if (T(1) - dist > eps) {
          if (dist < bd) {
            bd = dist;
            bi = m;
          }
        } else {
          flags[m] &= ~F_IN;
        }
      }
      warp_argmin(bd, bi);
    }

    // ---- supporting-hyperplane peel (decomp_base.h:63-83) -------------------
    frame_Cinv(Rf, a0, a1, a2, Ci);
    T Mq[9];
    mmt<3, 3, 3>(Ci, Ci, Mq);                 // C^{-1} C^{-T}
    bd = inf;
    bi = M;
    for (int m = lane; m < M; m += 32) {
      const bool in_box = flags[m] & F_BBOX;
      flags[m] = in_box ? F_IN : 0;           // F_IN now means "remains"
      if (in_box) {
        const T dist = ell_dist(Ci, d, ox[m], oy[m], oz[m]);
        if (dist < bd) {
          bd = dist;
          bi = m;
        }
      }
    }
    warp_argmin(bd, bi);
    int r = 0;
    for (; r < c.max_planes && bi < M; ++r) {
      const T pw[3] = {ox[bi], oy[bi], oz[bi]};
      const T rel[3] = {pw[0] - d[0], pw[1] - d[1], pw[2] - d[2]};
      T nrm[3];
      mv<3, 3>(Mq, rel, nrm);
      const T nn = nmax(t_sqrt(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2]),
                        T(1e-12));
      for (int k = 0; k < 3; ++k) nrm[k] = nrm[k] / nn;
      if (lane == 0) put_row(A_out + 3 * r, b_out + r, pw, nrm, d);
      bd = inf;
      bi = M;
      for (int m = lane; m < M; m += 32) {
        if (!(flags[m] & F_IN)) continue;
        const T sd = nrm[0] * (ox[m] - pw[0]) + nrm[1] * (oy[m] - pw[1]) +
                     nrm[2] * (oz[m] - pw[2]);
        if (sd < T(0)) {
          const T dist = ell_dist(Ci, d, ox[m], oy[m], oz[m]);
          if (dist < bd) {
            bd = dist;
            bi = m;
          }
        } else {
          flags[m] = 0;
        }
      }
      warp_argmin(bd, bi);
    }

    // ---- rows: unused peel rows zero, walls, zero padding -------------------
    for (int k = r + lane; k < c.max_planes; k += 32) {
      A_out[3 * k] = T(0);
      A_out[3 * k + 1] = T(0);
      A_out[3 * k + 2] = T(0);
      b_out[k] = T(0);
    }
    if (lane < 6) {
      const int k = c.max_planes + lane;
      put_row(A_out + 3 * k, b_out + k, wpt[lane], wn[lane], d);
    }
    for (int k = c.max_planes + 6 + lane; k < c.nh; k += 32) {
      A_out[3 * k] = T(0);
      A_out[3 * k + 1] = T(0);
      A_out[3 * k + 2] = T(0);
      b_out[k] = T(0);
    }
  }
}

// warps per CTA: the fewest passes over the stages with at most MAX_WARPS
// warps, spread evenly (N = 20 -> 10 warps of 2 stages)
inline int corridor_warps(int N) {
  const int passes = (N + MAX_WARPS - 1) / MAX_WARPS;
  return (N + passes - 1) / passes;
}

template <typename T>
size_t corridor_smem(int N, int M) {
  return 3 * static_cast<size_t>(M) * sizeof(T) +
         static_cast<size_t>(corridor_warps(N)) * M;
}

template <typename T>
int launch_corridor(const CorrConsts<T>* c, int B, int N, int M, const T* p1,
                    const T* p2, const T* obs, const unsigned char* mask,
                    T* A, T* b, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || c->nh < c->max_planes + 6)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = corridor_smem<T>(N, M);
  cudaError_t err = cudaFuncSetAttribute(
      corridor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  corridor_kernel<T><<<B, 32 * corridor_warps(N), smem, stream>>>(
      *c, N, M, p1, p2, obs, mask, A, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using frp::CorrConsts;

extern "C" {

// dynamic shared memory one CTA needs (the wrapper checks it against the card)
size_t corridor_smem_bytes(int N, int M, int elem_bytes) {
  return elem_bytes == 8 ? frp::corridor_smem<double>(N, M)
                         : frp::corridor_smem<float>(N, M);
}

#define CORRIDOR_ENTRY(NAME, T)                                               \
  int NAME(const CorrConsts<T>* c, int B, int N, int M, const T* p1,          \
           const T* p2, const T* obs, const unsigned char* mask, T* A, T* b,  \
           cudaStream_t stream) {                                             \
    return frp::launch_corridor<T>(c, B, N, M, p1, p2, obs, mask, A, b,       \
                                   stream);                                   \
  }

CORRIDOR_ENTRY(corridor_f32, float)
CORRIDOR_ENTRY(corridor_f64, double)

}  // extern "C"
