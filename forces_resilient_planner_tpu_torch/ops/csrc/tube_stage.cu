// Per-stage disturbance-tube math, a team of 9 threads per stage lane (Hopper).
//
// Replaces forces_resilient_planner_tpu/ops/tube_pallas.py::_tube_kernel
// (the Pallas TPU kernel behind tube_stage_lanes).  For each stage lane l
// of L = B N, from the stage state x (9) and input u (4):
//   Phi = Jc + Bc K                       (closed loop, nmpc_solver.cpp:696)
//   s   = clip(nan_to_num(ceil(log2(max(|Phi dt|_1 / 0.5, 1)))), 0, 4)
//   Pu  = Phi dt 2^-s;  Mm = e^{-Pu}, Mp = e^{+Pu} by an NTERMS Horner
//   X_c = dt 2^-s sum_m H_m / (m+1), H_0 = e_c e_c^T (c = vx, vy, vz),
//         H_{m} = -(Pu H_{m-1} + (Pu H_{m-1})^T) / m
//   s doublings: X_c += Mm X_c Mm^T, Mm = Mm^2, Mp = Mp^2
//   X_c *= dt w^2;  Qd = (sum_c tr_c) sum_c X_c / tr_c, tr_c = sqrt(max(tr X_c, 1e-30))
//   Q1  = R diag(r^2, r^2, h^2) R^T       (ego ellipsoid, nmpc_solver.cpp:503-513)
// The plain PyTorch version is ops/tube_kernel.py::tube_stage_reference
// (tube/lyapunov.py::closed_loop_phi + channel_Qd_fast + ego_ellipsoid);
// its NaN handling is kept (nan_to_num on s, NaN-propagating clamps),
// which the Pallas kernel lacks.
//
// NTERMS is a template argument: 7 at f32 and 12 at f64, the plain path's
// tube/lyapunov.py::taylor_n_terms; the entry points refuse another count.
//
// What bounds it: operations, not bytes: per lane at f32 12 Horner and 15
// series 9x9 products (and 3 sparse ones), 8 per doubling
// (ops/tube_kernel.py::tube_stage_operations counts them).  Design:
//  * a team of 9 threads per stage lane, 3 teams per warp (threads 27-31
//    idle), WARPS warps per CTA (1 at f32: measured fastest of 1, 3 and 4);
//    a team synchronises with __syncwarp on its own 9-bit mask, so the
//    teams of a warp run their own doubling counts;
//  * thread k of a team owns column k of every right-hand factor, in
//    registers: Mm and Mp in the Horner chains, H_c and X_c in the series,
//    X_c in the doublings; each thread also holds all of Pu (81 values), so
//    the Horner and the series read no shared memory in their products;
//  * the products loop over the shared index j outermost: a thread
//    advances 18 (Horner: Mm, Mp) or 27 (series: three channels)
//    independent sums at once, and each output is still the same
//    sequential sum over j as in the one-thread-per-lane kernel this
//    replaces;
//  * the transposes (H = -(W + W^T)/m, M X M^T) go through the lane's shared
//    memory: W is stored by columns and read back by rows, double-buffered
//    so a series step needs one team barrier; the doublings' left factors
//    (Mm, M X) are read as rows of their transposes, 16-byte vectors (rows
//    padded to 12 floats or 10 doubles), all 9 threads at one address;
//  * each lane's outputs are staged in shared memory and written as one
//    contiguous run per matrix by the team's 9 threads;
//  * a division by the series index m is a product with the rounded 1/m.
// f32: 0 spill bytes (chip_smoke.py phase 1 prints the ptxas report).
#include "common.cuh"

namespace frp {

constexpr int MAX_DOUBLINGS = 4;
constexpr int TEAM = 9;          // threads per stage lane
constexpr int TEAMS_PER_WARP = 3;

template <typename T>
struct TubeConsts {
  T mass, drag, dt, noise, ego_r2, ego_h2;
  T K[36];  // (4, 9) row-major feedback gain
};

// padded row stride of a 9x9 matrix in shared memory: 16-byte rows
template <typename T>
struct Stride;
template <>
struct Stride<float> { static constexpr int S = 12; };
template <>
struct Stride<double> { static constexpr int S = 10; };

// shared-memory elements of one lane: Pu, Mm, Mp, 2 x 3 W buffers (padded
// rows), then two 81-value staging areas and the 27 channel diagonals
template <typename T>
__host__ __device__ constexpr int tube_lane_elements() {
  constexpr int raw = (3 + 6) * 9 * Stride<T>::S + 2 * 81 + 27;
  constexpr int v = 16 / static_cast<int>(sizeof(T));   // 16-byte lanes
  return (raw + v - 1) / v * v;
}

__device__ __forceinline__ void ld_row9(const float* p, float* r) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = p[8];
}
__device__ __forceinline__ void ld_row9(const double* p, double* r) {
  for (int q = 0; q < 4; ++q) {
    const double2 a = *reinterpret_cast<const double2*>(p + 2 * q);
    r[2 * q] = a.x;
    r[2 * q + 1] = a.y;
  }
  r[8] = p[8];
}

// a * b rounded on its own (never contracted into an FMA)
__device__ __forceinline__ float t_mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double t_mul_rn(double a, double b) { return __dmul_rn(a, b); }

// v[t] for a runtime t without indexing a register array
template <typename T>
__device__ __forceinline__ T pick9(const T* v, int t) {
  T out = v[0];
  for (int e = 1; e < 9; ++e) out = e == t ? v[e] : out;
  return out;
}

template <typename T, int NTERMS, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) tube_stage_kernel(
    const TubeConsts<T> c, const int L, const T* __restrict__ x_,
    const T* __restrict__ u_, T* __restrict__ Qd_, T* __restrict__ Mp_,
    T* __restrict__ Phi_, T* __restrict__ Q1_) {
  constexpr int S = Stride<T>::S;
  constexpr int LANES = TEAMS_PER_WARP * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wl = threadIdx.x % 32;
  const int team = wl / TEAM;
  if (team >= TEAMS_PER_WARP) return;              // threads 27-31
  const int k = wl % TEAM;                         // my row / column
  const unsigned mask = 0x1FFu << (TEAM * team);
  const int slot = (threadIdx.x / 32) * TEAMS_PER_WARP + team;
  const int l = blockIdx.x * LANES + slot;
  const bool valid = l < L;
  const size_t ll = static_cast<size_t>(valid ? l : L - 1);

  T* sm = reinterpret_cast<T*>(smem_raw) + slot * tube_lane_elements<T>();
  T* PuT = sm;                                     // transposed (rows = columns)
  T* MmT = PuT + 9 * S;
  T* MpT = MmT + 9 * S;
  T* Wb = MpT + 9 * S;                             // [2][3][9 * S]
  T* stage = Wb + 6 * 9 * S;                       // 81
  T* stage2 = stage + 81;                          // 81
  T* diag = stage2 + 81;                           // 27

  T x[9], u[4];
  for (int q = 0; q < 9; ++q) x[q] = x_[ll * 9 + q];
  for (int q = 0; q < 4; ++q) u[q] = u_[ll * 4 + q];
  const T dt = c.dt;

  // ---- Phi = Jc + Bc K: row k per thread; Q1's entry k -------------------
  // Jc's rows 0-2 are e_{3+k}, rows 6-8 zero; Bc's rows 0-2 zero, rows 6-8
  // e_{k-6}: only rows 3-5 need the Jacobian blocks (cont_jac's formulas)
  T phi[9], q1k;
  {
    T R[9], dR[27];
    rot_blocks(x + 6, R, dR);
    const T D[3] = {c.drag, c.drag, T(0)};
    T RD[9], RDRt[9], dvd[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) RD[3 * i + j] = R[3 * i + j] * D[j];
    mmt<3, 3, 3>(RD, R, RDRt);
    const T Tm = u[3] / c.mass;
    for (int a = 0; a < 3; ++a) {
      const T* dRa = dR + 9 * a;
      T dRD[9], m1[9], m2[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) dRD[3 * i + j] = dRa[3 * i + j] * D[j];
      mmt<3, 3, 3>(dRD, R, m1);
      mmt<3, 3, 3>(RD, dRa, m2);
      for (int i = 0; i < 3; ++i) {
        T sacc = T(0);
        for (int j = 0; j < 3; ++j) sacc += (m1[3 * i + j] + m2[3 * i + j]) * x[3 + j];
        dvd[3 * i + a] = dRa[3 * i + 2] * Tm - sacc;
      }
    }
    const int r3 = k - 3, r6 = k - 6;
    for (int j = 0; j < 9; ++j) {
      T v = (k < 3 && j == 3 + k) ? T(1) : T(0);           // rows 0-2
      if (k >= 3 && k < 6) {
        T jc = T(0);
        if (j >= 3) {
          const int q = j < 6 ? j - 3 : j - 6;
          const T* blk = j < 6 ? RDRt : dvd;
          const T e0 = blk[q], e1 = blk[3 + q], e2 = blk[6 + q];
          const T e = r3 == 0 ? e0 : (r3 == 1 ? e1 : e2);
          jc = j < 6 ? -e : e;
        }
        const T b3 = (r3 == 0 ? R[2] : (r3 == 1 ? R[5] : R[8])) / c.mass;
        v = jc + t_mul_rn(b3, c.K[27 + j]);   // (Bc K), then + Jc
      } else if (k >= 6) {
        v = r6 == 0 ? c.K[j] : (r6 == 1 ? c.K[9 + j] : c.K[18 + j]);
      }
      phi[j] = v;
    }
    // ego ellipsoid Q1 = R diag(r^2, r^2, h^2) R^T: entry k
    const T ego[3] = {c.ego_r2, c.ego_r2, c.ego_h2};
    T q1[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        T acc = (R[i * 3] * ego[0]) * R[j * 3];
        for (int q = 1; q < 3; ++q) acc += (R[i * 3 + q] * ego[q]) * R[j * 3 + q];
        q1[i * 3 + j] = acc;
      }
    q1k = pick9(q1, k);
  }
  for (int j = 0; j < 9; ++j) stage[k * 9 + j] = phi[j];
  __syncwarp(mask);

  // ---- scaling from the 1-norm of Phi dt (every thread, same order) ------
  T norm1 = T(0);
  for (int j = 0; j < 9; ++j) {
    T col = t_abs(stage[j] * dt);
    for (int i = 1; i < 9; ++i) col += t_abs(stage[i * 9 + j] * dt);
    norm1 = j == 0 ? col : nmax(norm1, col);
  }
  T s = t_ceil(t_log2(nmax(norm1 / T(0.5), T(1))));
  if (s != s) s = T(0);                       // nan_to_num(s, nan=0)
  s = s < T(0) ? T(0) : (s > T(MAX_DOUBLINGS) ? T(MAX_DOUBLINGS) : s);
  T us = T(1);
  for (int q = 0; q < MAX_DOUBLINGS; ++q)
    if (s > T(q)) us *= T(0.5);               // 0.5^s, s integral
  // Pu^T: column j of Pu as row j, so a product's j-th step reads one row
  for (int j = 0; j < 9; ++j) PuT[j * S + k] = (phi[j] * dt) * us;
  if (valid)
    for (int q = 0; q < 9; ++q) Phi_[ll * 81 + k + 9 * q] = stage[k + 9 * q];
  __syncwarp(mask);

  // Pu in registers, every thread all of it: the Horner and the series
  // then read no shared memory
  T P[81];
  for (int j = 0; j < 9; ++j) {
    T a[9];
    ld_row9(PuT + j * S, a);
    for (int i = 0; i < 9; ++i) P[i * 9 + j] = a[i];
  }

  // ---- Mm = e^{-Pu}, Mp = e^{+Pu}: shared Horner, column k ---------------
  T mm[9], mp[9];
  for (int i = 0; i < 9; ++i) mm[i] = mp[i] = i == k ? T(1) : T(0);
#pragma unroll 1
  for (int m = NTERMS; m >= 1; --m) {
    const T rm = T(1) / T(m);
    T am[9], ap[9];
    for (int j = 0; j < 9; ++j)
      for (int i = 0; i < 9; ++i) {
        const T a = P[i * 9 + j];
        am[i] = j == 0 ? a * mm[0] : am[i] + a * mm[j];
        ap[i] = j == 0 ? a * mp[0] : ap[i] + a * mp[j];
      }
    for (int i = 0; i < 9; ++i) {
      const T e = i == k ? T(1) : T(0);
      mm[i] = e - am[i] * rm;
      mp[i] = e + ap[i] * rm;
    }
  }
  // Mm^T and Mp^T: column k of Mm as row k
  for (int i = 0; i < 9; ++i) {
    MmT[k * S + i] = mm[i];
    MpT[k * S + i] = mp[i];
  }

  // ---- channel series at the scaled time: the three channels together ----
  T h[3][9], X[3][9];
  for (int ch = 0; ch < 3; ++ch)
    for (int i = 0; i < 9; ++i)
      X[ch][i] = h[ch][i] = (i == 3 + ch && k == 3 + ch) ? T(1) : T(0);
#pragma unroll 1
  for (int m = 1; m <= NTERMS; ++m) {
    const T rm = T(1) / T(m), rm1 = T(1) / T(m + 1);
    T* W = Wb + (m & 1) * 3 * 9 * S;
    T w[3][9];
    for (int j = 0; j < 9; ++j)
      for (int ch = 0; ch < 3; ++ch)
        for (int i = 0; i < 9; ++i) {
          const T a = P[i * 9 + j];
          w[ch][i] = j == 0 ? a * h[ch][0] : w[ch][i] + a * h[ch][j];
        }
    for (int ch = 0; ch < 3; ++ch)
      for (int i = 0; i < 9; ++i) W[ch * 9 * S + i * S + k] = w[ch][i];
    __syncwarp(mask);
    for (int ch = 0; ch < 3; ++ch) {
      T wt[9];                                 // row k of W: W[k][i]
      ld_row9(W + ch * 9 * S + k * S, wt);
      for (int i = 0; i < 9; ++i) {
        const T hn = -((w[ch][i] + wt[i]) * rm);
        h[ch][i] = hn;
        X[ch][i] = X[ch][i] + hn * rm1;
      }
    }
  }
  const T tus = dt * us;
  for (int ch = 0; ch < 3; ++ch)
    for (int i = 0; i < 9; ++i) X[ch][i] = X[ch][i] * tus;
  __syncwarp(mask);                          // the last W reads done

  // ---- doublings (per lane, s of them) -----------------------------------
#pragma unroll 1
  for (int kd = 0; kd < MAX_DOUBLINGS; ++kd) {
    if (!(s > T(kd))) break;
    // M X_c (column k), stored as row k of (M X_c)^T
    {
      T mx[3][9];
      for (int j = 0; j < 9; ++j) {
        T a[9];                                // column j of Mm
        ld_row9(MmT + j * S, a);
        for (int ch = 0; ch < 3; ++ch)
          for (int i = 0; i < 9; ++i)
            mx[ch][i] = j == 0 ? a[i] * X[ch][0] : mx[ch][i] + a[i] * X[ch][j];
      }
      for (int ch = 0; ch < 3; ++ch)
        for (int i = 0; i < 9; ++i) Wb[ch * 9 * S + k * S + i] = mx[ch][i];
    }
    __syncwarp(mask);
    // X_c += (M X_c) M^T, column k: sum_j (M X_c)[:, j] M[k][j]
    {
      T mk[9];                                 // row k of Mm
      for (int j = 0; j < 9; ++j) mk[j] = MmT[j * S + k];
      for (int ch = 0; ch < 3; ++ch) {
        T wc[9];
        for (int j = 0; j < 9; ++j) {
          T r[9];                              // column j of M X_c
          ld_row9(Wb + ch * 9 * S + j * S, r);
          for (int i = 0; i < 9; ++i)
            wc[i] = j == 0 ? r[i] * mk[0] : wc[i] + r[i] * mk[j];
        }
        for (int i = 0; i < 9; ++i) X[ch][i] = X[ch][i] + wc[i];
      }
    }
    // Mm^2, Mp^2 (column k): sum_j M[:, j] M[j][k]
    T cm[9], cp[9], nm[9], np[9];
    ld_row9(MmT + k * S, cm);                  // column k of Mm
    ld_row9(MpT + k * S, cp);
    for (int j = 0; j < 9; ++j) {
      T a[9], b[9];
      ld_row9(MmT + j * S, a);
      ld_row9(MpT + j * S, b);
      for (int i = 0; i < 9; ++i) {
        nm[i] = j == 0 ? a[i] * cm[0] : nm[i] + a[i] * cm[j];
        np[i] = j == 0 ? b[i] * cp[0] : np[i] + b[i] * cp[j];
      }
    }
    __syncwarp(mask);                        // every read of Mm, Mp, W done
    for (int i = 0; i < 9; ++i) {
      MmT[k * S + i] = nm[i];
      MpT[k * S + i] = np[i];
      mp[i] = np[i];
    }
    __syncwarp(mask);
  }

  // ---- Nt factor + trace-normalized combine ------------------------------
  const T w2t = dt * (c.noise * c.noise);
  for (int ch = 0; ch < 3; ++ch) {
    for (int i = 0; i < 9; ++i) X[ch][i] = X[ch][i] * w2t;
    diag[ch * 9 + k] = pick9(X[ch], k);
  }
  for (int i = 0; i < 9; ++i) stage[i * 9 + k] = mp[i];
  __syncwarp(mask);
  T tr[3];
  for (int ch = 0; ch < 3; ++ch) {
    T acc = diag[ch * 9];
    for (int i = 1; i < 9; ++i) acc += diag[ch * 9 + i];
    tr[ch] = t_sqrt(nmax(acc, T(1e-30)));
  }
  const T tsum = (tr[0] + tr[1]) + tr[2];
  for (int i = 0; i < 9; ++i)
    stage2[i * 9 + k] =
        tsum * ((X[0][i] / tr[0] + X[1][i] / tr[1]) + X[2][i] / tr[2]);

  __syncwarp(mask);
  if (valid) {
    for (int q = 0; q < 9; ++q) {
      Mp_[ll * 81 + k + 9 * q] = stage[k + 9 * q];
      Qd_[ll * 81 + k + 9 * q] = stage2[k + 9 * q];
    }
    Q1_[ll * 9 + k] = q1k;
  }
}

// warps per CTA: 1 at f32 (3 lanes, 13,968 B of shared memory), 2 at f64
// (6 lanes, 48,000 B)
template <typename T>
struct TubeWarps { static constexpr int W = sizeof(T) == 4 ? 1 : 2; };

template <typename T>
size_t tube_smem() {
  return static_cast<size_t>(TEAMS_PER_WARP * TubeWarps<T>::W) *
         tube_lane_elements<T>() * sizeof(T);
}

template <typename T, int NTERMS>
int launch_tube(const TubeConsts<T>* c, int L, int n_terms, const T* x,
                const T* u, T* Qd, T* Mp, T* Phi, T* Q1, cudaStream_t stream) {
  if (n_terms != NTERMS || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = TubeWarps<T>::W;
  const size_t smem = tube_smem<T>();
  // the shared-memory opt-in, once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(tube_stage_kernel<T, NTERMS, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const int lanes = TEAMS_PER_WARP * W;
  const int blocks = (L + lanes - 1) / lanes;
  tube_stage_kernel<T, NTERMS, W><<<blocks, 32 * W, smem, stream>>>(
      *c, L, x, u, Qd, Mp, Phi, Q1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using frp::TubeConsts;

extern "C" {

// the launch geometry of one dtype (elem_bytes 4 or 8): stage lanes and
// threads per CTA, bytes of shared memory per CTA
void tube_geometry(int elem_bytes, int* lanes, int* threads, size_t* smem) {
  const int w = elem_bytes == 8 ? frp::TubeWarps<double>::W
                                : frp::TubeWarps<float>::W;
  *lanes = frp::TEAMS_PER_WARP * w;
  *threads = 32 * w;
  *smem = elem_bytes == 8 ? frp::tube_smem<double>() : frp::tube_smem<float>();
}

// the Taylor length is the plain path's taylor_n_terms(dtype): 7 at f32,
// 12 at f64 (tests/test_torch_tube.py reads these two lines)
#define TUBE_ENTRY(NAME, T, NTERMS)                                          \
  int NAME(const TubeConsts<T>* c, int L, int n_terms, const T* x,           \
           const T* u, T* Qd, T* Mp, T* Phi, T* Q1, cudaStream_t stream) {   \
    return frp::launch_tube<T, NTERMS>(c, L, n_terms, x, u, Qd, Mp, Phi, Q1, \
                                       stream);                              \
  }

TUBE_ENTRY(tube_stage_f32, float, 7)
TUBE_ENTRY(tube_stage_f64, double, 12)

}  // extern "C"
