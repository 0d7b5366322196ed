// Per-stage disturbance-tube math, one thread per stage lane (Hopper).
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
// Design (right and simple first): one thread per lane, 128 threads per
// block; inputs and outputs batch-leading ((L, 9), (L, 4) in; (L, 9, 9)
// x 3 and (L, 3, 3) out), each thread reading and writing its own rows.
// What bounds it: ~67 9x9 products per lane (about 49k FMA) on about seven
// live 9x9 matrices (~650 values), far above the 255-register limit, so
// most of the state lives in thread-local (L1-cached local) memory; the
// stores are strided by 81 across a warp.  A warp-per-lane or shared-memory
// layout and coalesced stores are later work.
#include "common.cuh"

namespace frp {

constexpr int TUBE_THREADS = 128;
constexpr int MAX_DOUBLINGS = 4;
constexpr int N9 = 9;

template <typename T>
struct TubeConsts {
  T mass, drag, dt, noise, ego_r2, ego_h2;
  T K[36];  // (4, 9) row-major feedback gain
};

// out = a @ b for 9x9 row-major
template <typename T>
__device__ __forceinline__ void mm9(const T* a, const T* b, T* out) {
  mm<9, 9, 9>(a, b, out);
}

template <typename T, int NTERMS>
__global__ void __launch_bounds__(TUBE_THREADS) tube_stage_kernel(
    const TubeConsts<T> c, const int L, const T* __restrict__ x_,
    const T* __restrict__ u_, T* __restrict__ Qd_, T* __restrict__ Mp_,
    T* __restrict__ Phi_, T* __restrict__ Q1_) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t ll = static_cast<size_t>(l);
  T x[9], u[4];
  for (int k = 0; k < 9; ++k) x[k] = x_[ll * 9 + k];
  for (int k = 0; k < 4; ++k) u[k] = u_[ll * 4 + k];
  const T dt = c.dt;

  // ---- Phi = Jc + Bc K ---------------------------------------------------
  T P[81], Bc[36];
  {
    T Jc[81];
    cont_jac(x, u, c.mass, c.drag, Jc, Bc);
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) {
        T acc = Bc[i * 4] * c.K[j];
        for (int k = 1; k < 4; ++k) acc += Bc[i * 4 + k] * c.K[k * 9 + j];
        P[i * 9 + j] = Jc[i * 9 + j] + acc;
      }
  }
  for (int k = 0; k < 81; ++k) Phi_[ll * 81 + k] = P[k];

  // ---- scaling from the 1-norm of Phi dt ---------------------------------
  T norm1 = T(0);
  for (int j = 0; j < 9; ++j) {
    T col = t_abs(P[j] * dt);
    for (int i = 1; i < 9; ++i) col += t_abs(P[i * 9 + j] * dt);
    norm1 = j == 0 ? col : nmax(norm1, col);
  }
  T s = t_ceil(t_log2(nmax(norm1 / T(0.5), T(1))));
  if (s != s) s = T(0);                       // nan_to_num(s, nan=0)
  s = s < T(0) ? T(0) : (s > T(MAX_DOUBLINGS) ? T(MAX_DOUBLINGS) : s);
  T us = T(1);
  for (int k = 0; k < MAX_DOUBLINGS; ++k)
    if (s > T(k)) us *= T(0.5);               // 0.5^s, s integral
  T Pu[81];
  for (int k = 0; k < 81; ++k) Pu[k] = (P[k] * dt) * us;

  // ---- Mm = e^{-Pu}, Mp = e^{+Pu}: shared Horner --------------------------
  T Mm[81], Mp[81], W[81];
  for (int k = 0; k < 81; ++k) {
    const T e = (k % 10 == 0) ? T(1) : T(0);
    Mm[k] = e;
    Mp[k] = e;
  }
  for (int m = NTERMS; m >= 1; --m) {
    const T fm = T(m);
    mm9(Pu, Mm, W);
    for (int k = 0; k < 81; ++k) Mm[k] = ((k % 10 == 0) ? T(1) : T(0)) - W[k] / fm;
    mm9(Pu, Mp, W);
    for (int k = 0; k < 81; ++k) Mp[k] = ((k % 10 == 0) ? T(1) : T(0)) + W[k] / fm;
  }

  // ---- channel series at the scaled time ----------------------------------
  T X[3][81];
  const T tus = dt * us;
  for (int ch = 0; ch < 3; ++ch) {
    const int ie = 3 + ch;
    T H[81];
    for (int k = 0; k < 81; ++k) H[k] = T(0);
    H[ie * 10] = T(1);
    for (int k = 0; k < 81; ++k) X[ch][k] = H[k];
    for (int m = 1; m <= NTERMS; ++m) {
      mm9(Pu, H, W);
      const T fm = T(m), fm1 = T(m + 1);
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j)
          H[i * 9 + j] = -(W[i * 9 + j] + W[j * 9 + i]) / fm;
      for (int k = 0; k < 81; ++k) X[ch][k] = X[ch][k] + H[k] / fm1;
    }
    for (int k = 0; k < 81; ++k) X[ch][k] = X[ch][k] * tus;
  }

  // ---- doublings (per lane, s of them) -----------------------------------
  for (int kd = 0; kd < MAX_DOUBLINGS; ++kd) {
    if (!(s > T(kd))) break;
    for (int ch = 0; ch < 3; ++ch) {
      T MX[81];
      mm9(Mm, X[ch], MX);
      mmt<9, 9, 9>(MX, Mm, W);                // MX Mm^T
      for (int k = 0; k < 81; ++k) X[ch][k] = X[ch][k] + W[k];
    }
    mm9(Mm, Mm, W);
    for (int k = 0; k < 81; ++k) Mm[k] = W[k];
    mm9(Mp, Mp, W);
    for (int k = 0; k < 81; ++k) Mp[k] = W[k];
  }
  for (int k = 0; k < 81; ++k) Mp_[ll * 81 + k] = Mp[k];

  // ---- Nt factor + trace-normalized combine ------------------------------
  const T w2t = dt * (c.noise * c.noise);
  T tr[3];
  for (int ch = 0; ch < 3; ++ch) {
    for (int k = 0; k < 81; ++k) X[ch][k] = X[ch][k] * w2t;
    T acc = X[ch][0];
    for (int i = 1; i < 9; ++i) acc += X[ch][i * 10];
    tr[ch] = t_sqrt(nmax(acc, T(1e-30)));
  }
  const T tsum = (tr[0] + tr[1]) + tr[2];
  for (int k = 0; k < 81; ++k)
    Qd_[ll * 81 + k] =
        tsum * ((X[0][k] / tr[0] + X[1][k] / tr[1]) + X[2][k] / tr[2]);

  // ---- ego ellipsoid Q1 = R diag(r^2, r^2, h^2) R^T -----------------------
  T R[9];
  rot_blocks(x + 6, R, static_cast<T*>(nullptr));
  const T ego[3] = {c.ego_r2, c.ego_r2, c.ego_h2};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T acc = (R[i * 3] * ego[0]) * R[j * 3];
      for (int k = 1; k < 3; ++k) acc += (R[i * 3 + k] * ego[k]) * R[j * 3 + k];
      Q1_[ll * 9 + i * 3 + j] = acc;
    }
}

template <typename T, int NTERMS>
int launch_tube(const TubeConsts<T>* c, int L, int n_terms, const T* x,
                const T* u, T* Qd, T* Mp, T* Phi, T* Q1, cudaStream_t stream) {
  if (n_terms != NTERMS || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (L + TUBE_THREADS - 1) / TUBE_THREADS;
  tube_stage_kernel<T, NTERMS><<<blocks, TUBE_THREADS, 0, stream>>>(
      *c, L, x, u, Qd, Mp, Phi, Q1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using frp::TubeConsts;

extern "C" {

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
