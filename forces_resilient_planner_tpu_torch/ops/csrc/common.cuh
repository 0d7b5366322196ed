// Helpers shared by the hand-written kernels of ops/csrc/: scalar math with
// the plain PyTorch versions' NaN semantics, small dense matrix products on
// thread-local row-major arrays, and the quadrotor rotation and continuous
// Jacobians (dynamics/quadrotor.py; ipm_pallas.py:100-215).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <limits>

namespace frp {

// ---- scalar helpers ------------------------------------------------------
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float t_cos(float x) { return cosf(x); }
__device__ __forceinline__ double t_cos(double x) { return cos(x); }
__device__ __forceinline__ float t_sin(float x) { return sinf(x); }
__device__ __forceinline__ double t_sin(double x) { return sin(x); }
__device__ __forceinline__ float t_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double t_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float t_log2(float x) { return log2f(x); }
__device__ __forceinline__ double t_log2(double x) { return log2(x); }
__device__ __forceinline__ float t_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double t_ceil(double x) { return ceil(x); }

template <typename T>
__device__ __forceinline__ T t_abs(T x) { return x < T(0) ? -x : x; }

template <typename T>
__device__ __forceinline__ bool t_finite(T x) {
  // false for +-inf and NaN (NaN compares false)
  return t_abs(x) <= std::numeric_limits<T>::max();
}

// NaN-propagating max / min (jnp.maximum / torch.clamp semantics)
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// ---- small dense linear algebra on thread-local row-major arrays ---------
// out (I x K) = a (I x J) @ b (J x K)
template <int I, int J, int K, typename T>
__device__ void mm(const T* a, const T* b, T* out) {
#pragma unroll 1
  for (int i = 0; i < I; ++i)
    for (int k = 0; k < K; ++k) {
      T acc = a[i * J] * b[k];
      for (int j = 1; j < J; ++j) acc += a[i * J + j] * b[j * K + k];
      out[i * K + k] = acc;
    }
}
// out (I x K) = a (I x J) @ b^T, b (K x J)
template <int I, int J, int K, typename T>
__device__ void mmt(const T* a, const T* b, T* out) {
  for (int i = 0; i < I; ++i)
    for (int k = 0; k < K; ++k) {
      T acc = a[i * J] * b[k * J];
      for (int j = 1; j < J; ++j) acc += a[i * J + j] * b[k * J + j];
      out[i * K + k] = acc;
    }
}
// out (I) = a (I x J) @ v
template <int I, int J, typename T>
__device__ void mv(const T* a, const T* v, T* out) {
  for (int i = 0; i < I; ++i) {
    T acc = a[i * J] * v[0];
    for (int j = 1; j < J; ++j) acc += a[i * J + j] * v[j];
    out[i] = acc;
  }
}
// out (I) = a^T v, a (J x I)
template <int I, int J, typename T>
__device__ void mtv(const T* a, const T* v, T* out) {
  for (int i = 0; i < I; ++i) {
    T acc = a[i] * v[0];
    for (int j = 1; j < J; ++j) acc += a[j * I + i] * v[j];
    out[i] = acc;
  }
}

// ---- dynamics (dynamics/quadrotor.py; ipm_pallas.py:100-215) -------------
// R = Rz Ry Rx and, when dR is non-null, its three angle derivatives
// (dR[0..8] roll, dR[9..17] pitch, dR[18..26] yaw)
template <typename T>
__device__ void rot_blocks(const T* rpy, T* R, T* dR) {
  const T o = T(1), z = T(0);
  const T cr = t_cos(rpy[0]), sr = t_sin(rpy[0]);
  const T cp = t_cos(rpy[1]), sp = t_sin(rpy[1]);
  const T cy = t_cos(rpy[2]), sy = t_sin(rpy[2]);
  const T Rx[9] = {o, z, z, z, cr, -sr, z, sr, cr};
  const T Ry[9] = {cp, z, sp, z, o, z, -sp, z, cp};
  const T Rz[9] = {cy, -sy, z, sy, cy, z, z, z, o};
  T RyRx[9];
  mm<3, 3, 3>(Ry, Rx, RyRx);
  mm<3, 3, 3>(Rz, RyRx, R);
  if (dR != nullptr) {
    const T dRx[9] = {z, z, z, z, -sr, -cr, z, cr, -sr};
    const T dRy[9] = {-sp, z, cp, z, z, z, -cp, z, -sp};
    const T dRz[9] = {-sy, -cy, z, cy, -sy, z, z, z, z};
    T t[9];
    mm<3, 3, 3>(Ry, dRx, t);
    mm<3, 3, 3>(Rz, t, dR);
    mm<3, 3, 3>(dRy, Rx, t);
    mm<3, 3, 3>(Rz, t, dR + 9);
    mm<3, 3, 3>(dRz, RyRx, dR + 18);
  }
}

// continuous Jacobians Jc (9x9), Bc (9x4) at state x (9), input u (4);
// rotor drag diag(drag, drag, 0) in the body frame
template <typename T>
__device__ __noinline__ void cont_jac(const T* x, const T* u, const T mass,
                                      const T drag, T* Jc, T* Bc) {
  const T* vel = x + 3;
  T R[9], dR[27];
  rot_blocks(x + 6, R, dR);
  const T D[3] = {drag, drag, T(0)};
  T RD[9], RDRt[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) RD[3 * i + j] = R[3 * i + j] * D[j];
  mmt<3, 3, 3>(RD, R, RDRt);
  const T Tm = u[3] / mass;
  T dv_drpy[9];
  for (int a = 0; a < 3; ++a) {
    const T* dRa = dR + 9 * a;
    T dRD[9], m1[9], m2[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) dRD[3 * i + j] = dRa[3 * i + j] * D[j];
    mmt<3, 3, 3>(dRD, R, m1);
    mmt<3, 3, 3>(RD, dRa, m2);
    for (int i = 0; i < 3; ++i) {
      T s = T(0);
      for (int j = 0; j < 3; ++j) s += (m1[3 * i + j] + m2[3 * i + j]) * vel[j];
      dv_drpy[3 * i + a] = dRa[3 * i + 2] * Tm - s;
    }
  }
  for (int k = 0; k < 81; ++k) Jc[k] = T(0);
  for (int k = 0; k < 36; ++k) Bc[k] = T(0);
  for (int i = 0; i < 3; ++i) {
    Jc[i * 9 + 3 + i] = T(1);
    for (int k = 0; k < 3; ++k) {
      Jc[(3 + i) * 9 + 3 + k] = -RDRt[3 * i + k];
      Jc[(3 + i) * 9 + 6 + k] = dv_drpy[3 * i + k];
    }
    Bc[(3 + i) * 4 + 3] = R[3 * i + 2] / mass;
    Bc[(6 + i) * 4 + i] = T(1);
  }
}

}  // namespace frp
