// Device code of the Riccati kernels (lqr.cu, K4 and K5): the dimensions of
// the 13-wide Riccati state [x(9), u_prev(4)] and the packed 4x4 Cholesky
// factor and solve.  The whole-iteration kernel (ipm_iteration.cu, K1)
// shares its dimensions.
#pragma once

#include "common.cuh"

namespace frp {

constexpr int NXB = 13;  // Riccati augmented state [x(9), u_prev(4)]
constexpr int NU = 4;
constexpr int NX = 9;
constexpr int NH = 30;   // corridor rows per stage (K1's layout; K4's maximum)

// packed Cholesky factors (l00 l10 l20 l30 l11 l21 l31 l22 l32 l33) of a
// 4x4 SPD matrix (row-major)
template <typename T>
__device__ void chol4(const T* A, T* f) {
  const T eps = T(1e-30);
  T l00 = t_sqrt(nmax(A[0], eps));
  T l10 = A[4] / l00;
  T l20 = A[8] / l00;
  T l30 = A[12] / l00;
  T l11 = t_sqrt(nmax(A[5] - l10 * l10, eps));
  T l21 = (A[9] - l20 * l10) / l11;
  T l31 = (A[13] - l30 * l10) / l11;
  T l22 = t_sqrt(nmax(A[10] - l20 * l20 - l21 * l21, eps));
  T l32 = (A[14] - l30 * l20 - l31 * l21) / l22;
  T l33 = t_sqrt(nmax(A[15] - l30 * l30 - l31 * l31 - l32 * l32, eps));
  f[0] = l00; f[1] = l10; f[2] = l20; f[3] = l30; f[4] = l11;
  f[5] = l21; f[6] = l31; f[7] = l22; f[8] = l32; f[9] = l33;
}

// X (4 x K) = (L L^T)^{-1} Bm (4 x K); X may alias Bm
template <int K, typename T>
__device__ void chol4_solve(const T* f, const T* Bm, T* X) {
  const T l00 = f[0], l10 = f[1], l20 = f[2], l30 = f[3], l11 = f[4];
  const T l21 = f[5], l31 = f[6], l22 = f[7], l32 = f[8], l33 = f[9];
  for (int k = 0; k < K; ++k) {
    T b0 = Bm[k], b1 = Bm[K + k], b2 = Bm[2 * K + k], b3 = Bm[3 * K + k];
    T y0 = b0 / l00;
    T y1 = (b1 - l10 * y0) / l11;
    T y2 = (b2 - l20 * y0 - l21 * y1) / l22;
    T y3 = (b3 - l30 * y0 - l31 * y1 - l32 * y2) / l33;
    T x3 = y3 / l33;
    T x2 = (y2 - l32 * x3) / l22;
    T x1 = (y1 - l21 * x2 - l31 * x3) / l11;
    T x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00;
    X[k] = x0; X[K + k] = x1; X[2 * K + k] = x2; X[3 * K + k] = x3;
  }
}

}  // namespace frp
