// One whole monotone interior-point iteration per scenario lane (Hopper).
//
// Replaces forces_resilient_planner_tpu/ops/ipm_pallas.py::_iter_kernel
// (the Pallas TPU kernel behind ipm_iteration_fused).  It computes, per
// lane: the RK2 dynamics residual and Jacobians of every stage, the cost
// gradient, the 64 inequality rows per stage, the scaled KKT errors, the
// gated barrier update, the right-hand side, the Riccati factor on the
// 13-wide augmented state (packed 4x4 Cholesky factors), the backsolve and
// forward rollout, the fraction-to-boundary step lengths, the NaN guard
// and the masked state update.  The plain PyTorch version of the same step
// is ops/ipm_kernel.py::ipm_iteration_reference (= solver/ipm_lanes.py::
// lane_step); the NaN guard follows it (finiteness of the stepped Z and s).
//
// What bounds it: a lane reads 5,757 values and writes 3,164 (N = 20), so
// the least time is set by HBM bytes (~44 us at B = 4096, f32); the
// arithmetic (~1.6 GFLOP at B = 4096, mostly the Riccati factor's 13x13
// products) would take ~25 us.  In practice a lane's serial path (the
// Riccati recursion over 20 stages) sets the time; the design shortens it
// and runs many lanes at once:
//  * a team of 64 threads (two warps) per lane, up to 4 lanes per CTA at
//    consecutive b (one CTA per SM: the lanes' stacks fill its shared
//    memory).  The CTA copies its lanes' inputs (lane-minor, element
//    [row * B + b]) into shared memory with cp.async, neighbouring threads
//    on neighbouring b, and copies the outputs back the same way;
//  * each lane's whole working set lives in dynamic shared memory
//    (lane_layout below: ~51 KB at N = 20, f32), no global scratch.  P is
//    stored as its upper triangle (it is exactly symmetric), Ax/Bx instead
//    of the augmented Abar/Bbar, sigma = mu_d / s and r_g recomputed
//    where they are used, ds and dmu recomputed from dZ, each stage's QP
//    blocks as their 24 distinct values;
//  * stage-parallel phases split their (stage, row) tasks over the team;
//    each Riccati product gives a thread one output row or column, split
//    between the two warps, its sums advancing together over the inner
//    index (independent chains) and each summed in the plain version's
//    order; a named barrier of the team's two warps between dependent
//    products; the 4x4 Cholesky factors keep reciprocal diagonals, so the
//    solves on the serial path multiply instead of divide;
//  * reductions are warp shuffles in a fixed tree, NaN-propagating like
//    jnp.maximum / jnp.min, then the two warps' values combined in a fixed
//    order.  A lane's result depends neither on its slot in the CTA nor on
//    B (the tiered solver's bit-exactness rests on that);
//  * lanes whose loop condition is false, and lanes that converge this
//    iteration, stop after the phase that decides it (their outputs do
//    not depend on the rest);
//  * the augmented dynamics multiply through their zero blocks, as the
//    plain version does, so 0 * inf = NaN trips the NaN guard on the same
//    lanes; templated on T (float on the main path, double for checks);
//    built without fast math.
#include "riccati.cuh"

#if !defined(__CUDA_ARCH__)
// the team barrier outside device code: defined only by the host stand-in
// of tests/cuda_emu, which runs this source on the CPU
__device__ void frp_team_barrier(int id, int count);
#endif

namespace frp {

constexpr int NZ = 17;   // stage variables [u(4), u_prev(4), x(9)]
constexpr int NIN = 64;  // inequality rows: 17 lb + 17 ub + 30 corridor
constexpr int WARP = 32;
constexpr int TEAM = 2 * WARP;   // threads per lane: two warps
constexpr int MAX_LANES = 4;     // lanes per CTA (ops/ipm_kernel.py)
constexpr int RED = 16;          // reduction slots per warp
constexpr int N_INPUTS = 17;
constexpr int N_OUTPUTS = 5;
constexpr int NTRI = NXB * (NXB + 1) / 2;  // packed upper triangle of P

template <typename T>
struct IterConsts {
  T mass, g, drag, dt, rmax2, hu, tol, mu_floor, tol_ref, tau,
      mu_gate_factor, kappa_mu, reg;
  T lb[NZ];
  T ub[NZ];
  int mu_gate;
};

// ---- one lane's shared-memory layout (elements of T) ----------------------
// The inputs first, in argument order, so that the load and the store walk
// one table; ops/ipm_kernel.py::lane_elements mirrors the total.
__host__ __device__ __forceinline__ int input_rows(int a, int N) {
  switch (a) {
    case 0: return NZ * N;             // Z
    case 1: return NXB * N;            // lam
    case 2: case 3: return NIN * N;    // s, mu_d
    case 4: return 4;                  // scal = [mu, it, done, err]
    case 10: return 3 * N;             // ref_pos
    case 12: return NH * 3 * N;        // corridor A
    case 13: return NH * N;            // corridor b
    case 14: return 3;                 // f_ext
    case 15: return NX;                // xinit
    case 16: return 1;                 // max_iters
    default: return N;                 // the 5 weight tables, ref_yaw
  }
}

struct Layout {
  int Z, lam, s, mud, scal, w, refp, refy, A, bcor, fext, xinit, maxit;
  int bnd, red, Ax, Bx, c, gq, qa, P, K, cRh, RiS, cRt, kk, pn, scr, total;
};

__host__ __device__ inline Layout lane_layout(int N) {
  Layout L;
  const int n1 = N - 1;
  int off = 0;
  auto take = [&](int count) { const int o = off; off += count; return o; };
  L.Z = take(NZ * N);
  L.lam = take(NXB * N);
  L.s = take(NIN * N);
  L.mud = take(NIN * N);
  L.scal = take(4);
  L.w = take(5 * N);
  L.refp = take(3 * N);
  L.refy = take(N);
  L.A = take(NH * 3 * N);
  L.bcor = take(NH * N);
  L.fext = take(3);
  L.xinit = take(NX);
  L.maxit = take(1);
  L.bnd = take(2 * NZ);      // lb, ub
  L.red = take(2 * RED);     // the two warps' partial reductions
  L.Ax = take(n1 * NX * NX);
  L.Bx = take(n1 * NX * NU);
  L.c = take(n1 * NXB);
  L.gq = take(N * NZ);       // grad f, then q, then dZ
  L.qa = take(N * (NXB + 6 + NU + 1));  // the stage QP blocks (QA values)
  L.P = take(N * NTRI);
  L.K = take(n1 * NU * NXB);
  L.cRh = take(n1 * 10);
  L.RiS = take(NU * NXB);
  L.cRt = take(10);
  L.kk = take(n1 * NU);
  L.pn = take(N * NXB);      // p, then the costates nu
  // phase scratch: the factor's stage blocks, or the RHS's corridor rows
  const int fac = 3 * NXB * NXB + NU * NU + 2 * NU * NXB;
  L.scr = take(fac > NH * N ? fac : NH * N);
  L.total = off;
  return L;
}

// one lane's view of its shared memory: a base and the horizon; each stack's
// address is recomputed from them where it is used (a few integer
// operations), so no pointer table is held in registers
template <typename T>
struct LaneMem {
  T* base;
  int N;
  __device__ __forceinline__ T* Z() const { return base + lane_layout(N).Z; }
  __device__ __forceinline__ T* lam() const { return base + lane_layout(N).lam; }
  __device__ __forceinline__ T* s() const { return base + lane_layout(N).s; }
  __device__ __forceinline__ T* mud() const { return base + lane_layout(N).mud; }
  __device__ __forceinline__ T* scal() const { return base + lane_layout(N).scal; }
  __device__ __forceinline__ T* w() const { return base + lane_layout(N).w; }
  __device__ __forceinline__ T* refp() const { return base + lane_layout(N).refp; }
  __device__ __forceinline__ T* refy() const { return base + lane_layout(N).refy; }
  __device__ __forceinline__ T* A() const { return base + lane_layout(N).A; }
  __device__ __forceinline__ T* bcor() const { return base + lane_layout(N).bcor; }
  __device__ __forceinline__ T* fext() const { return base + lane_layout(N).fext; }
  __device__ __forceinline__ T* xinit() const { return base + lane_layout(N).xinit; }
  __device__ __forceinline__ T* maxit() const { return base + lane_layout(N).maxit; }
  __device__ __forceinline__ T* bnd() const { return base + lane_layout(N).bnd; }
  __device__ __forceinline__ T* red() const { return base + lane_layout(N).red; }
  __device__ __forceinline__ T* Ax() const { return base + lane_layout(N).Ax; }
  __device__ __forceinline__ T* Bx() const { return base + lane_layout(N).Bx; }
  __device__ __forceinline__ T* c() const { return base + lane_layout(N).c; }
  __device__ __forceinline__ T* gq() const { return base + lane_layout(N).gq; }
  __device__ __forceinline__ T* qa() const { return base + lane_layout(N).qa; }
  __device__ __forceinline__ T* P() const { return base + lane_layout(N).P; }
  __device__ __forceinline__ T* K() const { return base + lane_layout(N).K; }
  __device__ __forceinline__ T* cRh() const { return base + lane_layout(N).cRh; }
  __device__ __forceinline__ T* RiS() const { return base + lane_layout(N).RiS; }
  __device__ __forceinline__ T* cRt() const { return base + lane_layout(N).cRt; }
  __device__ __forceinline__ T* kk() const { return base + lane_layout(N).kk; }
  __device__ __forceinline__ T* pn() const { return base + lane_layout(N).pn; }
  __device__ __forceinline__ T* scr() const { return base + lane_layout(N).scr; }
};

// index of P[r][c] in the packed upper triangle of a stage
__device__ __forceinline__ int tri(int r, int c) {
  if (r > c) { const int t = r; r = c; c = t; }
  return r * NXB - (r * (r - 1)) / 2 + (c - r);
}

// Abar = [[Ax, 0], [0, 0]] and Bbar = [[Bx], [I4]] entries from Ax, Bx
template <typename T>
__device__ __forceinline__ T abar(const T* Ax, int r, int c) {
  return (r < NX && c < NX) ? Ax[r * NX + c] : T(0);
}
template <typename T>
__device__ __forceinline__ T bbar(const T* Bx, int r, int k) {
  return r < NX ? Bx[r * NU + k] : (r - NX == k ? T(1) : T(0));
}

// |x| with |-0| = +0 (the plain version's abs), NaN kept
__device__ __forceinline__ float t_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_fabs(double x) { return fabs(x); }

// ---- phase clocks (tools/k1_phase_probe.py builds with FRP_K1_CLOCKS) ------
// clock64() of lane 0's thread 0 at the phase boundaries of one launch
#ifdef FRP_K1_CLOCKS
constexpr int N_CLOCKS = 16;
__device__ long long k1_clocks[N_CLOCKS];
#define K1_CLOCK(k)                                              \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) k1_clocks[k] = clock64(); \
  } while (0)
#else
#define K1_CLOCK(k) \
  do {              \
  } while (0)
#endif

// ---- packed 4x4 Cholesky with reciprocal diagonal --------------------------
// [1/l00 l10 l20 l30 1/l11 l21 l31 1/l22 l32 1/l33]: riccati.cuh::chol4's
// factor with each diagonal entry stored as its reciprocal, so that the
// solves, on the Riccati sweep's serial path, multiply instead of divide
template <typename T>
__device__ __forceinline__ void chol4_rcp(const T* A, T* f) {
  const T eps = T(1e-30);
  const T r00 = T(1) / t_sqrt(nmax(A[0], eps));
  const T l10 = A[4] * r00, l20 = A[8] * r00, l30 = A[12] * r00;
  const T r11 = T(1) / t_sqrt(nmax(A[5] - l10 * l10, eps));
  const T l21 = (A[9] - l20 * l10) * r11, l31 = (A[13] - l30 * l10) * r11;
  const T r22 = T(1) / t_sqrt(nmax(A[10] - l20 * l20 - l21 * l21, eps));
  const T l32 = (A[14] - l30 * l20 - l31 * l21) * r22;
  const T r33 =
      T(1) / t_sqrt(nmax(A[15] - l30 * l30 - l31 * l31 - l32 * l32, eps));
  f[0] = r00; f[1] = l10; f[2] = l20; f[3] = l30; f[4] = r11;
  f[5] = l21; f[6] = l31; f[7] = r22; f[8] = l32; f[9] = r33;
}

// x = (L L^T)^{-1} b for one right-hand side; x may alias b
template <typename T>
__device__ __forceinline__ void chol4_rcp_solve(const T* f, const T* b, T* x) {
  const T r00 = f[0], l10 = f[1], l20 = f[2], l30 = f[3], r11 = f[4];
  const T l21 = f[5], l31 = f[6], r22 = f[7], l32 = f[8], r33 = f[9];
  const T y0 = b[0] * r00;
  const T y1 = (b[1] - l10 * y0) * r11;
  const T y2 = (b[2] - l20 * y0 - l21 * y1) * r22;
  const T y3 = (b[3] - l30 * y0 - l31 * y1 - l32 * y2) * r33;
  const T x3 = y3 * r33;
  const T x2 = (y2 - l32 * x3) * r22;
  const T x1 = (y1 - l21 * x2 - l31 * x3) * r11;
  const T x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) * r00;
  x[0] = x0; x[1] = x1; x[2] = x2; x[3] = x3;
}

// ---- the team: barrier and reductions -------------------------------------
// barrier of one lane's team (named barrier 1 + its slot in the CTA)
__device__ __forceinline__ void team_sync() {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;" ::"r"(1 + int(threadIdx.x) / TEAM),
               "n"(TEAM) : "memory");
#else
  ::frp_team_barrier(1 + int(threadIdx.x) / TEAM, TEAM);
#endif
}

// warp trees (NaN-propagating max/min like jnp.maximum / jnp.min, fixed
// order sums); lane 0 of each warp holds the warp's value
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = WARP / 2; off > 0; off /= 2)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = WARP / 2; off > 0; off /= 2)
    v = nmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = WARP / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the team's two warp values of slot k, combined as op(warp 0, warp 1):
// every thread gets the same bits.  The caller's lane 0s wrote red[k] and
// red[RED + k] before a team_sync().
template <typename T>
__device__ __forceinline__ T team_max2(const T* red, int k) {
  return nmax(red[k], red[RED + k]);
}
template <typename T>
__device__ __forceinline__ T team_min2(const T* red, int k) {
  return nmin(red[k], red[RED + k]);
}

// ---- 3x3 helpers, fully unrolled (registers, no local memory) -------------
template <typename T>
__device__ __forceinline__ void mm3(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[3 * i + k] = a[3 * i] * b[k] + a[3 * i + 1] * b[3 + k] +
                       a[3 * i + 2] * b[6 + k];
}

// rotation R = Rz Ry Rx (common.cuh::rot_blocks' products)
template <typename T>
__device__ __forceinline__ void rot(const T* rpy, T* R) {
  const T o = T(1), z = T(0);
  const T cr = t_cos(rpy[0]), sr = t_sin(rpy[0]);
  const T cp = t_cos(rpy[1]), sp = t_sin(rpy[1]);
  const T cy = t_cos(rpy[2]), sy = t_sin(rpy[2]);
  const T Rx[9] = {o, z, z, z, cr, -sr, z, sr, cr};
  const T Ry[9] = {cp, z, sp, z, o, z, -sp, z, cp};
  const T Rz[9] = {cy, -sy, z, sy, cy, z, z, z, o};
  T RyRx[9];
  mm3(Ry, Rx, RyRx);
  mm3(Rz, RyRx, R);
}

// continuous dynamics xdot (9) (nonlinear_dynamics.m:20-40)
template <typename T>
__device__ __forceinline__ void xdot(const T* x, const T* u, const T* f,
                                     const T* R, const IterConsts<T>& c,
                                     T* out) {
  const T* vel = x + 3;
  const T thrust_m = u[3] / c.mass;
  const T vb0 = R[0] * vel[0] + R[3] * vel[1] + R[6] * vel[2];
  const T vb1 = R[1] * vel[0] + R[4] * vel[1] + R[7] * vel[2];
  const T dv0 = c.drag * vb0, dv1 = c.drag * vb1, dv2 = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T drag = R[3 * i] * dv0 + R[3 * i + 1] * dv1 + R[3 * i + 2] * dv2;
    const T ge3 = i == 2 ? c.g : T(0);
    out[i] = vel[i];
    out[3 + i] = R[3 * i + 2] * thrust_m + f[i] - ge3 - drag;
    out[6 + i] = u[i];
  }
}

// The non-constant parts of the continuous Jacobians at (x, u)
// (common.cuh::cont_jac): Jc = [[0, I, 0], [0, M, V], [0, 0, 0]],
// Bc = [[0], [b e4^T], [I3, 0]]; out = [M (3x3), V (3x3), b (3)].
template <typename T>
__device__ __forceinline__ void jac_parts(const T* x, const T* u, const IterConsts<T>& c,
                          T* out) {
  const T* vel = x + 3;
  const T o = T(1), z = T(0);
  const T cr = t_cos(x[6]), sr = t_sin(x[6]);
  const T cp = t_cos(x[7]), sp = t_sin(x[7]);
  const T cy = t_cos(x[8]), sy = t_sin(x[8]);
  const T Rx[9] = {o, z, z, z, cr, -sr, z, sr, cr};
  const T Ry[9] = {cp, z, sp, z, o, z, -sp, z, cp};
  const T Rz[9] = {cy, -sy, z, sy, cy, z, z, z, o};
  T RyRx[9], R[9];
  mm3(Ry, Rx, RyRx);
  mm3(Rz, RyRx, R);
  const T D[3] = {c.drag, c.drag, T(0)};
  T RD[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) RD[3 * i + j] = R[3 * i + j] * D[j];
  // M = -R diag(D) R^T
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[3 * i + k] = -(RD[3 * i] * R[3 * k] + RD[3 * i + 1] * R[3 * k + 1] +
                         RD[3 * i + 2] * R[3 * k + 2]);
  const T Tm = u[3] / c.mass;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T dRa[9], t9[9];
    if (a == 0) {
      const T dRx[9] = {z, z, z, z, -sr, -cr, z, cr, -sr};
      mm3(Ry, dRx, t9);
      mm3(Rz, t9, dRa);
    } else if (a == 1) {
      const T dRy[9] = {-sp, z, cp, z, z, z, -cp, z, -sp};
      mm3(dRy, Rx, t9);
      mm3(Rz, t9, dRa);
    } else {
      const T dRz[9] = {-sy, -cy, z, cy, -sy, z, z, z, z};
      mm3(dRz, RyRx, dRa);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // m1 = (dRa diag(D)) R^T, m2 = RD dRa^T
        const T m1 = (dRa[3 * i] * D[0]) * R[3 * j] +
                     (dRa[3 * i + 1] * D[1]) * R[3 * j + 1] +
                     (dRa[3 * i + 2] * D[2]) * R[3 * j + 2];
        const T m2 = RD[3 * i] * dRa[3 * j] + RD[3 * i + 1] * dRa[3 * j + 1] +
                     RD[3 * i + 2] * dRa[3 * j + 2];
        s += (m1 + m2) * vel[j];
      }
      out[9 + 3 * i + a] = dRa[3 * i + 2] * Tm - s;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) out[18 + i] = R[3 * i + 2] / c.mass;
}

// dense entries of Jc and Bc from jac_parts' output p (r, j, k known at
// compile time in the unrolled products below: constants or registers)
template <typename T>
__device__ __forceinline__ T jc(const T* p, int r, int j) {
  if (r < 3) return j == 3 + r ? T(1) : T(0);
  if (r < 6 && j >= 3) return j < 6 ? p[3 * (r - 3) + j - 3] : p[9 + 3 * (r - 3) + j - 6];
  return T(0);
}
template <typename T>
__device__ __forceinline__ T bc(const T* p, int r, int k) {
  if (r >= 3 && r < 6) return k == 3 ? p[18 + r - 3] : T(0);
  if (r >= 6) return k == r - 6 ? T(1) : T(0);
  return T(0);
}

// ---- phase 0: dynamics linearization, one stage per thread -----------------
// residual c, then Ax = I + dt/2 (J1 + J2 + dt J2 J1) and
// Bx = dt/2 (B1 + B2 + dt J2 B1) with the products dense (zeros included,
// as the plain version multiplies them), all in registers
template <typename T>
__device__ __forceinline__ void dynamics(const LaneMem<T>& m,
                                         const IterConsts<T>& c, int t) {
  const int N = m.N;
  const T dt = c.dt, hdt = T(0.5) * c.dt;
  for (int i = t; i < N - 1; i += TEAM) {
    const T* zi = m.Z() + i * NZ;
    const T* zn = m.Z() + (i + 1) * NZ;
    T x[9], u[4], xm[9], p1[21], p2[21];
#pragma unroll
    for (int k = 0; k < 9; ++k) x[k] = zi[8 + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = zi[k];
    {
      T k1[9], k2[9], R[9];
      rot(x + 6, R);
      xdot(x, u, m.fext(), R, c, k1);
#pragma unroll
      for (int k = 0; k < 9; ++k) xm[k] = x[k] + dt * k1[k];
      rot(xm + 6, R);
      xdot(xm, u, m.fext(), R, c, k2);
      T* ci = m.c() + i * NXB;
#pragma unroll
      for (int k = 0; k < 9; ++k) ci[k] = (x[k] + hdt * (k1[k] + k2[k])) - zn[8 + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) ci[9 + k] = u[k] - zn[4 + k];
    }
    jac_parts(x, u, c, p1);
    jac_parts(xm, u, c, p2);
    T* Ax = m.Ax() + i * NX * NX;
    T* Bx = m.Bx() + i * NX * NU;
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        T acc = jc(p2, r, 0) * jc(p1, 0, k);
#pragma unroll
        for (int j = 1; j < NX; ++j) acc += jc(p2, r, j) * jc(p1, j, k);
        Ax[r * NX + k] = (r == k ? T(1) : T(0)) +
                         hdt * (jc(p1, r, k) + jc(p2, r, k) + dt * acc);
      }
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        T acc = jc(p2, r, 0) * bc(p1, 0, k);
#pragma unroll
        for (int j = 1; j < NX; ++j) acc += jc(p2, r, j) * bc(p1, j, k);
        Bx[r * NU + k] = hdt * (bc(p1, r, k) + bc(p2, r, k) + dt * acc);
      }
    }
  }
}

// ---- phases 1-3: gradient, residuals, KKT errors, barrier update ----------
// inequality row k of stage i: g = [lb - z, z - ub, A p - b - hu], written
// without branches (every operand loaded, the row's kind selected)
template <typename T>
__device__ __forceinline__ T ineq_g(const LaneMem<T>& m, const IterConsts<T>& c,
                                    int i, int k) {
  const T* z = m.Z() + i * NZ;
  const bool is_lb = k < NZ, is_box = k < 2 * NZ;
  const T zk = z[is_lb ? k : (is_box ? k - NZ : 0)];
  const T bnd = m.bnd()[is_box ? k : 0];
  const int h = is_box ? 0 : k - 2 * NZ;
  const T* a = m.A() + (i * NH + h) * 3;
  const T cor = (a[0] * z[8] + a[1] * z[9] + a[2] * z[10]) - m.bcor()[i * NH + h] - c.hu;
  return is_lb ? bnd - zk : (is_box ? zk - bnd : cor);
}

// inequality row k of every stage is the team's thread k
static_assert(NIN == TEAM, "one thread per inequality row of a stage");

template <typename T>
struct Errors {
  T ineq, comp, comp0, habs, lam_sum, mud_sum, lam_max, mud_max, eq, stat;
};

template <typename T>
__device__ __forceinline__ Errors<T> residuals(const LaneMem<T>& m,
                                               const IterConsts<T>& c, T mu,
                                               int t) {
  const int N = m.N;
  const T ninf = -std::numeric_limits<T>::infinity();
  Errors<T> e{ninf, ninf, ninf, ninf, T(0), T(0), ninf, ninf, ninf, ninf};
  const T *wwp = m.w(), *win = m.w() + N, *wrt = m.w() + 2 * N, *wvl = m.w() + 3 * N,
          *wup = m.w() + 4 * N;
  // cost gradient and |H| |z| row maxima
  for (int task = t; task < N * NZ; task += TEAM) {
    const int i = task / NZ, k = task % NZ;
    const T* z = m.Z() + i * NZ;
    const T wp = wwp[i], wr = wrt[i], wi = win[i], wu = wup[i], wv = wvl[i];
    T gf, h = ninf;
    if (k < 4) {
      gf = T(2) * wr * (z[k] - z[4 + k]);
      h = T(2) * wr * (t_fabs(z[k]) + t_fabs(z[4 + k]));
      if (k < 3) {
        gf = gf + T(2) * (wi / c.rmax2) * z[k];
        h = h + T(2) * (wi / c.rmax2) * t_fabs(z[k]);
      }
    } else if (k < 8) {
      const int q = k - 4;
      gf = T(2) * wr * (z[k] - z[q]);
      h = T(2) * wr * (t_fabs(z[k]) + t_fabs(z[q]));
      if (q < 3) {
        gf = gf + T(2) * wu * z[k];
        h = h + T(2) * wu * t_fabs(z[k]);
      }
    } else if (k < 11) {
      gf = T(2) * wp * (z[k] - m.refp()[i * 3 + k - 8]);
      h = T(2) * t_fabs(wp) * t_fabs(z[k]);
    } else if (k < 14) {
      gf = T(2) * wv * z[k];
      h = T(2) * t_fabs(wv) * t_fabs(z[k]);
    } else if (k < 16) {
      gf = T(0);
    } else {
      gf = T(24) * wp * (z[16] - m.refy()[i]);
      h = T(24) * wp * t_fabs(z[16]);
    }
    m.gq()[task] = gf;
    e.habs = nmax(e.habs, h);
  }
  // inequality rows
  for (int i = 0; i < N; ++i) {
    const int task = i * NIN + t;
    const T si = m.s()[task], mdi = m.mud()[task];
    const T rg = ineq_g(m, c, i, t) + si;
    e.ineq = nmax(e.ineq, t_fabs(rg));
    const T smd = si * mdi;
    e.comp = nmax(e.comp, t_fabs(smd - mu));
    e.comp0 = nmax(e.comp0, t_fabs(smd));
    e.mud_sum += t_fabs(mdi);
    e.mud_max = nmax(e.mud_max, t_fabs(mdi));
  }
  for (int task = t; task < N * NXB; task += TEAM) {
    const T l = m.lam()[task];
    e.lam_sum += t_fabs(l);
    e.lam_max = nmax(e.lam_max, t_fabs(l));
  }
  for (int task = t; task < (N - 1) * NXB; task += TEAM)
    e.eq = nmax(e.eq, t_fabs(m.c()[task]));
  if (t < NX) e.eq = nmax(e.eq, t_fabs(m.Z()[8 + t] - m.xinit()[t]));
  return e;
}

// stationarity grad f + J_eq^T lam + J_g^T mu_d, max |.| over this thread's
// (stage, row) tasks
template <typename T>
__device__ __forceinline__ T stationarity(const LaneMem<T>& m, int t) {
  const int N = m.N;
  T stat = -std::numeric_limits<T>::infinity();
  for (int task = t; task < N * NZ; task += TEAM) {
    const int i = task / NZ, k = task % NZ;
    const T* md = m.mud() + i * NIN;
    T r = m.gq()[task] - md[k] + md[NZ + k];
    if (k >= 8 && k < 11) {
      const T* a = m.A() + i * NH * 3 + (k - 8);
      T acc = a[0] * md[34];
      for (int h = 1; h < NH; ++h) acc += a[3 * h] * md[34 + h];
      r += acc;
    }
    if (i < N - 1) {
      const T* lx = m.lam() + (i + 1) * NXB;
      if (k < NU) {
        const T* Bx = m.Bx() + i * NX * NU;
        T acc = Bx[k] * lx[0];
        for (int j = 1; j < NX; ++j) acc += Bx[j * NU + k] * lx[j];
        r = r + acc + lx[NX + k];
      } else if (k >= 8) {
        const T* Ax = m.Ax() + i * NX * NX;
        T acc = Ax[k - 8] * lx[0];
        for (int j = 1; j < NX; ++j) acc += Ax[j * NX + k - 8] * lx[j];
        r += acc;
      }
    }
    if (i > 0) {
      if (k >= 4 && k < 8) r -= m.lam()[i * NXB + NX + k - 4];
      else if (k >= 8) r -= m.lam()[i * NXB + k - 8];
    } else if (k >= 8) {
      r += m.lam()[k - 8];
    }
    stat = nmax(stat, t_fabs(r));
  }
  return stat;
}

// ---- phase 4: RHS q = grad f + J_g^T (mu_n / s + sigma r_g) ----------------
template <typename T>
__device__ __forceinline__ T barrier_w(const LaneMem<T>& m, const IterConsts<T>& c,
                                       T mu_n, int i, int k) {
  const int e = i * NIN + k;
  const T si = m.s()[e], inv = T(1) / si;
  return mu_n * inv + (m.mud()[e] * inv) * (ineq_g(m, c, i, k) + si);
}

template <typename T>
__device__ __forceinline__ void rhs_rows(const LaneMem<T>& m,
                                         const IterConsts<T>& c, T mu_n, int t) {
  for (int task = t; task < m.N * NH; task += TEAM) {
    const int i = task / NH, h = task % NH;
    m.scr()[task] = barrier_w(m, c, mu_n, i, 2 * NZ + h);
  }
}

template <typename T>
__device__ __forceinline__ void rhs(const LaneMem<T>& m, const IterConsts<T>& c,
                                    T mu_n, int t) {
  for (int task = t; task < m.N * NZ; task += TEAM) {
    const int i = task / NZ, k = task % NZ;
    T q = m.gq()[task] - barrier_w(m, c, mu_n, i, k) +
          barrier_w(m, c, mu_n, i, NZ + k);
    if (k >= 8 && k < 11) {
      const T* a = m.A() + i * NH * 3 + (k - 8);
      const T* wv = m.scr() + i * NH;
      T acc = a[0] * wv[0];
      for (int h = 1; h < NH; ++h) acc += a[3 * h] * wv[h];
      q += acc;
    }
    m.gq()[task] = q;
  }
}

// q in the Riccati partition: qx = [q_x (9), q_uprev (4)], qu = q_u
template <typename T>
__device__ __forceinline__ T qx_of(const T* q, int k) {
  return k < NX ? q[8 + k] : q[4 + k - NX];
}

// ---- phase 5: the stage QP blocks, then the Riccati factor -----------------
// Each stage's barrier-weighted blocks (riccati.cuh::assemble_stage) are
// kept as their QA distinct values: Q's diagonal without the corridor
// block (13), the corridor block's 6 sums for l >= j (mirrored, in the
// plain version's order), R's diagonal (4) and S's one value -2 w_rate.
constexpr int QA = NXB + 6 + NU + 1;

template <typename T>
__device__ __forceinline__ void assemble_stages(const LaneMem<T>& m,
                                                const IterConsts<T>& c, int t) {
  const int N = m.N;
  for (int i = t; i < N; i += TEAM) {
    const T* s = m.s() + i * NIN;
    const T* md = m.mud() + i * NIN;
    const T wwp = m.w()[i], win = m.w()[N + i], wrt = m.w()[2 * N + i],
            wvl = m.w()[3 * N + i], wup = m.w()[4 * N + i];
    T* qa = m.qa() + i * QA;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T xd = (md[8 + k] / s[8 + k] + md[25 + k] / s[25 + k]) + c.reg;
      if (k < 3) xd += T(2) * wwp;
      else if (k < 6) xd += T(2) * wvl;
      else if (k == 8) xd += T(24) * wwp;
      qa[k] = xd;
    }
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      T up = T(2) * wrt + (md[4 + k] / s[4 + k] + md[21 + k] / s[21 + k]) + c.reg;
      if (k < 3) up += T(2) * wup;
      qa[NX + k] = up;
      T r = T(2) * wrt + (md[k] / s[k] + md[17 + k] / s[17 + k]) + c.reg;
      if (k < 3) r += T(2) * win / c.rmax2;
      qa[NXB + 6 + k] = r;
    }
    qa[QA - 1] = -T(2) * wrt;
    const T* Ai = m.A() + i * NH * 3;
    T acc[6];
    {
      const T sc = md[34] / s[34];
#pragma unroll
      for (int j = 0, n = 0; j < 3; ++j)
#pragma unroll
        for (int l = j; l < 3; ++l, ++n) acc[n] = (Ai[j] * sc) * Ai[l];
    }
    for (int k = 1; k < NH; ++k) {
      const T sc = md[34 + k] / s[34 + k];
      const T a0 = Ai[3 * k], a1 = Ai[3 * k + 1], a2 = Ai[3 * k + 2];
      const T as[3] = {a0 * sc, a1 * sc, a2 * sc};
      const T av[3] = {a0, a1, a2};
#pragma unroll
      for (int j = 0, n = 0; j < 3; ++j)
#pragma unroll
        for (int l = j; l < 3; ++l, ++n) acc[n] += as[j] * av[l];
    }
#pragma unroll
    for (int n = 0; n < 6; ++n) qa[NXB + n] = acc[n];
  }
}

// stage blocks from their distinct values
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

// factor scratch: two full 13x13 buffers that take turns holding P_{i+1}
// and Qh (then Pn, then P_i), AtP (13x13), Rh (4x4), Sh, BtP (4x13)
constexpr int NN = NXB * NXB;
template <typename T>
struct FacScratch {
  T* base;
  __device__ __forceinline__ T* buf(int k) const { return base + k * NN; }
  __device__ __forceinline__ T* AtP() const { return base + 2 * NN; }
  __device__ __forceinline__ T* Rh() const { return base + 3 * NN; }
  __device__ __forceinline__ T* Sh() const { return base + 3 * NN + NU * NU; }
  __device__ __forceinline__ T* BtP() const {
    return base + 3 * NN + NU * NU + NU * NXB;
  }
};

// terminal stage: P = Q - S^T R^{-1} S into buf(0), RiS = R^{-1} S
template <typename T>
__device__ __forceinline__ void factor_terminal(const LaneMem<T>& m,
                                                const FacScratch<T>& f, int t) {
  const int i = m.N - 1;
  const T* qa = m.qa() + i * QA;
  T R[NU * NU], fR[10];
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int c = 0; c < NU; ++c) R[r * NU + c] = r_of(qa, r, c);
  chol4_rcp(R, fR);
  if (t < NXB) {
    T col[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) col[k] = s_of(qa, k, t);
    chol4_rcp_solve(fR, col, col);
#pragma unroll
    for (int k = 0; k < NU; ++k) m.RiS()[k * NXB + t] = col[k];
  } else if (t == NXB) {
#pragma unroll
    for (int k = 0; k < 10; ++k) m.cRt()[k] = fR[k];
  }
  team_sync();
  if (t < NXB) {
    const int r = t;
    const T* RiS = m.RiS();
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
    T* Pf = f.buf(0);
    T* Pi = m.P() + i * NTRI;
#pragma unroll
    for (int col = 0; col < NXB; ++col) {
      const T p = q_of(qa, r, col) - acc[col];
      Pf[r * NXB + col] = p;
      if (col >= r) Pi[tri(r, col)] = p;
    }
  }
  team_sync();
}

// Column `col` of rows R0..R0+NR-1 of [Abar^T; Bbar^T] P (AtP rows 0-12,
// then BtP rows 0-3 as rows 13-16), the sums advancing together over j
// (independent chains), each in order j = 0..12
template <int R0, int NR, typename T>
__device__ __forceinline__ void at_p_column(const T* Ax, const T* Bx,
                                            const T* Pf, int col, T* AtP,
                                            T* BtP) {
  auto op = [&](int j, int r) {
    return r < NXB ? abar(Ax, j, r) : bbar(Bx, j, r - NXB);
  };
  T acc[NR];
  {
    const T p0 = Pf[col];
#pragma unroll
    for (int q = 0; q < NR; ++q) acc[q] = op(0, R0 + q) * p0;
  }
#pragma unroll
  for (int j = 1; j < NXB; ++j) {
    const T pj = Pf[j * NXB + col];
#pragma unroll
    for (int q = 0; q < NR; ++q) acc[q] += op(j, R0 + q) * pj;
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int r = R0 + q;
    (r < NXB ? AtP + r * NXB : BtP + (r - NXB) * NXB)[col] = acc[q];
  }
}

// Row `row` (13 values) times columns C0..C0+NC-1 of [Abar, Bbar] (Abar
// columns 0-12, then Bbar columns as 13-16), sums advancing together
template <int C0, int NC, typename T>
__device__ __forceinline__ void row_times_ab(const T* Ax, const T* Bx,
                                             const T* row, T* acc) {
  auto op = [&](int j, int c) {
    return c < NXB ? abar(Ax, j, c) : bbar(Bx, j, c - NXB);
  };
  {
    const T a0 = row[0];
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] = a0 * op(0, C0 + q);
  }
#pragma unroll
  for (int j = 1; j < NXB; ++j) {
    const T aj = row[j];
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] += aj * op(j, C0 + q);
  }
}

// Pn = Qh + Sh^T K, row r, columns C0..C0+NC-1, into Pn
template <int C0, int NC, typename T>
__device__ __forceinline__ void pn_row(const T* Qh, const T* Sh, const T* K,
                                       int r, T* Pn) {
  T a[NC];
  {
    const T s0 = Sh[r];
#pragma unroll
    for (int q = 0; q < NC; ++q) a[q] = s0 * K[C0 + q];
  }
#pragma unroll
  for (int j = 1; j < NU; ++j) {
    const T sj = Sh[j * NXB + r];
#pragma unroll
    for (int q = 0; q < NC; ++q) a[q] += sj * K[j * NXB + C0 + q];
  }
#pragma unroll
  for (int q = 0; q < NC; ++q)
    Pn[r * NXB + C0 + q] = Qh[r * NXB + C0 + q] + a[q];
}

// P_i = 0.5 (Pn + Pn^T), row r, columns C0..C0+NC-1 that are >= r
template <int C0, int NC, typename T>
__device__ __forceinline__ void p_sym_row(const T* Pn, int r, T* P, T* Pi) {
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = C0 + q;
    if (col >= r) {
      const T p = T(0.5) * (Pn[r * NXB + col] + Pn[col * NXB + r]);
      P[r * NXB + col] = p;
      P[col * NXB + r] = p;
      Pi[tri(r, col)] = p;
    }
  }
}

// stage i < N-1, with P_{i+1} in buf(cur), leaving P_i in buf(1 - cur):
// Qh = Q + Abar^T P Abar, Rh = R + Bbar^T P Bbar, Sh = S + Bbar^T P Abar,
// K = -Rh^{-1} Sh, P_i = sym(Qh + Sh^T K).  Each product runs one output
// row or column per thread, split between the team's two warps, each sum
// in the plain version's order.
template <typename T>
__device__ __forceinline__ void factor_stage(const LaneMem<T>& m,
                                             const FacScratch<T>& f, int i,
                                             int cur, int t) {
  const T* Ax = m.Ax() + i * NX * NX;
  const T* Bx = m.Bx() + i * NX * NU;
  const T* qa = m.qa() + i * QA;
  T* Pf = f.buf(cur);
  T* Qh = f.buf(1 - cur);
  const int w = t / WARP, u = t % WARP;
  if (i == 1) K1_CLOCK(12);
  // AtP = Abar^T P, BtP = Bbar^T P: column u; warp 0 rows 0-8, warp 1
  // rows 9-12 of AtP and the 4 of BtP
  if (u < NXB) {
    if (w == 0) at_p_column<0, NX>(Ax, Bx, Pf, u, f.AtP(), f.BtP());
    else at_p_column<NX, NXB + NU - NX>(Ax, Bx, Pf, u, f.AtP(), f.BtP());
  }
  team_sync();
  if (i == 1) K1_CLOCK(13);
  // row u of [AtP; BtP] [Abar, Bbar]: rows 0-12 give Qh, rows 13-16 Sh and
  // Rh; warp 0 columns 0-8, warp 1 columns 9-12 and Bbar's 4
  if (u < NXB + NU) {
    const bool qrow = u < NXB;
    const int r = qrow ? u : u - NXB;
    const T* row = qrow ? f.AtP() + r * NXB : f.BtP() + r * NXB;
    T* out = qrow ? Qh + r * NXB : f.Sh() + r * NXB;
    if (w == 0) {
      T acc[NX];
      row_times_ab<0, NX>(Ax, Bx, row, acc);
#pragma unroll
      for (int col = 0; col < NX; ++col)
        out[col] = (qrow ? q_of(qa, r, col) : s_of(qa, r, col)) + acc[col];
    } else {
      T acc[NXB - NX + NU];
      row_times_ab<NX, NXB - NX + NU>(Ax, Bx, row, acc);
#pragma unroll
      for (int col = NX; col < NXB; ++col)
        out[col] = (qrow ? q_of(qa, r, col) : s_of(qa, r, col)) + acc[col - NX];
      if (!qrow) {
#pragma unroll
        for (int col = 0; col < NU; ++col)
          f.Rh()[r * NU + col] = r_of(qa, r, col) + acc[NXB - NX + col];
      }
    }
  }
  team_sync();
  if (i == 1) K1_CLOCK(14);
  T fh[10];
  chol4_rcp(f.Rh(), fh);
  T* K = m.K() + i * NU * NXB;
  if (t < NXB) {
    T col[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) col[k] = f.Sh()[k * NXB + t];
    chol4_rcp_solve(fh, col, col);
#pragma unroll
    for (int k = 0; k < NU; ++k) K[k * NXB + t] = -col[k];
  } else if (t == NXB) {
#pragma unroll
    for (int k = 0; k < 10; ++k) m.cRh()[i * 10 + k] = fh[k];
  }
  team_sync();
  if (i == 1) K1_CLOCK(15);
  // Pn = Qh + Sh^T K into buf(cur) (P_{i+1} is no longer read): row u,
  // warp 0 columns 0-6, warp 1 columns 7-12
  constexpr int HALF = (NXB + 1) / 2;
  if (u < NXB) {
    if (w == 0) pn_row<0, HALF>(Qh, f.Sh(), K, u, Pf);
    else pn_row<HALF, NXB - HALF>(Qh, f.Sh(), K, u, Pf);
  }
  team_sync();
  // P_i = 0.5 (Pn + Pn^T) into buf(1 - cur) and the packed stack
  if (u < NXB) {
    T* Pi = m.P() + i * NTRI;
    if (w == 0) p_sym_row<0, HALF>(Pf, u, Qh, Pi);
    else p_sym_row<HALF, NXB - HALF>(Pf, u, Qh, Pi);
  }
  team_sync();
}

// ---- phase 6: backsolve, forward rollout, costates -------------------------
template <typename T>
__device__ __forceinline__ void backsolve_stage(const LaneMem<T>& m, int i, int t) {
  T* Pc = m.scr();              // 13
  T* qh = m.scr() + NXB;        // qxh (13), quh (4)
  const T* Pn = m.P() + (i + 1) * NTRI;
  const T* ci = m.c() + i * NXB;
  if (t < NXB) {
    T acc = Pn[tri(t, 0)] * ci[0];
    for (int j = 1; j < NXB; ++j) acc += Pn[tri(t, j)] * ci[j];
    Pc[t] = m.pn()[(i + 1) * NXB + t] + acc;
  }
  team_sync();
  const T* Ax = m.Ax() + i * NX * NX;
  const T* Bx = m.Bx() + i * NX * NU;
  const T* q = m.gq() + i * NZ;
  if (t < NXB) {
    T acc = abar(Ax, 0, t) * Pc[0];
    for (int j = 1; j < NXB; ++j) acc += abar(Ax, j, t) * Pc[j];
    qh[t] = qx_of(q, t) + acc;
  } else if (t < NXB + NU) {
    const int k = t - NXB;
    T acc = bbar(Bx, 0, k) * Pc[0];
    for (int j = 1; j < NXB; ++j) acc += bbar(Bx, j, k) * Pc[j];
    qh[t] = q[k] + acc;
  }
  team_sync();
  const T* quh = qh + NXB;
  const T* K = m.K() + i * NU * NXB;
  if (t < NXB) {
    T acc = K[t] * quh[0];
    for (int j = 1; j < NU; ++j) acc += K[j * NXB + t] * quh[j];
    m.pn()[i * NXB + t] = qh[t] + acc;
  } else if (t == NXB) {
    T kv[NU];
    chol4_rcp_solve(m.cRh() + i * 10, quh, kv);
    for (int k = 0; k < NU; ++k) m.kk()[i * NU + k] = -kv[k];
  }
  team_sync();
}

template <typename T>
__device__ __forceinline__ void backsolve(const LaneMem<T>& m, int t) {
  const int N = m.N;
  const T* qN = m.gq() + (N - 1) * NZ;
  if (t < NXB) {
    T acc = m.RiS()[t] * qN[0];
    for (int j = 1; j < NU; ++j) acc += m.RiS()[j * NXB + t] * qN[j];
    m.pn()[(N - 1) * NXB + t] = qx_of(qN, t) - acc;
  }
  team_sync();
  for (int i = N - 2; i >= 0; --i) backsolve_stage(m, i, t);
}

// the initial augmented step [x_init - x_0, dtheta] (every thread)
template <typename T>
__device__ __forceinline__ void initial_step(const LaneMem<T>& m, T* dxb) {
  const T* P0 = m.P();
  const T* p0 = m.pn();
  for (int k = 0; k < NX; ++k) dxb[k] = m.xinit()[k] - m.Z()[8 + k];
  T rhs[NU], Ptt[NU * NU], fP[10];
  for (int k = 0; k < NU; ++k) {
    T acc = P0[tri(0, NX + k)] * dxb[0];
    for (int j = 1; j < NX; ++j) acc += P0[tri(j, NX + k)] * dxb[j];
    rhs[k] = -(p0[NX + k] + acc);
    for (int l = 0; l < NU; ++l) Ptt[k * NU + l] = P0[tri(NX + k, NX + l)];
  }
  chol4_rcp(Ptt, fP);
  chol4_rcp_solve(fP, rhs, dxb + NX);
}

// forward rollout: du, dZ (into the q region) per stage
template <typename T>
__device__ __forceinline__ void rollout(const LaneMem<T>& m, int t) {
  const int N = m.N;
  T* dx = m.scr() + 2 * NXB + NU;   // two 13-vectors, swapped per stage
  T* dxn = dx + NXB;
  T* du = dx + 2 * NXB;
  {
    T d0[NXB];
    initial_step(m, d0);
    if (t < NXB) dx[t] = d0[t];
  }
  T Riqu[NU];
  {
    const T* qN = m.gq() + (N - 1) * NZ;
    T quN[NU];
    for (int k = 0; k < NU; ++k) quN[k] = qN[k];
    chol4_rcp_solve(m.cRt(), quN, Riqu);
  }
  team_sync();
  for (int i = 0; i < N; ++i) {
    T* dz = m.gq() + i * NZ;
    if (t < NU) {
      T v;
      if (i < N - 1) {
        const T* K = m.K() + i * NU * NXB + t * NXB;
        T acc = K[0] * dx[0];
        for (int j = 1; j < NXB; ++j) acc += K[j] * dx[j];
        v = acc + m.kk()[i * NU + t];
      } else {
        const T* RiS = m.RiS() + t * NXB;
        T acc = RiS[0] * dx[0];
        for (int j = 1; j < NXB; ++j) acc += RiS[j] * dx[j];
        v = -(Riqu[t] + acc);
      }
      du[t] = v;
      dz[t] = v;
    } else if (t < 8) {
      dz[t] = dx[NX + t - 4];
    } else if (t < NZ) {
      dz[t] = dx[t - 8];
    }
    team_sync();
    if (i < N - 1) {
      if (t < NXB) {
        const T* Ax = m.Ax() + i * NX * NX;
        const T* Bx = m.Bx() + i * NX * NU;
        T a = abar(Ax, t, 0) * dx[0];
        for (int j = 1; j < NXB; ++j) a += abar(Ax, t, j) * dx[j];
        T b = bbar(Bx, t, 0) * du[0];
        for (int j = 1; j < NU; ++j) b += bbar(Bx, t, j) * du[j];
        dxn[t] = a + b + m.c()[i * NXB + t];
      }
      team_sync();
      T* tmp = dx;
      dx = dxn;
      dxn = tmp;
    }
  }
}

// costates nu_i = P_i dxb_i + p_i, in place of p
template <typename T>
__device__ __forceinline__ void costates(const LaneMem<T>& m, int t) {
  for (int task = t; task < m.N * NXB; task += TEAM) {
    const int i = task / NXB, k = task % NXB;
    const T* dz = m.gq() + i * NZ;
    const T* Pi = m.P() + i * NTRI;
    T acc = Pi[tri(k, 0)] * dz[8];
    for (int j = 1; j < NXB; ++j) acc += Pi[tri(k, j)] * (j < NX ? dz[8 + j] : dz[4 + j - NX]);
    m.pn()[task] += acc;
  }
}

// ds and dmu of inequality row k of stage i
template <typename T>
__device__ __forceinline__ void ineq_step(const LaneMem<T>& m,
                                          const IterConsts<T>& c, T mu_n,
                                          int i, int k, T& ds, T& dmu) {
  const T* dz = m.gq() + i * NZ;
  const bool is_lb = k < NZ, is_box = k < 2 * NZ;
  const T dzk = dz[is_lb ? k : (is_box ? k - NZ : 0)];
  const T* a = m.A() + (i * NH + (is_box ? 0 : k - 2 * NZ)) * 3;
  const T jcor = a[0] * dz[8] + a[1] * dz[9] + a[2] * dz[10];
  const T jdz = is_lb ? -dzk : (is_box ? dzk : jcor);
  const int e = i * NIN + k;
  const T si = m.s()[e], mdi = m.mud()[e], inv = T(1) / si;
  ds = -(ineq_g(m, c, i, k) + si) - jdz;
  dmu = mu_n * inv - (mdi * inv) * ds - mdi;
}

// ---- the lane's iteration ---------------------------------------------------
template <typename T>
__device__ __forceinline__ void lane_iteration(const LaneMem<T>& m,
                                               const IterConsts<T>& c, int t) {
  const int N = m.N;
  const T inf = std::numeric_limits<T>::infinity();
  const T eps = std::numeric_limits<T>::epsilon();
  const T mu = m.scal()[0], it = m.scal()[1], done_in = m.scal()[2];
  // a lane outside its loop condition keeps its state (the input copy)
  if (done_in > T(0.5) || !(it < m.maxit()[0])) return;

  K1_CLOCK(1);
  if (t < NZ) {
    m.bnd()[t] = c.lb[t];
    m.bnd()[NZ + t] = c.ub[t];
  }
  dynamics(m, c, t);
  team_sync();
  K1_CLOCK(2);
  Errors<T> e = residuals(m, c, mu, t);
  team_sync();
  e.stat = stationarity(m, t);
  {
    T* red = m.red() + (t / WARP) * RED;
    const T v[10] = {warp_max(e.ineq), warp_max(e.comp), warp_max(e.comp0),
                     warp_max(e.habs), warp_sum(e.lam_sum),
                     warp_sum(e.mud_sum), warp_max(e.lam_max),
                     warp_max(e.mud_max), warp_max(e.eq), warp_max(e.stat)};
    if (t % WARP == 0)
#pragma unroll
      for (int k = 0; k < 10; ++k) red[k] = v[k];
    team_sync();
    const T* r = m.red();
    e.ineq = team_max2(r, 0);
    e.comp = team_max2(r, 1);
    e.comp0 = team_max2(r, 2);
    e.habs = team_max2(r, 3);
    e.lam_sum = r[4] + r[RED + 4];
    e.mud_sum = r[5] + r[RED + 5];
    e.lam_max = team_max2(r, 6);
    e.mud_max = team_max2(r, 7);
    e.eq = team_max2(r, 8);
    e.stat = team_max2(r, 9);
  }
  K1_CLOCK(3);

  // scaled errors, convergence, barrier update
  const T m_eq = T(N * NXB), m_in = T(N * NIN), s_max = T(100);
  const T m_all = (e.lam_sum + e.mud_sum) / (m_eq + m_in);
  const T s_d = nmax(s_max, m_all) / s_max;
  const T s_c = nmax(s_max, e.mud_sum / m_in) / s_max;
  const T mag = e.habs + e.lam_max + e.mud_max;
  const T stat_scale = nmax(T(1), T(4) * eps * mag / c.tol_ref);
  const T stat = e.stat / (s_d * stat_scale);
  const T comp = e.comp / s_c;
  const T comp0 = e.comp0 / s_c;
  const T err0 = nmax(nmax(stat, e.eq), nmax(e.ineq, comp0));
  const bool lane_done = err0 <= c.tol;
  if (lane_done) {
    team_sync();
    if (t == 0) {
      m.scal()[1] = it + T(1);
      m.scal()[2] = T(1);
      m.scal()[3] = err0;
    }
    return;
  }
  const bool shrink =
      c.mu_gate ? (nmax(nmax(stat, e.eq), nmax(e.ineq, comp)) <=
                   c.mu_gate_factor * mu)
                : true;
  // mu ** 1.5 as mu * sqrt(mu) (the wrapper requires mu_superlin == 1.5)
  const T mu_n = shrink ? nmax(c.mu_floor, nmin(c.kappa_mu * mu, mu * t_sqrt(mu)))
                        : mu;

  rhs_rows(m, c, mu_n, t);
  team_sync();
  rhs(m, c, mu_n, t);
  team_sync();
  K1_CLOCK(4);
  assemble_stages(m, c, t);
  team_sync();
  K1_CLOCK(5);

  const FacScratch<T> f{m.scr()};
  factor_terminal(m, f, t);
  for (int i = N - 2, cur = 0; i >= 0; --i, cur = 1 - cur)
    factor_stage(m, f, i, cur, t);
  K1_CLOCK(6);
  backsolve(m, t);
  K1_CLOCK(7);
  rollout(m, t);
  team_sync();
  costates(m, t);
  K1_CLOCK(8);

  // fraction-to-boundary step lengths
  const T tau = c.tau;
  T ap = T(1), ad = T(1);
  for (int i = 0; i < N; ++i) {
    const int task = i * NIN + t;
    T ds, dmu;
    ineq_step(m, c, mu_n, i, t, ds, dmu);
    const T rp = ds < T(0) ? (-tau * m.s()[task]) / nmin(ds, T(-1e-30)) : inf;
    const T rd = dmu < T(0) ? (-tau * m.mud()[task]) / nmin(dmu, T(-1e-30)) : inf;
    ap = nmin(ap, rp);
    ad = nmin(ad, rd);
  }
  ap = warp_min(ap);
  ad = warp_min(ad);
  if (t % WARP == 0) {
    m.red()[(t / WARP) * RED + 10] = ap;
    m.red()[(t / WARP) * RED + 11] = ad;
  }
  team_sync();
  ap = team_min2(m.red(), 10);
  ad = team_min2(m.red(), 11);
  K1_CLOCK(9);

  // NaN guard: err0 and every stepped Z and s finite
  bool finite = t_finite(err0);
  for (int task = t; task < N * NZ && finite; task += TEAM)
    finite = t_finite(m.Z()[task] + ap * m.gq()[task]);
  for (int i = 0; i < N && finite; ++i) {
    T ds, dmu;
    ineq_step(m, c, mu_n, i, t, ds, dmu);
    finite = finite && t_finite(m.s()[i * NIN + t] + ap * ds);
  }
  {
    const bool warp_finite = __all_sync(0xffffffffu, finite);
    if (t % WARP == 0) m.red()[(t / WARP) * RED + 12] = warp_finite ? T(1) : T(0);
  }
  team_sync();
  const bool bad = !(m.red()[12] > T(0.5) && m.red()[RED + 12] > T(0.5));
  K1_CLOCK(10);
  if (!bad) {
    for (int i = 0; i < N; ++i) {
      const int task = i * NIN + t;
      T ds, dmu;
      ineq_step(m, c, mu_n, i, t, ds, dmu);
      m.s()[task] = m.s()[task] + ap * ds;
      m.mud()[task] = m.mud()[task] + ad * dmu;
    }
    team_sync();
    for (int task = t; task < N * NZ; task += TEAM)
      m.Z()[task] = m.Z()[task] + ap * m.gq()[task];
    for (int task = t; task < N * NXB; task += TEAM) {
      const int k = task % NXB;
      T lp = m.pn()[task];
      if (task < NXB) lp = k < NX ? -lp : T(0);
      m.lam()[task] = m.lam()[task] + ad * (lp - m.lam()[task]);
    }
  }
  if (t == 0) {
    m.scal()[0] = mu_n;
    m.scal()[1] = it + T(1);
    m.scal()[2] = bad ? T(1) : T(0);
    m.scal()[3] = bad ? inf : err0;
  }
}

// ---- the kernel: copy in, one team per lane, copy out ---------------------
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

template <typename T>
struct IterArgs {
  const T* in[N_INPUTS];   // Z, lam, s, mu_d, scal, 5 weights, ref_pos,
                           // ref_yaw, A, b, f_ext, xinit, max_iters
  T* out[N_OUTPUTS];       // Z, lam, s, mu_d, scal
};

template <typename T>
__global__ void __launch_bounds__(TEAM * MAX_LANES, 2) ipm_iteration_kernel(
    const IterConsts<T> cst, const int N, const int B, const int lanes_log2,
    const int stride, const IterArgs<T> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int lanes = 1 << lanes_log2;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * lanes;
  K1_CLOCK(0);
  // thread tid copies lane l = tid % lanes, rows tid / lanes + k nthr / lanes
  // of every input: neighbouring threads read neighbouring b
  const int l = tid & (lanes - 1), r0 = tid >> lanes_log2;
  const int rstep = nthr >> lanes_log2;
  const bool valid = b0 + l < B;
  T* lane_sm = sm + l * stride;
  if (valid) {
    int off = 0;
#pragma unroll
    for (int a = 0; a < N_INPUTS; ++a) {
      const int rows = input_rows(a, N);
      const T* src = args.in[a] + b0 + l + size_t(r0) * B;
#pragma unroll 4
      for (int r = r0; r < rows; r += rstep, src += size_t(rstep) * B)
        copy_async(lane_sm + off + r, src);
      off += rows;
    }
  }
  copy_async_wait();
  __syncthreads();
  const int slot = tid / TEAM;
  if (b0 + slot < B)
    lane_iteration(LaneMem<T>{sm + slot * stride, N}, cst, tid % TEAM);
  __syncthreads();
  K1_CLOCK(11);
  if (valid) {
    int off = 0;
#pragma unroll
    for (int a = 0; a < N_OUTPUTS; ++a) {
      const int rows = input_rows(a, N);
      T* dst = args.out[a] + b0 + l + size_t(r0) * B;
#pragma unroll 4
      for (int r = r0; r < rows; r += rstep, dst += size_t(rstep) * B)
        *dst = lane_sm[off + r];
      off += rows;
    }
  }
}

// shared memory above 48 KB needs the attribute; set once per size
template <typename T>
int launch(const IterConsts<T>* c, int N, int B, int lanes_log2, int stride,
           const T* const* ins, T* const* outs, cudaStream_t stream) {
  static int smem_set = 0;
  const int lanes = 1 << lanes_log2;
  if (N < 2 || B < 1 || lanes > MAX_LANES || lane_layout(N).total > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(lanes) * stride * sizeof(T);
  if (smem > size_t(smem_set)) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ipm_iteration_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = static_cast<int>(smem);
  }
  IterArgs<T> args;
  for (int a = 0; a < N_INPUTS; ++a) args.in[a] = ins[a];
  for (int a = 0; a < N_OUTPUTS; ++a) args.out[a] = outs[a];
  const int blocks = (B + lanes - 1) / lanes;
  ipm_iteration_kernel<T><<<blocks, TEAM * lanes, smem, stream>>>(
      *c, N, B, lanes_log2, stride, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

using frp::IterConsts;

extern "C" {

#ifdef FRP_K1_CLOCKS
int ipm_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, frp::k1_clocks,
                                               sizeof(frp::k1_clocks)));
}
#endif

// elements of T per lane of the shared-memory layout (the Python geometry
// function computes the same; tests hold the two equal)
int ipm_lane_elements(int N) { return frp::lane_layout(N).total; }

int ipm_iteration_f32(const IterConsts<float>* c, int N, int B, int lanes_log2,
                      int stride, const float* const* ins, float* const* outs,
                      cudaStream_t stream) {
  return frp::launch<float>(c, N, B, lanes_log2, stride, ins, outs, stream);
}

int ipm_iteration_f64(const IterConsts<double>* c, int N, int B,
                      int lanes_log2, int stride, const double* const* ins,
                      double* const* outs, cudaStream_t stream) {
  return frp::launch<double>(c, N, B, lanes_log2, stride, ins, outs, stream);
}

}  // extern "C"
