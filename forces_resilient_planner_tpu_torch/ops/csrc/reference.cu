// Stage 1 of the step, the references, one thread per robot (Hopper).
//
// Replaces no TPU kernel: on the TPU, XLA fused the plain jnp code of
// forces_resilient_planner_tpu/engine/reference.py::sample_references; in
// PyTorch that code dispatched ~470 small launches a step, 340 of them in
// the sequential yaw filter.  Per robot b, for each stage n < N, in the plain
// version's order (engine/reference.py::sample_references_plain):
//   t_n    = n Ts + t_offset, rounded twice (the product, then the sum)
//   idx_n  = floor(fma_small(n, Ts, t_offset) (1/Ts)), the double-double
//            near-FMA of _fma_small: Ts split into hi + lo (a Veltkamp split
//            at 12 bits at f32, 27 at f64), a TwoSum of n hi + t_offset, its
//            error, n lo, one more sum
//   frac_n = remainder(t_n, Ts) (1/Ts), remainder as torch's computes it:
//            fmod, plus Ts where the signs differ
//   ref_n  = p[idx] + frac (p[idx + 1] - p[idx]) while idx + 1 < size, else
//            p[last]; fwd_n = p[idx + lookahead] while idx + lookahead <
//            size, else p[last]; last = max(size - 1, 0); every gather clamps
//            its index to [0, K - 1]
//   yaw    the low-pass of calculate_yaw (nmpc_solver.cpp:834-862) from
//          y = last_yaw: d = fwd - ref, |d| summed x, y, z in order, the
//          target atan2(d_y, d_x) where |d| > 0.1 (else y), wrapped by 2 PI
//          where it lies more than PI from y, then y = 0.2 y + 0.8 target
//   jump   |ref_0 - pred_pos1|
// Each constant is the Python float the plain version names, rounded to T
// once, as torch rounds a Python scalar.  NaN and inf pass as through the
// plain version's ops.
//
// What bounds it: a robot's yaw filter is sequential, and its work is a few
// hundred operations (one thread each covers it all); bytes are the path
// samples gathered and the references written.  No multiply-add is
// contracted (-fmad=false, ops/_build.py) and no fast math: every operation
// rounds on its own as the plain version's separate launches do, and sqrt,
// floor, fmod and atan2 are the CUDA math library's, as torch's kernels
// call them, so the kernel gives the plain version's results bit for bit.
#include "common.cuh"

namespace frp {

constexpr int REF_THREADS = 32;  // robots per CTA: B = 4096 fills 128 SMs
constexpr double REF_PI = 3.1415926;  // the reference's PI (nmpc_solver.cpp:3)

__device__ __forceinline__ float t_floor(float x) { return floorf(x); }
__device__ __forceinline__ double t_floor(double x) { return floor(x); }
__device__ __forceinline__ float t_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double t_fmod(double x, double y) { return fmod(x, y); }

// (((x0 x0) + (x1 x1)) + (x2 x2))^(1/2): utils/lanes.py::norm3
template <typename T>
__device__ __forceinline__ T norm3(T x0, T x1, T x2) {
  return t_sqrt(x0 * x0 + x1 * x1 + x2 * x2);
}

template <typename T>
__global__ void __launch_bounds__(REF_THREADS)
reference_kernel(int B, int K, int N, int lookahead, T Ts, T inv_Ts,
                 const T* __restrict__ path, const long long* __restrict__ size,
                 const T* __restrict__ t_offset, const T* __restrict__ last_yaw,
                 const T* __restrict__ pred, T* __restrict__ ref_pos,
                 T* __restrict__ ref_yaw, T* __restrict__ jump) {
  const int b = blockIdx.x * REF_THREADS + threadIdx.x;
  if (b >= B) return;
  const T* p = path + static_cast<size_t>(b) * K * 3;
  const long long sz = size[b];
  const long long last = sz - 1 > 0 ? sz - 1 : 0;
  auto at = [&](long long i) {  // torch.clamp(i, 0, K - 1)
    return p + 3 * (i < 0 ? 0 : (i > K - 1 ? K - 1 : i));
  };
  const T t = t_offset[b];
  // _fma_small's Veltkamp split factor 2^12 + 1 (f32) or 2^27 + 1 (f64)
  const T big = Ts * (sizeof(T) == 4 ? T(4097.0) : T(134217729.0));
  const T hi = big - (big - Ts);
  const T lo = Ts - hi;
  const T pi = T(REF_PI), two_pi = T(2 * REF_PI);
  T y = last_yaw[b];
  T* out = ref_pos + static_cast<size_t>(b) * N * 3;
  for (int n = 0; n < N; ++n) {
    const T i = T(n);
    const T index_time = i * Ts + t;
    const T a = i * hi, c = i * lo;
    const T s = a + t;
    const T bb = s - a;
    const T err = (a - (s - bb)) + (t - bb);
    const long long idx =
        static_cast<long long>(t_floor((s + (err + c)) * inv_Ts));
    T mod = t_fmod(index_time, Ts);
    if (mod != T(0) && ((Ts < T(0)) != (mod < T(0)))) mod += Ts;
    const T frac = mod * inv_Ts;

    const T* p0 = at(idx);
    const T* p1 = at(idx + 1);
    const T* pl = at(last);
    const T* pf = at(idx + lookahead < sz ? idx + lookahead : last);
    const bool inside = idx + 1 < sz;
    T r[3];
    for (int k = 0; k < 3; ++k)
      r[k] = inside ? p0[k] + frac * (p1[k] - p0[k]) : pl[k];
    for (int k = 0; k < 3; ++k) out[3 * n + k] = r[k];
    if (n == 0)
      jump[b] = norm3(r[0] - pred[3 * b], r[1] - pred[3 * b + 1],
                      r[2] - pred[3 * b + 2]);

    const T d0 = pf[0] - r[0], d1 = pf[1] - r[1], d2 = pf[2] - r[2];
    const T target = norm3(d0, d1, d2) > T(0.1) ? t_atan2(d1, d0) : y;
    const T gap = target - y;
    const T wrapped = t_abs(gap) > pi
                          ? (target > T(0) ? target - two_pi : target + two_pi)
                          : target;
    y = T(0.2) * y + T(0.8) * wrapped;
    ref_yaw[static_cast<size_t>(b) * N + n] = y;
  }
}

template <typename T>
int launch_reference(int B, int K, int N, int lookahead, T Ts, T inv_Ts,
                     const T* path, const long long* size, const T* t_offset,
                     const T* last_yaw, const T* pred, T* ref_pos, T* ref_yaw,
                     T* jump, cudaStream_t stream) {
  if (B < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const int grid = (B + REF_THREADS - 1) / REF_THREADS;
  reference_kernel<T><<<grid, REF_THREADS, 0, stream>>>(
      B, K, N, lookahead, Ts, inv_Ts, path, size, t_offset, last_yaw, pred,
      ref_pos, ref_yaw, jump);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp

#define REF_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(int B, int K, int N, int lookahead, T Ts, T inv_Ts,    \
                      const T* path, const long long* size,                  \
                      const T* t_offset, const T* last_yaw, const T* pred,   \
                      T* ref_pos, T* ref_yaw, T* jump, cudaStream_t stream) { \
    return frp::launch_reference<T>(B, K, N, lookahead, Ts, inv_Ts, path,   \
                                    size, t_offset, last_yaw, pred, ref_pos, \
                                    ref_yaw, jump, stream);                  \
  }
REF_ENTRY(reference_f32, float)
REF_ENTRY(reference_f64, double)
