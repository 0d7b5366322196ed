// A host stand-in for the parts of the CUDA runtime that the kernels of
// forces_resilient_planner_tpu_torch/ops/csrc/ use, so that a kernel source
// compiles with g++ and runs on the CPU: every block of a launch runs after
// the one before, each of its threads as a std::thread; __syncthreads is a
// barrier; __syncwarp(mask) is a barrier of the threads in mask (one per
// mask, so the sub-warp groups of a warp sync on their own); a warp's
// shuffles, ballots and votes pass values through per-warp slots between
// two barriers of their mask; a named barrier (bar.sync) is a barrier per
// id.  tests/_cuda_emu.py rewrites the source's launch (<<<...>>>) and its
// `extern __shared__` declaration to emu::launch and emu::shared_memory
// before compiling.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) double2 {
  double x, y;
};
using std::fma;
using std::fmaf;

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 232448;
  return cudaSuccess;
}

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {

constexpr int WARP = 32;

struct Warp {
  explicit Warp(int n) : threads(n) {}
  int threads;                      // threads of the block in this warp
  std::mutex mu;
  std::map<unsigned, std::unique_ptr<std::barrier<>>> bars;  // per mask
  std::uint64_t slot[WARP] = {};

  // the barrier of the threads of `mask` that exist in this warp
  void sync(unsigned mask) {
    std::barrier<>* bar;
    {
      std::lock_guard<std::mutex> lock(mu);
      auto& b = bars[mask];
      if (!b) {
        const unsigned have = threads == WARP ? 0xffffffffu
                                              : (1u << threads) - 1u;
        b = std::make_unique<std::barrier<>>(__builtin_popcount(mask & have));
      }
      bar = b.get();
    }
    bar->arrive_and_wait();
  }
};

struct Block {
  Block(int threads, size_t smem) : bar(threads), shared(smem + 16) {
    for (int w = 0; w < (threads + WARP - 1) / WARP; ++w) {
      const int n = threads - w * WARP < WARP ? threads - w * WARP : WARP;
      warps.emplace_back(std::make_unique<Warp>(n));
    }
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<double> shared;  // 8-byte aligned
  std::mutex mu;
  std::map<int, std::unique_ptr<std::barrier<>>> named;  // bar.sync ids
};

inline thread_local Block* block = nullptr;

inline unsigned char* shared_memory() {
  return reinterpret_cast<unsigned char*>(block->shared.data());
}
inline Warp& warp() { return *block->warps[threadIdx.x / WARP]; }

template <typename F, typename... Args>
void launch(F kernel, int grid, int threads, size_t smem, Args... args) {
  for (int b = 0; b < grid; ++b) {
    Block blk(threads, smem);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        block = &blk;
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        gridDim.x = grid;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}

template <typename T>
T exchange(unsigned mask, T v, int src) {
  Warp& w = warp();
  const int lane = threadIdx.x % WARP;
  std::uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.sync(mask);
  bits = w.slot[src];
  w.sync(mask);
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}

}  // namespace emu

inline void __syncthreads() { emu::block->bar.arrive_and_wait(); }
// the PTX named barrier `bar.sync id, count` of a kernel's team of threads
inline void frp_team_barrier(int id, int count) {
  emu::Block& b = *emu::block;
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(b.mu);
    auto& slot = b.named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  emu::warp().sync(mask);
}
// width: the shuffle stays within segments of `width` lanes
template <typename T>
T __shfl_xor_sync(unsigned mask, T v, int lane_mask, int width = emu::WARP) {
  const int lane = threadIdx.x % emu::WARP;
  const int src = lane ^ lane_mask;
  return emu::exchange(mask, v, (src / width == lane / width) ? src : lane);
}
template <typename T>
T __shfl_sync(unsigned mask, T v, int src, int width = emu::WARP) {
  const int lane = threadIdx.x % emu::WARP;
  return emu::exchange(mask, v, lane / width * width + src % width);
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  emu::Warp& w = emu::warp();
  const int lane = threadIdx.x % emu::WARP;
  w.slot[lane] = pred != 0;
  w.sync(mask);
  unsigned bits = 0;
  for (int k = 0; k < emu::WARP; ++k)
    if ((mask >> k) & 1u && w.slot[k] != 0) bits |= 1u << k;
  w.sync(mask);
  return bits;
}
inline int __all_sync(unsigned mask, int pred) {
  emu::Warp& w = emu::warp();
  const int lane = threadIdx.x % emu::WARP;
  w.slot[lane] = pred != 0;
  w.sync(mask);
  int all = 1;
  for (int k = 0; k < w.threads; ++k)
    if ((mask >> k) & 1u) all = all && w.slot[k] != 0;
  w.sync(mask);
  return all;
}
inline int __any_sync(unsigned mask, int pred) {
  emu::Warp& w = emu::warp();
  const int lane = threadIdx.x % emu::WARP;
  w.slot[lane] = pred != 0;
  w.sync(mask);
  int any = 0;
  for (int k = 0; k < w.threads; ++k)
    if ((mask >> k) & 1u) any = any || w.slot[k] != 0;
  w.sync(mask);
  return any;
}
inline unsigned __reduce_max_sync(unsigned mask, unsigned value) {
  emu::Warp& w = emu::warp();
  const int lane = threadIdx.x % emu::WARP;
  w.slot[lane] = value;
  w.sync(mask);
  unsigned most = 0;
  for (int k = 0; k < w.threads; ++k)
    if ((mask >> k) & 1u && w.slot[k] > most) most = static_cast<unsigned>(w.slot[k]);
  w.sync(mask);
  return most;
}
