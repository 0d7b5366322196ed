// A host stand-in for the parts of the CUDA runtime that the kernels of
// forces_resilient_planner_tpu_torch/ops/csrc/ use, so that a kernel source
// compiles with g++ and runs on the CPU: every block of a launch runs after
// the one before, each of its threads as a std::thread; __syncthreads and
// __syncwarp are barriers; a warp's shuffles and votes pass values through
// per-warp slots between two barriers; a named barrier (bar.sync) is a
// barrier per id.  tests/test_torch_ipm_kernel.py
// rewrites the source's launch (<<<...>>>) and its `extern __shared__`
// declaration to emu::launch and emu::shared_memory before compiling.
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

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {

constexpr int WARP = 32;

struct Warp {
  explicit Warp(int n) : bar(n) {}
  std::barrier<> bar;
  std::uint64_t slot[WARP] = {};
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
T exchange(T v, int src) {
  Warp& w = warp();
  const int lane = threadIdx.x % WARP;
  std::uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.bar.arrive_and_wait();
  bits = w.slot[src];
  w.bar.arrive_and_wait();
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
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp().bar.arrive_and_wait();
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu::exchange(v, (threadIdx.x % emu::WARP) ^ mask);
}
template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  return emu::exchange(v, src);
}
inline int __all_sync(unsigned, int pred) {
  emu::Warp& w = emu::warp();
  const int lane = threadIdx.x % emu::WARP;
  w.slot[lane] = pred != 0;
  w.bar.arrive_and_wait();
  int all = 1;
  for (int k = 0; k < emu::WARP; ++k) all = all && w.slot[k] != 0;
  w.bar.arrive_and_wait();
  return all;
}
