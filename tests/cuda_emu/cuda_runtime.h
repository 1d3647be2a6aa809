// A stand-in for <cuda_runtime.h> that runs a CUDA kernel's source on the
// CPU, for tests on machines without nvcc or a card: each CUDA thread of a
// block is a std::thread; __syncwarp and __syncthreads are barriers over
// the warp's and the block's threads; a shuffle passes values through a
// per-warp slot between two warp barriers; the dynamic shared memory is a
// buffer per block (the test swaps the kernel's `extern __shared__`
// declaration for `g_smem`). Only what csrc/newton_lanes.cu uses is here.
// Every lane of a warp must reach each __syncwarp and shuffle, and every
// thread of the block each __syncthreads, as the kernel already requires.
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <cstddef>
#include <cstdint>
#include <mutex>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x)

struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 2
};

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const int g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return g != gen; });
    }
  }
};

struct EmuBlock {
  EmuBarrier block, warp[32];
  uint32_t slot[32][32];
};

extern thread_local EmuDim3 threadIdx, blockIdx;
extern thread_local float* g_smem;
extern thread_local EmuBlock* g_block;

inline void __syncwarp() { g_block->warp[threadIdx.x >> 5].wait(); }
inline void __syncthreads() { g_block->block.wait(); }

template <class T>
T emu_exchange(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t* s = g_block->slot[threadIdx.x >> 5];
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  s[threadIdx.x & 31] = bits;
  __syncwarp();
  bits = s[src];
  __syncwarp();
  std::memcpy(&v, &bits, 4);
  return v;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_exchange(v, (threadIdx.x & 31) ^ mask);
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, src);
}

inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fabsf(float a) { return std::fabs(a); }
inline float expf(float a) { return std::exp(a); }
inline float __expf(float a) { return std::exp(a); }
inline float log1pf(float a) { return std::log1p(a); }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float __frcp_rn(float a) { return 1.f / a; }

inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
