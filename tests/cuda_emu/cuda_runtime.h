// A stand-in for <cuda_runtime.h> that runs a CUDA kernel's source on the
// CPU, for tests on machines without nvcc or a card: each CUDA thread of a
// block is a std::thread; __syncwarp and __syncthreads are barriers over
// the warp's and the block's threads; a shuffle or a vote passes values
// through a per-warp slot between two warp barriers; atomics are the
// compiler's atomic builtins. The dynamic shared memory is a buffer per
// block (the test swaps the kernel's `extern __shared__` declaration for
// `g_smem`); a static __shared__ variable becomes a static one, shared by
// the threads of the one block that runs at a time (harnesses run blocks
// one after another). Only what the kernels of csrc/newton_lanes.cu,
// fe_loss_grad.cu (with fe_common.cuh), windowed_scatter.cu and re_pack.cu
// use is here.
// Every lane of a warp must reach each __syncwarp, shuffle and vote, and
// every thread of the block each __syncthreads, as the kernels require.
#pragma once
#include <algorithm>
#include <atomic>
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
#define __shared__ static
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
struct int4 {
  int x, y, z, w;
};
struct double2 {
  double x, y;
};
template <class T>
T __ldg(const T* p) {
  return *p;
}
template <class T>
T __ldcg(const T* p) {
  return *p;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 2,
  cudaDevAttrMultiProcessorCount = 3
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
  uint64_t slot[32][32];
};

extern thread_local EmuDim3 threadIdx, blockIdx;
extern thread_local float* g_smem;
extern thread_local EmuBlock* g_block;
// the launch's shape, set by each harness thread
inline thread_local EmuDim3 gridDim, blockDim;

inline void __syncwarp() { g_block->warp[threadIdx.x >> 5].wait(); }
inline void __syncthreads() { g_block->block.wait(); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

template <class T>
T emu_exchange(T v, int src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "32/64-bit shuffles");
  uint64_t* s = g_block->slot[threadIdx.x >> 5];
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  s[threadIdx.x & 31] = bits;
  __syncwarp();
  bits = s[src];
  __syncwarp();
  std::memcpy(&v, &bits, sizeof(T));
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
// lanes past the warp's edge keep their own value, as on the card
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane >= (int)delta ? lane - (int)delta : lane);
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned delta) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane + (int)delta < 32 ? lane + (int)delta : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  uint64_t* s = g_block->slot[threadIdx.x >> 5];
  s[threadIdx.x & 31] = pred ? 1 : 0;
  __syncwarp();
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (unsigned)s[l] << l;
  __syncwarp();
  return out;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicCAS(int* p, int cmp, int val) {
  __atomic_compare_exchange_n(p, &cmp, val, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return cmp;   // the old value, whether or not it was swapped
}
template <class F, class U>
F emu_atomic_add(F* p, F v) {
  static_assert(sizeof(F) == sizeof(U), "");
  U* u = reinterpret_cast<U*>(p);
  U old = __atomic_load_n(u, __ATOMIC_SEQ_CST), sum;
  F f;
  do {
    std::memcpy(&f, &old, sizeof(F));
    const F r = f + v;
    std::memcpy(&sum, &r, sizeof(F));
  } while (!__atomic_compare_exchange_n(u, &old, sum, false,
                                        __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST));
  return f;
}
inline float atomicAdd(float* p, float v) {
  return emu_atomic_add<float, uint32_t>(p, v);
}
inline double atomicAdd(double* p, double v) {
  return emu_atomic_add<double, uint64_t>(p, v);
}

inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fabsf(float a) { return std::fabs(a); }
inline float expf(float a) { return std::exp(a); }
inline float __expf(float a) { return std::exp(a); }
inline float log1pf(float a) { return std::log1p(a); }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float __frcp_rn(float a) { return 1.f / a; }

using std::exp;
using std::log1p;

inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F*, int, int) {
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
