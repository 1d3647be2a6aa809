// The fixed-effect data term that every L-BFGS funcall of the global model
// evaluates: Σ weighted loss and its gradient over padded COO records
// (indices / values [N, K], labels / weights / offsets [N], θ = [w(D), b]),
// and the flat entry-space gather / scatter pair. Float and double.
//
// Replaces seven pallas_call sites of the JAX package:
//   fe_loss_grad_fused  ← gdmix_tpu/ops/pallas/fe_grad.py:48 _kernel (K5),
//                         fe_block.py:85 _kernel (K6), fe_gather.py:50 _kernel
//                         (K7). The three compute one sum; their one-hot
//                         densifications and VMEM `take` are TPU devices for a
//                         gather and a scatter, which the GPU has natively.
//   fe_gather_entries   ← fe_flat.py:81 _gather_kernel_split (K8) and :96
//                         _gather_kernel_f32 (K9); the bf16x2 split existed for
//                         the MXU, so both become one kernel in the working type.
//   fe_scatter_entries  ← fe_flat.py:109 _scatter_kernel_split (K10) and :134
//                         _scatter_kernel_f32 (K11).
//
// The fused kernel is fe_common.cuh's pass (its header gives the design):
// this file holds its C entry points. Bound: the reads, K·(4 + sizeof(T))
// bytes of ids and values a record plus three scalars (at N = 4,997,120,
// K = 16, float32: 700 MB, 0.209 ms at 3.35 TB/s).
//
// Forms, chosen by the wrapper from the shape alone
// (ops/fe_loss_grad.py privatised_form): a block-private gradient in shared
// memory while D·sizeof(T) fits the 227 KB a block may opt into beside the
// strips and the hashed table of frequent ids (D ≤ 54,752 in float32,
// 26,864 in float64); past that device-memory atomics, with the strips and
// a hashed cache of 8,192 first-come ids in shared memory. The vector path
// takes K ≤ 16 with K % 4 == 0 and 16-byte aligned rows; any other shape
// the lane-group path (fe_common.cuh).
//
// What decided each choice: each alternative was built and timed against
// what is here while the kernel was designed, and only the winner is kept in
// the source (NVIDIA H100 80GB HBM3, 700 W; N = 4,997,120, K = 16, float32;
// ms a call with uniform / Zipf(1.2) ids, CUDA events around the wrapper). At
// D = 10,000, as kept 0.342 / 0.565 (the kernel alone 0.26 under the
// profiler, uniform). Lanes a record: one 0.373 / 0.980, sixteen 0.693 /
// 0.810, four kept. Blocks of 512 threads 0.381 / 0.579, 1,024 kept. No
// strips 0.310 / 2.216: the strips cost uniform ids a tenth and save Zipf
// ids 3.9×. Warp aggregation in their place 0.832 / 0.677: __match_any_sync
// on 32 distinct ids costs more than the atomics it saves, so it was not
// kept. 64 strips 0.345 / 0.716: the 1/256 share, not their number, bounds
// the set. θ in shared memory beside the gradient, before the strips were
// added, 0.306 against 0.316 through the read-only cache: dropped, it
// halves the D that fits. The device-memory form, uniform / Zipf: D =
// 100,000 1.600 / 1.022, D = 1,000,000 1.589 / 0.858; without the cache
// 1.575 / 4.772 and 1.588 / 6.610; without the strips 1.567 / 2.076 and
// 1.585 / 1.994; with neither (every addition a device atomic) 24–26 on
// Zipf ids; a cache of 16,384 slots leaves one block an SM and measured
// 1.502 / 1.263 at D = 100,000. These were timed at K = 16, on the vector
// path; at criteo's K = 39, D = 1,000,000 (Zipf(1.2), the device-memory
// form) the lane-group path takes 1.887 in float32 and 2.540 in float64,
// where the scalar loop it replaced took 13.08 and 9.70. ptxas: 32
// registers in float32, 61 in float64, no spills on the vector path (the
// lane-group path: fe_common.cuh); two 1,024-thread blocks an SM at D =
// 10,000 and in the device-memory form, one past D ≈ 27,000 block-private.
// A cluster-sharded form (the table over the shared memories of a cluster
// of 8 blocks, 7 of 8 additions remote) against the device-memory
// form: D = 100,000 2.160 / 5.414 against 1.600 / 1.022; D = 400,000
// uniform 2.300 against 1.610; D = 10,000 uniform 2.609 against 0.342
// block-private. An atomic through distributed shared memory costs more
// than one in L2, so that form was not kept.
//
// The gather of the flat pair is a grid-stride loop over the entry axis.
// The scatter (K10/K11: g[idx[e]] += ce[e] over E entries, unsorted ids)
// is K5's gradient without its records: a persistent grid of 1,024-thread
// blocks adds through fe_common.cuh's GradTable, block-private while
// privatised_form says the table fits and in device memory behind the
// hashed cache past that, with strips for the ids the block's sample finds
// frequent, and one flush a block from a staggered slot. A thread reads
// four entries by 16-byte loads (int4 ids, float4 or two double2
// contributions) where both arrays are 16-byte aligned, and the E % 4 last
// entries one at a time; entries of contribution 0 are inert. Bound: the
// reads, (4 + sizeof(T)) bytes an entry, and the table written once (at
// E = 79,953,920, D = 10,000 in float32: 640 MB, 0.191 ms at 3.35 TB/s).
#include <cstdint>

#include <cuda_runtime.h>

#include "fe_common.cuh"

namespace {

constexpr int kGatherThreads = 256;   // the gather's block

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_entries_kernel(const int32_t* __restrict__ idx,
                      const T* __restrict__ val, const T* __restrict__ theta,
                      int64_t e, T* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    const T v = val[i];
    out[i] = v != T(0) ? v * __ldg(theta + idx[i]) : T(0);
  }
}

// K10/K11. vec: four entries a thread by 16-byte loads, then the E % 4
// last ones by the scalar loop.
template <typename T, bool kVec, int kForm>
__global__ void __launch_bounds__(gdx_fe::kThreads)
scatter_entries_kernel(const int32_t* __restrict__ idx,
                       const T* __restrict__ ce, int64_t e, int d,
                       T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gdx_fe::GradTable<T, kForm, false> tab;
  tab.init(smem_raw, g, kForm == gdx_fe::kBlock ? d : 0, d, idx, ce, e);
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * gdx_fe::kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * gdx_fe::kThreads;
  int64_t done = 0;
  if constexpr (kVec) {
    const int64_t quads = e >> 2;
    for (int64_t q = first; q < quads; q += stride) {
      int32_t a[4];
      T c[4];
      gdx_fe::load4(idx + 4 * q, a);
      gdx_fe::load4(ce + 4 * q, c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c[u] != T(0)) tab.add(a[u], c[u], lane);
    }
    done = quads << 2;
  }
  for (int64_t i = done + first; i < e; i += stride) {
    const T c = ce[i];
    if (c != T(0)) tab.add(idx[i], c, lane);
  }
  tab.flush(lane);
}

int grid_for(int64_t items, int max_blocks) {
  const int64_t need = (items + kGatherThreads - 1) / kGatherThreads;
  return (int)(need < max_blocks ? (need > 0 ? need : 1) : max_blocks);
}

template <typename T>
int fused(const int32_t* idx, const T* val, const T* y, const T* w,
          const T* off, const T* theta, int64_t n, int k, int d,
          int has_intercept, int linear, int form, int vec, T* grad,
          double* sums, void* stream, int* blocks_per_sm) {
  const int s = form == gdx_fe::kBlock ? d : 0;
  const gdx_fe::Pass<T> p{idx, val, y, w, off, theta,
                          has_intercept ? theta + d : nullptr, n, k, d,
                          s, linear, grad, nullptr, sums};
  return gdx_fe::launch<T, false>(p, vec, form, (cudaStream_t)stream,
                                  blocks_per_sm);
}

template <typename T>
int gather(const int32_t* idx, const T* val, const T* theta, int64_t e,
           T* out, int max_blocks, void* stream) {
  gather_entries_kernel<T><<<grid_for(e, max_blocks), kGatherThreads, 0,
                             (cudaStream_t)stream>>>(idx, val, theta, e, out);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec, int kForm>
int scatter_form(const int32_t* idx, const T* ce, int64_t e, int d, T* g,
                 cudaStream_t stream, int* blocks_per_sm) {
  constexpr int64_t per_block = gdx_fe::kThreads * (kVec ? 4 : 1);
  return gdx_fe::launch_persistent(
      scatter_entries_kernel<T, kVec, kForm>,
      gdx_fe::GradTable<T, kForm, false>::smem_bytes(
          kForm == gdx_fe::kBlock ? d : 0),
      (e + per_block - 1) / per_block, stream, blocks_per_sm, idx, ce, e, d,
      g);
}

template <typename T>
int scatter(const int32_t* idx, const T* ce, int64_t e, int d, int form,
            int vec, T* g, void* stream, int* blocks_per_sm) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (form == gdx_fe::kBlock)
    return vec ? scatter_form<T, true, gdx_fe::kBlock>(idx, ce, e, d, g, st,
                                                       blocks_per_sm)
               : scatter_form<T, false, gdx_fe::kBlock>(idx, ce, e, d, g, st,
                                                        blocks_per_sm);
  if (form == gdx_fe::kDevice)
    return vec ? scatter_form<T, true, gdx_fe::kDevice>(idx, ce, e, d, g, st,
                                                        blocks_per_sm)
               : scatter_form<T, false, gdx_fe::kDevice>(idx, ce, e, d, g,
                                                         st, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// grad [d (+1)] and sums [2] (loss, Σr in double) must be zero on entry.
// form: 1 to keep a block-private gradient in shared memory (d·sizeof(T)
// bytes), 0 for the device-memory form; vec: 1 for the vector path (k ≤ 16,
// k % 4 == 0, rows 16-byte aligned), 0 for the lane-group path (any k).
// With blocks_per_sm not null nothing is launched: the form's resident
// blocks per SM are written there.
int gdx_fe_fused_f32(const int32_t* idx, const float* val, const float* y,
                     const float* w, const float* off, const float* theta,
                     int64_t n, int k, int d, int has_intercept, int linear,
                     int form, int vec, float* grad, double* sums,
                     void* stream, int* blocks_per_sm) {
  return fused<float>(idx, val, y, w, off, theta, n, k, d, has_intercept,
                      linear, form, vec, grad, sums, stream, blocks_per_sm);
}

int gdx_fe_fused_f64(const int32_t* idx, const double* val, const double* y,
                     const double* w, const double* off, const double* theta,
                     int64_t n, int k, int d, int has_intercept, int linear,
                     int form, int vec, double* grad, double* sums,
                     void* stream, int* blocks_per_sm) {
  return fused<double>(idx, val, y, w, off, theta, n, k, d, has_intercept,
                       linear, form, vec, grad, sums, stream,
                       blocks_per_sm);
}

int gdx_fe_gather_f32(const int32_t* idx, const float* val,
                      const float* theta, int64_t e, float* out,
                      int max_blocks, void* stream) {
  return gather<float>(idx, val, theta, e, out, max_blocks, stream);
}

int gdx_fe_gather_f64(const int32_t* idx, const double* val,
                      const double* theta, int64_t e, double* out,
                      int max_blocks, void* stream) {
  return gather<double>(idx, val, theta, e, out, max_blocks, stream);
}

// g [d] must be zero on entry. form as for the fused kernel (1: a
// block-private table of d·sizeof(T) bytes, 0: device memory behind the
// cache); vec: 1 for 16-byte loads (idx and ce 16-byte aligned). With
// blocks_per_sm not null nothing is launched: the form's resident blocks per
// SM are written there.
int gdx_fe_scatter_f32(const int32_t* idx, const float* ce, int64_t e,
                       int d, int form, int vec, float* g, void* stream,
                       int* blocks_per_sm) {
  return scatter<float>(idx, ce, e, d, form, vec, g, stream, blocks_per_sm);
}

int gdx_fe_scatter_f64(const int32_t* idx, const double* ce, int64_t e,
                       int d, int form, int vec, double* g, void* stream,
                       int* blocks_per_sm) {
  return scatter<double>(idx, ce, e, d, form, vec, g, stream, blocks_per_sm);
}

// The number of ids that get a lane-private strip, and the buckets of the
// hashed table that finds them (the wrapper's byte budget counts both).
// The lane-group shape (lanes·100 + entries) of records of k entries off
// the vector path: the wrapper checks its mirror of the choice against it.
int gdx_fe_lane_group(int k) {
  int g = 0, e = 0, chunks = 0;
  gdx_fe::lane_group(k, &g, &e, &chunks);
  return g * 100 + e;
}

int gdx_fe_strip_ids(void) { return gdx_fe::kStrip; }
int gdx_fe_buckets(void) { return gdx_fe::kBuckets; }

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
