// The fixed-effect data term that every L-BFGS funcall of the global model
// evaluates: Σ weighted loss and its gradient over padded COO records
// (indices / values [N, K], labels / weights / offsets [N], θ = [w(D), b]).
// Float and double, one template each.
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
// Bound: the gradient's atomics, not the reads. A funcall reads each record
// once: K·(4 + sizeof(T)) bytes of ids and values plus three scalars (at
// N = 5M, K = 16, f32: ~700 MB, about 0.2 ms at 3.35 TB/s); θ and the
// gradient (D + 1 values, 40 KB at D = 10k) live in L2. But every non-zero
// entry is one atomicAdd into D + 1 addresses: on an H100 (700 W) the entry
// scatter alone takes 1.9 ms of the fused kernel's 2.4 ms at that shape with
// uniform ids, and ten times more with Zipf(1.2) ids, where the hot ids
// serialise.
//
// Design: one thread per record in a grid-stride loop, so the loss, the
// residual and the gather stay in registers and nothing of size N·K is
// written (the flat pair writes two such vectors by construction). θ is read
// through the read-only cache; the gradient takes global atomicAdd, native
// for float and double on sm_90. The loss and Σr are summed in double inside
// a thread, reduced over the block and added with one double atomic per
// block, so their rounding does not grow with N. Entries with value 0 and
// rows with weight 0 (the padding of the batch) are skipped: they are inert
// by construction, and a skipped entry's id is never read. A shared-memory
// copy of θ and a privatised gradient are later work.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
template <typename T>
__device__ __forceinline__ T abs_(T x) { return x < T(0) ? -x : x; }

template <typename T>
__device__ __forceinline__ T sigmoid(T z) {
  // both branches exp(-|z|) ≤ 1: no overflow at large |z|
  const T e = exp_(-abs_(z));
  return z >= T(0) ? T(1) / (T(1) + e) : e / (T(1) + e);
}

// Sum of v over the block, in thread 0 (all threads must call).
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < (kThreads / 32) ? part[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fe_fused_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                const T* __restrict__ y, const T* __restrict__ w,
                const T* __restrict__ off, const T* __restrict__ theta,
                int64_t n, int k, int d, int has_intercept, int linear,
                T* __restrict__ grad, double* __restrict__ sums) {
  const T b = has_intercept ? theta[d] : T(0);
  double loss = 0.0, rsum = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const T wt = w[row];
    if (wt == T(0)) continue;
    const int32_t* ri = idx + row * k;
    const T* rv = val + row * k;
    T z = off[row] + b;
    for (int j = 0; j < k; ++j) {
      const T v = rv[j];
      if (v != T(0)) z += v * __ldg(theta + ri[j]);
    }
    const T yt = y[row];
    T per, dz;
    if (linear) {
      per = (yt - z) * (yt - z);
      dz = T(2) * (z - yt);
    } else {
      per = (z > T(0) ? z : T(0)) - z * yt + log1p_(exp_(-abs_(z)));
      dz = sigmoid(z) - yt;
    }
    const T r = wt * dz;
    loss += (double)(wt * per);
    rsum += (double)r;
    for (int j = 0; j < k; ++j) {
      const T v = rv[j];
      if (v != T(0)) atomicAdd(grad + ri[j], v * r);
    }
  }
  loss = block_sum(loss);
  __syncthreads();  // block_sum's shared array is reused below
  rsum = block_sum(rsum);
  if (threadIdx.x == 0) {
    atomicAdd(sums, loss);
    atomicAdd(sums + 1, rsum);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_entries_kernel(const int32_t* __restrict__ idx,
                       const T* __restrict__ ce, int64_t e,
                       T* __restrict__ g) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    const T c = ce[i];
    if (c != T(0)) atomicAdd(g + idx[i], c);
  }
}

int grid_for(int64_t items, int max_blocks) {
  const int64_t need = (items + kThreads - 1) / kThreads;
  return (int)(need < max_blocks ? (need > 0 ? need : 1) : max_blocks);
}

template <typename T>
int fused(const int32_t* idx, const T* val, const T* y, const T* w,
          const T* off, const T* theta, int64_t n, int k, int d,
          int has_intercept, int linear, T* grad, double* sums,
          int max_blocks, void* stream) {
  fe_fused_kernel<T><<<grid_for(n, max_blocks), kThreads, 0,
                       (cudaStream_t)stream>>>(
      idx, val, y, w, off, theta, n, k, d, has_intercept, linear, grad, sums);
  return (int)cudaGetLastError();
}

template <typename T>
int gather(const int32_t* idx, const T* val, const T* theta, int64_t e,
           T* out, int max_blocks, void* stream) {
  gather_entries_kernel<T><<<grid_for(e, max_blocks), kThreads, 0,
                             (cudaStream_t)stream>>>(idx, val, theta, e, out);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter(const int32_t* idx, const T* ce, int64_t e, T* g, int max_blocks,
            void* stream) {
  scatter_entries_kernel<T><<<grid_for(e, max_blocks), kThreads, 0,
                              (cudaStream_t)stream>>>(idx, ce, e, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gdx_fe_fused_f32(const int32_t* idx, const float* val, const float* y,
                     const float* w, const float* off, const float* theta,
                     int64_t n, int k, int d, int has_intercept, int linear,
                     float* grad, double* sums, int max_blocks,
                     void* stream) {
  return fused<float>(idx, val, y, w, off, theta, n, k, d, has_intercept,
                      linear, grad, sums, max_blocks, stream);
}

int gdx_fe_fused_f64(const int32_t* idx, const double* val, const double* y,
                     const double* w, const double* off, const double* theta,
                     int64_t n, int k, int d, int has_intercept, int linear,
                     double* grad, double* sums, int max_blocks,
                     void* stream) {
  return fused<double>(idx, val, y, w, off, theta, n, k, d, has_intercept,
                       linear, grad, sums, max_blocks, stream);
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

int gdx_fe_scatter_f32(const int32_t* idx, const float* ce, int64_t e,
                       float* g, int max_blocks, void* stream) {
  return scatter<float>(idx, ce, e, g, max_blocks, stream);
}

int gdx_fe_scatter_f64(const int32_t* idx, const double* ce, int64_t e,
                       double* g, int max_blocks, void* stream) {
  return scatter<double>(idx, ce, e, g, max_blocks, stream);
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
