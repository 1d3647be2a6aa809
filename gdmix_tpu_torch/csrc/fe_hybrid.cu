// The hot side of the wide-D fixed-effect hybrid: one fused pass over the
// records against a compact top-A id space. Float and double.
//
// Replaces gdmix_tpu/ops/pallas/fe_hybrid.py:53 _kernel (K12,
// fe_hybrid_hot_pallas). Per record, with compact ids idx ∈ [0, A] (A is the
// dump slot of cold and padding entries):
//   z = Σ v·θc[idx] + off₂ + b        (off₂ already holds z_cold)
//   loss += w·bce(z, y) (or w·(y − z)²), r = w·(σ(z) − y) (or w·2(z − y))
//   g[idx] += v·r,  Σr += r,  r_out[row] = r (the cold side's input)
// The TPU kernel built this from one-hot matmuls on the MXU with θ and v·r
// split into two bf16 terms, a [T, 1] → [1, T] identity-dot transpose for r,
// and rows padded to 8 tiles; none of that exists here: the card gathers
// and adds natively, and each thread masks its own rows.
//
// Bound: device memory. A record is read once (K ids and values, y, w,
// off₂) and r written once: at N = 4,997,120, K = 16 in f32 about 720 MB,
// 0.21 ms at 3.35 TB/s. What stands between the kernel and that bound is
// contention: on Zipf(1.2) ids the hottest id alone is ~14% of all entries,
// and the fused kernel of fe_loss_grad.cu, whose atomics all go to device
// memory, runs ten times slower there than on uniform ids.
//
// Design: a persistent grid, as many blocks as fit on the SMs. While
// 2·A·sizeof(T) fits the shared-memory opt-in (A ≤ ~28k in f32), each block
// copies θc into shared memory and keeps a private compact gradient there,
// so the gradient's additions are shared-memory atomics, flushed at the end
// with one device atomic per non-zero slot per block. Past that (the wrapper
// decides by shape), the kernel reads θc and adds into the gradient in
// device memory: one template instantiation per address space, so the
// shared form keeps plain shared loads. One thread per record, each warp on
// 32 consecutive records: within a warp, the entries of one position k that
// share an id are summed first (__match_any_sync, then a tree over the
// peers), so one atomic goes out per distinct id. Entries at the dump slot
// or with value 0, and rows of weight 0, are skipped (r_out is 0 there).
// Loss and Σr are summed in double, reduced over the block and added with
// one double atomic per block.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
template <typename T>
__device__ __forceinline__ T abs_(T x) { return x < T(0) ? -x : x; }

template <typename T>
__device__ __forceinline__ T sigmoid(T z) {
  const T e = exp_(-abs_(z));
  return z >= T(0) ? T(1) / (T(1) + e) : e / (T(1) + e);
}

// Sum of v over the block, in thread 0 (all threads must call).
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < (kThreads / 32) ? part[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  }
  return v;
}

// The sum of x over the lanes of `peers` (the lanes holding the same id),
// in the lowest of them: a tree over the peers' ranks, each step adding the
// next remaining peer's partial sum. The whole warp must call.
template <typename T>
__device__ __forceinline__ T sum_peers(unsigned peers, T x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= ~((2u << lane) - 1u);        // peers above this lane
  while (__any_sync(kFull, peers != 0u)) {
    const int next = __ffs(peers);      // 1 + lane of the next peer, or 0
    const T t = __shfl_sync(kFull, x, (next - 1) & 31);
    if (next) x += t;
    peers &= ~__ballot_sync(kFull, rank & 1);   // odd ranks are absorbed
    rank >>= 1;
  }
  return x;
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
fe_hybrid_hot_kernel(const int32_t* __restrict__ idx,
                     const T* __restrict__ val, const T* __restrict__ y,
                     const T* __restrict__ w, const T* __restrict__ off2,
                     const T* __restrict__ theta_c,
                     const T* __restrict__ b_ptr, int64_t n, int k, int hot,
                     int linear, T* __restrict__ g, T* __restrict__ r_out,
                     double* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* th;
  T* acc;
  if constexpr (kShared) {
    T* th_s = reinterpret_cast<T*>(smem_raw);
    T* g_s = th_s + hot;
    for (int a = threadIdx.x; a < hot; a += blockDim.x) {
      th_s[a] = theta_c[a];
      g_s[a] = T(0);
    }
    __syncthreads();
    th = th_s;
    acc = g_s;
  } else {
    th = theta_c;
    acc = g;
  }
  const T b = *b_ptr;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  double loss = 0.0, rsum = 0.0;
  // the loop bound is uniform over a warp: the warp-wide votes below need
  // every lane
  for (int64_t base = warp * 32; base < n; base += stride) {
    const int64_t row = base + lane;
    const bool live = row < n;
    const int32_t* ri = idx + (live ? row : 0) * k;
    const T* rv = val + (live ? row : 0) * k;
    const T wt = live ? w[row] : T(0);
    T r = T(0);
    if (wt != T(0)) {
      T z = off2[row] + b;
      for (int j = 0; j < k; ++j) {
        const int32_t a = ri[j];
        const T v = rv[j];
        if ((unsigned)a < (unsigned)hot && v != T(0)) z += v * th[a];
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
      r = wt * dz;
      loss += (double)(wt * per);
      rsum += (double)r;
    }
    if (live) r_out[row] = r;
    for (int j = 0; j < k; ++j) {
      int32_t a = hot;
      T c = T(0);
      if (r != T(0)) {
        const T v = rv[j];
        a = ri[j];
        if ((unsigned)a < (unsigned)hot && v != T(0)) {
          c = v * r;
        } else {
          a = hot;
        }
      }
      const unsigned peers = __match_any_sync(kFull, a);
      c = sum_peers(peers, c);
      if (a != hot && lane == __ffs(peers) - 1) atomicAdd(acc + a, c);
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int a = threadIdx.x; a < hot; a += blockDim.x) {
      const T v = acc[a];
      if (v != T(0)) atomicAdd(g + a, v);
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

template <typename T, bool kShared>
int launch_form(const int32_t* idx, const T* val, const T* y, const T* w,
                const T* off2, const T* theta_c, const T* b, int64_t n, int k,
                int hot, int linear, T* g, T* r, double* sums,
                cudaStream_t stream) {
  auto kernel = fe_hybrid_hot_kernel<T, kShared>;
  const size_t smem = kShared ? 2 * sizeof(T) * (size_t)hot : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (n + kThreads - 1) / kThreads;
  int64_t blocks = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  if (need < blocks) blocks = need > 0 ? need : 1;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      idx, val, y, w, off2, theta_c, b, n, k, hot, linear, g, r, sums);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const int32_t* idx, const T* val, const T* y, const T* w,
           const T* off2, const T* theta_c, const T* b, int64_t n, int k,
           int hot, int linear, int shared, T* g, T* r, double* sums,
           void* stream) {
  if (shared)
    return launch_form<T, true>(idx, val, y, w, off2, theta_c, b, n, k, hot,
                                linear, g, r, sums, (cudaStream_t)stream);
  return launch_form<T, false>(idx, val, y, w, off2, theta_c, b, n, k, hot,
                               linear, g, r, sums, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// g [hot] and sums [2] (loss, Σr in double) must be zero on entry; r [n] is
// written whole. shared: 1 to keep θc and the gradient in shared memory
// (2·hot·sizeof(T) bytes), 0 for the device-memory form.
int gdx_fe_hybrid_hot_f32(const int32_t* idx, const float* val,
                          const float* y, const float* w, const float* off2,
                          const float* theta_c, const float* b, int64_t n,
                          int k, int hot, int linear, int shared, float* g,
                          float* r, double* sums, void* stream) {
  return launch<float>(idx, val, y, w, off2, theta_c, b, n, k, hot, linear,
                       shared, g, r, sums, stream);
}

int gdx_fe_hybrid_hot_f64(const int32_t* idx, const double* val,
                          const double* y, const double* w,
                          const double* off2, const double* theta_c,
                          const double* b, int64_t n, int k, int hot,
                          int linear, int shared, double* g, double* r,
                          double* sums, void* stream) {
  return launch<double>(idx, val, y, w, off2, theta_c, b, n, k, hot, linear,
                        shared, g, r, sums, stream);
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
