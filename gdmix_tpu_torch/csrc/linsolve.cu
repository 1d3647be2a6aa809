// Batched solve of damped SPD systems H·X = R with r right-hand sides,
// batch-major, float or double: H [B, d, d], R [B, d, r], X [B, d, r].
//
// Replaces two TPU kernels with one elimination (gj.cuh):
//   * gdmix_tpu/ops/pallas/linsolve.py:_gj_kernel (spd_solve_batched,
//     r = 1), the solve of the batch-major primal Newton for dim > 64
//     (gdmix_tpu/ops/newton.py:129-134);
//   * gdmix_tpu/ops/pallas/linsolve.py:_gj_kernel_mrhs
//     (spd_solve_batched_mrhs), the n×n kernel solve of the sample-space
//     dual Newton, n ≤ 128 and r = 2 (gdmix_tpu/ops/newton.py:168-170).
//
// Design: one block per system. The augmented matrix [H | R] is copied once
// into shared memory (d·(d+r) elements with an odd row stride: 64 KB in f32
// and 128 KB in f64 at d = 128, r = 1; 134 KB at n = 128, r = 2 in f64, so
// the dynamic limit is raised above 48 KB) and eliminated there; device
// memory sees one read of H and R and one write of X. A system too large
// for the 227 KB a block may opt into (d > 240 in f32, d > 169 in f64)
// runs the same elimination on a global-memory workspace of the same
// layout that the caller allocates ([B, d, stride]); it then lives in L2
// and L1 rather than shared memory. The TPU kernels laid the batch along
// the 128 lanes and padded d to 8 and B to 128 with identity systems; here
// a block reads its own system straight from the batch-major arrays, so
// neither padding exists.
//
// Bound: per system, the ~d³/2 fused multiply-adds of the row updates (three
// shared-memory accesses each) and 2·d block barriers, against one device
// read of H and R: at d = 100 a system is 40 KB (f32) read once against
// ~1.5·10⁶ shared-memory accesses, so the elimination, not device memory,
// sets the time; the design keeps every access after the first read on
// chip, and the odd row stride keeps a column walk free of bank conflicts
// in f32.
#include "gj.cuh"

namespace {

// kWorkspace: eliminate in the global-memory workspace `ws` instead of
// shared memory. A template parameter, so that each instantiation knows the
// address space of A and the shared-memory one keeps plain shared loads and
// stores.
template <typename T, bool kWorkspace>
__global__ void spd_solve_kernel(const T* __restrict__ H,
                                 const T* __restrict__ R, T* __restrict__ X,
                                 int d, int r, T* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = gdx::odd_stride(d + r);
  const int64_t sys = blockIdx.x;
  T* A = kWorkspace ? ws + sys * d * lda : reinterpret_cast<T*>(smem_raw);
  const T* Hs = H + sys * d * d;
  const T* Rs = R + sys * d * r;
  for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
    const int i = e / d;
    A[i * lda + (e - i * d)] = Hs[e];
  }
  for (int e = threadIdx.x; e < d * r; e += blockDim.x) {
    const int i = e / r;
    A[i * lda + d + (e - i * r)] = Rs[e];
  }
  __syncthreads();
  gdx::gj_solve_inplace<T, false>(A, lda, d, r, threadIdx.x, blockDim.x);
  for (int e = threadIdx.x; e < d * r; e += blockDim.x) {
    const int i = e / r;
    X[sys * d * r + e] = A[i * lda + d + (e - i * r)];
  }
}

template <typename T>
int launch(const T* H, const T* R, T* X, int64_t B, int d, int r, T* ws,
           void* stream) {
  const int threads = d > 128 ? 512 : d > 64 ? 256 : 128;
  if (ws != nullptr) {
    spd_solve_kernel<T, true><<<(unsigned)B, threads, 0,
                                (cudaStream_t)stream>>>(H, R, X, d, r, ws);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(T) * (size_t)d * gdx::odd_stride(d + r);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spd_solve_kernel<T, false><<<(unsigned)B, threads, smem,
                               (cudaStream_t)stream>>>(H, R, X, d, r, ws);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws: nullptr to eliminate in shared memory, else a [B, d, (d + r) | 1]
// workspace in device memory.
int gdx_spd_solve_f32(const float* H, const float* R, float* X, int64_t B,
                      int d, int r, float* ws, void* stream) {
  return launch<float>(H, R, X, B, d, r, ws, stream);
}

int gdx_spd_solve_f64(const double* H, const double* R, double* X, int64_t B,
                      int d, int r, double* ws, void* stream) {
  return launch<double>(H, R, X, B, d, r, ws, stream);
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
