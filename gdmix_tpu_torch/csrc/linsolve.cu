// Batched solve of damped SPD systems H·x = g, batch-major, float or double.
//
// Replaces gdmix_tpu/ops/pallas/linsolve.py:_gj_kernel (spd_solve_lanes /
// spd_solve_batched), the solve of the batch-major Newton for
// 64 < dim <= 128 (gdmix_tpu/ops/newton.py:129-134).
//
// Design: one block per system. The augmented matrix [H | g] is copied once
// into shared memory (d·(d+1) elements: 64 KB in f32 and 128 KB in f64 at
// d = 128, so the dynamic limit is raised above 48 KB) and eliminated there;
// device memory sees one read of H and g and one write of x. The TPU kernel
// laid the batch along the 128 lanes and padded d to 8 and B to 128 with
// identity systems; here a block reads its own system straight from the
// batch-major array, so neither padding exists.
//
// Bound: shared-memory traffic of the d³/2 row updates (three accesses per
// fused multiply-add) and the 2·d block barriers per solve, not device
// memory — at d = 100 a system is 40 KB (f32) read once against ~10⁶
// shared-memory accesses.
#include "gj.cuh"

namespace {

template <typename T>
__global__ void spd_solve_kernel(const T* __restrict__ H,
                                 const T* __restrict__ g, T* __restrict__ x,
                                 int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  const int lda = gdx::odd_stride(d + 1);
  const int64_t sys = blockIdx.x;
  const T* Hs = H + sys * d * d;
  const T* gs = g + sys * d;
  for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
    const int i = e / d;
    A[i * lda + (e - i * d)] = Hs[e];
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x) A[i * lda + d] = gs[i];
  __syncthreads();
  gdx::gj_solve_inplace<T, false>(A, lda, d, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    x[sys * d + i] = A[i * lda + d];
  }
}

template <typename T>
int launch(const T* H, const T* g, T* x, int64_t B, int d, void* stream) {
  const size_t smem = sizeof(T) * (size_t)d * gdx::odd_stride(d + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = d > 64 ? 256 : 128;
  spd_solve_kernel<T><<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      H, g, x, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gdx_spd_solve_f32(const float* H, const float* g, float* x, int64_t B,
                      int d, void* stream) {
  return launch<float>(H, g, x, B, d, stream);
}

int gdx_spd_solve_f64(const double* H, const double* g, double* x, int64_t B,
                      int d, void* stream) {
  return launch<double>(H, g, x, B, d, stream);
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
