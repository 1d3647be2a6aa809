// Shared device code for the Newton and linear-solve kernels: an in-place,
// unpivoted Gauss–Jordan solve on an augmented matrix held in shared memory.
//
// A is [d][d + 1] with row stride `lda` (the right-hand side in column d);
// on return column d holds x = A⁻¹·b. The row updates are those of the TPU
// kernel (gdmix_tpu/ops/pallas/linsolve.py:33-44): scale the pivot row by
// 1/A[j][j], subtract A[i][j] times it from every other row. Only columns
// j+1..d are touched: columns left of the pivot already hold the identity
// (up to rounding) and never feed back into column d, so skipping them
// leaves x unchanged and saves a third of the work.
//
// The caller damps A (Levenberg) so that it is SPD: no pivoting is needed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gdx {

constexpr unsigned kFullMask = 0xffffffffu;

// Row stride that is odd, so that threads walking down a column of a
// float array hit distinct shared-memory banks.
__host__ __device__ inline int odd_stride(int w) { return w | 1; }

template <bool kWarp>
__device__ __forceinline__ void coop_sync() {
  if (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// tid/nthr: this thread's rank among the cooperating threads (one warp when
// kWarp, else the whole block).
template <typename T, bool kWarp>
__device__ void gj_solve_inplace(T* A, int lda, int d, int tid, int nthr) {
  for (int j = 0; j < d; ++j) {
    T* row_j = A + j * lda;
    const T inv_p = T(1) / row_j[j];
    for (int k = j + 1 + tid; k <= d; k += nthr) row_j[k] *= inv_p;
    coop_sync<kWarp>();
    const int w = d - j;  // columns j+1 .. d
    for (int e = tid; e < d * w; e += nthr) {
      const int i = e / w;
      if (i == j) continue;
      const int k = j + 1 + (e - i * w);
      A[i * lda + k] -= A[i * lda + j] * row_j[k];
    }
    coop_sync<kWarp>();
  }
}

}  // namespace gdx
