// Shared device code for the Newton and linear-solve kernels: an in-place,
// unpivoted Gauss–Jordan solve on an augmented matrix [A | R].
//
// The matrix is [d][d + r] with row stride `lda` (the r right-hand sides in
// columns d .. d+r-1); on return those columns hold X = A⁻¹·R. It may live
// in shared memory or, for systems too large for it, in a global-memory
// workspace of the same layout. The row updates are those of the TPU
// kernels (gdmix_tpu/ops/pallas/linsolve.py:33-44 and :110-120): scale the
// pivot row by 1/A[j][j], subtract A[i][j] times it from every other row.
// Only columns j+1 .. d+r-1 are touched: columns left of the pivot already
// hold the identity (up to rounding) and never feed back into the
// right-hand sides, so skipping them leaves X unchanged and saves a third
// of the work.
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
// kWarp, else the whole block). Offsets within one system are 32-bit.
template <typename T, bool kWarp>
__device__ void gj_solve_inplace(T* A, int lda, int d, int r, int tid,
                                 int nthr) {
  const int cols = d + r;
  for (int j = 0; j < d; ++j) {
    T* row_j = A + j * lda;
    const T inv_p = T(1) / row_j[j];
    for (int k = j + 1 + tid; k < cols; k += nthr) row_j[k] *= inv_p;
    coop_sync<kWarp>();
    const int w = cols - 1 - j;  // columns j+1 .. d+r-1
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
