// Batched solve of damped SPD systems H·X = R with r right-hand sides by a
// panel-blocked, unpivoted LDLᵀ factorisation, batch-major, float or double:
// H [B, d, d], R [B, d, r], X [B, d, r].
//
// Replaces two TPU kernels, which solved by Gauss–Jordan elimination:
//   * gdmix_tpu/ops/pallas/linsolve.py:_gj_kernel (spd_solve_batched,
//     r = 1), the solve of the batch-major primal Newton for dim > 64
//     (gdmix_tpu/ops/newton.py:129-134);
//   * gdmix_tpu/ops/pallas/linsolve.py:_gj_kernel_mrhs
//     (spd_solve_batched_mrhs), the n×n kernel solve of the sample-space
//     dual Newton, n ≤ 128 and r = 2 (gdmix_tpu/ops/newton.py:168-170).
// Both systems are SPD by construction (Levenberg damping of H; K =
// √d√dᵀ⊙G + αI), so no pivoting is needed. The pivots D_jj are the Schur
// complement diagonals, the same numbers Gauss–Jordan divides by, and no
// square root is taken: a system Gauss–Jordan solved to finite numbers
// stays finite here.
//
// What bounds it on an H100: one read of H and R and one write of X per
// system against d³/6 + 2·d²·r multiply-adds. At the card's 3.35 TB/s and
// 67 TFLOP/s the bytes set the least time below d ≈ 120 in float32 (240 in
// float64), the operations above; the bytes are the lower triangle of H
// (all the kernel reads), R and X. In practice neither is reached: the
// latency of the panel steps (a chain of dependent shuffles and
// shared-memory loads per column of a panel) and the block barriers between
// them set the time of one system, and the number of systems resident on an
// SM sets how much of that latency the other blocks hide.
//
// The design, against the four causes that held the Gauss–Jordan kernel
// back:
//  1. Algorithm. LDLᵀ does d³/6 multiply-adds per system where Gauss–Jordan
//     did ~d³/2, and the substitutions 2·d²·r.
//  2. Inner loop. The dominant work, the trailing update A22 −= L21·W21ᵀ
//     (W21 = L21·D1) of each panel of kNB columns, runs on register tiles:
//     each thread owns kTile×kTile entries of the lower triangle, reads
//     kTile values of L21 and of W21 per panel column as two 16-byte loads
//     from a column-major panel buffer, and does kTile² fused multiply-adds
//     with them: no integer division, 2/kTile loads per multiply-add, and
//     the tile of A is read and written once per panel, not once per column.
//     The tile's place in the triangle is found once per tile (a square
//     root), not per element.
//  3. Barriers and occupancy. A panel costs three block barriers in the
//     factorisation (diagonal block, the rows below it, the trailing update)
//     and two in the back substitution: O(d/kNB) barriers per system instead
//     of 2·d. The diagonal block is factored by one warp in registers (lane i
//     holds row i, the pivot column comes by shuffles), with the forward
//     substitution of its right-hand sides. Only the lower triangle is kept
//     (packed by rows), half the square's shared memory, so more systems fit
//     an SM. The block size follows B and d: when B is at most two blocks per
//     SM, a system gets up to 512 threads to cut its latency; for large
//     batches smaller blocks let several systems share an SM.
//  4. Past shared memory. The triangle with its panel buffers and right-hand
//     sides fits the 227 KB a block may opt into up to d = 308 in float32
//     and d = 208 in float64 at r = 1 (`smem_elems` below; the wrapper holds
//     the same rule). Past that the same algorithm runs on a per-system device-memory
//     workspace of the same layout: the trailing update then reads and
//     writes each entry of A once per panel (kNB columns) through L2, not
//     once per column as the Gauss–Jordan workspace did. A left-looking form
//     that streams earlier panels into shared memory would read L once per
//     later panel instead; it is not built.
// H is read once (the lower triangle, coalesced by rows) and X written once.
// The trailing update stays on the CUDA cores in both types: TF32 would
// break the float32 tolerance, and in float64 the multiply-adds are a small
// share of a system's time next to the latency of the panel steps, so the
// FP64 tensor cores (mma.sync m8n8k4) would not pay for their fragment
// shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNB = 16;     // panel width (columns); ≤ 32, one warp's lanes
constexpr int kTile = 4;    // register tile of the trailing update
constexpr int kMaxThreads = 512;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
// offset of row i in the packed (by rows) lower triangle
__host__ __device__ inline int prow(int i) { return i * (i + 1) / 2; }

// Per-system arrays, in elements, each starting on a multiple of 4 (16-byte
// loads of the panels): the packed triangle A, the panels L21 and W21
// column-major [kNB][ldp], and the right-hand sides Y [d][r].
struct Layout {
  int lp, wp, y, total;
};

__host__ __device__ inline Layout layout(int d, int r) {
  const int ldp = round4(d);
  Layout s;
  s.lp = round4(prow(d));
  s.wp = s.lp + kNB * ldp;
  s.y = s.wp + kNB * ldp;
  s.total = s.y + round4(d * r);
  return s;
}

// the diagonal block's L11 [kNB][kNB] and 1/D [kNB], always in shared memory
constexpr int kSmall = kNB * kNB + kNB;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// One warp: LDLᵀ of the w×w diagonal block at j0 in registers (lane i holds
// row i), then the forward substitution Y1 := L11⁻¹·Y1. Writes L11 (strictly
// lower) and D back into A, L11 into l11 and 1/D into dinv.
template <typename T>
__device__ __forceinline__ void factor_diag_block(T* A, T* Y, T* l11,
                                                  T* dinv, int j0, int w,
                                                  int r, int lane) {
  const bool own = lane < w;
  T* Ai = A + prow(j0 + (own ? lane : 0)) + j0;
  T a[kNB];
#pragma unroll
  for (int k = 0; k < kNB; ++k) a[k] = (own && k <= lane) ? Ai[k] : T(0);
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (j < w) {
      const T wj = a[j];                          // W[i][j]; lane j: D_j
      const T inv = T(1) / __shfl_sync(kFull, wj, j);
      const T lj = wj * inv;
#pragma unroll
      for (int k = j + 1; k < kNB; ++k) {
        const T wk = __shfl_sync(kFull, wj, k);
        if (k <= lane) a[k] -= lj * wk;           // lane > j only, as k > j
      }
      if (lane > j) a[j] = lj;
      if (lane == j) dinv[j] = inv;
    }
  }
  if (own) {
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      if (k <= lane) Ai[k] = a[k];
      if (k < lane) l11[lane * kNB + k] = a[k];
    }
  }
  for (int c = 0; c < r; ++c) {
    T y = own ? Y[(j0 + lane) * r + c] : T(0);
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      if (k < w) {
        const T yk = __shfl_sync(kFull, y, k);
        if (lane > k) y -= a[k] * yk;
      }
    }
    if (own) Y[(j0 + lane) * r + c] = y;
  }
}

// The rows below the diagonal block, one thread a row: W21 = A21·L11⁻ᵀ by
// forward substitution, L21 = W21·D1⁻¹ into A and both into the panel
// buffers; and the rows' right-hand sides Y2 −= L21·Y1.
template <typename T>
__device__ __forceinline__ void panel_rows(T* A, T* Y, T* Lp, T* Wp,
                                           const T* l11, const T* dinv,
                                           int j0, int w, int d, int r,
                                           int ldp, int tid, int nthr) {
  const int j1 = j0 + w;
  for (int i = j1 + tid; i < d; i += nthr) {
    T* Ai = A + prow(i) + j0;
    T v[kNB];
#pragma unroll
    for (int m = 0; m < kNB; ++m) v[m] = m < w ? Ai[m] : T(0);
#pragma unroll
    for (int m = 1; m < kNB; ++m) {
      if (m < w) {
        T s = v[m];
#pragma unroll
        for (int q = 0; q < m; ++q) s -= l11[m * kNB + q] * v[q];
        v[m] = s;
      }
    }
#pragma unroll
    for (int m = 0; m < kNB; ++m) {
      if (m < w) {
        const T l = v[m] * dinv[m];
        Ai[m] = l;
        Lp[m * ldp + (i - j1)] = l;
        Wp[m * ldp + (i - j1)] = v[m];
        v[m] = l;
      }
    }
    for (int c = 0; c < r; ++c) {
      T s = Y[i * r + c];
#pragma unroll
      for (int m = 0; m < kNB; ++m)
        if (m < w) s -= v[m] * Y[(j0 + m) * r + c];
      Y[i * r + c] = s;
    }
  }
}

// A22 −= L21·W21ᵀ on the lower triangle of the n2×n2 trailing matrix at j1,
// one kTile×kTile register tile per task.
template <typename T>
__device__ __forceinline__ void trailing_update(T* A, const T* Lp,
                                                const T* Wp, int w, int j1,
                                                int n2, int ldp, int tid,
                                                int nthr) {
  const int nt = (n2 + kTile - 1) / kTile;
  const int ntiles = nt * (nt + 1) / 2;
  for (int t = tid; t < ntiles; t += nthr) {
    int bi = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
    while (prow(bi) > t) --bi;
    while (prow(bi + 1) <= t) ++bi;
    const int i0 = bi * kTile, k0 = (t - prow(bi)) * kTile;
    T acc[kTile][kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) acc[a][b] = T(0);
#pragma unroll 4
    for (int m = 0; m < w; ++m) {
      T l[kTile], v[kTile];
      load4(Lp + m * ldp + i0, l);
      load4(Wp + m * ldp + k0, v);
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b) acc[a][b] += l[a] * v[b];
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int i = i0 + a;
      if (i < n2) {
        T* Ai = A + prow(j1 + i) + j1 + k0;
#pragma unroll
        for (int b = 0; b < kTile; ++b)
          if (k0 + b <= i) Ai[b] -= acc[a][b];
      }
    }
  }
}

// One warp: the back substitution L11ᵀ·X1 = Z1 of the block at j0.
template <typename T>
__device__ __forceinline__ void back_diag_block(const T* A, T* Y, int j0,
                                                int w, int r, int lane) {
  for (int c = 0; c < r; ++c) {
    T z = lane < w ? Y[(j0 + lane) * r + c] : T(0);
#pragma unroll
    for (int k = kNB - 1; k > 0; --k) {
      if (k < w) {
        const T xk = __shfl_sync(kFull, z, k);
        if (lane < k) z -= A[prow(j0 + k) + j0 + lane] * xk;
      }
    }
    if (lane < w) Y[(j0 + lane) * r + c] = z;
  }
}

// kWorkspace: A, the panels and Y live in the device-memory workspace `ws`
// (Layout per system) instead of shared memory. A template parameter, so
// that the shared-memory instantiation keeps plain shared loads and stores.
template <typename T, bool kWorkspace>
__global__ void __launch_bounds__(kMaxThreads)
    ldlt_solve_kernel(const T* __restrict__ H, const T* __restrict__ R,
                      T* __restrict__ X, int d, int r, T* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Layout lay = layout(d, r);
  const int64_t sys = blockIdx.x;
  T* base = kWorkspace ? ws + sys * lay.total : sm;
  T* A = base;
  T* Lp = base + lay.lp;
  T* Wp = base + lay.wp;
  T* Y = base + lay.y;
  T* l11 = kWorkspace ? sm : sm + lay.total;
  T* dinv = l11 + kNB * kNB;
  const int ldp = round4(d);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  const T* Hs = H + sys * d * d;
  for (int i = warp; i < d; i += nwarp) {
    T* Ai = A + prow(i);
    const T* Hi = Hs + i * d;
    for (int k = lane; k <= i; k += 32) Ai[k] = Hi[k];
  }
  const T* Rs = R + sys * d * r;
  for (int e = tid; e < d * r; e += nthr) Y[e] = Rs[e];
  __syncthreads();

  for (int j0 = 0; j0 < d; j0 += kNB) {
    const int w = min(kNB, d - j0);
    if (warp == 0) factor_diag_block<T>(A, Y, l11, dinv, j0, w, r, lane);
    __syncthreads();
    const int n2 = d - j0 - w;
    if (n2 > 0) {
      panel_rows<T>(A, Y, Lp, Wp, l11, dinv, j0, w, d, r, ldp, tid, nthr);
      __syncthreads();
      trailing_update<T>(A, Lp, Wp, w, j0 + w, n2, ldp, tid, nthr);
      __syncthreads();
    }
  }
  for (int i = tid; i < d; i += nthr) {
    const T D = A[prow(i) + i];
    for (int c = 0; c < r; ++c) Y[i * r + c] /= D;
  }
  __syncthreads();
  for (int j0 = (d - 1) / kNB * kNB; j0 >= 0; j0 -= kNB) {
    const int w = min(kNB, d - j0);
    if (warp == 0) back_diag_block<T>(A, Y, j0, w, r, lane);
    __syncthreads();
    if (j0 == 0) break;
    // Z0 −= L10ᵀ·X1 for the rows above the block
    for (int i = tid; i < j0; i += nthr) {
      for (int c = 0; c < r; ++c) {
        T s = Y[i * r + c];
        for (int m = 0; m < w; ++m)
          s -= A[prow(j0 + m) + i] * Y[(j0 + m) * r + c];
        Y[i * r + c] = s;
      }
    }
    __syncthreads();
  }
  T* Xs = X + sys * d * r;
  for (int e = tid; e < d * r; e += nthr) Xs[e] = Y[e];
}

// Elements of shared memory a block needs: everything in the shared form,
// the diagonal block's scratch only in the workspace form.
inline int64_t smem_elems(int d, int r, bool workspace) {
  return (workspace ? 0 : (int64_t)layout(d, r).total) + kSmall;
}

// Threads per system: enough for a panel's rows and the first trailing
// update's tiles, up to 512 when the batch is at most two blocks per SM or a
// block fills most of an SM's shared memory (latency bound: one system per
// SM), else 128 (d ≤ 64) or 256, so that several systems share an SM.
inline int threads_for(int64_t B, int d, size_t smem_bytes) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      sms = 132;
  }
  const int nt = (d + kTile - 1) / kTile;
  const int work = d > nt * (nt + 1) / 2 ? d : nt * (nt + 1) / 2;
  const int cap = (B <= 2 * (int64_t)sms || d > 160 || smem_bytes > 76 * 1024)
                      ? kMaxThreads
                      : (d <= 64 ? 128 : 256);
  const int want = (work + 31) / 32 * 32;
  return want < 32 ? 32 : (want > cap ? cap : want);
}

template <typename T>
int launch(const T* H, const T* R, T* X, int64_t B, int d, int r, T* ws,
           void* stream) {
  const bool use_ws = ws != nullptr;
  const size_t smem = sizeof(T) * (size_t)smem_elems(d, r, use_ws);
  const int threads = threads_for(B, d, smem);
  if (use_ws) {
    ldlt_solve_kernel<T, true><<<(unsigned)B, threads, smem,
                                 (cudaStream_t)stream>>>(H, R, X, d, r, ws);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ldlt_solve_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ldlt_solve_kernel<T, false><<<(unsigned)B, threads, smem,
                                (cudaStream_t)stream>>>(H, R, X, d, r, ws);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws: nullptr to factor in shared memory, else a workspace of
// gdx_ldlt_workspace_elems(d, r) elements per system in device memory.
int gdx_ldlt_solve_f32(const float* H, const float* R, float* X, int64_t B,
                       int d, int r, float* ws, void* stream) {
  return launch<float>(H, R, X, B, d, r, ws, stream);
}

int gdx_ldlt_solve_f64(const double* H, const double* R, double* X,
                       int64_t B, int d, int r, double* ws, void* stream) {
  return launch<double>(H, R, X, B, d, r, ws, stream);
}

// elements of the workspace per system: the wrapper checks its own storage
// rule against this layout
int64_t gdx_ldlt_workspace_elems(int d, int r) { return layout(d, r).total; }

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
