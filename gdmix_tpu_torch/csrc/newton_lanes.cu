// Damped-Newton kernels for batched per-entity logistic regression (f32).
//
// Objective per entity (the mean form of gdmix_tpu/ops/newton.py):
//   f(θ) = (Σ_r w_r·bce(z_r, y_r) + ½·Σ_k λ_k·θ_k²) / n,  z = Xθ + offset,
// with λ_0 = 0 when the intercept is unregularised. A Newton step solves
//   A·δ = g,  A = (XᵀDX + diag λ)/n + diag(ε·(1 + |diag|)),  ε = 1e-6,
// exactly as _damped_gj_solve (gdmix_tpu/ops/pallas/newton_lanes.py:101-134)
// does, so the iterates match the batch-major solver's.
//
// newton_full — replaces newton_lanes.py:_newton_full_kernel (K1): the whole
//   solve for an entity with n·d ≤ 1024. One warp per entity, four entities
//   per block. The entity's X (at most 4 KB), the augmented Hessian and the
//   per-row vectors stay in shared memory for the whole solve; device memory
//   sees one read of X and one write of θ. Each warp runs its own loop and
//   stops when its entity is done (the TPU kernel stopped per 128-lane
//   block), with the same semantics: Armijo backtracking (c1 = 1e-4, at most
//   20 halvings), frozen once converged, done when a step is refused.
//   Bound: shared-memory bandwidth of the Hessian build (n·d² multiply-adds,
//   two shared loads each) and of the d³/3 Gauss–Jordan updates; only
//   warp-level barriers are used.
//
// newton_fgd — replaces newton_lanes.py:_fgd_kernel (K2): for larger n, one
//   Newton iteration: f, the scaled gradient and δ. One block per entity
//   streams X through shared memory in chunks of rows, accumulates f, g and
//   H there (no carry between blocks), then damps and solves in place. X at
//   n = 2048, d = 32 is 256 KB, more than a block's 227 KB, hence the
//   chunks. The line search stays outside, in PyTorch. Bound: the same
//   shared-memory traffic per row as newton_full, plus one read of X per
//   iteration from device memory.
#include "gj.cuh"

namespace {

constexpr float kArmijoC1 = 1e-4f;
constexpr int kMaxBacktracks = 20;
constexpr float kDampEps = 1e-6f;
constexpr int kWarpsPerBlock = 4;
constexpr int kFgdThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(gdx::kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(gdx::kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float bce(float z, float y) {
  return fmaxf(z, 0.f) - z * y + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ float lam_of(int k, float lam, int unreg_bias) {
  return (unreg_bias && k == 0) ? 0.f : lam;
}

// Row stride of an X tile in shared memory: odd, so lanes that each walk
// their own row (z = X·θ) hit distinct banks.
__host__ __device__ inline int x_stride(int d) { return gdx::odd_stride(d); }

// Floats of shared memory one newton_full warp uses.
__host__ __device__ inline int full_warp_floats(int n, int d) {
  return n * x_stride(d) + d * gdx::odd_stride(d + 1) + 4 * d + 5 * n;
}

struct WarpTile {
  float* X;    // [n][ldx]
  float* A;    // [d][lda]: Hessian | gradient, then solved in place
  float* th;   // [d] current θ
  float* dl;   // [d] Newton step δ
  float* gs;   // [d] scaled gradient
  float* tr;   // [d] line-search trial
  float* y;    // [n]
  float* w;    // [n]
  float* off;  // [n]
  float* rr;   // [n] w·(p − y)
  float* dv;   // [n] w·p·(1 − p)
  int ldx, lda;
};

// Σ_r w_r·bce(z_r) for θ = `th`; with `derivs` also the per-row residual
// and curvature. Warp-uniform result.
__device__ float warp_rows(const WarpTile& t, const float* th, int n, int d,
                           bool derivs, int lane) {
  float acc = 0.f;
  for (int r = lane; r < n; r += 32) {
    const float* xr = t.X + r * t.ldx;
    float z = 0.f;
    for (int k = 0; k < d; ++k) z += xr[k] * th[k];
    z += t.off[r];
    acc += t.w[r] * bce(z, t.y[r]);
    if (derivs) {
      const float p = sigmoid(z);
      t.rr[r] = t.w[r] * (p - t.y[r]);
      t.dv[r] = t.w[r] * p * (1.f - p);
    }
  }
  return warp_sum(acc);
}

__device__ float warp_reg(const float* th, int d, float lam, int unreg_bias,
                          int lane) {
  float acc = 0.f;
  for (int k = lane; k < d; k += 32)
    acc += lam_of(k, lam, unreg_bias) * th[k] * th[k];
  return 0.5f * warp_sum(acc);
}

// f, the scaled gradient (t.gs) and the Newton step (t.dl) at t.th.
__device__ float warp_fgd(const WarpTile& t, int n, int d, float lam,
                          int unreg_bias, float inv_n, int lane) {
  const float f_data = warp_rows(t, t.th, n, d, true, lane);
  const float reg = warp_reg(t.th, d, lam, unreg_bias, lane);
  __syncwarp();
  for (int k = lane; k < d; k += 32) {
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += t.X[r * t.ldx + k] * t.rr[r];
    const float g = (s + lam_of(k, lam, unreg_bias) * t.th[k]) * inv_n;
    t.gs[k] = g;
    t.A[k * t.lda + d] = g;
  }
  for (int e = lane; e < d * d; e += 32) {
    const int k = e / d, l = e - k * d;
    float s = 0.f;
    for (int r = 0; r < n; ++r)
      s += t.X[r * t.ldx + k] * (t.X[r * t.ldx + l] * t.dv[r]);
    if (k == l) {
      s = (s + lam_of(k, lam, unreg_bias)) * inv_n;
      s += kDampEps * (1.f + fabsf(s));
    } else {
      s *= inv_n;
    }
    t.A[k * t.lda + l] = s;
  }
  __syncwarp();
  gdx::gj_solve_inplace<float, true>(t.A, t.lda, d, 1, lane, 32);
  for (int k = lane; k < d; k += 32) t.dl[k] = t.A[k * t.lda + d];
  __syncwarp();
  return (f_data + reg) * inv_n;
}

__global__ void newton_full_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ W, const float* __restrict__ OFF,
    const float* __restrict__ CNT, const float* __restrict__ TH0,
    float* __restrict__ TH, uint8_t* __restrict__ CONV,
    int32_t* __restrict__ ITERS, int64_t B, int n, int d, float lam,
    int unreg_bias, int maxiter, float ftol, float pgtol) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only: no block-wide barrier below
  extern __shared__ __align__(16) float smem[];
  WarpTile t;
  t.ldx = x_stride(d);
  t.lda = gdx::odd_stride(d + 1);
  t.X = smem + warp * full_warp_floats(n, d);
  t.A = t.X + n * t.ldx;
  t.th = t.A + d * t.lda;
  t.dl = t.th + d;
  t.gs = t.dl + d;
  t.tr = t.gs + d;
  t.y = t.tr + d;
  t.w = t.y + n;
  t.off = t.w + n;
  t.rr = t.off + n;
  t.dv = t.rr + n;

  const float* Xb = X + b * n * d;
  for (int e = lane; e < n * d; e += 32) {
    const int r = e / d;
    t.X[r * t.ldx + (e - r * d)] = Xb[e];
  }
  for (int r = lane; r < n; r += 32) {
    t.y[r] = Y[b * n + r];
    t.w[r] = W[b * n + r];
    t.off[r] = OFF[b * n + r];
  }
  for (int k = lane; k < d; k += 32) t.th[k] = TH0[b * d + k];
  const float inv_n = 1.f / fmaxf(CNT[b], 1.f);
  __syncwarp();

  float f = warp_fgd(t, n, d, lam, unreg_bias, inv_n, lane);
  float gmax = 0.f;
  for (int k = lane; k < d; k += 32) gmax = fmaxf(gmax, fabsf(t.gs[k]));
  bool done = warp_max(gmax) <= pgtol;
  int iters = 0;
  for (int it = 0; it < maxiter && !done; ++it) {
    float gd = 0.f;
    for (int k = lane; k < d; k += 32) gd += t.gs[k] * t.dl[k];
    const float gdot = warp_sum(gd);
    float step = 1.f, f_new = f;
    bool accepted = false;
    for (int i = 0; i < kMaxBacktracks && !accepted; ++i) {
      for (int k = lane; k < d; k += 32) t.tr[k] = t.th[k] - step * t.dl[k];
      __syncwarp();
      const float f_trial = (warp_rows(t, t.tr, n, d, false, lane) +
                             warp_reg(t.tr, d, lam, unreg_bias, lane)) *
                            inv_n;
      // lane 0 decides for the warp, so control flow stays uniform
      const int ok = __shfl_sync(gdx::kFullMask,
                                 f_trial <= f - kArmijoC1 * step * gdot, 0);
      if (ok) {
        accepted = true;
        f_new = f_trial;
      } else {
        step *= 0.5f;
      }
      __syncwarp();
    }
    if (accepted) {
      for (int k = lane; k < d; k += 32) t.th[k] = t.th[k] - step * t.dl[k];
    }
    __syncwarp();
    const float f_next = accepted ? f_new : f;
    warp_fgd(t, n, d, lam, unreg_bias, inv_n, lane);
    gmax = 0.f;
    for (int k = lane; k < d; k += 32) gmax = fmaxf(gmax, fabsf(t.gs[k]));
    gmax = warp_max(gmax);
    const float f_drop = f - f_next;
    const float rel = fmaxf(fmaxf(fabsf(f), fabsf(f_next)), 1.f);
    const bool conv = gmax <= pgtol || f_drop <= ftol * rel;
    done = __shfl_sync(gdx::kFullMask, (int)(conv || !accepted), 0);
    iters += 1;
    f = f_next;
  }
  for (int k = lane; k < d; k += 32) TH[b * d + k] = t.th[k];
  if (lane == 0) {
    CONV[b] = done ? 1 : 0;
    ITERS[b] = iters;
  }
}

// Floats of shared memory one newton_fgd block uses.
__host__ __device__ inline int fgd_block_floats(int nb, int d) {
  return nb * x_stride(d) + d * gdx::odd_stride(d + 1) + d + 2 * nb + 32;
}

__global__ void newton_fgd_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ W, const float* __restrict__ OFF,
    const float* __restrict__ CNT, const float* __restrict__ TH,
    float* __restrict__ F, float* __restrict__ G, float* __restrict__ DELTA,
    int n, int d, int nb, float lam, int unreg_bias) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ldx = x_stride(d), lda = gdx::odd_stride(d + 1);
  float* Xs = smem;                // [nb][ldx] chunk of rows
  float* A = Xs + nb * ldx;        // [d][lda]
  float* th = A + d * lda;         // [d]
  float* rr = th + d;              // [nb]
  float* dv = rr + nb;             // [nb]
  float* red = dv + nb;            // [32] reduction scratch
  const int64_t b = blockIdx.x;

  for (int k = tid; k < d; k += nthr) th[k] = TH[b * d + k];
  for (int e = tid; e < d * d; e += nthr) {
    const int k = e / d;
    A[k * lda + (e - k * d)] = 0.f;
  }
  float g_acc = 0.f;  // thread k < d owns gradient coordinate k
  float f_acc = 0.f;
  __syncthreads();
  for (int r0 = 0; r0 < n; r0 += nb) {
    const int rows = min(nb, n - r0);
    const float* Xc = X + (b * n + r0) * d;
    for (int e = tid; e < rows * d; e += nthr) {
      const int r = e / d;
      Xs[r * ldx + (e - r * d)] = Xc[e];
    }
    __syncthreads();
    for (int r = tid; r < rows; r += nthr) {
      const float* xr = Xs + r * ldx;
      float z = 0.f;
      for (int k = 0; k < d; ++k) z += xr[k] * th[k];
      const int64_t q = b * n + r0 + r;
      z += OFF[q];
      const float y = Y[q], w = W[q];
      f_acc += w * bce(z, y);
      const float p = sigmoid(z);
      rr[r] = w * (p - y);
      dv[r] = w * p * (1.f - p);
    }
    __syncthreads();
    if (tid < d) {
      for (int r = 0; r < rows; ++r) g_acc += Xs[r * ldx + tid] * rr[r];
    }
    for (int e = tid; e < d * d; e += nthr) {
      const int k = e / d, l = e - k * d;
      float s = 0.f;
      for (int r = 0; r < rows; ++r)
        s += Xs[r * ldx + k] * (Xs[r * ldx + l] * dv[r]);
      A[k * lda + l] += s;
    }
    __syncthreads();
  }

  // f: block sum of the per-thread partials, plus the L2 term
  float reg_part = 0.f;
  for (int k = tid; k < d; k += nthr)
    reg_part += lam_of(k, lam, unreg_bias) * th[k] * th[k];
  const float f_part = warp_sum(f_acc);
  const float reg_w = warp_sum(reg_part);
  if ((tid & 31) == 0) {
    red[tid >> 5] = f_part;
    red[16 + (tid >> 5)] = reg_w;
  }
  const float inv_n = 1.f / fmaxf(CNT[b], 1.f);
  if (tid < d) {
    const float g = (g_acc + lam_of(tid, lam, unreg_bias) * th[tid]) * inv_n;
    A[tid * lda + d] = g;
    G[b * d + tid] = g;
  }
  __syncthreads();
  if (tid == 0) {
    float fs = 0.f, rs = 0.f;
    for (int i = 0; i < (nthr >> 5); ++i) {
      fs += red[i];
      rs += red[16 + i];
    }
    F[b] = (fs + 0.5f * rs) * inv_n;
  }
  for (int e = tid; e < d * d; e += nthr) {
    const int k = e / d, l = e - k * d;
    float s = A[k * lda + l];
    if (k == l) {
      s = (s + lam_of(k, lam, unreg_bias)) * inv_n;
      s += kDampEps * (1.f + fabsf(s));
    } else {
      s *= inv_n;
    }
    A[k * lda + l] = s;
  }
  __syncthreads();
  gdx::gj_solve_inplace<float, false>(A, lda, d, 1, tid, nthr);
  for (int k = tid; k < d; k += nthr) DELTA[b * d + k] = A[k * lda + d];
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// θ [B, d] f32, converged [B] bool (one byte), iterations [B] int32.
int gdx_newton_full(const float* X, const float* Y, const float* W,
                    const float* OFF, const float* CNT, const float* TH0,
                    float* TH, uint8_t* CONV, int32_t* ITERS, int64_t B,
                    int n, int d, float lam, int unreg_bias, int maxiter,
                    float ftol, float pgtol, void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)kWarpsPerBlock * full_warp_floats(n, d);
  int err = set_smem((const void*)newton_full_kernel, smem);
  if (err) return err;
  const int64_t blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  newton_full_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                       (cudaStream_t)stream>>>(
      X, Y, W, OFF, CNT, TH0, TH, CONV, ITERS, B, n, d, lam, unreg_bias,
      maxiter, ftol, pgtol);
  return (int)cudaGetLastError();
}

// Rows of X per shared-memory chunk in newton_fgd.
int gdx_fgd_rows_per_chunk(int n) { return n < 64 ? n : 64; }

// f [B], scaled gradient [B, d], Newton step [B, d], all f32.
int gdx_newton_fgd(const float* X, const float* Y, const float* W,
                   const float* OFF, const float* CNT, const float* TH,
                   float* F, float* G, float* DELTA, int64_t B, int n, int d,
                   float lam, int unreg_bias, void* stream) {
  const int nb = gdx_fgd_rows_per_chunk(n);
  const size_t smem = sizeof(float) * (size_t)fgd_block_floats(nb, d);
  int err = set_smem((const void*)newton_fgd_kernel, smem);
  if (err) return err;
  newton_fgd_kernel<<<(unsigned)B, kFgdThreads, smem,
                      (cudaStream_t)stream>>>(X, Y, W, OFF, CNT, TH, F, G,
                                              DELTA, n, d, nb, lam,
                                              unreg_bias);
  return (int)cudaGetLastError();
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
