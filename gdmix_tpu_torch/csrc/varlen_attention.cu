// Attention over packed documents of different lengths, forward and
// backward, in float32 on the FMA units (no tensor core, no TF32): the
// ModernBERT encoder's attention (models/deep_tower.py, through
// ops/varlen_attention.py).
//
// Replaces no TPU kernel: the JAX package has no ModernBERT encoder, and
// its attention encoders run outside any Pallas kernel. It exists because
// no PyTorch operator computes attention over packed documents within a
// window: at 8,192 positions the padded [B, heads, L, L] layout would
// compute ~140 times a step's real work.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [T, H, 64] (a token's heads
// side by side), document b owning tokens [offsets[b], offsets[b + 1]).
// A query i of a document sees the document's keys j with |i − j| ≤
// window (window ≥ 0), or all of them (window < 0); logits are scaled by
// 1/8. lse [T, H] is each row's natural log-sum-exp of its scaled logits;
// delta [T, H] the backward's rowsum(dO ⊙ O).
//
// Forward (attn_forward_kernel): FlashAttention-2's tiling. A block of 128
// threads takes 64 queries of one document and head, keeps them in shared
// memory, and walks the document's key tiles of 64 that the window
// reaches (no tile outside the document or wholly outside the window is
// loaded), with an online softmax: S = Q·Kᵀ, the row maxima and sums, O
// rescaled and O += P·V, all in registers but P, which passes through
// shared memory. Backward: attn_delta_kernel (D), attn_dkdv_kernel (a block
// a key tile: dV += Pᵀ·dO, dK += dSᵀ·Q over the query tiles that see it,
// dS = P ⊙ (dO·Vᵀ − D)) and attn_dq_kernel (a block a query tile: dQ +=
// dS·K over its key tiles). Each output row is written by one block, in a
// fixed order of sums: no atomics, and a step repeats bit for bit.
//
// What bounds it: operations. A global layer at this model's lengths does
// 2·n²·64 multiply-adds a head and document forward, ~64 times its bytes
// at the card's ratio; a local one 2·n·129·64. Every product is FFMA: the
// card's float32 peak outside the tensor cores is 67 TFLOP/s. The design
// keeps the FFMAs fed from shared memory: each thread computes a 4×8 tile
// of S (rows ty·4…, columns tx + 8u) and a 4×8 tile of O (rows ty·4…,
// columns tx·4 + 32·jj…), reading 16-byte vectors (12 vector loads a 128
// FFMAs); rows are padded to 68 floats so that the eight lanes of a
// quarter warp read eight distinct bank groups. A row's eight lanes are
// eight consecutive lanes of one warp, so the softmax's reductions are
// three shuffles and P's round trip through shared memory needs no block
// barrier. Tiles wholly inside the window skip the mask. Backward
// recomputes S (and dP) in both its kernels: 7 tile products against the
// forward's 2.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;               // head size
constexpr int kTile = 64;            // queries a block, keys a tile
constexpr int kThreads = 128;
constexpr int kStride = kD + 4;      // a shared row, floats
constexpr int kTileFloats = kTile * kStride;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;   // (1/8)·log2 e
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;
  const float* dout;
  const float* delta;
  const int32_t* offsets;
  int heads;
  int window;
  float* out;      // forward: O; dq kernel: dQ; dkdv kernel: dK
  float* out2;     // forward: lse; dkdv kernel: dV
};

// `kTile` rows of [*, heads, kD] from token `first` of a document of `n`
// (rows past n are zeros) into a shared tile of kStride-float rows.
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          int64_t row_stride, int first,
                                          int n) {
  for (int i = threadIdx.x; i < kTile * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < n)
      val = *reinterpret_cast<const float4*>(
          g + (int64_t)(first + r) * row_stride + c);
    *reinterpret_cast<float4*>(s + r * kStride + c) = val;
  }
}

// acc[i][u] = Σ_k A[ty·4 + i][k] · B[tx + 8u][k] over a tile's kD columns
__device__ __forceinline__ void tile_dot(float acc[4][8], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kD; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * kStride + k);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (tx + 8 * u) * kStride + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][u];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][u] = s;
      }
    }
  }
}

// acc[i][jj·4 + e] += Σ_j W[ty·4 + i][j] · V[j][tx·4 + 32·jj + e] over a
// tile's kTile rows j (W the thread's rows of P or dS, V a value tile)
__device__ __forceinline__ void tile_accumulate(float acc[4][8],
                                                const float* W,
                                                const float* V, int ty,
                                                int tx) {
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (ty * 4 + i) * kStride + j);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float4 v0 = *reinterpret_cast<const float4*>(
          V + (j + 0) * kStride + tx * 4 + 32 * jj);
      const float4 v1 = *reinterpret_cast<const float4*>(
          V + (j + 1) * kStride + tx * 4 + 32 * jj);
      const float4 v2 = *reinterpret_cast<const float4*>(
          V + (j + 2) * kStride + tx * 4 + 32 * jj);
      const float4 v3 = *reinterpret_cast<const float4*>(
          V + (j + 3) * kStride + tx * 4 + 32 * jj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* a = acc[i] + jj * 4;
        a[0] = fmaf(w[i].x, v0.x, a[0]);
        a[1] = fmaf(w[i].x, v0.y, a[1]);
        a[2] = fmaf(w[i].x, v0.z, a[2]);
        a[3] = fmaf(w[i].x, v0.w, a[3]);
        a[0] = fmaf(w[i].y, v1.x, a[0]);
        a[1] = fmaf(w[i].y, v1.y, a[1]);
        a[2] = fmaf(w[i].y, v1.z, a[2]);
        a[3] = fmaf(w[i].y, v1.w, a[3]);
        a[0] = fmaf(w[i].z, v2.x, a[0]);
        a[1] = fmaf(w[i].z, v2.y, a[1]);
        a[2] = fmaf(w[i].z, v2.z, a[2]);
        a[3] = fmaf(w[i].z, v2.w, a[3]);
        a[0] = fmaf(w[i].w, v3.x, a[0]);
        a[1] = fmaf(w[i].w, v3.y, a[1]);
        a[2] = fmaf(w[i].w, v3.z, a[2]);
        a[3] = fmaf(w[i].w, v3.w, a[3]);
      }
    }
  }
}

// The thread's 4×8 tile into shared rows: W[ty·4 + i][tx + 8u]
__device__ __forceinline__ void store_rows(float* W, const float t[4][8],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) W[(ty * 4 + i) * kStride + tx + 8 * u] =
        t[i][u];
}

// The thread's output tile (rows ty·4 + i, columns tx·4 + 32·jj …) times
// `scale`, rows from `first` of a document of n, into [*, heads, kD]
__device__ __forceinline__ void store_out(float* g, int64_t row_stride,
                                          int first, int n,
                                          const float acc[4][8], int ty,
                                          int tx, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = first + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      *reinterpret_cast<float4*>(g + (int64_t)r * row_stride + tx * 4 +
                                 32 * jj) =
          make_float4(acc[i][jj * 4] * scale, acc[i][jj * 4 + 1] * scale,
                      acc[i][jj * 4 + 2] * scale,
                      acc[i][jj * 4 + 3] * scale);
  }
}

// The tiles [lo, hi) (starts, multiples of kTile) of the other side that
// rows [first, first + kTile) of an n-row document reach
__device__ __forceinline__ void reach(int first, int n, int window, int* lo,
                                      int* hi) {
  if (window < 0) {
    *lo = 0;
    *hi = n;
  } else {
    *lo = max(0, first - window) / kTile * kTile;
    *hi = min(n, first + kTile + window);
  }
}

// Whether the tile pair (rows from a, columns from b) needs no mask: both
// inside the document and every pair inside the window
__device__ __forceinline__ bool unmasked(int a, int b, int n, int window) {
  if (a + kTile > n || b + kTile > n) return false;
  return window < 0 || (a + kTile - 1 - b <= window &&
                        b + kTile - 1 - a <= window);
}

__device__ __forceinline__ bool seen(int i, int j, int n, int window) {
  const int d = i - j;
  return i < n && j < n && (window < 0 || (d <= window && -d <= window));
}

__global__ void __launch_bounds__(kThreads)
    attn_forward_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;
  const int doc = blockIdx.y, h = blockIdx.z;
  const int start = a.offsets[doc], n = a.offsets[doc + 1] - start;
  const int q0 = blockIdx.x * kTile;
  if (q0 >= n) return;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int64_t stride = (int64_t)a.heads * kD;
  const int64_t base = (int64_t)start * stride + (int64_t)h * kD;
  load_tile(Qs, a.q + base, stride, q0, n);
  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }
  int lo, hi;
  reach(q0, n, a.window, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();             // the last tile's readers are done
    load_tile(Ks, a.k + base, stride, k0, n);
    load_tile(Vs, a.v + base, stride, k0, n);
    __syncthreads();
    float s[4][8];
    tile_dot(s, Qs, Ks, ty, tx);
    const bool full = unmasked(q0, k0, n, a.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float x = s[i][u] * kScaleLog2;
        if (!full && !seen(q0 + ty * 4 + i, k0 + tx + 8 * u, n, a.window))
          x = -INFINITY;
        s[i][u] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s[i][u] = exp2f(s[i][u] - m_use);
        sum += s[i][u];
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum += __shfl_xor_sync(kFull, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
    }
    store_rows(Ps, s, ty, tx);
    __syncwarp();
    tile_accumulate(o, Ps, Vs, ty, tx);
    __syncwarp();                // P's rows are read before the next write
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] *= inv;
  }
  store_out(a.out + base, stride, q0, n, o, ty, tx, 1.f);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r < n)
        a.out2[(int64_t)(start + r) * a.heads + h] =
            (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// D = rowsum(dO ⊙ O): 16 lanes a (token, head) row, four floats each
__global__ void attn_delta_kernel(const float* o, const float* dout,
                                  float* delta, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 16) +
                      threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  float s = 0.f;
  if (row < rows) {
    const float4 x = reinterpret_cast<const float4*>(o + row * kD)[lane];
    const float4 y = reinterpret_cast<const float4*>(dout + row * kD)[lane];
    s = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  s += __shfl_xor_sync(kFull, s, 8);
  s += __shfl_xor_sync(kFull, s, 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  if (row < rows && lane == 0) delta[row] = s;
}

// For the 64 rows of a tile from `first`: lse in base 2 and D, into shared
// arrays (rows past n: lse +∞, so that their P is 0, and D 0)
__device__ __forceinline__ void load_rows(float* L2, float* Dl, const Args& a,
                                          int start, int first, int n,
                                          int h) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int64_t t = (int64_t)(start + first + r) * a.heads + h;
    const bool ok = first + r < n;
    L2[r] = ok ? a.lse[t] * kLog2e : INFINITY;
    Dl[r] = ok ? a.delta[t] : 0.f;
  }
}

// dK, dV of one key tile: over the query tiles that see it, P = exp(S −
// lse), dV += Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − D), dK += dSᵀ·Q / 8. The
// thread's tiles are transposed: rows are keys (ty·4 + i), columns
// queries (tx + 8u).
__global__ void __launch_bounds__(kThreads)
    attn_dkdv_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTileFloats;
  float* Qs = Vs + kTileFloats;
  float* dOs = Qs + kTileFloats;
  float* Ps = dOs + kTileFloats;
  float* L2 = Ps + kTileFloats;
  float* Dl = L2 + kTile;
  const int doc = blockIdx.y, h = blockIdx.z;
  const int start = a.offsets[doc], n = a.offsets[doc + 1] - start;
  const int k0 = blockIdx.x * kTile;
  if (k0 >= n) return;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int64_t stride = (int64_t)a.heads * kD;
  const int64_t base = (int64_t)start * stride + (int64_t)h * kD;
  load_tile(Ks, a.k + base, stride, k0, n);
  load_tile(Vs, a.v + base, stride, k0, n);
  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;
  int lo, hi;
  reach(k0, n, a.window, &lo, &hi);
  for (int q0 = lo; q0 < hi; q0 += kTile) {
    __syncthreads();
    load_tile(Qs, a.q + base, stride, q0, n);
    load_tile(dOs, a.dout + base, stride, q0, n);
    load_rows(L2, Dl, a, start, q0, n, h);
    __syncthreads();
    const bool full = unmasked(k0, q0, n, a.window);
    float p[4][8], dp[4][8];
    tile_dot(p, Ks, Qs, ty, tx);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float lse2 = L2[tx + 8 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok =
            full || seen(q0 + tx + 8 * u, k0 + ty * 4 + i, n, a.window);
        p[i][u] = ok ? exp2f(p[i][u] * kScaleLog2 - lse2) : 0.f;
      }
    }
    store_rows(Ps, p, ty, tx);
    __syncwarp();
    tile_accumulate(dv, Ps, dOs, ty, tx);
    tile_dot(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float d = Dl[tx + 8 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[i][u] = p[i][u] * (dp[i][u] - d);
    }
    __syncwarp();                // Pᵀ's rows are read before dSᵀ's write
    store_rows(Ps, dp, ty, tx);
    __syncwarp();
    tile_accumulate(dk, Ps, Qs, ty, tx);
    __syncwarp();
  }
  store_out(a.out + base, stride, k0, n, dk, ty, tx, 0.125f);
  store_out(a.out2 + base, stride, k0, n, dv, ty, tx, 1.f);
}

// dQ of one query tile: over its key tiles, P = exp(S − lse), dP = dO·Vᵀ,
// dS = P ⊙ (dP − D), dQ += dS·K / 8.
__global__ void __launch_bounds__(kThreads)
    attn_dq_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;
  float* L2 = Ps + kTileFloats;
  float* Dl = L2 + kTile;
  const int doc = blockIdx.y, h = blockIdx.z;
  const int start = a.offsets[doc], n = a.offsets[doc + 1] - start;
  const int q0 = blockIdx.x * kTile;
  if (q0 >= n) return;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int64_t stride = (int64_t)a.heads * kD;
  const int64_t base = (int64_t)start * stride + (int64_t)h * kD;
  load_tile(Qs, a.q + base, stride, q0, n);
  load_tile(dOs, a.dout + base, stride, q0, n);
  load_rows(L2, Dl, a, start, q0, n, h);
  __syncthreads();
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse2[i] = L2[ty * 4 + i];
    dl[i] = Dl[ty * 4 + i];
  }
  float dq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dq[i][c] = 0.f;
  int lo, hi;
  reach(q0, n, a.window, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, a.k + base, stride, k0, n);
    load_tile(Vs, a.v + base, stride, k0, n);
    __syncthreads();
    const bool full = unmasked(q0, k0, n, a.window);
    float p[4][8], dp[4][8];
    tile_dot(p, Qs, Ks, ty, tx);
    tile_dot(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool ok =
            full || seen(q0 + ty * 4 + i, k0 + tx + 8 * u, n, a.window);
        const float pv = ok ? exp2f(p[i][u] * kScaleLog2 - lse2[i]) : 0.f;
        p[i][u] = pv * (dp[i][u] - dl[i]);
      }
    store_rows(Ps, p, ty, tx);
    __syncwarp();
    tile_accumulate(dq, Ps, Ks, ty, tx);
    __syncwarp();
  }
  store_out(a.out + base, stride, q0, n, dq, ty, tx, 0.125f);
}

constexpr size_t kForwardSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kBackwardSmem = (5 * kTileFloats + 2 * kTile) *
                                 sizeof(float);

}  // namespace

extern "C" {

int gdx_varlen_attention_head_dim() { return kD; }
int gdx_varlen_attention_tile() { return kTile; }

// O [T, H, 64] and lse [T, H] of packed q, k, v over the B documents of
// offsets [B + 1]; `longest` bounds every document's length.
int gdx_varlen_attention_forward(const float* q, const float* k,
                                 const float* v, const int32_t* offsets,
                                 int B, int H, int longest, int window,
                                 float* o, float* lse, void* stream) {
  if (B <= 0 || longest <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      attn_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kForwardSmem);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, offsets, H,
               window, o, lse};
  const dim3 grid((longest + kTile - 1) / kTile, B, H);
  attn_forward_kernel<<<grid, kThreads, kForwardSmem,
                        (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// dQ, dK, dV [T, H, 64] of the forward's O against dO; delta [T, H]
// scratch.
int gdx_varlen_attention_backward(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* lse, const float* dout,
                                  const int32_t* offsets, int B, int H,
                                  int longest, int window, int64_t T,
                                  float* delta, float* dq, float* dk,
                                  float* dv, void* stream) {
  if (B <= 0 || longest <= 0) return 0;
  const int64_t rows = T * H;
  attn_delta_kernel<<<(unsigned)((rows + 15) / 16), 256, 0,
                      (cudaStream_t)stream>>>(o, dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (const void* fn : {(const void*)attn_dkdv_kernel,
                         (const void*)attn_dq_kernel}) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kBackwardSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((longest + kTile - 1) / kTile, B, H);
  const Args kv{q, k, v, o, lse, dout, delta, offsets, H, window, dk, dv};
  attn_dkdv_kernel<<<grid, kThreads, kBackwardSmem,
                     (cudaStream_t)stream>>>(kv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Args qa{q, k, v, o, lse, dout, delta, offsets, H, window, dq,
                nullptr};
  attn_dq_kernel<<<grid, kThreads, kBackwardSmem, (cudaStream_t)stream>>>(
      qa);
  return cudaGetLastError();
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
