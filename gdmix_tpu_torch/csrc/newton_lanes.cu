// Whole damped-Newton solves for batched per-entity logistic regression
// (float32, dim ≤ 64), one launch per bucket.
//
// Objective per entity (the mean form of gdmix_tpu/ops/newton.py):
//   f(θ) = (Σ_r w_r·bce(z_r, y_r) + ½·Σ_k λ_k·θ_k²) / n,  z = Xθ + offset,
// with λ_0 = 0 when the intercept is unregularised. A Newton step solves
//   A·δ = g,  A = (XᵀDX + diag λ)/n + diag(ε·(1 + |diag|)),  ε = 1e-6,
// the system of _damped_gj_solve (gdmix_tpu/ops/pallas/newton_lanes.py:
// 101-134). Armijo backtracking (c1 = 1e-4, at most 20 halvings), an entity
// done at the gradient test (max|g| ≤ pgtol), at the relative decrease test
// (f − f_next ≤ ftol·max(|f|, |f_next|, 1)) or when its step is refused, and
// frozen once done: the semantics of the JAX lanes path.
//
// One kernel body, two forms, each a whole solve per entity in one launch:
//   newton_full  (W = 1) replaces newton_lanes.py:_newton_full_kernel (K1):
//     one warp per entity, four entities per block, for the small tiles.
//   newton_block (W = 4) replaces newton_lanes.py:_fgd_kernel (K2), whose
//     TPU form computed one iteration per launch and left the line search to
//     the host: one block of four warps per entity, the whole loop with the
//     line search inside, barriers in place of the host's `done.all()`.
//     X stays in shared memory while the entity fits the 227 KB a block may
//     opt into; past that (STREAM) it is read again from device memory in
//     chunks of kStreamRows rows on each pass, and z and u live in a
//     device-memory scratch.
// Which form a shape takes is decided by the wrapper (ops/newton_lanes.py
// `lanes_form`) from the shared-memory layout below, before any launch.
//
// What bounds it on an H100: device memory sees one read of X, y, w, offset
// and θ0 and one write of θ per entity, and the operations are a few n·d²
// multiply-adds per iteration: both far below the card's rates. What is left
// is shared-memory traffic and instruction issue, so the design cuts both:
//  * the gradient comes first, and an entity that passes the gradient test
//    (a padded entity, or one converged at θ0) never forms a Hessian;
//  * the Hessian is the lower triangle only, built on 4×4 register tiles
//    (each lane owns ⌈T⌉ of the ⌈d/4⌉·(⌈d/4⌉+1)/2 tiles), fed by two 16-byte
//    shared loads of an X row and one of its curvature weight per 16
//    multiply-adds, with no division in the index math;
//  * the solve is an unpivoted LDLᵀ of the damped triangle on those same
//    register tiles, right-looking, one column broadcast through shared
//    memory per step, with the forward substitution of g folded in: the
//    arithmetic of csrc/ldlt_solve.cu, whose pivots (the Schur complement
//    diagonals) keep damped systems finite;
//  * line-search trials cost O(n): z and u = Xδ are carried, a trial is
//    z − step·u, and z is recomputed exactly from X only at an accepted
//    step, where the next gradient needs X anyway.
// One entity per warp (newton_full) or block (newton_block) of the grid:
// the block scheduler starts a new block wherever one finishes, which
// balances the iteration counts that differ across a bucket; persistent
// blocks over an atomic counter measured no faster (PERF.md §6).
//
// Phase 2 of two-phase Newton (gdmix_tpu/models/random_effect_lr.py:
// 235-294 _newton_two_phase_solver) runs the same kernels over a lane list
// that only the card knows: LANES [B], the entities to solve first, and
// NLANES, how many of them to solve. The group of slot i solves entity
// LANES[i] while i < NLANES and returns past it; entities it does not
// solve keep whatever their outputs held. The caller makes the list and
// its count on the card (ops/newton_lanes.py): on one bucket the
// stragglers first and the JAX solver's ladder prefix that holds them; on
// a shard of the entity-sharded plane, that shard's own lanes of the
// prefix cut across the whole tier. The grid still spans B slots: the
// groups past the count read one integer and exit, and no host read sizes
// the launch. With LANES null, slot i is entity i.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kArmijoC1 = 1e-4f;
constexpr int kMaxBacktracks = 20;
constexpr float kDampEps = 1e-6f;
constexpr int kThreads = 128;     // every block: four warps
constexpr int kBlockWarps = 4;    // warps of one entity in newton_block
constexpr int kStreamRows = 256;  // rows of X per chunk in the streamed form

__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

// Shared-memory layout of one group (one entity), in floats. Every array
// starts on a multiple of 4 floats (16-byte loads of X rows, θ, δ and the
// broadcast column). The X row stride is 4·(odd number): lanes that each
// read a float4 of their own row hit distinct banks. ops/newton_lanes.py
// `_group_floats` repeats this arithmetic for the gate.
struct Layout {
  int D4, d4, ldx, T, rows;
  int x, y, w, off, z, u, rr, dv, th, dl, g, zz, col, red, gpart, tsc;
  int total;
};

__host__ __device__ inline Layout make_layout(int n, int d, int W,
                                              bool stream) {
  Layout L;
  L.D4 = (d + 4) / 4;  // ≥ one padding row: row d carries g in the solve
  L.d4 = 4 * L.D4;
  L.ldx = 4 * (L.D4 | 1);
  L.T = (L.D4 * (L.D4 + 1) / 2 + 31) / 32;
  L.rows = stream ? (n < kStreamRows ? n : kStreamRows) : n;
  int o = 0;
  L.x = o;
  o += L.rows * L.ldx;
  L.y = L.w = L.off = L.z = L.u = -1;
  if (!stream) {
    L.y = o;
    o += align4(n);
    L.w = o;
    o += align4(n);
    L.off = o;
    o += align4(n);
    L.z = o;
    o += align4(n);
    L.u = o;
    o += align4(n);
  }
  L.rr = o;
  o += align4(L.rows);
  L.dv = o;
  o += align4(L.rows);
  L.th = o;
  o += L.d4;
  L.dl = o;
  o += L.d4;
  L.g = o;
  o += L.d4;
  L.zz = o;
  o += L.d4;
  L.col = o;
  o += 2 * L.d4;
  L.red = o;
  o += W > 1 ? 4 : 0;  // the group's partial sums, one a warp
  L.gpart = o;
  o += W > 1 ? W * L.d4 : 0;
  L.tsc = o;
  o += W > 1 ? (W - 1) * L.T * 16 * 32 : 0;
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float bce(float z, float y) {
  return fmaxf(z, 0.f) - z * y + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(1.f + __expf(-z));
}

template <int W>
__device__ __forceinline__ void gsync() {
  if (W == 1)
    __syncwarp();
  else
    __syncthreads();
}

// One entity's state: shared-memory arrays (device-memory ones for y, w,
// offset, z and u in the streamed form) and its scalars.
struct Ctx {
  float *Xs, *rr, *dv, *th, *dl, *g, *zz, *col, *red, *gpart, *tsc;
  const float *y, *w, *off;
  float *z, *u;
  const float* Xg;  // the entity's X in device memory, [n][d]
  int n, d, D4, d4, ldx;
  float lam, inv_n;
  int unreg_bias, wg, lane, gtid;
  __device__ float lam_of(int k) const {
    return (k >= d || (unreg_bias && k == 0)) ? 0.f : lam;
  }
};

// the sum over the group's threads, the same value on every thread
template <int W>
__device__ __forceinline__ float gsum(const Ctx& c, float v) {
  v = warp_sum(v);
  if (W == 1) return __shfl_sync(kFull, v, 0);
  if (c.lane == 0) c.red[c.wg] = v;
  __syncthreads();
  float s = c.red[0];
#pragma unroll
  for (int i = 1; i < W; ++i) s += c.red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float dot_row(const float* xr, const float* v,
                                         int D4) {
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.f;
  for (int q = 0; q < D4; ++q) {
    const float4 a = x4[q], b = v4[q];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return s;
}

// Rows [r0, r1) of the entity's X into Xs (row stride ldx), columns d..d4-1
// zeroed: coalesced reads of the row-major [n][d] source, one division per
// thread.
template <int W>
__device__ void stage_rows(const Ctx& c, int r0, int r1) {
  constexpr int kStep = 32 * W;
  for (int r = r0 + c.gtid; r < r1; r += kStep)
    for (int k = c.d; k < c.d4; ++k) c.Xs[(r - r0) * c.ldx + k] = 0.f;
  const float* src = c.Xg + (int64_t)r0 * c.d;
  const int total = (r1 - r0) * c.d;
  const int dr = kStep / c.d, dk = kStep - dr * c.d;
  int r = c.gtid / c.d, k = c.gtid - r * c.d;
  for (int e = c.gtid; e < total; e += kStep) {
    c.Xs[r * c.ldx + k] = src[e];
    r += dr;
    k += dk;
    if (k >= c.d) {
      k -= c.d;
      ++r;
    }
  }
}

// body(c0, c1) over the rows of X in shared memory: the whole X at once
// when it is resident, else chunk by chunk, each staged from device memory.
template <int W, bool STREAM, typename F>
__device__ __forceinline__ void for_chunks(const Ctx& c, F&& body) {
  if (!STREAM) {
    body(0, c.n);
    gsync<W>();
    return;
  }
  for (int c0 = 0; c0 < c.n; c0 += kStreamRows) {
    const int c1 = min(c.n, c0 + kStreamRows);
    stage_rows<W>(c, c0, c1);
    __syncthreads();
    body(c0, c1);
    __syncthreads();
  }
}

// z = Xθ + offset exactly, then g = (Xᵀ·w(p − y) + λθ)/n; with `f` also the
// objective. Returns max|g|, the same on every thread of the group.
template <int W, bool STREAM>
__device__ float zg_pass(const Ctx& c, float* f) {
  float fpart = 0.f, a0 = 0.f, a1 = 0.f;
  for_chunks<W, STREAM>(c, [&](int c0, int c1) {
    for (int r = c0 + c.gtid; r < c1; r += 32 * W) {
      const float z = dot_row(c.Xs + (r - c0) * c.ldx, c.th, c.D4) + c.off[r];
      const float y = c.y[r], w = c.w[r];
      c.z[r] = z;
      if (f != nullptr) fpart += w * bce(z, y);
      const float p = sigmoid(z);
      c.rr[r - c0] = w * (p - y);
      if (!STREAM) c.dv[r] = w * p * (1.f - p);  // for the Hessian, if any
    }
    gsync<W>();
    for (int r = c0 + c.wg; r < c1; r += W) {
      const float* xr = c.Xs + (r - c0) * c.ldx;
      const float rv = c.rr[r - c0];
      if (c.lane < c.d4) a0 = fmaf(xr[c.lane], rv, a0);
      if (c.lane + 32 < c.d4) a1 = fmaf(xr[c.lane + 32], rv, a1);
    }
  });
  if (W == 1) {
    if (c.lane < c.d4)
      c.g[c.lane] = (a0 + c.lam_of(c.lane) * c.th[c.lane]) * c.inv_n;
    if (c.lane + 32 < c.d4)
      c.g[c.lane + 32] =
          (a1 + c.lam_of(c.lane + 32) * c.th[c.lane + 32]) * c.inv_n;
    __syncwarp();
  } else {
    if (c.lane < c.d4) c.gpart[c.wg * c.d4 + c.lane] = a0;
    if (c.lane + 32 < c.d4) c.gpart[c.wg * c.d4 + c.lane + 32] = a1;
    __syncthreads();
    if (c.gtid < c.d4) {
      float s = c.gpart[c.gtid];
#pragma unroll
      for (int i = 1; i < W; ++i) s += c.gpart[i * c.d4 + c.gtid];
      c.g[c.gtid] = (s + c.lam_of(c.gtid) * c.th[c.gtid]) * c.inv_n;
    }
    __syncthreads();
  }
  if (f != nullptr) {
    for (int k = c.gtid; k < c.d; k += 32 * W)
      fpart += 0.5f * c.lam_of(k) * c.th[k] * c.th[k];
    *f = gsum<W>(c, fpart) * c.inv_n;
  }
  float m = 0.f;
  if (c.lane < c.d) m = fabsf(c.g[c.lane]);
  if (c.lane + 32 < c.d) m = fmaxf(m, fabsf(c.g[c.lane + 32]));
  return __shfl_sync(kFull, warp_max(m), 0);
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One warp: damp the Hessian tiles, factor A = L·D·Lᵀ in place on them and
// solve A·δ = g into c.dl. Tile t of this lane holds rows 4·I[t].., columns
// 4·K[t].. of A (K ≤ I). Row d, the first padding row, carries gᵀ: the
// elimination of columns 0..d-1 turns it into D⁻¹L⁻¹g, the forward
// substitution and the diagonal scaling for free. The other padding entries
// are zero off the diagonal and 1 on it, so those coordinates stay
// decoupled (δ = 0). Steps run four at a time, one 4-column tile column
// each, so that a tile's column and row indices inside the step are known
// at compile time.
template <int T>
__device__ void warp_ldlt_solve(const Ctx& c, float (&acc)[T][16],
                                const int (&I)[T], const int (&K)[T],
                                const bool (&ok)[T]) {
  const int d = c.d, d4 = c.d4, D4 = c.D4;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (!ok[t]) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * I[t] + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 4 * K[t] + b;
        float v = acc[t][a * 4 + b];
        if (i == d) {
          v = k < d ? c.g[k] : 1.f;
        } else if (i == k) {
          if (i < d) {
            v = (v + c.lam_of(i)) * c.inv_n;
            v += kDampEps * (1.f + fabsf(v));
          } else {
            v = 1.f;
          }
        } else {
          v *= c.inv_n;
        }
        acc[t][a * 4 + b] = v;
      }
    }
  }
  for (int J = 0; J < D4; ++J) {
#pragma unroll
    for (int cj = 0; cj < 4; ++cj) {
      const int j = 4 * J + cj;
      if (j >= d) break;
      float* buf = c.col + (j & 1) * d4;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (ok[t] && K[t] == J)
          *reinterpret_cast<float4*>(buf + 4 * I[t]) =
              make_float4(acc[t][cj], acc[t][4 + cj], acc[t][8 + cj],
                          acc[t][12 + cj]);
      __syncwarp();
      const float inv = __frcp_rn(buf[j]);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!ok[t] || K[t] < J) continue;
        const float4 ci = *reinterpret_cast<const float4*>(buf + 4 * I[t]);
        const float4 ck = *reinterpret_cast<const float4*>(buf + 4 * K[t]);
        if (K[t] > J) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float l = f4(ci, a) * inv;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[t][a * 4 + b] = fmaf(-l, f4(ck, b), acc[t][a * 4 + b]);
          }
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            if (I[t] == J && a <= cj) continue;  // rows i ≤ j stay
            const float l = f4(ci, a) * inv;
#pragma unroll
            for (int b = cj + 1; b < 4; ++b)
              acc[t][a * 4 + b] = fmaf(-l, f4(ck, b), acc[t][a * 4 + b]);
            acc[t][a * 4 + cj] = l;
          }
        }
      }
    }
  }
  // row d now holds z = D⁻¹L⁻¹g: step k stored y_k / D_k there as its l
  const int ad = d & 3;
#pragma unroll
  for (int t = 0; t < T; ++t)
    if (ok[t] && I[t] == D4 - 1) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 4 * K[t] + b;
        float z = acc[t][b];
#pragma unroll
        for (int a = 1; a < 4; ++a)
          if (a == ad) z = acc[t][a * 4 + b];
        c.zz[k] = k < d ? z : 0.f;
      }
    }
  __syncwarp();
  // the back substitution Lᵀx = z, one row of L a step, from the last
  for (int J = D4 - 1; J >= 0; --J) {
#pragma unroll
    for (int rj = 3; rj >= 0; --rj) {
      const int j = 4 * J + rj;
      if (j >= d || j == 0) continue;
      const float xj = c.zz[j];
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (ok[t] && I[t] == J) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (b >= rj && K[t] == J) continue;  // columns k ≥ j
            float* zk = c.zz + 4 * K[t] + b;
            *zk = fmaf(-acc[t][rj * 4 + b], xj, *zk);
          }
        }
      __syncwarp();
    }
  }
  for (int k = c.lane; k < d4; k += 32) c.dl[k] = c.zz[k];
}

// The Newton step at the current θ (z and θ set): the Hessian's tiles over
// the rows (each warp of the group its own rows, summed into warp 0), warp
// 0 damps, factors and solves into c.dl, then u = Xδ.
template <int T, int W, bool STREAM>
__device__ void newton_dir(const Ctx& c, const int (&I)[T], const int (&K)[T],
                           const bool (&ok)[T]) {
  float acc[T][16];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[t][e] = 0.f;
  for_chunks<W, STREAM>(c, [&](int c0, int c1) {
    if (STREAM) {  // resident: zg_pass left the weights in c.dv
      for (int r = c0 + c.gtid; r < c1; r += 32 * W) {
        const float p = sigmoid(c.z[r]);
        c.dv[r - c0] = c.w[r] * p * (1.f - p);
      }
      __syncthreads();
    }
    for (int r = c0 + c.wg; r < c1; r += W) {
      const float* xr = c.Xs + (r - c0) * c.ldx;
      const float dvr = c.dv[r - c0];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!ok[t]) continue;
        const float4 xi = *reinterpret_cast<const float4*>(xr + 4 * I[t]);
        const float4 xk = *reinterpret_cast<const float4*>(xr + 4 * K[t]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float s = f4(xi, a) * dvr;
          acc[t][a * 4 + 0] = fmaf(s, xk.x, acc[t][a * 4 + 0]);
          acc[t][a * 4 + 1] = fmaf(s, xk.y, acc[t][a * 4 + 1]);
          acc[t][a * 4 + 2] = fmaf(s, xk.z, acc[t][a * 4 + 2]);
          acc[t][a * 4 + 3] = fmaf(s, xk.w, acc[t][a * 4 + 3]);
        }
      }
    }
  });
  if (W > 1) {
    if (c.wg > 0) {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          c.tsc[(((c.wg - 1) * T + t) * 16 + e) * 32 + c.lane] = acc[t][e];
    }
    __syncthreads();
    if (c.wg == 0) {
      for (int v = 1; v < W; ++v)
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int e = 0; e < 16; ++e)
            acc[t][e] += c.tsc[(((v - 1) * T + t) * 16 + e) * 32 + c.lane];
    }
  }
  if (c.wg == 0) warp_ldlt_solve<T>(c, acc, I, K, ok);
  gsync<W>();
  for_chunks<W, STREAM>(c, [&](int c0, int c1) {
    for (int r = c0 + c.gtid; r < c1; r += 32 * W)
      c.u[r] = dot_row(c.Xs + (r - c0) * c.ldx, c.dl, c.D4);
  });
}

// One tile a lane (T = 1: dim ≤ 27, the primary workload's 25) is held to
// 128 registers, four blocks resident on an SM: left free, the compiler
// takes 156–168 and three fit, which the card measured slower (PERF.md §6).
template <int T, int W, bool STREAM>
__global__ void __launch_bounds__(kThreads, T == 1 ? 4 : 1) newton_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ Wt, const float* __restrict__ OFF,
    const float* __restrict__ CNT, const float* __restrict__ TH0,
    float* __restrict__ TH, uint8_t* __restrict__ CONV,
    int32_t* __restrict__ ITERS, float* __restrict__ ZS,
    float* __restrict__ US, const int32_t* __restrict__ LANES,
    const int32_t* __restrict__ NLANES, int64_t B, int n, int d, float lam,
    int unreg_bias, int maxiter, float ftol, float pgtol) {
  constexpr int kGroups = kThreads / 32 / W;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const Layout L = make_layout(n, d, W, STREAM);
  float* base = smem + (warp / W) * L.total;
  Ctx c;
  c.n = n;
  c.d = d;
  c.D4 = L.D4;
  c.d4 = L.d4;
  c.ldx = L.ldx;
  c.lam = lam;
  c.unreg_bias = unreg_bias;
  c.wg = warp % W;
  c.lane = threadIdx.x & 31;
  c.gtid = c.wg * 32 + c.lane;
  c.Xs = base + L.x;
  c.rr = base + L.rr;
  c.dv = base + L.dv;
  c.th = base + L.th;
  c.dl = base + L.dl;
  c.g = base + L.g;
  c.zz = base + L.zz;
  c.col = base + L.col;
  c.red = base + L.red;
  c.gpart = base + L.gpart;
  c.tsc = base + L.tsc;

  // this lane's 4×4 tiles of the lower triangle: tile q = lane + 32·t,
  // numbered by rows (q = I(I+1)/2 + K)
  int I[T], K[T];
  bool ok[T];
  const int ntiles = L.D4 * (L.D4 + 1) / 2;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int q = c.lane + 32 * t;
    ok[t] = q < ntiles;
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= q) ++i;
    I[t] = ok[t] ? i : 0;
    K[t] = ok[t] ? q - i * (i + 1) / 2 : 0;
  }

  const int64_t slot = (int64_t)blockIdx.x * kGroups + warp / W;
  if (slot >= B) return;  // its group alone: a warp (W = 1) or the block
  // a slot of a lane list past its count has nothing to solve
  if (LANES != nullptr && slot >= *NLANES) return;
  const int64_t b = LANES != nullptr ? LANES[slot] : slot;  // the entity

  c.Xg = X + b * n * d;
  if (STREAM) {
    c.y = Y + b * n;
    c.w = Wt + b * n;
    c.off = OFF + b * n;
    c.z = ZS + b * n;
    c.u = US + b * n;
  } else {
    float* ys = base + L.y;
    float* ws = base + L.w;
    float* os = base + L.off;
    for (int r = c.gtid; r < n; r += 32 * W) {
      ys[r] = Y[b * n + r];
      ws[r] = Wt[b * n + r];
      os[r] = OFF[b * n + r];
    }
    c.y = ys;
    c.w = ws;
    c.off = os;
    c.z = base + L.z;
    c.u = base + L.u;
    stage_rows<W>(c, 0, n);
  }
  for (int k = c.gtid; k < c.d4; k += 32 * W)
    c.th[k] = k < d ? TH0[b * d + k] : 0.f;
  c.inv_n = 1.f / fmaxf(CNT[b], 1.f);
  gsync<W>();

  float f;
  float gmax = zg_pass<W, STREAM>(c, &f);
  bool done = gmax <= pgtol;
  int iters = 0;
  if (!done) newton_dir<T, W, STREAM>(c, I, K, ok);
  for (int it = 0; it < maxiter && !done; ++it) {
    float gd = 0.f;
    if (c.lane < d) gd = c.g[c.lane] * c.dl[c.lane];
    if (c.lane + 32 < d) gd = fmaf(c.g[c.lane + 32], c.dl[c.lane + 32], gd);
    const float gdot = __shfl_sync(kFull, warp_sum(gd), 0);
    float step = 1.f, f_next = f;
    bool accepted = false;
    for (int i = 0; i < kMaxBacktracks; ++i) {
      float part = 0.f;
      for (int r = c.gtid; r < n; r += 32 * W)
        part += c.w[r] * bce(fmaf(-step, c.u[r], c.z[r]), c.y[r]);
      for (int k = c.gtid; k < d; k += 32 * W) {
        const float tk = c.th[k] - step * c.dl[k];
        part += 0.5f * c.lam_of(k) * tk * tk;
      }
      const float f_trial = gsum<W>(c, part) * c.inv_n;
      if (f_trial <= f - kArmijoC1 * step * gdot) {
        accepted = true;
        f_next = f_trial;
        break;
      }
      step *= 0.5f;
    }
    if (accepted) {
      for (int k = c.gtid; k < c.d4; k += 32 * W)
        c.th[k] = c.th[k] - step * c.dl[k];
      gsync<W>();
      gmax = zg_pass<W, STREAM>(c, nullptr);
    }
    const float rel = fmaxf(fmaxf(fabsf(f), fabsf(f_next)), 1.f);
    const bool conv = gmax <= pgtol || f - f_next <= ftol * rel;
    done = conv || !accepted;
    iters += 1;
    f = f_next;
    if (!done) newton_dir<T, W, STREAM>(c, I, K, ok);
  }
  // the entity read again from the list rather than kept through the
  // solve, which would hold one more register there (K1 is held to 128):
  // a volatile load, which the compiler does not merge with the first
  const int64_t e =
      LANES != nullptr ? *(const volatile int32_t*)(LANES + slot) : slot;
  for (int k = c.gtid; k < d; k += 32 * W) TH[e * d + k] = c.th[k];
  if (c.gtid == 0) {
    CONV[e] = done ? 1 : 0;
    ITERS[e] = iters;
  }
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, const float*, float*,
                          uint8_t*, int32_t*, float*, float*, const int32_t*,
                          const int32_t*, int64_t, int, int, float, int, int,
                          float, float);

template <int W, bool STREAM>
KernelFn pick(int T) {
  switch (T) {
    case 1: return newton_kernel<1, W, STREAM>;
    case 2: return newton_kernel<2, W, STREAM>;
    case 3: return newton_kernel<3, W, STREAM>;
    case 4: return newton_kernel<4, W, STREAM>;
    case 5: return newton_kernel<5, W, STREAM>;
    default: return nullptr;
  }
}

int launch(KernelFn fn, size_t smem, int groups_per_block, const float* X,
           const float* Y, const float* Wt, const float* OFF,
           const float* CNT, const float* TH0, float* TH, uint8_t* CONV,
           int32_t* ITERS, float* ZS, float* US, const int32_t* LANES,
           const int32_t* NLANES, int64_t B, int n, int d, float lam,
           int unreg_bias, int maxiter, float ftol, float pgtol,
           void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (B + groups_per_block - 1) / groups_per_block;
  fn<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      X, Y, Wt, OFF, CNT, TH0, TH, CONV, ITERS, ZS, US, LANES, NLANES, B, n,
      d, lam, unreg_bias, maxiter, ftol, pgtol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of shared memory one group uses (one entity): form 0 newton_full
// (one warp), 1 newton_block resident, 2 newton_block streamed.
int gdx_newton_group_floats(int form, int n, int d) {
  return make_layout(n, d, form == 0 ? 1 : kBlockWarps, form == 2).total;
}

// θ [B, d] f32, converged [B] (one byte), iterations [B] int32.
// `LANES` [B] and `NLANES` [1] int32: a lane list, the entities
// LANES[0 .. NLANES) solved and written and no other (two-phase Newton's
// phase 2), or both null (every entity).
int gdx_newton_full(const float* X, const float* Y, const float* Wt,
                    const float* OFF, const float* CNT, const float* TH0,
                    float* TH, uint8_t* CONV, int32_t* ITERS,
                    const int32_t* LANES, const int32_t* NLANES, int64_t B,
                    int n, int d, float lam, int unreg_bias, int maxiter,
                    float ftol, float pgtol, void* stream) {
  const Layout L = make_layout(n, d, 1, false);
  const size_t smem = sizeof(float) * (size_t)(kThreads / 32) * L.total;
  return launch(pick<1, false>(L.T), smem, kThreads / 32, X, Y, Wt, OFF, CNT,
                TH0, TH, CONV, ITERS, nullptr, nullptr, LANES, NLANES, B, n,
                d, lam, unreg_bias, maxiter, ftol, pgtol, stream);
}

// The same, one block per entity. `ZS`/`US`: [B, n] f32 device-memory
// scratch for z and u in the streamed form (`streamed` = 1), else null;
// `LANES`/`NLANES` as gdx_newton_full's.
int gdx_newton_block(const float* X, const float* Y, const float* Wt,
                     const float* OFF, const float* CNT, const float* TH0,
                     float* TH, uint8_t* CONV, int32_t* ITERS, float* ZS,
                     float* US, const int32_t* LANES, const int32_t* NLANES,
                     int streamed, int64_t B, int n, int d, float lam,
                     int unreg_bias, int maxiter, float ftol, float pgtol,
                     void* stream) {
  const Layout L = make_layout(n, d, kBlockWarps, streamed != 0);
  const size_t smem = sizeof(float) * (size_t)L.total;
  const KernelFn fn =
      streamed ? pick<kBlockWarps, true>(L.T) : pick<kBlockWarps, false>(L.T);
  return launch(fn, smem, 1, X, Y, Wt, OFF, CNT, TH0, TH, CONV, ITERS, ZS, US,
                LANES, NLANES, B, n, d, lam, unreg_bias, maxiter, ftol, pgtol,
                stream);
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
