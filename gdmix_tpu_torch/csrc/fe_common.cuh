// One fused pass over padded COO records [N, K], shared by the fixed-effect
// data term (fe_loss_grad.cu, K5) and the hot side of the wide-D hybrid
// (fe_hybrid.cu, K12). Per record, against a table θ of d coefficients:
//   z = Σ v·θ[id] + off + b
//   loss += w·bce(z, y) (or w·(y − z)²), r = w·(σ(z) − y) (or w·2(z − y))
//   g[id] += v·r,  Σr += r
// K12 is the same pass with three additions (kHybrid): ids run over a
// compact space [0, d] whose slot d is a dump that is skipped, r is written
// per record, and ids are rank-ordered (0 the most frequent), which the
// strip below uses. Entries of value 0 and records of weight 0 are inert:
// their ids are never used as an address. Float and double.
//
// The gradient table of the pass (GradTable: init, add, flush) stands apart
// from the record loop, so the flat entry scatter of fe_loss_grad.cu (K10,
// g[idx[e]] += ce[e]) adds through the same forms, strips and cache.
//
// Bound: device memory. A record is read once (K ids and values, y, w, off;
// 140 bytes at K = 16 in float32, 324 at criteo's K = 39) and, for K12, r
// written once; θ and g stay on the SM. What the design has to keep off the
// critical path is the N·K additions into g.
//
// Design.
//  * A persistent grid (blocks = SMs × occupancy) of kThreads threads. While
//    the table fits (kBlock), each block keeps a private copy of the
//    gradient in shared memory: an entry's addition is a shared-memory
//    atomic, and a block flushes its table once at its end, one device atomic
//    per non-zero slot, each block starting at another slot so that blocks
//    do not meet. Past that (kDevice: K5 beyond the shared-memory budget)
//    an addition is a device atomic, except for the ids a block has cached:
//    a hashed table of kCache slots in shared memory, each kept by the
//    first id that reaches it (under skewed ids, the frequent ones), summed
//    there and flushed once per block. For K12 the table is tiered: compact
//    ids below s live in shared memory, ids in [s, d) (the cold tail of a
//    rank-ordered space, which rarely meet) go to device memory. θ is read
//    through the read-only cache in every form. Every address space is
//    chosen at compile time, per branch.
//  * How a record is read (Shape). The vector path (kVec; K ≤ 16 and
//    K % 4 == 0, 16-byte aligned rows): four lanes share a record, each
//    holding four entries in registers from 16-byte loads. Every other
//    shape takes the lane-group path (lane_group): G lanes share a record,
//    the fewest (a power of two, at most 32) that hold it at E ≤ 5 entries
//    each, E = ⌈K/G⌉ but at least 3; lane sub holds positions sub, sub + G,
//    …, so at each step a record's G lanes read G consecutive entries by
//    4-byte loads (no alignment asked) and a warp's load covers the runs of
//    its 32/G consecutive records. Criteo's K = 39 takes G = 8, E = 5: four
//    records a warp. Past 32 lanes × 5 (K > 160) a record is read in chunks
//    of 160, once for z and once more for the gradient. Otherwise, on both
//    paths, an entry is read once from device memory, z is summed over the
//    record's lanes by log₂G shuffles and the gradient's additions come
//    from the registers. In float32 the lane-group path is held to 32
//    registers, two 1,024-thread blocks an SM: at E = 5 that spills 12–40
//    bytes, which costs less than the lost block (below).
//  * Equal ids. A floating-point atomic in shared memory is a
//    compare-and-swap loop, so the lanes of a warp (and the warps of a block)
//    that hit one address take turns; in device memory they queue in L2.
//    The kStrip most frequent ids therefore get a strip of 32 slots
//    each, one a lane: no two lanes of a warp share a slot, no vote is
//    needed, and the strips are summed into the table once per block. K12's
//    compact ids are rank-ordered, so its strips are the ids below
//    kStrip. K5's raw ids carry no rank: each block first counts a
//    sample of its entries in a hashed table (learn_hot_ids; K10 alike)
//    and gives a strip to every id above 1/256 of the sample; an entry
//    then costs one more shared load to ask whether its id has a strip.
//    Which ids are
//    chosen affects the time only, never the sums.
//  * Loss and Σr are double sums, reduced over the block, one double atomic
//    per block.
// The headers of fe_loss_grad.cu and fe_hybrid.cu give the alternatives
// that were measured against each of these choices, and their times.
//
// What decided the lane-group path: each alternative was built and timed
// against it (NVIDIA H100 80GB HBM3, 700 W; K12 through its C entry, CUDA
// events, medians of rounds in turns; N = 4,997,120 float32 rows at A =
// 16,384 compact ids; ms a call). At K = 39 on criteo-shaped rows (13
// log-normal numeric ids in every row, 26 Zipf(1.2) ids over 1M): as kept
// (G = 8, E = 5, held to 32 registers) 0.889–0.890; the same unheld (44
// registers, one block an SM) 1.098; G = 8 with E = 6 or 8 slots (held)
// 0.954 and 1.125; G = 4, E = 10 1.045 (51 registers) and 1.244 held; G =
// 16, E = 3 1.087–1.137; G = 16, E = 4 1.163–1.208; G = 32, E = 2 1.708;
// chunks of 8 × 4 read twice 1.167; the staged form — a warp's run of four
// rows copied into shared memory by cp.async, double-buffered (80 KB a
// block beside the 68 KB table: one block an SM), lanes reading their
// entries there — 1.104–1.108 at G = 8 and 1.576 at G = 16 (two blocks);
// the scalar loop this path replaced 17.67–17.71. float64: 1.577–1.623
// against the scalar loop's 7.43–7.47. Other K (Zipf(1.2) over 1M, split
// at A = 16,384), as kept / the alternatives / the scalar loop: K = 3 (G =
// 1, E = 3) 0.100–0.108 / G = 2 0.138, G = 4 0.194 / 0.122–0.127; K = 5 (1,
// 5) 0.152 / (2, 3) 0.166–0.169, (4, 2) 0.234 / 0.198–0.206; K = 16 on rows
// off a 16-byte boundary (4, 4) 0.394 / (8, 2) 0.455, (2, 8) 0.480 / 3.92–
// 3.94 (the vector path on aligned rows 0.360–0.364); K = 17 (4, 5) 0.441 /
// (8, 3) 0.545–0.552 / 4.83–4.90; K = 20 (4, 5) 0.504 / (8, 3) 0.575 /
// 6.48–6.50; K = 64 (16, 4) 1.413–1.458 / (32, 2) 1.817, (8, 8) 1.922 /
// 36.64–36.66; at N = 999,424: K = 100 (32, 4) 0.542 / 10.34, K = 200 in
// chunks 1.223 (one host copy a call included) / 21.51. The scalar loop
// lost at every shape and was removed. ptxas: float32 32 registers on both
// paths (E = 5 and the chunks spill 12–60 bytes, E ≤ 4 none but 4–8 bytes
// in K5's device-memory form); float64 58–64, one block an SM.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gdx_fe {

constexpr int kThreads = 1024;
// the vector path: kVecLanes lanes a record, kVecMaxK / kVecLanes entries each
constexpr int kVecLanes = 4;
constexpr int kVecMaxK = 16;
// the lane-group path: at most kLanesMaxE entries a lane (and at least
// kLanesMinE: fewer save nothing), G at most 32 lanes a record
constexpr int kLanesMinE = 3, kLanesMaxE = 5, kLanesMaxG = 32;
// ids that get a lane-private strip
constexpr int kStrip = 32;
// K5's hashed table of sampled ids: kBuckets slots (a power of two), a
// sample of kSample entries per block
constexpr int kBuckets = 1024;
constexpr int kSample = 4096;
// K5's device-memory form: slots (a power of two) of the hashed cache that
// keeps the gradient of recurring ids in shared memory
constexpr int kCache = 8192;
constexpr unsigned kFull = 0xffffffffu;
// the forms of the gradient table: device memory, or a block's shared memory
constexpr int kDevice = 0, kBlock = 1;

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

// The weighted loss of one record at margin z (returned) and its residual
// r = w·dloss/dz.
template <typename T>
__device__ __forceinline__ T loss_residual(T z, T y, T w, int linear, T* r) {
  T per, dz;
  if (linear) {
    per = (y - z) * (y - z);
    dz = T(2) * (z - y);
  } else {
    per = (z > T(0) ? z : T(0)) - z * y + log1p_(exp_(-abs_(z)));
    dz = sigmoid(z) - y;
  }
  *r = w * dz;
  return w * per;
}

// Sum of v over the block, in thread 0 (all threads must call).
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the array may still be read from an earlier call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < (kThreads / 32) ? part[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  }
  return v;
}

__device__ __forceinline__ void load4(const int32_t* p, int32_t* out) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double* out) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// A lane's E entries of one record (E a multiple of 4), from position j0,
// by 16-byte loads. Positions at or past k (k % 4 == 0) get value 0.
template <typename T, int E>
__device__ __forceinline__ void load_entries(const int32_t* ri, const T* rv,
                                             int j0, int k, int32_t* id,
                                             T* v) {
#pragma unroll
  for (int q = 0; q < E; q += 4) {
    if (j0 + q < k) {
      load4(ri + j0 + q, id + q);
      load4(rv + j0 + q, v + q);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        id[q + u] = 0;
        v[q + u] = T(0);
      }
    }
  }
}

// A lane's E entries of one record on the lane-group path: positions j,
// j + G, …, j + (E − 1)·G, by 4-byte loads, so that the G lanes of a record
// read G consecutive entries at each step. Positions at or past k get
// value 0 and are not read.
template <typename T, int G, int E>
__device__ __forceinline__ void load_lanes(const int32_t* ri, const T* rv,
                                           int j, int k, int32_t* id, T* v) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (j + e * G < k) {
      id[e] = __ldg(ri + j + e * G);
      v[e] = __ldg(rv + j + e * G);
    } else {
      id[e] = 0;
      v[e] = T(0);
    }
  }
}

template <typename T>
struct Pass {
  const int32_t* idx;  // [n, k]
  const T* val;        // [n, k]
  const T* y;          // [n]
  const T* w;          // [n]
  const T* off;        // [n]
  const T* theta;      // [d]
  const T* b;          // the intercept, or null
  int64_t n;
  int k;
  int d;               // table size; for kHybrid also the dump slot
  int s;               // ids below s add into shared memory; 0: none do
  int linear;
  T* g;                // [d], zero on entry
  T* r_out;            // [n] (kHybrid)
  double* sums;        // [2]: loss, Σr; zero on entry
};

// Which ids get a strip (K5 and K10, whose raw ids carry no rank). The
// block counts a sample of kSample entries of the id array, from position
// blockIdx.x·kSample on (wrapping), by id & (kBuckets − 1), keeping one
// candidate id a bucket and counting only that id; entries of value 0 are
// not counted. Ids at or above 1/64 of the sample are placed first, then
// those at or above 1/256, up to kStrip. On return key[b] is the id with a
// strip in bucket b (or −1), slot[b] its strip, hot_id[i] the id of strip
// i; returns the number of strips in use. All threads must call.
template <typename T>
__device__ __forceinline__ int learn_hot_ids(const int32_t* ids,
                                             const T* vals, int64_t total,
                                             int32_t* key, int32_t* slot,
                                             int32_t* hot_id) {
  __shared__ int n_hot;
  for (int b = threadIdx.x; b < kBuckets; b += kThreads) {
    key[b] = -1;
    slot[b] = 0;
  }
  if (threadIdx.x == 0) n_hot = 0;
  __syncthreads();
  const int64_t first = total > 0 ? ((int64_t)blockIdx.x * kSample) % total
                                  : 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int64_t i = threadIdx.x; i < kSample && i < total; i += kThreads) {
      const int64_t e = first + i < total ? first + i : first + i - total;
      if (vals[e] == T(0)) continue;
      const int32_t a = ids[e];
      const int b = a & (kBuckets - 1);
      if (pass == 0) key[b] = a;       // any one of the bucket's ids
      else if (key[b] == a) atomicAdd(slot + b, 1);
    }
    __syncthreads();
  }
  for (int share = 64; share <= 256; share *= 4) {
    for (int b = threadIdx.x; b < kBuckets; b += kThreads) {
      if (slot[b] >= kSample / share) {
        const int i = atomicAdd(&n_hot, 1);
        if (i < kStrip) {
          hot_id[i] = key[b];
          slot[b] = -(i + 1);
        }
      }
    }
    __syncthreads();
  }
  for (int b = threadIdx.x; b < kBuckets; b += kThreads) {
    if (slot[b] < 0) slot[b] = -slot[b] - 1;
    else key[b] = -1;
  }
  __syncthreads();
  return n_hot < kStrip ? n_hot : kStrip;
}

// The gradient table one block adds into, in the forms of the Design
// above; where each id's sum lives is fixed at compile time by kForm and
// kRanked. kRanked (K12): ids are rank-ordered, the strips are the ids
// below kStrip, and the block table is tiered at s. Otherwise (K5, K10) the
// strips go to sampled ids, and the device form keeps the hashed cache.
//   init  — carve the dynamic shared memory, zero it, choose the strips;
//   add   — one addition of c to id a, by the caller's lane of its warp;
//   flush — the strips, the cache and the block table into device memory.
// init and flush hold block barriers: every thread of the block calls them.
template <typename T, int kForm, bool kRanked>
struct GradTable {
  static constexpr bool kCached = !kRanked && kForm == kDevice;
  T* g;             // [d] device memory, zero on entry
  T* g_s;           // [s] the block's table
  T* strip;         // [kStrip, 32]
  int32_t* key;     // [kBuckets] the sampled ids' hashed table (!kRanked)
  int32_t* slot;    // [kBuckets]
  int32_t* hot_id;  // [kStrip]
  int32_t* c_id;    // [kCache] the cache (kCached): slot h's id, −1 free
  T* c_sum;         // [kCache]
  int s;            // ids below s live in g_s (kBlock)
  int hs;           // strips in use

  // Dynamic shared memory of one form: the table [s], the strips
  // [kStrip, 32], for sampled strips their hashed table, and for the
  // cached form the cache's ids and sums.
  static size_t smem_bytes(int s) {
    return sizeof(T) * ((size_t)s + 32 * (size_t)kStrip) +
           (kRanked ? 0 : sizeof(int32_t) * (2 * kBuckets + kStrip)) +
           (kCached ? (sizeof(int32_t) + sizeof(T)) * kCache : 0);
  }

  // ids / vals / total: the entries the strips are sampled from (not read
  // when kRanked); d the table's size.
  __device__ __forceinline__ void init(unsigned char* smem, T* g_dev,
                                       int s_, int d, const int32_t* ids,
                                       const T* vals, int64_t total) {
    g = g_dev;
    s = s_;
    g_s = reinterpret_cast<T*>(smem);
    strip = g_s + s;
    key = reinterpret_cast<int32_t*>(strip + 32 * kStrip);
    slot = key + kBuckets;
    hot_id = slot + kBuckets;
    c_id = hot_id + kStrip;
    c_sum = reinterpret_cast<T*>(c_id + kCache);
    for (int a = threadIdx.x; a < s + 32 * kStrip; a += kThreads)
      g_s[a] = T(0);
    if constexpr (kCached) {
      for (int h = threadIdx.x; h < kCache; h += kThreads) {
        c_id[h] = -1;
        c_sum[h] = T(0);
      }
    }
    if constexpr (kRanked) hs = kStrip < d ? kStrip : d;
    else hs = learn_hot_ids(ids, vals, total, key, slot, hot_id);
    __syncthreads();
  }

  // into the table, wherever this form keeps slot a
  __device__ __forceinline__ void table_add(int32_t a, T c) {
    if constexpr (kForm == kDevice) {
      if constexpr (kCached) {
        // first come, first kept: under skewed ids the frequent ones come
        // first, and a slot never changes hands, so no sum is ever moved
        const int h = a & (kCache - 1);
        int32_t owner = *(volatile int32_t*)(c_id + h);
        if (owner == -1) {
          owner = atomicCAS(c_id + h, -1, a);
          if (owner == -1) owner = a;
        }
        if (owner == a) {
          atomicAdd(c_sum + h, c);
          return;
        }
      }
      atomicAdd(g + a, c);
    } else {
      if (!kRanked || a < s) atomicAdd(g_s + a, c);
      else atomicAdd(g + a, c);
    }
  }

  __device__ __forceinline__ void add(int32_t a, T c, int lane) {
    if constexpr (kRanked) {
      if (a < hs) {
        atomicAdd(strip + a * 32 + lane, c);
        return;
      }
    } else {
      // hs is uniform over the block: data without frequent ids pays
      // nothing for the question
      const int b = a & (kBuckets - 1);
      if (hs > 0 && key[b] == a) {
        atomicAdd(strip + slot[b] * 32 + lane, c);
        return;
      }
    }
    table_add(a, c);
  }

  __device__ __forceinline__ void flush(int lane) {
    __syncthreads();
    // a warp per strip in use: its 32 slots into the id's place
    for (int i = threadIdx.x >> 5; i < hs; i += kThreads / 32) {
      T t = strip[i * 32 + lane];
      for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(kFull, t, o);
      if (lane == 0 && t != T(0)) table_add(kRanked ? i : hot_id[i], t);
    }
    if constexpr (kCached) {
      __syncthreads();
      for (int h = threadIdx.x; h < kCache; h += kThreads) {
        const T t = c_sum[h];
        if (t != T(0)) atomicAdd(g + c_id[h], t);
      }
    }
    if constexpr (kForm == kBlock) {
      __syncthreads();
      // each block starts its flush at another slot (a multiple of 32, so
      // a warp still covers whole lines)
      const int start = (int)((int64_t)blockIdx.x * s / gridDim.x) & ~31;
      for (int i = threadIdx.x; i < s; i += kThreads) {
        int a = i + start;
        if (a >= s) a -= s;
        const T t = g_s[a];
        if (t != T(0)) atomicAdd(g + a, t);
      }
    }
  }
};

// How the pass holds a record: G lanes share it (G a power of two, at most
// 32), each with E of its entries in registers. kVec: lane sub holds the
// run sub·E … sub·E + E − 1, by 16-byte loads (the vector path). Otherwise
// lane sub holds positions sub, sub + G, …, by 4-byte loads (the lane-group
// path); kChunks: a record longer than G·E is read in chunks of G·E, once
// for z and once more for the gradient.
template <int G_, int E_, bool kVec_ = false, bool kChunks_ = false>
struct Shape {
  static constexpr int G = G_, E = E_;
  static constexpr bool kVec = kVec_, kChunks = kChunks_;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 1, 2, … 32");
  static_assert(!kVec || (G * E == kVecMaxK && E % 4 == 0), "vector path");
};

// The pass of one block (every thread of the block calls it).
template <typename T, class S, bool kHybrid, int kForm>
__device__ __forceinline__ void fe_pass(const Pass<T> p) {
  constexpr int G = S::G, E = S::E;
  constexpr int R = 32 / G;  // records per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradTable<T, kForm, kHybrid> tab;
  tab.init(smem_raw, p.g, p.s, p.d, p.idx, p.val, p.n * p.k);
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  // whether an entry counts: a non-zero value and, for kHybrid, an id that
  // is not the dump slot
  auto counts = [&](int32_t a, T v) -> bool {
    if constexpr (kHybrid) return v != T(0) && (unsigned)a < (unsigned)p.d;
    else return v != T(0);
  };
  // Σ v·θ[id] over a lane's entries (lane-group path); those that do not
  // count get value 0
  auto dot = [&](const int32_t* id, T* v) -> T {
    T z = T(0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (counts(id[e], v[e])) z += v[e] * __ldg(p.theta + id[e]);
      else v[e] = T(0);
    }
    return z;
  };
  const T b = p.b != nullptr ? *p.b : T(0);
  const int64_t warp = (int64_t)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * (kThreads / 32) * R;
  double loss = 0.0, rsum = 0.0;
  // the loop bound is uniform over a warp: the shuffles below need every
  // lane
  for (int64_t base = warp * R; base < p.n; base += stride) {
    const int64_t row = base + lane / G;
    const bool live = row < p.n;
    const T wt = live ? p.w[row] : T(0);
    const bool on = wt != T(0);
    const int32_t* ri = p.idx + (live ? row : 0) * p.k;
    const T* rv = p.val + (live ? row : 0) * p.k;
    int32_t id[E];
    T v[E];
    T z = T(0);
    if constexpr (S::kVec) {
      if (on) {
        load_entries<T, E>(ri, rv, sub * E, p.k, id, v);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = T(0);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (counts(id[e], v[e])) z += v[e] * __ldg(p.theta + id[e]);
        else v[e] = T(0);
      }
    } else if constexpr (!S::kChunks) {
      load_lanes<T, G, E>(ri, rv, sub, on ? p.k : 0, id, v);
      z = dot(id, v);
    } else {
      for (int c = 0; c < (on ? p.k : 0); c += G * E) {
        load_lanes<T, G, E>(ri, rv, c + sub, p.k, id, v);
        z += dot(id, v);
      }
    }
    for (int o = G / 2; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
    T r = T(0);
    if (on) {
      const T per = loss_residual(z + p.off[row] + b, p.y[row], wt, p.linear,
                                  &r);
      if (sub == 0) {
        loss += (double)per;
        rsum += (double)r;
      }
    }
    if constexpr (kHybrid) {
      if (live && sub == 0) p.r_out[row] = r;
    }
    if (r != T(0)) {
      if constexpr (S::kChunks) {
        for (int c = 0; c < p.k; c += G * E) {
          load_lanes<T, G, E>(ri, rv, c + sub, p.k, id, v);
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (counts(id[e], v[e])) tab.add(id[e], v[e] * r, lane);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (v[e] != T(0)) tab.add(id[e], v[e] * r, lane);
      }
    }
  }
  tab.flush(lane);
  loss = block_sum(loss);
  rsum = block_sum(rsum);
  if (threadIdx.x == 0) {
    atomicAdd(p.sums, loss);
    atomicAdd(p.sums + 1, rsum);
  }
}

// The vector path, and float64 on either path, at ptxas's own register
// budget (32 on the vector path in float32).
template <typename T, class S, bool kHybrid, int kForm>
__global__ void __launch_bounds__(kThreads) fe_pass_kernel(const Pass<T> p) {
  fe_pass<T, S, kHybrid, kForm>(p);
}

// The lane-group path in float32, held to 32 registers so that two blocks
// are resident on an SM where their tables fit.
template <typename T, class S, bool kHybrid, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
fe_pass_lanes_kernel(const Pass<T> p) {
  fe_pass<T, S, kHybrid, kForm>(p);
}

// Launches `kernel` on a persistent grid of kThreads-thread blocks: as
// many as the SMs hold at `smem` bytes of dynamic shared memory each, or
// `need` if fewer. With blocks_per_sm not null nothing is launched: the
// occupancy the grid would be sized from is written there.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, size_t smem, int64_t need,
                      cudaStream_t stream, int* blocks_per_sm,
                      Args... args) {
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
  if (blocks_per_sm != nullptr) {
    *blocks_per_sm = per_sm;
    return 0;
  }
  int64_t blocks = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  if (need < blocks) blocks = need > 0 ? need : 1;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Launches one instantiation of the pass on a persistent grid.
template <typename T, class S, bool kHybrid, int kForm>
auto pass_kernel() {
  if constexpr (sizeof(T) == 4 && !S::kVec)
    return fe_pass_lanes_kernel<T, S, kHybrid, kForm>;
  else
    return fe_pass_kernel<T, S, kHybrid, kForm>;
}

template <typename T, class S, bool kHybrid, int kForm>
int launch_form(const Pass<T>& p, cudaStream_t stream, int* blocks_per_sm) {
  constexpr int kRecords = kThreads / S::G;
  return launch_persistent(pass_kernel<T, S, kHybrid, kForm>(),
                           GradTable<T, kForm, kHybrid>::smem_bytes(p.s),
                           (p.n + kRecords - 1) / kRecords, stream,
                           blocks_per_sm, p);
}

// The shape of the lane-group path for records of k entries: the fewest
// lanes G (a power of two) that hold the record at kLanesMaxE entries or
// fewer each, E = ⌈k/G⌉ but at least kLanesMinE; past kLanesMaxG lanes of
// kLanesMaxE, chunks of that size (*chunks = 1).
inline void lane_group(int k, int* g, int* e, int* chunks) {
  int lanes = 1;
  while (lanes < kLanesMaxG && (k + lanes - 1) / lanes > kLanesMaxE)
    lanes *= 2;
  const int per = (k + lanes - 1) / lanes;
  *g = lanes;
  *e = per < kLanesMinE ? kLanesMinE : per > kLanesMaxE ? kLanesMaxE : per;
  *chunks = per > kLanesMaxE;
}

template <int G, typename F>
int with_entries(int e, F&& f) {
  static_assert(kLanesMinE == 3 && kLanesMaxE == 5, "the cases below");
  switch (e) {
    case 3: return f(Shape<G, 3>{});
    case 4: return f(Shape<G, 4>{});
    case 5: return f(Shape<G, 5>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Calls f(Shape<…>{}) with the shape that records of k entries take: the
// vector path where vec is 1 (the caller has checked k and the alignment),
// else lane_group's.
template <typename F>
int with_shape(int k, int vec, F&& f) {
  if (vec) return f(Shape<kVecLanes, kVecMaxK / kVecLanes, true>{});
  int g = 0, e = 0, chunks = 0;
  lane_group(k, &g, &e, &chunks);
  if (chunks) return f(Shape<kLanesMaxG, kLanesMaxE, false, true>{});
  switch (g) {
    case 1: return with_entries<1>(e, f);
    case 2: return with_entries<2>(e, f);
    case 4: return with_entries<4>(e, f);
    case 8: return with_entries<8>(e, f);
    case 16: return with_entries<16>(e, f);
    case 32: return with_entries<32>(e, f);
  }
  return (int)cudaErrorInvalidValue;
}

// vec: 1 for the vector path (the caller has checked the alignment).
// form: kBlock (p.s = d for K5, the tier for K12) or, for K5, kDevice.
template <typename T, bool kHybrid>
int launch(const Pass<T>& p, int vec, int form, cudaStream_t stream,
           int* blocks_per_sm) {
  if (p.s < 0 || p.s > p.d || (vec && (p.k > kVecMaxK || p.k % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  return with_shape(p.k, vec, [&](auto shape) -> int {
    using S = decltype(shape);
    if (form == kBlock)
      return launch_form<T, S, kHybrid, kBlock>(p, stream, blocks_per_sm);
    if constexpr (!kHybrid) {
      if (form == kDevice)
        return launch_form<T, S, false, kDevice>(p, stream, blocks_per_sm);
    }
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace gdx_fe
