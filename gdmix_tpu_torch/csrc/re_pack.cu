// The random-effect fit's marshal on the card: a columnar partition's flat
// records, uploaded once a fit, packed into the padded tier tensors that the
// solver ladder takes (models/random_effect_lr.py fit_groups, through
// ops/re_pack.py).
//
// Replaces no TPU kernel: the JAX package packs the tiers on the host
// (gdmix_tpu/data/bucketing.py iter_bucketize_flat, with its native
// per-entity sort in native/bucketize_ops.cc gdx_entry_local) and ships the
// padded arrays. Packing on the card moves only the raw columns across the
// bus and leaves no host packing at all.
//
// Records are entity-contiguous: entity e owns records
// [starts[e], starts[e] + counts[e]), each with K padded entries of which
// the first min(nnz[r], K) are live (all K when nnz is null).
//
// Pass 1, supports (re_supports_warp_kernel, re_supports_block_kernel): for
// each entity, the sorted distinct feature ids of its live entries, written
// to its own slice of a scratch [N·K] at starts[e]·K (its count·K entries
// always fit there, so no prefix sum is needed), their count u_count[e], its
// largest raw nnz, and per tier the maxima of max(u_count, 1) and of the
// nnz (atomicMax into tier_max [T, 2], zero on entry). The entity's count·K
// entries are loaded as keys (a dead entry is INT_MAX, so the live keys are
// the first `live` after the sort: a live INT_MAX id is equal to them), put
// in order by a bitonic network, and each first key of a run is written at
// its rank, found by a scan of the run-start flags.
//  * A warp an entity while count·K ≤ kWarpKeys: the keys in the warp's own
//    shared-memory tile, __syncwarp between the network's stages.
//  * A block an entity past that, from a list the wrapper builds from the
//    counts: keys in shared memory up to kBlockKeys, past that in a
//    device-memory workspace the wrapper allocates (the entity's keys
//    rounded up to a power of two), __syncthreads between stages.
// Pass 2, pack (re_pack_tier_kernel): one thread a (slot, row) of a tier's
// [b, n_cap] grid writes the row whole, padding included, so the outputs
// need no clearing: the live entries' local ids (the rank of the id among
// the entity's distinct ids, by a binary search of its slice) as int64 and
// their values, the label, offset and weight (1 where there is no weight
// column, 0 on padding rows), the slot's sample count, and the entity's
// distinct ids (one dummy 0 where it has none) into a compact int32 buffer
// at coff[slot]. Every output is optional: the sweep cache's hit packs the
// offsets alone.
//
// What bounds it: bytes. Over the fleet's 1,000,000 entities (12.1M
// records, K 4, four tiers of 25.2M padded rows) pass 1 reads ~0.24 GB and
// writes ~0.2 GB; pass 2 reads ~0.5 GB and writes the tiers' ~1.6 GB: ~2.5
// GB, ~0.75 ms at 3.35 TB/s. Consecutive threads take consecutive rows of
// one entity (pass 2) or consecutive entries (pass 1), so reads of the
// records coalesce; the binary searches read a few ids of a slice that the
// row's neighbours read too.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpKeys = 256;            // warp path: count·K up to this
constexpr int kWarpsPerBlock = 8;
constexpr int kBlockThreads = 256;        // block path and pass 2
constexpr int kBlockKeys = 4096;          // block path in shared memory
constexpr int kPerLane = kWarpKeys / 32;  // keys a lane ranks (warp path)
constexpr unsigned kFull = 0xffffffffu;

struct SupportsArgs {
  const int32_t* indices;   // [N, K]
  const int32_t* nnz;       // [N] or null: all K live
  const int32_t* counts;    // [E]
  const int64_t* starts;    // [E]
  const int32_t* tier_of;   // [E]
  int64_t E;
  int K;
  int32_t* uniq;            // [N·K] scratch
  int32_t* u_count;         // [E]
  int32_t* max_nnz;         // [E]
  int32_t* tier_max;        // [T, 2]
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Inclusive scan over the warp's lanes.
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The entity's key i of n: its id if live, else INT_MAX; `live` counts the
// live ones.
__device__ __forceinline__ int load_key(const SupportsArgs& a, int64_t r0,
                                        int64_t n, int64_t i, int& live) {
  if (i >= n) return INT_MAX;
  const int64_t r = i / a.K;
  const int c = (int)(i - r * a.K);
  const int nz = a.nnz ? a.nnz[r0 + r] : a.K;
  if (c >= nz) return INT_MAX;
  ++live;
  return a.indices[r0 * a.K + i];
}

// One compare-and-swap stage of the bitonic network over p keys, pairs
// i = tid, tid + step, …: the pair (lo, lo + stride) of block `size`,
// ascending where lo & size is 0.
__device__ __forceinline__ void bitonic_stage(int* keys, int p, int size,
                                              int stride, int tid, int step) {
  for (int i = tid; i < p / 2; i += step) {
    const int lo = 2 * i - (i & (stride - 1));
    const int hi = lo + stride;
    const bool asc = (lo & size) == 0;
    const int x = keys[lo], y = keys[hi];
    if ((x > y) == asc) {
      keys[lo] = y;
      keys[hi] = x;
    }
  }
}

__device__ __forceinline__ bool run_start(const int* keys, int pos) {
  return pos == 0 || keys[pos] != keys[pos - 1];
}

// The entity's outputs, from one thread.
__device__ __forceinline__ void finish(const SupportsArgs& a, int64_t e,
                                       int u, int mx) {
  a.u_count[e] = u;
  a.max_nnz[e] = mx;
  int32_t* t = a.tier_max + 2 * (int64_t)a.tier_of[e];
  atomicMax(t, max(u, 1));
  atomicMax(t + 1, mx);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    re_supports_warp_kernel(SupportsArgs a) {
  __shared__ int s_keys[kWarpsPerBlock][kWarpKeys];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t e = (int64_t)blockIdx.x * kWarpsPerBlock + w;
  if (e >= a.E) return;
  const int64_t cnt = a.counts[e], n = cnt * a.K;
  if (n > kWarpKeys) return;   // the block path's
  const int64_t r0 = a.starts[e];
  int* keys = s_keys[w];
  const int p = pow2_at_least(n);
  int live = 0, mx = 0;
  for (int i = lane; i < p; i += 32) keys[i] = load_key(a, r0, n, i, live);
  for (int64_t r = lane; r < cnt; r += 32)
    mx = max(mx, a.nnz ? a.nnz[r0 + r] : a.K);
  live = warp_sum(live);
  mx = warp_max(mx);
  __syncwarp();
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      bitonic_stage(keys, p, size, stride, lane, 32);
      __syncwarp();
    }
  const int base = lane * kPerLane;
  int mine = 0;
  for (int j = 0; j < kPerLane; ++j) {
    const int pos = base + j;
    mine += pos < live && run_start(keys, pos);
  }
  const int incl = warp_scan(mine, lane);
  const int u = __shfl_sync(kFull, incl, 31);
  int32_t* out = a.uniq + r0 * a.K;
  int at = incl - mine;
  for (int j = 0; j < kPerLane; ++j) {
    const int pos = base + j;
    if (pos < live && run_start(keys, pos)) out[at++] = keys[pos];
  }
  if (lane == 0) finish(a, e, u, mx);
}

// Sum and max over the block (kBlockThreads); every thread gets both.
__device__ __forceinline__ void block_sum_max(int& s, int& m, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  s = warp_sum(s);
  m = warp_max(m);
  if (lane == 0) {
    red[2 * w] = s;
    red[2 * w + 1] = m;
  }
  __syncthreads();
  s = 0;
  m = 0;
  for (int i = 0; i < kBlockThreads / 32; ++i) {
    s += red[2 * i];
    m = max(m, red[2 * i + 1]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBlockThreads)
    re_supports_block_kernel(SupportsArgs a, const int32_t* ents,
                             const int64_t* ws_off, int32_t* ws) {
  __shared__ int s_keys[kBlockKeys];
  __shared__ int s_red[2 * (kBlockThreads / 32)];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t e = ents[blockIdx.x];
  const int64_t cnt = a.counts[e], n = cnt * a.K;
  const int64_t r0 = a.starts[e];
  const int p = pow2_at_least(n);
  int* keys = ws_off[blockIdx.x] < 0 ? s_keys : ws + ws_off[blockIdx.x];
  int live = 0, mx = 0;
  for (int i = tid; i < p; i += kBlockThreads)
    keys[i] = load_key(a, r0, n, i, live);
  for (int64_t r = tid; r < cnt; r += kBlockThreads)
    mx = max(mx, a.nnz ? a.nnz[r0 + r] : a.K);
  block_sum_max(live, mx, s_red);
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      bitonic_stage(keys, p, size, stride, tid, kBlockThreads);
      __syncthreads();
    }
  // each thread ranks a run of consecutive keys
  const int per = (p + kBlockThreads - 1) / kBlockThreads;
  const int base = tid * per;
  int mine = 0;
  for (int j = 0; j < per; ++j) {
    const int pos = base + j;
    mine += pos < live && run_start(keys, pos);
  }
  const int incl = warp_scan(mine, lane);
  if (lane == 31) s_red[w] = incl;
  __syncthreads();
  int before = 0, u = 0;
  for (int i = 0; i < kBlockThreads / 32; ++i) {
    before += i < w ? s_red[i] : 0;
    u += s_red[i];
  }
  int32_t* out = a.uniq + r0 * a.K;
  int at = before + incl - mine;
  for (int j = 0; j < per; ++j) {
    const int pos = base + j;
    if (pos < live && run_start(keys, pos)) out[at++] = keys[pos];
  }
  if (tid == 0) finish(a, e, u, mx);
}

template <class T>
struct PackArgs {
  const int32_t* indices;   // [N, K]
  const T* values;          // [N, K]
  const int32_t* nnz;       // [N] or null
  const T* labels;          // [N] or null: 0
  const T* offsets;         // [N] or null: 0
  const T* weights;         // [N] or null: 1 on real rows
  const int32_t* counts;    // [E]
  const int64_t* starts;    // [E]
  const int32_t* uniq;      // pass 1's scratch
  const int32_t* u_count;   // [E]
  const int32_t* members;   // [b_real]: the entity in each slot
  const int64_t* coff;      // [b_real]: each slot's first compact id
  int64_t b_real, b, n_cap;
  int k, K;
  int64_t* idx_out;         // [b, n_cap, k] or null
  T* val_out;               // [b, n_cap, k] (with idx_out)
  T* lab_out;               // [b, n_cap] or null
  T* off_out;
  T* wt_out;
  T* cnt_out;               // [b] or null
  int32_t* sup_out;         // compact ids or null
};

// The rank of `fid` among the u sorted ids of `sup` (it is one of them).
__device__ __forceinline__ int64_t rank_of(const int32_t* sup, int u,
                                           int fid) {
  int lo = 0, hi = u;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sup[mid] < fid)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <class T>
__global__ void __launch_bounds__(kBlockThreads)
    re_pack_tier_kernel(PackArgs<T> a) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= a.b * a.n_cap) return;
  const int64_t slot = pos / a.n_cap;
  const int row = (int)(pos - slot * a.n_cap);
  int64_t e = -1;
  int cnt = 0;
  if (slot < a.b_real) {
    e = a.members[slot];
    cnt = a.counts[e];
  }
  const bool real = row < cnt;
  const int64_t rec = real ? a.starts[e] + row : 0;
  if (a.idx_out) {
    int nz = 0, u = 0;
    const int32_t* sup = nullptr;
    if (real) {
      nz = min(a.nnz ? a.nnz[rec] : a.K, a.K);
      sup = a.uniq + a.starts[e] * a.K;
      u = a.u_count[e];
    }
    int64_t* io = a.idx_out + pos * a.k;
    T* vo = a.val_out + pos * a.k;
    for (int c = 0; c < a.k; ++c) {
      int64_t loc = 0;
      T v = T(0);
      if (c < nz) {
        loc = rank_of(sup, u, a.indices[rec * a.K + c]);
        v = a.values[rec * a.K + c];
      }
      io[c] = loc;
      vo[c] = v;
    }
  }
  if (a.lab_out) a.lab_out[pos] = real && a.labels ? a.labels[rec] : T(0);
  if (a.off_out) a.off_out[pos] = real && a.offsets ? a.offsets[rec] : T(0);
  if (a.wt_out) a.wt_out[pos] = real ? (a.weights ? a.weights[rec] : T(1)) : T(0);
  if (a.cnt_out && row == 0) a.cnt_out[slot] = T(cnt);
  if (a.sup_out && e >= 0) {
    const int u = a.u_count[e];
    const int32_t* sup = a.uniq + a.starts[e] * a.K;
    int32_t* so = a.sup_out + a.coff[slot];
    for (int j = row; j < max(u, 1); j += (int)a.n_cap) so[j] = u ? sup[j] : 0;
  }
}

template <class T>
int pack_tier(const int32_t* indices, const T* values, const int32_t* nnz,
              const T* labels, const T* offsets, const T* weights,
              const int32_t* counts, const int64_t* starts,
              const int32_t* uniq, const int32_t* u_count,
              const int32_t* members, const int64_t* coff, int64_t b_real,
              int64_t b, int64_t n_cap, int k, int K, int64_t* idx_out,
              T* val_out, T* lab_out, T* off_out, T* wt_out, T* cnt_out,
              int32_t* sup_out, void* stream) {
  const int64_t total = b * n_cap;
  if (total == 0) return 0;
  if (k < 0 || K < 0 || b_real > b) return (int)cudaErrorInvalidValue;
  const PackArgs<T> a{indices, values,  nnz,     labels,  offsets, weights,
                      counts,  starts,  uniq,    u_count, members, coff,
                      b_real,  b,       n_cap,   k,       K,       idx_out,
                      val_out, lab_out, off_out, wt_out,  cnt_out, sup_out};
  re_pack_tier_kernel<T>
      <<<(unsigned)((total + kBlockThreads - 1) / kBlockThreads),
         kBlockThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest count·K the warp path takes, and the most keys the block path
// keeps in shared memory: the wrapper's entity lists and workspace follow
// them.
int gdx_re_pack_warp_keys(void) { return kWarpKeys; }
int gdx_re_pack_block_keys(void) { return kBlockKeys; }

// Pass 1 over all E entities. indices [N, K] int32, nnz [N] int32 or null,
// counts [E] int32, starts [E] int64, tier_of [E] int32; block_ents
// [n_block] int32 the entities with counts·K > kWarpKeys, ws_off [n_block]
// int64 each one's offset into the int32 workspace `ws` (its keys rounded
// up to a power of two) or −1 where they fit kBlockKeys. Out: uniq [N·K],
// u_count [E], max_nnz [E] int32; tier_max [T, 2] int32, zero on entry.
int gdx_re_supports(const int32_t* indices, const int32_t* nnz,
                    const int32_t* counts, const int64_t* starts,
                    const int32_t* tier_of, int64_t E, int K,
                    const int32_t* block_ents, const int64_t* ws_off,
                    int32_t* ws, int64_t n_block, int32_t* uniq,
                    int32_t* u_count, int32_t* max_nnz, int32_t* tier_max,
                    void* stream) {
  if (E == 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  const SupportsArgs a{indices, nnz,     counts,  starts,  tier_of, E,
                       K,       uniq,    u_count, max_nnz, tier_max};
  re_supports_warp_kernel<<<(unsigned)((E + kWarpsPerBlock - 1) /
                                       kWarpsPerBlock),
                            kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_block == 0) return (int)err;
  re_supports_block_kernel<<<(unsigned)n_block, kBlockThreads, 0,
                             (cudaStream_t)stream>>>(a, block_ents, ws_off,
                                                     ws);
  return (int)cudaGetLastError();
}

// Pass 2 over one tier: slots [0, b_real) hold entities members[slot],
// slots past them are padding. Outputs as re_pack_tier_kernel's; any may be
// null (with idx_out null, val_out is not read).
int gdx_re_pack_tier_f32(const int32_t* indices, const float* values,
                         const int32_t* nnz, const float* labels,
                         const float* offsets, const float* weights,
                         const int32_t* counts, const int64_t* starts,
                         const int32_t* uniq, const int32_t* u_count,
                         const int32_t* members, const int64_t* coff,
                         int64_t b_real, int64_t b, int64_t n_cap, int k,
                         int K, int64_t* idx_out, float* val_out,
                         float* lab_out, float* off_out, float* wt_out,
                         float* cnt_out, int32_t* sup_out, void* stream) {
  return pack_tier<float>(indices, values, nnz, labels, offsets, weights,
                          counts, starts, uniq, u_count, members, coff,
                          b_real, b, n_cap, k, K, idx_out, val_out, lab_out,
                          off_out, wt_out, cnt_out, sup_out, stream);
}

int gdx_re_pack_tier_f64(const int32_t* indices, const double* values,
                         const int32_t* nnz, const double* labels,
                         const double* offsets, const double* weights,
                         const int32_t* counts, const int64_t* starts,
                         const int32_t* uniq, const int32_t* u_count,
                         const int32_t* members, const int64_t* coff,
                         int64_t b_real, int64_t b, int64_t n_cap, int k,
                         int K, int64_t* idx_out, double* val_out,
                         double* lab_out, double* off_out, double* wt_out,
                         double* cnt_out, int32_t* sup_out, void* stream) {
  return pack_tier<double>(indices, values, nnz, labels, offsets, weights,
                           counts, starts, uniq, u_count, members, coff,
                           b_real, b, n_cap, k, K, idx_out, val_out,
                           lab_out, off_out, wt_out, cnt_out, sup_out,
                           stream);
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
