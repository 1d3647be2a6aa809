// Σ-scatter of a pre-sorted entry stream into a table cut into aligned
// windows: out[win_of_tile[t]·W + idx_local[e]] += contrib[e] for every
// entry e of tile t. Float32, as the TPU kernel.
//
// Replaces gdmix_tpu/ops/pallas/windowed_scatter.py:40 _kernel (K13,
// windowed_scatter_add_pallas). The wide-D hybrid's cold side runs it twice
// per funcall: the row accumulation of z_cold (entries sorted by row) and
// the cold gradient (entries sorted by feature id). The layout
// (gdmix_tpu_torch/ops/logistic.py _windowed_layout) packs the entries 16 to
// a row, pads each window to whole tiles and gives every window at least one
// tile; win_of_tile is non-decreasing. The TPU kernel turned each tile into
// one-hot matmuls against a [W/128, 128] window block that Pallas kept in
// VMEM while the window id held; here a window is an array in shared memory.
//
// Bound: device memory, one read of each entry's local index and
// contribution (8 bytes) and one write of the table: at ~7.6M entries and
// a 1M-slot table, ~65 MB, 0.019 ms at 3.35 TB/s.
//
// Design. A work plan, built once per fit beside the layout
// (ops/windowed_scatter.py windowed_plan), cuts the tiles into items: at
// most T consecutive tiles of one window, T chosen so that the items fill
// about one wave. Tiles whose entries are all padding (value 0 in the
// layout, so contribution 0 in every call) are left out. Every window has
// at least one item, with no tile if none is left. An item's entries are
// one contiguous range, so its loads wait on no index.
//  * A persistent grid of kThreads-thread blocks takes the items from a
//    queue (an atomic counter; the plan lists the largest first, so the
//    blocks finish together). For each it clears a shared-memory window,
//    adds the item's entries into it and stores the whole window with
//    16-byte stores, zeros included. So the table needs no clearing: the
//    wrapper allocates it with torch.empty, and an owned window (one item)
//    costs no device atomic.
//  * A window of several items (split; e.g. a window that collects many
//    cold entries) stores each item's window into its own row of a
//    scratch buffer [parts, W], fences, and counts in on the window's
//    counter. The last item to arrive sums the rows in item order (0 +
//    row 0 + row 1 + …, kSumBatch loads in flight a thread), stores the
//    window, and sets the counter back to 0 for the next call; the last
//    block out sets the queue back.
//  * Entries, a chunk of 4·kThreads at a time: each thread copies four ids
//    and four contributions (16 bytes each, cp.async) into a ring of
//    kStages chunks in shared memory, the next chunk's while it adds this
//    one; it reads back only its own copies, so the ring needs no barrier.
//    Runs of equal id are combined in the lane, then over the warp by a
//    segmented scan of shuffles, then over the block: each warp posts its
//    first and last id and the sum of its last run, and a run that began
//    in earlier warps takes their sums in order. The lane that holds a
//    run's last entry adds the run's sum to the window with one shared
//    atomic. In a stream sorted by id within each window every id then
//    gets at most one addition a chunk, the chunks in order: every sum is
//    taken in one order, and two calls give the same bits. (An unsorted
//    stream still sums right, through the atomics, in no fixed order.)
//    Entries of contribution 0 cost their read.
// Forks of it timed on the card (ring stages, block size, the parts above
// left out) and their times: PERF.md §6.
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;   // resident blocks an SM the kernel is built for
constexpr int kPerLane = 4;     // entries a lane adds a chunk: one 16-byte copy
constexpr int kStages = 2;      // chunks in the shared-memory ring
constexpr int kSumBatch = 4;    // scratch rows a thread loads at once
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kPerLane * kThreads;   // entries a block adds at once
// the ring: kStages chunks of ids and contributions, after the window
constexpr int kRingBytes = kStages * kChunk * 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPerLane == 4, "a lane's entries are one 16-byte copy");
// one plan item: [kItemInts] int32
enum {
  kBegin,       // its tiles, [begin, end) of the layout's
  kEnd,
  kWindow,
  kPart,        // −1: owns its window; else its row of the scratch
  kFirstPart,   // the window's first scratch row
  kParts,       // the window's items
  kCounter,     // the window's counter
  kItemInts
};

struct Plan {
  const int32_t* items;   // [n_items, kItemInts], the largest first
  float* scratch;         // [parts, window]
  // [0] the next item, [1] the blocks done, [2 + c] split window c's
  // items done; all 0 between calls
  int32_t* counters;
  int n_items;
};

struct Posts {             // each warp's summary of a chunk, for later warps
  int first[kWarps];       // its first id
  int last[kWarps];        // its last id
  float last_sum[kWarps];  // the sum of its last run, from its first lane on
  int whole[kWarps];       // 1: the warp is one run
};

// Starts the copy of chunk c of an item (entries [first, first + n) of
// the layout) into ring stage c % kStages: this thread's kPerLane ids and
// contributions, 16 bytes each, as the thread reads them back itself. One
// commit a call, a chunk past the end an empty one.
__device__ __forceinline__ void issue_chunk(const int32_t* idx_local,
                                            const float* contrib,
                                            int64_t first, int n, int c,
                                            int32_t* ring_k, float* ring_v) {
  const int p = c * kChunk + kPerLane * (int)threadIdx.x;
  if (p < n) {
    const int slot = (c % kStages) * kChunk + kPerLane * (int)threadIdx.x;
    __pipeline_memcpy_async(ring_k + slot, idx_local + first + p, 16);
    __pipeline_memcpy_async(ring_v + slot, contrib + first + p, 16);
  }
  __pipeline_commit();
}

// Adds one chunk (this lane's entries k[], v[], in stream order) into the
// window acc. All threads call.
__device__ __forceinline__ void add_chunk(float* acc, int window,
                                          const int* k, const float* v,
                                          Posts& post) {
  constexpr int L = kPerLane;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool whole = true;
#pragma unroll
  for (int j = 1; j < L; ++j) whole = whole && k[j] == k[0];
  // the sum of the lane's last run, within the lane
  float tail = v[L - 1];
  bool in_run = true;
#pragma unroll
  for (int j = L - 2; j >= 0; --j) {
    in_run = in_run && k[j] == k[L - 1];
    if (in_run) tail += v[j];
  }
  // x: the sum of the lane's last run from its start in this warp; open:
  // that run reaches back to the warp's first entry
  const int prev_last = __shfl_up_sync(kFull, k[L - 1], 1);
  float x = tail;
  bool open = whole && (lane == 0 || prev_last == k[0]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, x, o);
    const int up_open = __shfl_up_sync(kFull, (int)open, o);
    if (lane >= o && open) {
      x += up;
      open = up_open;
    }
  }
  // the previous lane's x and open, for this lane's first run
  const float x_prev = __shfl_up_sync(kFull, x, 1);
  const int open_prev = __shfl_up_sync(kFull, (int)open, 1);
  const int next_first = __shfl_down_sync(kFull, k[0], 1);
  if (lane == 0) post.first[warp] = k[0];
  if (lane == 31) {
    post.last[warp] = k[L - 1];
    post.last_sum[warp] = x;
    post.whole[warp] = open;
  }
  __syncthreads();
  // what this warp's first run carries in from earlier warps, in order
  float carry = 0.f;
  for (int w = warp - 1; w >= 0 && post.last[w] == post.first[warp]; --w) {
    carry += post.last_sum[w];
    if (!post.whole[w]) break;
  }
  // the lane's first run: from earlier lanes (and warps, if it reaches the
  // warp's start)
  float r;
  if (lane == 0) r = carry;
  else if (prev_last == k[0]) r = open_prev ? x_prev + carry : x_prev;
  else r = 0.f;
  // whether the lane's last run ends here
  const int after = lane < 31 ? next_first
                    : warp + 1 < kWarps ? post.first[warp + 1] : -1;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    r += v[j];
    const bool end = j < L - 1 ? k[j + 1] != k[j] : after != k[L - 1];
    if (end) {
      if (r != 0.f && (unsigned)k[j] < (unsigned)window)
        atomicAdd(acc + k[j], r);
      r = 0.f;
    }
  }
  __syncthreads();   // the posts are read; the next chunk adds after these
}

__device__ __forceinline__ void store_window(float* dst, const float* src,
                                             int window) {
  for (int i = 4 * threadIdx.x; i < window; i += 4 * kThreads)
    *reinterpret_cast<float4*>(dst + i) =
        *reinterpret_cast<const float4*>(src + i);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
windowed_scatter_kernel(const int32_t* __restrict__ idx_local,
                        const float* __restrict__ contrib, int tile_e,
                        int window, const Plan plan, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];   // [window], then the ring
  float* acc = smem;
  int32_t* ring_k = reinterpret_cast<int32_t*>(smem + window);
  float* ring_v = reinterpret_cast<float*>(ring_k + kStages * kChunk);
  __shared__ Posts post;
  __shared__ int last_in, next;
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(plan.counters, 1);
    __syncthreads();
    const int it = next;
    if (it >= plan.n_items) break;
    const int32_t* item = plan.items + (int64_t)it * kItemInts;
    const int part = item[kPart];
    const int64_t first = (int64_t)item[kBegin] * tile_e;
    const int n = (item[kEnd] - item[kBegin]) * tile_e;
    const int chunks = (n + kChunk - 1) / kChunk;
    float* dst = out + (int64_t)item[kWindow] * window;
    for (int c = 0; c < kStages - 1; ++c)
      issue_chunk(idx_local, contrib, first, n, c, ring_k, ring_v);
    for (int i = 4 * threadIdx.x; i < window; i += 4 * kThreads)
      *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      issue_chunk(idx_local, contrib, first, n, c + kStages - 1, ring_k,
                  ring_v);
      __pipeline_wait_prior(kStages - 1);   // chunk c has landed
      int k[kPerLane];
      float v[kPerLane];
      const int p = c * kChunk + kPerLane * (int)threadIdx.x;
      const int slot = (c % kStages) * kChunk + kPerLane * (int)threadIdx.x;
      const int4 a = *reinterpret_cast<const int4*>(ring_k + slot);
      const float4 b = *reinterpret_cast<const float4*>(ring_v + slot);
      const bool in = p < n;
      k[0] = in ? a.x : -1; k[1] = in ? a.y : -1;
      k[2] = in ? a.z : -1; k[3] = in ? a.w : -1;
      v[0] = in ? b.x : 0.f; v[1] = in ? b.y : 0.f;
      v[2] = in ? b.z : 0.f; v[3] = in ? b.w : 0.f;
      add_chunk(acc, window, k, v, post);
    }
    if (part < 0) {
      store_window(dst, acc, window);
    } else {
      store_window(plan.scratch + (int64_t)part * window, acc, window);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last_in = atomicAdd(plan.counters + 2 + item[kCounter], 1) ==
                  item[kParts] - 1;
      __syncthreads();
      if (last_in) {
        __threadfence();
        const float* rows = plan.scratch + (int64_t)item[kFirstPart] * window;
        const int parts = item[kParts];
        for (int i = 4 * threadIdx.x; i < window; i += 4 * kThreads) {
          // the rows in item order, kSumBatch loads in flight at a time
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int q0 = 0; q0 < parts; q0 += kSumBatch) {
            float4 t[kSumBatch];
#pragma unroll
            for (int u = 0; u < kSumBatch; ++u)
              if (q0 + u < parts)
                t[u] = __ldcg(reinterpret_cast<const float4*>(
                    rows + (int64_t)(q0 + u) * window + i));
#pragma unroll
            for (int u = 0; u < kSumBatch; ++u) {
              if (q0 + u < parts) {
                s.x += t[u].x; s.y += t[u].y; s.z += t[u].z; s.w += t[u].w;
              }
            }
          }
          *reinterpret_cast<float4*>(dst + i) = s;
        }
        if (threadIdx.x == 0) plan.counters[2 + item[kCounter]] = 0;
      }
    }
    __syncthreads();   // acc and `next` are read; the next item clears it
  }
  // the last block out sets the queue back for the next call: every
  // block has taken its last item by then
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(plan.counters + 1, 1) == (int)gridDim.x - 1) {
      plan.counters[0] = 0;
      plan.counters[1] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Sets the kernel's shared memory for windows of `window` floats (and the
// ring) and writes its resident blocks per SM there; once per window size.
int gdx_windowed_scatter_setup(int window, int* blocks_per_sm) {
  const size_t smem = sizeof(float) * (size_t)window + kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, windowed_scatter_kernel, kThreads, smem);
}

// out [num_windows·window] is written whole (no clearing needed): every
// window has an item. idx_local and contrib hold the layout's entries,
// tiles of tile_e (a multiple of 4), 16-byte aligned; items [n_items, 7]
// as windowed_plan builds them; counters zero on entry, and zero again on
// return. window % 4 == 0. grid: the persistent grid's blocks.
int gdx_windowed_scatter_add(const int32_t* idx_local, const float* contrib,
                             int tile_e, int window, const int32_t* items,
                             int n_items, float* scratch, int32_t* counters,
                             int grid, float* out, void* stream) {
  if (n_items == 0) return 0;
  if (window % 4 != 0 || tile_e % kPerLane != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan plan{items, scratch, counters, n_items};
  windowed_scatter_kernel<<<(unsigned)(grid < n_items ? grid : n_items),
                            kThreads,
                            sizeof(float) * (size_t)window + kRingBytes,
                            (cudaStream_t)stream>>>(
      idx_local, contrib, tile_e, window, plan, out);
  return (int)cudaGetLastError();
}

// The shared memory the kernel takes besides the window.
int gdx_windowed_scatter_ring_bytes(void) { return kRingBytes; }

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
