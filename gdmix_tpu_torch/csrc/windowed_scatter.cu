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
// contribution (8 bytes) and one write of the table: at ~7.3M entries and
// a 1M-slot table, ~63 MB, 0.019 ms at 3.35 TB/s.
//
// Design: a block walks a run of consecutive tiles, accumulating into a
// shared-memory window of W floats, and flushes the window into the table
// when the window id changes and at the end: one device atomic per non-zero
// slot (the table is zeroed first by the caller, so a window whose tiles
// are split over blocks sums correctly, and a window no entry reaches stays
// 0). Inside a warp, 32 consecutive entries are combined first by a
// segmented sum over runs of equal index (sorted entries repeat an index
// in runs: a popular cold id, or the entries of one row), so one shared
// atomic goes out per run. The zero padding (index 0, contribution 0)
// costs its read and nothing else. Blocks take runs of tiles, not whole
// windows, so the hundreds of thousands of padding entries that the
// layouts put into window 0 spread over many blocks.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void flush(float* acc, float* __restrict__ dst,
                                      int window) {
  __syncthreads();
  for (int i = threadIdx.x; i < window; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(dst + i, v);
    acc[i] = 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
windowed_scatter_kernel(const int32_t* __restrict__ idx_local,
                        const float* __restrict__ contrib,
                        const int32_t* __restrict__ win_of_tile,
                        int64_t n_tiles, int64_t tile_e, int num_windows,
                        int window, int tiles_per_block,
                        float* __restrict__ out) {
  extern __shared__ float acc[];   // [window]
  const int64_t t0 = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block
                                                    : n_tiles;
  for (int i = threadIdx.x; i < window; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned le_mask = (2u << lane) - 1u;   // lanes ≤ this one
  int cur = win_of_tile[t0];
  for (int64_t t = t0; t < t1; ++t) {
    const int wt = win_of_tile[t];   // the same for the whole block
    if (wt != cur) {
      if ((unsigned)cur < (unsigned)num_windows)
        flush(acc, out + (int64_t)cur * window, window);
      cur = wt;
    }
    const int64_t end = (t + 1) * tile_e;
    // the loop bound is uniform over a warp: the shuffles need every lane
    for (int64_t base = t * tile_e + (threadIdx.x & ~31); base < end;
         base += kThreads) {
      const int64_t e = base + lane;
      const bool live = e < end;
      const int key = live ? idx_local[e] : -1;
      float c = live ? contrib[e] : 0.f;
      // segmented inclusive sum over runs of equal key
      const int prev = __shfl_up_sync(kFull, key, 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || key != prev);
      const int seg = __popc(heads & le_mask);
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(kFull, c, o);
        const int up_seg = __shfl_up_sync(kFull, seg, o);
        if (lane >= o && up_seg == seg) c += up;
      }
      const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
      if (tail && c != 0.f && (unsigned)key < (unsigned)window)
        atomicAdd(acc + key, c);
    }
  }
  if ((unsigned)cur < (unsigned)num_windows)
    flush(acc, out + (int64_t)cur * window, window);
}

}  // namespace

extern "C" {

// out [num_windows·window] must be zero on entry. idx_local and contrib hold
// n_tiles·tile_e entries; win_of_tile [n_tiles].
int gdx_windowed_scatter_add(const int32_t* idx_local, const float* contrib,
                             const int32_t* win_of_tile, int64_t n_tiles,
                             int64_t tile_e, int num_windows, int window,
                             int tiles_per_block, float* out, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)window;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  windowed_scatter_kernel<<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      idx_local, contrib, win_of_tile, n_tiles, tile_e, num_windows, window,
      tiles_per_block, out);
  return (int)cudaGetLastError();
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
