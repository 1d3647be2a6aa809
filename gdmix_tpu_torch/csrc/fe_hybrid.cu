// The hot side of the wide-D fixed-effect hybrid: one fused pass over the
// records against a compact top-A id space. Float and double.
//
// Replaces gdmix_tpu/ops/pallas/fe_hybrid.py:53 _kernel (K12,
// fe_hybrid_hot_pallas). Per record, with compact ids idx ∈ [0, A] (A is the
// dump slot of cold and padding entries):
//   z = Σ v·θc[idx] + off₂ + b        (off₂ already holds z_cold)
//   loss += w·bce(z, y) (or w·(y − z)²), r = w·(σ(z) − y) (or w·2(z − y))
//   g[idx] += v·r,  Σr += r,  r_out[row] = r (the cold side's input)
// The TPU kernel built this from one-hot matmuls on the MXU with θ and v·r
// split into two bf16 terms, a [T, 1] → [1, T] identity-dot transpose for r,
// and rows padded to 8 tiles; none of that exists here: the card gathers
// and adds natively, and each thread masks its own rows.
//
// The kernel is fe_common.cuh's pass with kHybrid set (its header gives the
// design, the vector and lane-group paths and what decided the latter):
// this file holds its C entry points. Bound: device memory. A record is
// read once (K ids and values, y, w, off₂) and r written once: at N =
// 4,997,120, K = 16 in float32 about 720 MB, 0.215 ms at 3.35 TB/s; at
// criteo's K = 39 about 1.64 GB, 0.489 ms.
//
// What the pass adds for the compact space, which the split hands out in
// descending order of count (ops/logistic.py _hybrid_hot: compact id 0 is
// the most frequent):
//  * a strip of 32 lane-private slots for each of the 32 (kStrip) most
//    frequent ids, so the ids that many lanes of a warp hold at once never
//    share an address and need no vote;
//  * a tiered table (ops/fe_hybrid.py shared_tier): the gradient of the
//    ids below S in shared memory, S = A while A·sizeof(T) fits what is left
//    of the 227 KB a block may opt into, and the ids in [S, A), the rarest,
//    added in device memory.
//
// What decided each choice: each alternative was built and timed against
// what is here while the kernel was designed, and only the winner is kept in
// the source (NVIDIA H100 80GB HBM3, 700 W; N = 4,997,120, K = 16, the hot
// side of the D = 1,000,000 Zipf(1.2) split; ms a call at A = 16,384 float32
// / A = 65,536 float32 / A = 16,384 float64, CUDA events around the wrapper):
// as kept 0.382 / 0.560 / 0.679. No strips 1.951 / 2.023 / 2.774; no strips
// but warp aggregation (__match_any_sync and a tree over the peers, what
// this kernel did before) 0.652 / 0.796 / 0.909. 16 strips 0.379 / 0.566 /
// 0.691, 64 strips 0.373 / 0.551 / 0.666: 32 kept. On uniform compact ids,
// where no id is frequent, 0.390 with the strips and 0.388 without: they
// cost nothing there. Lanes a record: one 0.458 / 0.523 / 0.821, sixteen
// 0.739 / 1.228 / 1.514, four kept. Blocks of 512 threads 0.438 / 0.935 /
// 1.151, 1,024 kept. θc in shared memory beside the gradient measured 0.518
// at A = 16,384 against 0.382 through the read-only cache: with the table
// alone two blocks are resident on an SM instead of one, so θc left.
// These were timed at K = 16, on the vector path. ptxas: 32 registers in
// float32, 62 in float64, no spills on the vector path (fe_common.cuh for
// the lane-group path); resident 1,024-thread blocks an SM: 2 at A = 16,384
// float32 (K = 16 and K = 39 alike), 1 at A = 65,536 and in float64.
#include <cstdint>

#include <cuda_runtime.h>

#include "fe_common.cuh"

namespace {

template <typename T>
int hot(const int32_t* idx, const T* val, const T* y, const T* w,
        const T* off2, const T* theta_c, const T* b, int64_t n, int k, int a,
        int linear, int s, int vec, T* g, T* r, double* sums, void* stream,
        int* blocks_per_sm) {
  const gdx_fe::Pass<T> p{idx, val, y, w, off2, theta_c, b, n, k, a,
                          s, linear, g, r, sums};
  return gdx_fe::launch<T, true>(p, vec, gdx_fe::kBlock,
                                 (cudaStream_t)stream, blocks_per_sm);
}

}  // namespace

extern "C" {

// g [a] and sums [2] (loss, Σr in double) must be zero on entry; r [n] is
// written whole. s: the compact ids below it add into shared memory
// (s·sizeof(T) bytes), the rest in device memory; vec: 1 for the vector path
// (k ≤ 16, k % 4 == 0, rows 16-byte aligned), 0 for the lane-group path
// (any k). With blocks_per_sm not null
// nothing is launched: the form's resident blocks per SM are written there.
int gdx_fe_hybrid_hot_f32(const int32_t* idx, const float* val,
                          const float* y, const float* w, const float* off2,
                          const float* theta_c, const float* b, int64_t n,
                          int k, int a, int linear, int s, int vec,
                          float* g, float* r, double* sums, void* stream,
                          int* blocks_per_sm) {
  return hot<float>(idx, val, y, w, off2, theta_c, b, n, k, a, linear, s,
                    vec, g, r, sums, stream, blocks_per_sm);
}

int gdx_fe_hybrid_hot_f64(const int32_t* idx, const double* val,
                          const double* y, const double* w,
                          const double* off2, const double* theta_c,
                          const double* b, int64_t n, int k, int a,
                          int linear, int s, int vec, double* g, double* r,
                          double* sums, void* stream, int* blocks_per_sm) {
  return hot<double>(idx, val, y, w, off2, theta_c, b, n, k, a, linear, s,
                     vec, g, r, sums, stream, blocks_per_sm);
}

// The number of ids that get a lane-private strip (the wrapper's byte budget
// counts 32 slots for each).
int gdx_fe_hybrid_strip_ids(void) { return gdx_fe::kStrip; }

// The lane-group shape (lanes·100 + entries) of records of k entries off
// the vector path: the wrapper checks its mirror of the choice against it.
int gdx_fe_hybrid_lane_group(int k) {
  int g = 0, e = 0, chunks = 0;
  gdx_fe::lane_group(k, &g, &e, &chunks);
  return g * 100 + e;
}

const char* gdx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
