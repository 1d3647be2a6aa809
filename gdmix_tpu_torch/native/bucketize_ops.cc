// Native hot loops for the random-effect host marshal (data/bucketing.py's
// iter_bucketize_flat and models/random_effect_lr._entity_supports).
//
// The reference pays this cost as the producer loop that slices per-entity
// scipy COO matrices (gdmix-trainer/src/gdmix/models/custom/scipy/
// job_consumers.py:161-296); here the whole partition is columnar and these
// kernels do the per-entity support extraction + local-index remap and the
// per-tier block scatter multicore — the two loops that dominated the numpy
// marshal (~0.35 s + ~0.3 s per 100k entities single-threaded).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread bucketize_ops.cc -o
//        libgdmix_bucketize.so   (done lazily by gdmix_tpu.native)
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename Fn>
void parallel_for(int64_t n, int64_t grain, Fn&& fn) {
  int threads = 0;
  if (const char* env = std::getenv("GDMIX_TPU_NATIVE_THREADS"))
    threads = std::atoi(env);
  if (threads <= 0)
    threads = static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, 16));
  if (threads == 1 || n < grain * 2) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  threads = static_cast<int>(
      std::min<int64_t>(threads, (n + grain - 1) / grain));
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    pool.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Per-entity support extraction + per-entry LOCAL feature ids, fused.
//
// Records are entity-contiguous (rec_starts[e] .. rec_starts[e]+counts[e]);
// each entity's entries are sorted/deduped independently — embarrassingly
// parallel over entities, no global sort (the numpy path's combined-key
// argsort over all M entries).
//
// inputs:
//   indices  [N, K] int32 padded-COO feature ids
//   values   [N, K] double (only read when nnz == nullptr: value!=0 marks a
//            live entry, matching the python fallback)
//   nnz      [N] int32 live entries per record, or nullptr
//   counts   [E] int64 records per entity
//   rec_starts [E] int64 first record of each entity
// outputs (caller-allocated):
//   local    [N, K] int32 per-entry local feature id (position of the entry's
//            feature inside the entity's sorted unique support); padding
//            entries keep 0
//   uniq_fid [cap_u] int64 per-entity sorted unique feature ids, flattened
//            entity-major (cap_u >= total uniques; N*K always suffices)
//   u_counts [E] int64 unique-support size per entity
//   u_offs   [E+1] int64 exclusive prefix of u_counts
// returns total uniques U, or -1 if cap_u was too small.
// live-entry rule when nnz is null: use_value_mask != 0 -> value != 0 marks
// a live entry (models/random_effect_lr._entity_supports semantics); 0 -> all
// K entries are live (data/bucketing.iter_bucketize_flat semantics).
int64_t gdx_entry_local(const int32_t* indices, const double* values,
                        const int32_t* nnz, const int64_t* counts,
                        const int64_t* rec_starts, int64_t N, int32_t K,
                        int64_t E, int32_t use_value_mask, int32_t* local,
                        int64_t* uniq_fid, int64_t* u_counts, int64_t* u_offs,
                        int64_t cap_u) {
  if (E == 0) {
    u_offs[0] = 0;
    return 0;
  }
  // pass 1: per-entity sort+dedup into thread-local scratch, record u_counts
  parallel_for(E, 64, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<int64_t, int32_t>> ent;  // (fid, entry slot in [cnt*K])
    std::vector<int64_t> sup;
    for (int64_t e = lo; e < hi; ++e) {
      const int64_t r0 = rec_starts[e], cnt = counts[e];
      ent.clear();
      for (int64_t r = r0; r < r0 + cnt; ++r) {
        for (int32_t c = 0; c < K; ++c) {
          const bool ok = nnz ? (c < nnz[r])
                              : (!use_value_mask || values[r * K + c] != 0.0);
          if (ok)
            ent.emplace_back(indices[r * K + c],
                             static_cast<int32_t>((r - r0) * K + c));
        }
      }
      std::sort(ent.begin(), ent.end());
      sup.clear();
      int64_t prev = -1;
      for (const auto& p : ent) {
        if (p.first != prev) {
          sup.push_back(p.first);
          prev = p.first;
        }
        local[(r0 + p.second / K) * K + (p.second % K)] =
            static_cast<int32_t>(sup.size() - 1);
      }
      u_counts[e] = static_cast<int64_t>(sup.size());
      // stash the support in uniq_fid later (pass 2 needs global offsets);
      // re-derive here is cheap but we would re-sort — instead write into a
      // per-entity bounded slice of a scratch area: not possible without
      // offsets. So pass 2 below redoes dedup from `local`+indices cheaply.
    }
  });
  u_offs[0] = 0;
  for (int64_t e = 0; e < E; ++e) u_offs[e + 1] = u_offs[e] + u_counts[e];
  const int64_t U = u_offs[E];
  if (U > cap_u) return -1;
  // pass 2: scatter each entity's unique fids into its final slice using the
  // per-entry local ids computed in pass 1 (uniq[local] = fid).
  parallel_for(E, 64, [&](int64_t lo, int64_t hi) {
    for (int64_t e = lo; e < hi; ++e) {
      const int64_t r0 = rec_starts[e], cnt = counts[e];
      int64_t* out = uniq_fid + u_offs[e];
      for (int64_t r = r0; r < r0 + cnt; ++r) {
        for (int32_t c = 0; c < K; ++c) {
          const bool ok = nnz ? (c < nnz[r])
                              : (!use_value_mask || values[r * K + c] != 0.0);
          if (ok) out[local[r * K + c]] = indices[r * K + c];
        }
      }
    }
  });
  return U;
}

// Per-tier solver-block scatter: every live entry of a tier-t entity lands at
// out[slot, rec - rec_start, col]. Parallel over records; targets are unique
// per entry, so writes are race-free.
//
//   ent_of_rec [N] int64, tier_of_ent [E] int32, slot_of_ent [E] int64
//   out_idx [b, n_cap, k] int32, out_val [b, n_cap, k] double (zeroed by
//   caller; k >= K of the live entries)
void gdx_scatter_entries(const int32_t* indices, const double* values,
                         const int32_t* nnz, const int32_t* local,
                         const int64_t* ent_of_rec, const int64_t* rec_starts,
                         const int32_t* tier_of_ent,
                         const int64_t* slot_of_ent, int64_t N, int32_t K,
                         int32_t use_value_mask, int32_t t, int64_t n_cap,
                         int64_t k, int32_t* out_idx, double* out_val) {
  parallel_for(N, 4096, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const int64_t e = ent_of_rec[r];
      if (tier_of_ent[e] != t) continue;
      const int64_t base =
          (slot_of_ent[e] * n_cap + (r - rec_starts[e])) * k;
      for (int32_t c = 0; c < K; ++c) {
        const bool ok = nnz ? (c < nnz[r])
                            : (!use_value_mask || values[r * K + c] != 0.0);
        if (!ok) continue;
        out_idx[base + c] = local[r * K + c];
        out_val[base + c] = values[r * K + c];
      }
    }
  });
}

// Per-tier scalar-column gather: out[slot, rec - rec_start] = col[rec] for
// tier-t records (the pad_col loop). `col` may be null → fill 1.0 at live
// cells (the weight fallback).
void gdx_gather_column(const double* col, const int64_t* ent_of_rec,
                       const int64_t* rec_starts, const int32_t* tier_of_ent,
                       const int64_t* slot_of_ent, int64_t N, int32_t t,
                       int64_t n_cap, double* out) {
  parallel_for(N, 8192, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const int64_t e = ent_of_rec[r];
      if (tier_of_ent[e] != t) continue;
      out[slot_of_ent[e] * n_cap + (r - rec_starts[e])] =
          col ? col[r] : 1.0;
    }
  });
}

}  // extern "C"
