// Runs csrc/re_pack.cu's kernels on the CPU through cuda_runtime.h of this
// directory. The test writes the source, `<<<…>>>` removed, to
// re_pack_emu.inc beside the inputs.
//
//   harness E N K T n_block ws_size flags
//     flags: bit 0 nnz.i32 [N] given, 1 labels, 2 offsets, 3 weights (the
//     record columns, .f32), bit 4 float64 columns (.f64 in place of .f32).
//     Reads indices.i32 [N·K], values [N·K], counts.i32 [E], starts.i64
//     [E], tier_of.i32 [E], block_ents.i32 / ws_off.i64 [n_block] (pass
//     1's block path), order.i32 [E] and coff.i64 [E] (each slot's first
//     compact id, tier after tier), tiers.i64 [T·5] (base, b_real, b,
//     n_cap, k of each tier). Runs pass 1 (the warp kernel over every
//     entity, then the block kernel over the block path), then pass 2 over
//     each tier into outputs filled first with a marker, so that a value
//     the kernel failed to write shows. Writes uniq.i32, u_count.i32,
//     max_nnz.i32, tier_max.i32 [T·2], and per tier t idx<t>.i64 and
//     val<t>, lab<t>, off<t>, wt<t>, cnt<t> (.f32 or .f64), then sup.i32
//     (the compact ids). The blocks of a grid run one after another.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "re_pack_emu.inc"

thread_local EmuDim3 threadIdx, blockIdx;
thread_local float* g_smem;
thread_local EmuBlock* g_block;

// `count` values of type T from `name`; none (and no file) for 0.
template <class T>
static std::vector<T> load(const std::string& name, size_t count) {
  std::vector<T> v(count);
  if (count == 0) return v;
  FILE* f = std::fopen(name.c_str(), "rb");
  if (f == nullptr || std::fread(v.data(), sizeof(T), count, f) != count) {
    std::fprintf(stderr, "cannot read %s\n", name.c_str());
    std::exit(2);
  }
  std::fclose(f);
  return v;
}

template <class T>
static void save(const std::string& name, const std::vector<T>& v) {
  FILE* f = std::fopen(name.c_str(), "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

// The grid's blocks one after another, `threads` std::threads a block.
template <class Fn>
static void run_grid(int64_t blocks, int threads, Fn&& body) {
  for (int64_t bl = 0; bl < blocks; ++bl) {
    EmuBlock block;
    block.block.n = threads;
    for (int w = 0; w < threads / 32; ++w) block.warp[w].n = 32;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)bl;
        gridDim.x = (unsigned)blocks;
        blockDim.x = threads;
        g_block = &block;
        body();
      });
    for (auto& th : pool) th.join();
  }
}

template <class T>
static int run(int64_t E, int64_t N, int K, int T_, int64_t n_block,
               int64_t ws_size, int flags, const char* ext) {
  const auto indices = load<int32_t>("indices.i32", N * K);
  const auto values = load<T>(std::string("values") + ext, N * K);
  const auto nnz = load<int32_t>("nnz.i32", flags & 1 ? N : 0);
  const auto labels = load<T>(std::string("labels") + ext, flags & 2 ? N : 0);
  const auto offsets = load<T>(std::string("offsets") + ext, flags & 4 ? N : 0);
  const auto weights = load<T>(std::string("weights") + ext, flags & 8 ? N : 0);
  const auto counts = load<int32_t>("counts.i32", E);
  const auto starts = load<int64_t>("starts.i64", E);
  const auto tier_of = load<int32_t>("tier_of.i32", E);
  const auto block_ents = load<int32_t>("block_ents.i32", n_block);
  const auto ws_off = load<int64_t>("ws_off.i64", n_block);
  const auto order = load<int32_t>("order.i32", E);
  const auto coff = load<int64_t>("coff.i64", E);
  const auto tiers = load<int64_t>("tiers.i64", (size_t)T_ * 5);
  std::vector<int32_t> uniq(N * K > 0 ? N * K : 1, -7), u_count(E, -7),
      max_nnz(E, -7), tier_max((size_t)T_ * 2, 0),
      ws(ws_size > 0 ? ws_size : 1, -7);
  const SupportsArgs a{indices.data(), flags & 1 ? nnz.data() : nullptr,
                       counts.data(),  starts.data(), tier_of.data(), E, K,
                       uniq.data(),    u_count.data(), max_nnz.data(),
                       tier_max.data()};
  run_grid((E + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32,
           [&] { re_supports_warp_kernel(a); });
  run_grid(n_block, kBlockThreads, [&] {
    re_supports_block_kernel(a, block_ents.data(), ws_off.data(), ws.data());
  });
  save("uniq.i32", uniq);
  save("u_count.i32", u_count);
  save("max_nnz.i32", max_nnz);
  save("tier_max.i32", tier_max);
  int64_t n_sup = 0;
  for (int64_t e = 0; e < E; ++e) n_sup += u_count[e] > 0 ? u_count[e] : 1;
  std::vector<int32_t> sup(E + n_sup, -7);
  for (int t = 0; t < T_; ++t) {
    const int64_t base = tiers[5 * t], b_real = tiers[5 * t + 1],
                  b = tiers[5 * t + 2], n_cap = tiers[5 * t + 3];
    const int k = (int)tiers[5 * t + 4];
    std::vector<int64_t> idx(b * n_cap * k, -7);
    std::vector<T> val(b * n_cap * k, T(-7)), lab(b * n_cap, T(-7)),
        off(b * n_cap, T(-7)), wt(b * n_cap, T(-7)), cnt(b, T(-7));
    const PackArgs<T> p{indices.data(), values.data(),
                        flags & 1 ? nnz.data() : nullptr,
                        flags & 2 ? labels.data() : nullptr,
                        flags & 4 ? offsets.data() : nullptr,
                        flags & 8 ? weights.data() : nullptr,
                        counts.data(), starts.data(), uniq.data(),
                        u_count.data(), order.data() + base,
                        coff.data() + base, b_real, b, n_cap, k, K,
                        idx.data(), val.data(), lab.data(), off.data(),
                        wt.data(), cnt.data(), sup.data()};
    run_grid((b * n_cap + kBlockThreads - 1) / kBlockThreads, kBlockThreads,
             [&] { re_pack_tier_kernel<T>(p); });
    const std::string s = std::to_string(t);
    save("idx" + s + ".i64", idx);
    save("val" + s + ext, val);
    save("lab" + s + ext, lab);
    save("off" + s + ext, off);
    save("wt" + s + ext, wt);
    save("cnt" + s + ext, cnt);
  }
  save("sup.i32", sup);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const int64_t E = std::atoll(argv[1]), N = std::atoll(argv[2]);
  const int K = std::atoi(argv[3]), T_ = std::atoi(argv[4]);
  const int64_t n_block = std::atoll(argv[5]), ws_size = std::atoll(argv[6]);
  const int flags = std::atoi(argv[7]);
  return flags & 16 ? run<double>(E, N, K, T_, n_block, ws_size, flags, ".f64")
                    : run<float>(E, N, K, T_, n_block, ws_size, flags, ".f32");
}
