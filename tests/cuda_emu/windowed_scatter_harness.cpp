// Runs csrc/windowed_scatter.cu's kernel on the CPU through cuda_runtime.h
// of this directory. The test writes the kernel's source, with its dynamic
// shared memory declaration swapped for g_smem and `<<<…>>>` removed, to
// windowed_scatter_emu.inc beside the inputs.
//
//   harness tile_e window num_windows n_items parts counters grid m calls
//     reads idx.i32 and contrib.f32 [m] and items.i32 [n_items·7] (a
//     plan); runs the kernel `calls` times on one
//     scratch and one set of counters, each time into a table filled with
//     NaN; writes out<i>.f32 [num_windows·window] for each call and
//     counters.i32. The grid's blocks run one after another.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "windowed_scatter_emu.inc"

thread_local EmuDim3 threadIdx, blockIdx;
thread_local float* g_smem;
thread_local EmuBlock* g_block;

template <class T>
static std::vector<T> load(const char* name, size_t count) {
  std::vector<T> v(count);
  FILE* f = std::fopen(name, "rb");
  if (f == nullptr ||
      (count > 0 && std::fread(v.data(), sizeof(T), count, f) != count)) {
    std::fprintf(stderr, "cannot read %s\n", name);
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

int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const int tile_e = std::atoi(argv[1]);
  const int window = std::atoi(argv[2]), num_windows = std::atoi(argv[3]);
  const int n_items = std::atoi(argv[4]), parts = std::atoi(argv[5]);
  const int n_counters = std::atoi(argv[6]), grid = std::atoi(argv[7]);
  const int64_t m = std::atoll(argv[8]);
  const int calls = std::atoi(argv[9]);
  const auto idx = load<int32_t>("idx.i32", m);
  const auto contrib = load<float>("contrib.f32", m);
  const auto items = load<int32_t>("items.i32", (size_t)n_items * kItemInts);
  std::vector<float> scratch((size_t)parts * window + 1, NAN);
  std::vector<int32_t> counters(n_counters, 0);
  const Plan plan{items.data(), scratch.data(), counters.data(), n_items};
  const int blocks = grid < n_items ? grid : n_items;
  for (int c = 0; c < calls; ++c) {
    std::vector<float> out((size_t)num_windows * window, NAN);
    for (int bl = 0; bl < blocks; ++bl) {
      std::vector<float> smem(window + kRingBytes / 4, NAN);
      EmuBlock block;
      block.block.n = kThreads;
      for (int w = 0; w < kThreads / 32; ++w) block.warp[w].n = 32;
      std::vector<std::thread> threads;
      for (int t = 0; t < kThreads; ++t)
        threads.emplace_back([&, t] {
          threadIdx.x = t;
          blockIdx.x = (unsigned)bl;
          gridDim.x = (unsigned)blocks;
          blockDim.x = kThreads;
          g_smem = smem.data();
          g_block = &block;
          windowed_scatter_kernel(idx.data(), contrib.data(), tile_e,
                                  window, plan, out.data());
        });
      for (auto& th : threads) th.join();
    }
    save("out" + std::to_string(c) + ".f32", out);
  }
  save("counters.i32", counters);
  return 0;
}
