// Runs csrc/fe_loss_grad.cu's kernels on the CPU through cuda_runtime.h of
// this directory: the entry scatter (K10/K11) and the fused pass (K5, and
// K12's hybrid instantiation of the same pass of fe_common.cuh), in
// the table form and load path the command line names, so that each form
// is reached whatever the table's size. The test writes fe_loss_grad.cu
// and fe_common.cuh, with their dynamic shared memory declarations swapped
// for g_smem and `<<<…>>>` removed, beside the inputs (fe_loss_grad_emu.inc
// and fe_common.cuh).
//
//   harness scatter f32|f64 form vec d e blocks
//     reads idx.i32 [e] and ce.<type> [e]; writes g.<type> [d]
//   harness fused f32|f64 form vec n k d has_intercept linear blocks
//     reads idx.i32 [n·k], val, y, w, off, theta.<type> ([n·k], [n] ×3,
//     [d + has_intercept]); writes g.<type> [d] and sums.f64 [2]
//   harness hot f32|f64 1 vec n k a s linear blocks
//     K12's pass (fe_hybrid.cu's kernel) on compact ids in [0, a], a the
//     dump slot, the ids below s in the block's table: reads idx.i32,
//     val, y, w, off, theta.<type> ([a]) and b.<type> ([1]); writes
//     g.<type> [a], r.<type> [n] and sums.f64 [2]
//   form: 0 device memory (behind the cache), 1 block-private; vec: 1 the
//   vector path, 0 the lane-group path of the kernel's with_shape; blocks:
//   the grid, run one block after another.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "fe_loss_grad_emu.inc"

thread_local EmuDim3 threadIdx, blockIdx;
thread_local float* g_smem;
thread_local EmuBlock* g_block;

template <class T>
static std::vector<T> load(const std::string& name, size_t count) {
  std::vector<T> v(count);
  FILE* f = std::fopen(name.c_str(), "rb");
  if (f == nullptr ||
      (count > 0 && std::fread(v.data(), sizeof(T), count, f) != count)) {
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

// Runs body() as every thread of `blocks` blocks of gdx_fe::kThreads, one
// block at a time, each with `smem_bytes` of dynamic shared memory filled
// with 0xff (a NaN in every float, −1 in every int) so that a read of
// memory never written shows.
template <class Body>
static void run(int blocks, size_t smem_bytes, Body body) {
  for (int bl = 0; bl < blocks; ++bl) {
    std::vector<float> smem(smem_bytes / 4 + 4);
    std::memset(smem.data(), 0xff, smem.size() * 4);
    EmuBlock block;
    block.block.n = gdx_fe::kThreads;
    for (int w = 0; w < gdx_fe::kThreads / 32; ++w) block.warp[w].n = 32;
    std::vector<std::thread> threads;
    for (int t = 0; t < gdx_fe::kThreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)bl;
        gridDim.x = (unsigned)blocks;
        blockDim.x = gdx_fe::kThreads;
        g_smem = smem.data();
        g_block = &block;
        body();
      });
    for (auto& th : threads) th.join();
  }
}

template <class T, bool kVec, int kForm>
static void scatter(int d, int64_t e, int blocks, const std::string& ty) {
  const auto idx = load<int32_t>("idx.i32", e);
  const auto ce = load<T>("ce." + ty, e);
  std::vector<T> g(d, T(0));
  run(blocks,
      gdx_fe::GradTable<T, kForm, false>::smem_bytes(
          kForm == gdx_fe::kBlock ? d : 0),
      [&] {
        scatter_entries_kernel<T, kVec, kForm>(idx.data(), ce.data(), e, d,
                                               g.data());
      });
  save("g." + ty, g);
}

// The pass (K5, or K12 with kHybrid) in the shape the kernel's own
// with_shape takes for k and vec.
template <class T, bool kHybrid, int kForm>
static void pass(const gdx_fe::Pass<T>& p, int vec, int blocks) {
  const int err = gdx_fe::with_shape(p.k, vec, [&](auto shape) -> int {
    run(blocks, gdx_fe::GradTable<T, kForm, kHybrid>::smem_bytes(p.s), [&] {
      gdx_fe::fe_pass<T, decltype(shape), kHybrid, kForm>(p);
    });
    return 0;
  });
  if (err != 0) std::exit(3);
}

template <class T, int kForm>
static void fused(int vec, int64_t n, int k, int d, int has_b, int linear,
                  int blocks, const std::string& ty) {
  const auto idx = load<int32_t>("idx.i32", n * k);
  const auto val = load<T>("val." + ty, n * k);
  const auto y = load<T>("y." + ty, n), w = load<T>("w." + ty, n),
             off = load<T>("off." + ty, n);
  const auto theta = load<T>("theta." + ty, d + has_b);
  std::vector<T> g(d, T(0));
  std::vector<double> sums(2, 0.0);
  const int s = kForm == gdx_fe::kBlock ? d : 0;
  const gdx_fe::Pass<T> p{idx.data(), val.data(), y.data(), w.data(),
                          off.data(), theta.data(),
                          has_b ? theta.data() + d : nullptr, n, k, d, s,
                          linear, g.data(), nullptr, sums.data()};
  pass<T, false, kForm>(p, vec, blocks);
  save("g." + ty, g);
  save("sums.f64", sums);
}

// K12's pass: compact ids in [0, a] (a the dump slot), the ids below s in
// the block's table, the rest in device memory; b from b.<type>.
template <class T>
static void hot(int vec, int64_t n, int k, int a, int s, int linear,
                int blocks, const std::string& ty) {
  const auto idx = load<int32_t>("idx.i32", n * k);
  const auto val = load<T>("val." + ty, n * k);
  const auto y = load<T>("y." + ty, n), w = load<T>("w." + ty, n),
             off = load<T>("off." + ty, n);
  const auto theta = load<T>("theta." + ty, a), b = load<T>("b." + ty, 1);
  std::vector<T> g(a, T(0)), r(n, T(0));
  std::vector<double> sums(2, 0.0);
  const gdx_fe::Pass<T> p{idx.data(), val.data(), y.data(), w.data(),
                          off.data(), theta.data(), b.data(), n, k, a, s,
                          linear, g.data(), r.data(), sums.data()};
  pass<T, true, gdx_fe::kBlock>(p, vec, blocks);
  save("g." + ty, g);
  save("r." + ty, r);
  save("sums.f64", sums);
}

template <class T, bool kVec, int kForm>
static int dispatch(int argc, char** argv, const std::string& ty) {
  const std::string what = argv[1];
  if (what == "scatter" && argc == 8) {
    scatter<T, kVec, kForm>(std::atoi(argv[5]), std::atoll(argv[6]),
                            std::atoi(argv[7]), ty);
    return 0;
  }
  if (what == "fused" && argc == 11) {
    fused<T, kForm>(kVec, std::atoll(argv[5]), std::atoi(argv[6]),
                    std::atoi(argv[7]), std::atoi(argv[8]),
                    std::atoi(argv[9]), std::atoi(argv[10]), ty);
    return 0;
  }
  if (what == "hot" && argc == 11 && kForm == gdx_fe::kBlock) {
    hot<T>(kVec, std::atoll(argv[5]), std::atoi(argv[6]), std::atoi(argv[7]),
           std::atoi(argv[8]), std::atoi(argv[9]), std::atoi(argv[10]), ty);
    return 0;
  }
  return 2;
}

template <class T>
static int by_form(int argc, char** argv, const std::string& ty) {
  const int form = std::atoi(argv[3]), vec = std::atoi(argv[4]);
  if (form == gdx_fe::kBlock)
    return vec ? dispatch<T, true, gdx_fe::kBlock>(argc, argv, ty)
               : dispatch<T, false, gdx_fe::kBlock>(argc, argv, ty);
  return vec ? dispatch<T, true, gdx_fe::kDevice>(argc, argv, ty)
             : dispatch<T, false, gdx_fe::kDevice>(argc, argv, ty);
}

int main(int argc, char** argv) {
  if (argc < 5) return 2;
  const std::string ty = argv[2];
  return ty == "f64" ? by_form<double>(argc, argv, ty)
                     : by_form<float>(argc, argv, ty);
}
