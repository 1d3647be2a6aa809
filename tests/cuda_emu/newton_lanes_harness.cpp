// Runs csrc/newton_lanes.cu's kernel on the CPU through cuda_runtime.h of
// this directory. The test writes the kernel's source, with its dynamic
// shared memory declaration swapped for g_smem and `<<<…>>>` removed, to
// newton_lanes_emu.inc beside the inputs.
//
//   harness layout n d                        → group floats of forms 0 1 2
//   harness solve form B n d lam unreg maxiter ftol pgtol [lanes]
//     form 0 newton_full, 1 newton_block, 2 newton_block streamed. Reads
//     X y w off cnt th0 (.f32, in the working directory), writes th.f32,
//     conv.u8, iters.i32. With `lanes`, also reads lanes.i32 [B] and
//     nlanes.i32 [1] (a lane list and how many of its entities to solve:
//     two-phase Newton's phase 2) and fills the outputs with kUntouched*
//     first, so that an entity the kernel must not write shows those bits.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "newton_lanes_emu.inc"

thread_local EmuDim3 threadIdx, blockIdx;
thread_local float* g_smem;
thread_local EmuBlock* g_block;

constexpr uint32_t kUntouchedTheta = 0x7fc0deadu;  // a NaN with a payload
constexpr uint8_t kUntouchedConv = 0xab;
constexpr int32_t kUntouchedIters = -12345;

template <class T = float>
static std::vector<T> load(const char* name, size_t count) {
  std::vector<T> v(count);
  FILE* f = std::fopen(name, "rb");
  if (f == nullptr || std::fread(v.data(), 4, count, f) != count) {
    std::fprintf(stderr, "cannot read %s\n", name);
    std::exit(2);
  }
  std::fclose(f);
  return v;
}

template <class T>
static void save(const char* name, const std::vector<T>& v) {
  FILE* f = std::fopen(name, "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

int main(int argc, char** argv) {
  if (argc == 4 && !std::strcmp(argv[1], "layout")) {
    const int n = std::atoi(argv[2]), d = std::atoi(argv[3]);
    std::printf("%d %d %d\n", gdx_newton_group_floats(0, n, d),
                gdx_newton_group_floats(1, n, d),
                gdx_newton_group_floats(2, n, d));
    return 0;
  }
  const bool lanes = argc == 12 && !std::strcmp(argv[11], "lanes");
  if ((argc != 11 && !lanes) || std::strcmp(argv[1], "solve")) return 2;
  const int form = std::atoi(argv[2]);
  const int64_t B = std::atoll(argv[3]);
  const int n = std::atoi(argv[4]), d = std::atoi(argv[5]);
  const float lam = std::atof(argv[6]);
  const int unreg = std::atoi(argv[7]), maxiter = std::atoi(argv[8]);
  const float ftol = std::atof(argv[9]), pgtol = std::atof(argv[10]);
  const auto X = load("X.f32", B * n * d), Y = load("y.f32", B * n),
             W = load("w.f32", B * n), OFF = load("off.f32", B * n),
             CNT = load("cnt.f32", B), TH0 = load("th0.f32", B * d);
  std::vector<float> TH(B * d), ZS(B * n), US(B * n);
  std::vector<uint8_t> CONV(B);
  std::vector<int32_t> ITERS(B), LANES, NLANES;
  if (lanes) {
    LANES = load<int32_t>("lanes.i32", B);
    NLANES = load<int32_t>("nlanes.i32", 1);
    float untouched;
    std::memcpy(&untouched, &kUntouchedTheta, 4);
    std::fill(TH.begin(), TH.end(), untouched);
    std::fill(CONV.begin(), CONV.end(), kUntouchedConv);
    std::fill(ITERS.begin(), ITERS.end(), kUntouchedIters);
  }
  const int warps = form == 0 ? 1 : kBlockWarps;
  const Layout L = make_layout(n, d, warps, form == 2);
  const KernelFn fn = form == 0   ? pick<1, false>(L.T)
                      : form == 1 ? pick<kBlockWarps, false>(L.T)
                                  : pick<kBlockWarps, true>(L.T);
  const int groups = kThreads / 32 / warps;
  const int64_t blocks = (B + groups - 1) / groups;
  for (int64_t bl = 0; bl < blocks; ++bl) {
    // NaN-filled, so that a read of shared memory never written shows
    std::vector<float> smem((size_t)groups * L.total, NAN);
    EmuBlock block;
    block.block.n = kThreads;
    for (int w = 0; w < kThreads / 32; ++w) block.warp[w].n = 32;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)bl;
        g_smem = smem.data();
        g_block = &block;
        fn(X.data(), Y.data(), W.data(), OFF.data(), CNT.data(), TH0.data(),
           TH.data(), CONV.data(), ITERS.data(), ZS.data(), US.data(),
           lanes ? LANES.data() : nullptr, lanes ? NLANES.data() : nullptr, B,
           n, d, lam, unreg, maxiter, ftol, pgtol);
      });
    for (auto& th : threads) th.join();
  }
  save("th.f32", TH);
  save("conv.u8", CONV);
  save("iters.i32", ITERS);
  return 0;
}
