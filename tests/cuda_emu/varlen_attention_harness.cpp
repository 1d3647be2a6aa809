// Runs csrc/varlen_attention.cu's kernels on the CPU through cuda_runtime.h
// of this directory. The test writes the source, its shared-memory
// declarations swapped for g_smem and `<<<…>>>` removed, to
// varlen_attention_emu.inc beside the inputs.
//
//   harness B H T longest window
//     Reads q.f32, k.f32, v.f32, dout.f32 [T·H·64] and offsets.i32 [B + 1].
//     Runs the forward kernel into o and lse, then the backward's three
//     kernels (D, dK/dV, dQ) twice, every output filled first with a
//     marker (-7777), so that a value a kernel failed to write shows.
//     Writes o.f32, lse.f32, delta.f32, and dq, dk, dv of each backward
//     (dq1.f32 … dv2.f32). The blocks of a grid run one after another.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

#include "varlen_attention_emu.inc"

thread_local EmuDim3 threadIdx, blockIdx;
thread_local float* g_smem;
thread_local EmuBlock* g_block;

template <class T>
static std::vector<T> load(const std::string& name, size_t count) {
  std::vector<T> v(count);
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

// The grid's blocks one after another, `threads` std::threads a block,
// each block with `smem_bytes` of its own dynamic shared memory.
template <class Fn>
static void run_grid(dim3 grid, int threads, size_t smem_bytes, Fn&& body) {
  std::vector<float> smem(smem_bytes / sizeof(float) + 1);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        EmuBlock block;
        block.block.n = threads;
        for (int w = 0; w < (threads + 31) / 32; ++w) block.warp[w].n = 32;
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx.x = bx;
            blockIdx.y = by;
            blockIdx.z = bz;
            gridDim.x = grid.x;
            gridDim.y = grid.y;
            gridDim.z = grid.z;
            blockDim.x = threads;
            g_smem = smem.data();
            g_block = &block;
            body();
          });
        for (auto& th : pool) th.join();
      }
}

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const int B = std::atoi(argv[1]), H = std::atoi(argv[2]);
  const int64_t T = std::atoll(argv[3]);
  const int longest = std::atoi(argv[4]), window = std::atoi(argv[5]);
  const size_t n = (size_t)T * H * kD;
  const auto q = load<float>("q.f32", n), k = load<float>("k.f32", n),
             v = load<float>("v.f32", n), dout = load<float>("dout.f32", n);
  const auto offsets = load<int32_t>("offsets.i32", B + 1);
  std::vector<float> o(n, -7777.f), lse((size_t)T * H, -7777.f);
  const dim3 grid((longest + kTile - 1) / kTile, B, H);
  const Args fa{q.data(), k.data(), v.data(), nullptr, nullptr, nullptr,
                nullptr, offsets.data(), H, window, o.data(), lse.data()};
  run_grid(grid, kThreads, kForwardSmem, [&] { attn_forward_kernel(fa); });
  save("o.f32", o);
  save("lse.f32", lse);
  for (int rep = 1; rep <= 2; ++rep) {
    std::vector<float> delta((size_t)T * H, -7777.f), dq(n, -7777.f),
        dk(n, -7777.f), dv(n, -7777.f);
    const int64_t rows = T * H;
    run_grid(dim3((unsigned)((rows + 15) / 16)), 256, 0, [&] {
      attn_delta_kernel(o.data(), dout.data(), delta.data(), rows);
    });
    const Args kv{q.data(), k.data(), v.data(), o.data(), lse.data(),
                  dout.data(), delta.data(), offsets.data(), H, window,
                  dk.data(), dv.data()};
    run_grid(grid, kThreads, kBackwardSmem, [&] { attn_dkdv_kernel(kv); });
    const Args qa{q.data(), k.data(), v.data(), o.data(), lse.data(),
                  dout.data(), delta.data(), offsets.data(), H, window,
                  dq.data(), nullptr};
    run_grid(grid, kThreads, kBackwardSmem, [&] { attn_dq_kernel(qa); });
    const std::string s = std::to_string(rep);
    save("delta.f32", delta);
    save("dq" + s + ".f32", dq);
    save("dk" + s + ".f32", dk);
    save("dv" + s + ".f32", dv);
  }
  return 0;
}
