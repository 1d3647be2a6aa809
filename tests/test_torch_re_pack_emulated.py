"""The CUDA source of the random-effect marshal (csrc/re_pack.cu) run on the
CPU: built with g++ against the stub CUDA runtime of tests/cuda_emu (one
std::thread per CUDA thread, tests/cuda_emu/re_pack_harness.cpp) and held
to the plain versions of ops/re_pack.py on the same plan and columns
(ops/re_pack.py FlatPack on the CPU): pass 1's distinct ids, counts, nnz
and tier maxima equal, then every tier's tensors and the compact supports
equal bit for bit, each output filled with a marker first so that a value
the kernel failed to write shows. The cases reach pass 1's warp path (an
entity's count·K up to 256), its block path in shared memory (up to
4,096) and in the device-memory workspace (past that), with and without
an nnz column, in float32 and float64. No nvcc and no card: the kernels
themselves run on the card only in chip_smoke.py."""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gdmix_tpu_torch.ops import re_pack
from test_torch_re_pack import fleet

_EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cuda_emu")
_SRC = os.path.join(os.path.dirname(_EMU_DIR), "..", "gdmix_tpu_torch",
                    "csrc", "re_pack.cu")


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's CPU emulation needs it")
    out = tmp_path_factory.mktemp("re_pack_emu")
    with open(_SRC) as f:
        src = f.read()
    with open(out / "re_pack_emu.inc", "w") as f:
        f.write(re.sub(r"<<<[^>]*>>>", "", src))
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-I", _EMU_DIR,
                    "-I", str(out),
                    os.path.join(_EMU_DIR, "re_pack_harness.cpp"),
                    "-o", str(out / "harness")],
                   check=True, capture_output=True, timeout=300)
    return out


# (counts, K, nnz column, float64): the warp path alone; entities of 65–1,024
# records at K 4 (the block path in shared memory); one of 1,100 records
# (4,400 keys: the workspace)
CASES = {
    "warp": ([5, 3, 0] + list(range(1, 40)), 4, True, False),
    "warp_all_live_f64": (list(range(1, 30)), 3, False, True),
    "block_shared": ([2, 70, 9, 300, 1, 64, 65], 4, True, False),
    "block_workspace": ([4, 1100, 3, 100, 20], 4, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_emulated_matches_plain(emulator, case):
    counts, K, nnz, f64 = CASES[case]
    fg = fleet(11, counts, K=K, nnz=nnz, weights=True)
    dtype = torch.float64 if f64 else torch.float32
    pack = re_pack.FlatPack(fg, label_column="response",
                            weight_column="weight", offset_column="offset",
                            device="cpu", dtype=dtype)
    pack.upload()
    pack.supports()
    want = [pack.tier(i) for i in range(len(pack.tiers))]
    d, cols, sup = pack._dev, pack.cols, pack.sup
    n_block = d["block_ents"].shape[0]
    if case.startswith("block"):
        assert n_block > 0
    if case == "block_workspace":
        assert (d["ws_off"] >= 0).any() and (d["ws_off"] < 0).any()
    ext = ".f64" if f64 else ".f32"
    files = {"indices.i32": cols.indices, "values" + ext: cols.values,
             "labels" + ext: cols.labels, "offsets" + ext: cols.offsets,
             "weights" + ext: cols.weights, "counts.i32": cols.counts,
             "starts.i64": cols.starts, "tier_of.i32": d["tier_of"],
             "block_ents.i32": d["block_ents"], "ws_off.i64": d["ws_off"],
             "order.i32": d["order"], "coff.i64": pack._coff,
             "tiers.i64": torch.tensor(
                 [[t.base, len(t.members), t.b, t.n_cap, pack.k[i]]
                  for i, t in enumerate(pack.tiers)], dtype=torch.int64)}
    if nnz:
        files["nnz.i32"] = cols.nnz
    for name, t in files.items():
        t.contiguous().numpy().tofile(emulator / name)
    E, N = len(counts), int(sum(counts))
    flags = (1 if nnz else 0) | 2 | 4 | 8 | (16 if f64 else 0)
    subprocess.run([str(emulator / "harness"), str(E), str(N), str(K),
                    str(len(pack.tiers)), str(n_block), str(pack._ws_size),
                    str(flags)], cwd=emulator, check=True,
                   capture_output=True, timeout=600)
    read = lambda name, dt: np.fromfile(emulator / name, dt)  # noqa: E731
    u_count = read("u_count.i32", np.int32)
    np.testing.assert_array_equal(u_count, sup.u_count.numpy())
    np.testing.assert_array_equal(read("max_nnz.i32", np.int32),
                                  sup.max_nnz.numpy())
    np.testing.assert_array_equal(read("tier_max.i32", np.int32),
                                  sup.tier_max.numpy().reshape(-1))
    uniq, want_uniq = read("uniq.i32", np.int32), sup.uniq.numpy()
    for e, s in enumerate(cols.starts.numpy()):
        a = s * K
        np.testing.assert_array_equal(uniq[a:a + u_count[e]],
                                      want_uniq[a:a + u_count[e]])
    fdt = np.float64 if f64 else np.float32
    for i, w in enumerate(want):
        got = {"indices": read(f"idx{i}.i64", np.int64),
               "values": read(f"val{i}{ext}", fdt),
               "labels": read(f"lab{i}{ext}", fdt),
               "offsets": read(f"off{i}{ext}", fdt),
               "weights": read(f"wt{i}{ext}", fdt),
               "sample_count": read(f"cnt{i}{ext}", fdt)}
        for k, v in got.items():
            np.testing.assert_array_equal(v, w[k].numpy().reshape(-1), k)
    np.testing.assert_array_equal(read("sup.i32", np.int32)[E:],
                                  pack.support_ids.numpy()[E:])
