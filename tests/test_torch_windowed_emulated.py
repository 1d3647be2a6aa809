"""The CUDA source of the windowed scatter (K13, csrc/windowed_scatter.cu)
run on the CPU: built with g++ against the stub CUDA runtime of
tests/cuda_emu (one std::thread per CUDA thread,
tests/cuda_emu/windowed_scatter_harness.cpp) and held to the plain version
on a plan (ops/windowed_scatter.py windowed_plan) with every kind of window:
split over several items, owned, collecting the cold arrays' padding,
holding only value-0 entries, and reached by no entry. The kernel writes
into a table filled with NaN (as torch.empty may hand it over), twice in a
row on one plan: every window must be written, the slots no entry reaches
exactly 0, the two results equal bit for bit (a stream sorted within each
window sums in one order) and the counters back at 0. No nvcc and no card:
the kernel itself runs on the card only in chip_smoke.py."""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gdmix_tpu_torch.ops import logistic as tl
from gdmix_tpu_torch.ops import windowed_scatter as ws

_EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cuda_emu")
_SRC = os.path.join(os.path.dirname(_EMU_DIR), "..", "gdmix_tpu_torch",
                    "csrc", "windowed_scatter.cu")
_DECL = "extern __shared__ __align__(16) float smem[];"
W, TILE_ROWS = 256, 2          # small windows and tiles of 32 entries
# float32 sums of at most a few hundred entries a slot, against the plain
# version's index_add_ in another order
RTOL = 1e-6


@pytest.fixture(scope="module")
def ws_emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's CPU emulation needs it")
    out = tmp_path_factory.mktemp("ws_emu")
    with open(_SRC) as f:
        src = f.read()
    assert _DECL in src
    with open(out / "windowed_scatter_emu.inc", "w") as f:
        f.write(re.sub(r"<<<[^>]*>>>", "",
                       src.replace(_DECL, "float* smem = g_smem;")))
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-I", _EMU_DIR,
                    "-I", str(out),
                    os.path.join(_EMU_DIR, "windowed_scatter_harness.cpp"),
                    "-o", str(out / "harness")],
                   check=True, capture_output=True, timeout=300)
    return out


def _layout(seed, shuffle=False):
    """A layout of 7 windows: 0 a few entries and the cold padding, 1 many
    (split), 2 few (owned), 3 none, 4 only value-0 entries, 5 many again,
    6 one entry. shuffle: each tile's entries in random order (no longer
    sorted within a window)."""
    rng = np.random.RandomState(seed)
    nw = 7
    parts = [rng.randint(1, W, 20), W + rng.randint(0, W, 700),
             2 * W + rng.randint(0, W, 40), 4 * W + rng.randint(0, W, 90),
             5 * W + rng.randint(0, W, 300), [6 * W + 3]]
    key = np.concatenate(parts + [np.zeros(150, int)]).astype(np.int32)
    val = rng.randn(key.shape[0]).astype(np.float32)
    val[-150:] = 0.0
    val[(key >= 4 * W) & (key < 5 * W)] = 0.0
    t = torch.as_tensor
    idxl, _, _, v, win = tl._windowed_layout(t(key), t(key), t(key), t(val),
                                             nw * W, W, TILE_ROWS)
    contrib = v * t(rng.randn(*v.shape).astype(np.float32))
    if shuffle:
        te = TILE_ROWS * 16
        perm = np.concatenate([i * te + rng.permutation(te)
                               for i in range(win.shape[0])])
        idxl, contrib, v = (a.reshape(-1)[perm].reshape(a.shape)
                            for a in (idxl, contrib, v))
    return idxl, contrib, v, win, nw


def _emulate(emu, idxl, contrib, plan, nw, grid, calls=2):
    idxl.numpy().tofile(emu / "idx.i32")
    contrib.numpy().tofile(emu / "contrib.f32")
    plan.items.numpy().tofile(emu / "items.i32")
    args = (TILE_ROWS * 16, W, nw, plan.items.shape[0],
            plan.scratch.shape[0], plan.counters.shape[0], grid,
            idxl.numel(), calls)
    subprocess.run([str(emu / "harness")] + [str(a) for a in args], cwd=emu,
                   check=True, capture_output=True, timeout=300)
    return ([np.fromfile(emu / f"out{c}.f32", np.float32)
             for c in range(calls)],
            np.fromfile(emu / "counters.i32", np.int32))


# (plan blocks, grid, shuffled): the plan's blocks set T, so the split
# windows' parts; a grid below the items walks the queue
CASES = [(4, 2, False), (12, 3, False), (40, 5, False), (12, 3, True)]


@pytest.mark.parametrize("blocks,grid,shuffle", CASES)
def test_kernel_source_emulated_matches_plain(ws_emulator, blocks, grid,
                                              shuffle):
    idxl, contrib, v, win, nw = _layout(seed=blocks, shuffle=shuffle)
    plan = ws.windowed_plan(win, v, nw, W, blocks=blocks)
    items = plan.items.numpy()
    assert (items[:, 3] >= 0).any() and (items[:, 3] < 0).any()
    assert (items[:, 1] == items[:, 0]).sum() >= 2    # windows 3 and 4
    (got, again), counters = _emulate(ws_emulator, idxl, contrib, plan, nw,
                                      grid)
    want = ws.windowed_scatter_add_plain(idxl, contrib, win, nw, W,
                                         TILE_ROWS).numpy()
    assert np.isfinite(got).all() and np.isfinite(again).all()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    reached = np.zeros(nw * W, bool)
    live = v.reshape(-1).numpy() != 0
    target = (win.long().repeat_interleave(TILE_ROWS * 16) * W
              + idxl.reshape(-1).long()).numpy()
    reached[target[live]] = True
    assert (got[~reached] == 0).all()
    assert (counters == 0).all()
    if shuffle:   # the atomics sum right, in no fixed order
        assert np.abs(again - want).max() <= RTOL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, again)
