"""The CUDA source of the fixed-effect kernels run on the CPU: csrc/
fe_loss_grad.cu with csrc/fe_common.cuh, built with g++ against the stub
CUDA runtime of tests/cuda_emu (one std::thread per CUDA thread,
tests/cuda_emu/fe_loss_grad_harness.cpp), and held to the plain versions
at small sizes. The flat entry scatter (K10/K11) and the fused pass (K5)
share the pass's gradient table; each runs in the table form the harness
names (block-private or device memory behind the cache), not the one the
table's size would choose, over a grid of several blocks, each with its own
strips, cache and flush. No nvcc and no card: the forms themselves run on
the card only in chip_smoke.py."""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gdmix_tpu_torch.ops import fe_hybrid as fh
from gdmix_tpu_torch.ops import fe_loss_grad as fe

_EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cuda_emu")
_CSRC = os.path.join(os.path.dirname(_EMU_DIR), "..", "gdmix_tpu_torch",
                     "csrc")
_DECL = "extern __shared__ __align__(16) unsigned char smem_raw[];"
_REPL = "unsigned char* smem_raw = reinterpret_cast<unsigned char*>(g_smem);"
FORMS = {"device": fe.FORM_DEVICE, "block": fe.FORM_BLOCK}
# float32 sums of a few thousand additions in another order than the
# float64 reference's; float64 alike
F32_RTOL, F64_RTOL = 1e-5, 1e-12


@pytest.fixture(scope="module")
def fe_emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernels' CPU emulation needs it")
    out = tmp_path_factory.mktemp("fe_emu")
    for name, dest in (("fe_common.cuh", "fe_common.cuh"),
                       ("fe_loss_grad.cu", "fe_loss_grad_emu.inc")):
        with open(os.path.join(_CSRC, name)) as f:
            src = f.read()
        assert _DECL in src, name
        with open(out / dest, "w") as f:
            f.write(re.sub(r"<<<[^>]*>>>", "", src.replace(_DECL, _REPL)))
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-I", _EMU_DIR,
                    "-I", str(out),
                    os.path.join(_EMU_DIR, "fe_loss_grad_harness.cpp"),
                    "-o", str(out / "harness")],
                   check=True, capture_output=True, timeout=300)
    return out


def _run(emu, *args):
    subprocess.run([str(emu / "harness")] + [str(a) for a in args], cwd=emu,
                   check=True, capture_output=True, timeout=300)


def _entries(case, e, d, dtype, seed):
    """ids and contributions of one case; ~25% of the contributions are 0
    and their ids lie outside [0, d) in the `inert` case."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, e)
    if case == "hot":                  # one id takes most entries
        idx[rng.rand(e) < 0.8] = 7
    ce = rng.randn(e).astype(dtype)
    ce[rng.rand(e) < 0.25] = 0.0
    if case == "inert":
        idx = np.where(ce == 0, rng.choice([-7, d, 10 ** 6], e), idx)
    return idx.astype(np.int32), ce


# (case, E, vec): E % 4 != 0 with vec takes the scalar tail
K10_CASES = [("uniform", 6000, 1), ("hot", 6000, 1), ("ragged", 6003, 1),
             ("inert", 6000, 1)]


@pytest.mark.parametrize("case,e,vec", K10_CASES + [("uniform", 3001, 0),
                                                    ("hot", 3001, 0)])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scatter_source_emulated_matches_plain(fe_emulator, dtype, form,
                                               case, e, vec):
    """K10/K11's kernel against fe_scatter_entries_plain in float64 on
    the same contributions (inert ids taken to 0 for the plain version)."""
    d = 300
    ty = "f64" if dtype == np.float64 else "f32"
    idx, ce = _entries(case, e, d, dtype, seed=e + vec + len(case))
    idx.tofile(fe_emulator / "idx.i32")
    ce.tofile(fe_emulator / f"ce.{ty}")
    _run(fe_emulator, "scatter", ty, FORMS[form], vec, d, e, 3)
    got = np.fromfile(fe_emulator / f"g.{ty}", dtype)
    want = fe.fe_scatter_entries_plain(
        torch.as_tensor(np.where(ce == 0, 0, idx)),
        torch.as_tensor(ce.astype(np.float64)), d).numpy()
    tol = F64_RTOL if dtype == np.float64 else F32_RTOL
    assert got.shape == (d,)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# (n, k, vec, has_intercept, linear); vec 0 takes the lane-group path:
# G = 4 lanes a record up to K = 16, 8 up to 64, past that chunks of 32 × 8
K5_CASES = [(700, 8, 1, 1, 0), (333, 5, 0, 0, 1), (450, 3, 0, 1, 1),
            (300, 16, 0, 0, 0), (129, 17, 0, 1, 0), (401, 39, 0, 1, 0),
            (257, 64, 0, 1, 1), (90, 300, 0, 1, 0)]


@pytest.mark.parametrize("n,k,vec,has_b,linear", K5_CASES)
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_source_emulated_matches_plain(fe_emulator, dtype, form, n, k,
                                             vec, has_b, linear):
    """K5's pass on the lifted table: loss, gradient and Σr against
    fe_loss_grad_plain in float64, with a hot id, value-0 entries carrying
    out-of-range ids and weight-0 rows."""
    d = 200
    ty = "f64" if dtype == np.float64 else "f32"
    rng = np.random.RandomState(n + k)
    idx = rng.randint(0, d, (n, k))
    idx[rng.rand(n, k) < 0.3] = 3
    val = rng.randn(n, k) * (rng.rand(n, k) < 0.8)
    w = rng.rand(n) + 0.5
    w[n // 4:n // 3] = 0.0
    inert = (val == 0) | (w == 0)[:, None]
    raw = np.where(inert, 10 ** 6, idx).astype(np.int32)
    y = (rng.rand(n) < 0.5).astype(np.float64)
    off = 0.3 * rng.randn(n)
    theta = 0.2 * rng.randn(d + has_b)
    raw.tofile(fe_emulator / "idx.i32")
    for name, a in (("val", val), ("y", y), ("w", w), ("off", off),
                    ("theta", theta)):
        a.astype(dtype).tofile(fe_emulator / f"{name}.{ty}")
    _run(fe_emulator, "fused", ty, FORMS[form], vec, n, k, d, has_b, linear,
         3)
    g = np.fromfile(fe_emulator / f"g.{ty}", dtype)
    loss, rsum = np.fromfile(fe_emulator / "sums.f64", np.float64)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype).astype(np.float64))
    want_l, want_g = fe.fe_loss_grad_plain(
        t(theta), torch.as_tensor(np.where(inert, 0, idx).astype(np.int32)),
        t(val), t(y), t(w), t(off), d, has_intercept=bool(has_b),
        linear=bool(linear))
    want_g = want_g.numpy()
    tol = F64_RTOL if dtype == np.float64 else F32_RTOL
    assert abs(loss - float(want_l)) <= tol * abs(float(want_l))
    assert np.abs(g - want_g[:d]).max() <= tol * np.abs(want_g[:d]).max()
    if has_b:
        assert abs(rsum - want_g[d]) <= tol * np.abs(want_g[:d]).max()


# (n, k, vec, a, s): K12 on the vector path (k 16) and the lane-group path,
# the whole table in the block or the ids in [s, a) in device memory
K12_CASES = [(600, 16, 1, 64, 64), (500, 5, 0, 64, 64), (700, 39, 0, 300, 300),
             (700, 39, 0, 300, 40), (120, 300, 0, 64, 20)]


@pytest.mark.parametrize("n,k,vec,a,tier", K12_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hot_source_emulated_matches_plain(fe_emulator, dtype, n, k, vec, a,
                                           tier):
    """K12's pass (the hybrid instantiation) against fe_hybrid_hot_plain in
    float64: rank-ordered compact ids with a hot head for the strips, ~20%
    at the dump slot, value-0 entries and weight-0 rows carrying ids far
    out of range; loss, Σr, the gradient and r."""
    ty = "f64" if dtype == np.float64 else "f32"
    rng = np.random.RandomState(n + k + tier)
    idx = np.minimum((a + 1) * rng.rand(n, k) ** 3, a).astype(np.int64)
    idx[rng.rand(n, k) < 0.2] = a
    val = rng.randn(n, k) * (rng.rand(n, k) < 0.8)
    w = rng.rand(n) + 0.5
    w[n // 4:n // 3] = 0.0
    inert = (val == 0) | (w == 0)[:, None]
    raw = np.where(inert, a + 10 ** 6, idx).astype(np.int32)
    y = (rng.rand(n) < 0.5).astype(np.float64)
    off = 0.3 * rng.randn(n)
    theta, b = 0.2 * rng.randn(a), np.array([0.1])
    raw.tofile(fe_emulator / "idx.i32")
    for name, arr in (("val", val), ("y", y), ("w", w), ("off", off),
                      ("theta", theta), ("b", b)):
        arr.astype(dtype).tofile(fe_emulator / f"{name}.{ty}")
    _run(fe_emulator, "hot", ty, fe.FORM_BLOCK, vec, n, k, a, tier, 0, 3)
    g = np.fromfile(fe_emulator / f"g.{ty}", dtype)
    r = np.fromfile(fe_emulator / f"r.{ty}", dtype)
    loss, rsum = np.fromfile(fe_emulator / "sums.f64", np.float64)
    t = lambda x: torch.as_tensor(np.asarray(x, dtype).astype(np.float64))
    wl, wg, wrs, wr = fh.fe_hybrid_hot_plain(
        t(theta), t(b)[0], torch.as_tensor(np.where(inert, a, idx)
                                           .astype(np.int32)),
        t(val), t(y), t(w), t(off), a)
    tol = F64_RTOL if dtype == np.float64 else F32_RTOL
    assert abs(loss - float(wl)) <= tol * abs(float(wl))
    assert abs(rsum - float(wrs)) <= tol * float(wr.abs().sum())
    assert np.abs(g - wg.numpy()).max() <= tol * np.abs(wg.numpy()).max()
    assert np.abs(r - wr.numpy()).max() <= tol * np.abs(wr.numpy()).max()
    assert not r[n // 4:n // 3].any()
