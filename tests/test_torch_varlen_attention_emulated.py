"""The CUDA source of the varlen attention (csrc/varlen_attention.cu) run
on the CPU: built with g++ against the stub CUDA runtime of tests/cuda_emu
(one std::thread per CUDA thread, tests/cuda_emu/varlen_attention_harness.cpp)
and held to the plain versions of ops/varlen_attention.py in float64 on
the same packed rows: O, the log-sum-exp and the backward's dQ, dK and dV,
each output filled with a marker first so that a value the kernel failed
to write shows, and the backward run twice and required bit-equal. The
packs hold documents of 1, 63, 64, 65, 129, 130 and 300 rows (the tiles'
and the window's edges), under windows −1 (whole documents) and 64.
No nvcc and no card: the kernels themselves run on the card only in
chip_smoke.py.

Tolerance: the kernel sums in float32 (exp2 of logits scaled by log2 e,
an online softmax), the plain version in float64: _RTOL of the largest
entry of each output."""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gdmix_tpu_torch.ops import varlen_attention as va

_EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cuda_emu")
_SRC = os.path.join(os.path.dirname(_EMU_DIR), "..", "gdmix_tpu_torch",
                    "csrc", "varlen_attention.cu")
_DECL = "extern __shared__ __align__(16) float smem[];"
_RTOL = 2e-5


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's CPU emulation needs it")
    out = tmp_path_factory.mktemp("varlen_attention_emu")
    with open(_SRC) as f:
        src = f.read()
    assert src.count(_DECL) == 3
    src = src.replace(_DECL, "float* smem = g_smem;")
    with open(out / "varlen_attention_emu.inc", "w") as f:
        f.write(re.sub(r"<<<[^>]*>>>", "", src))
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-I", _EMU_DIR,
                    "-I", str(out),
                    os.path.join(_EMU_DIR, "varlen_attention_harness.cpp"),
                    "-o", str(out / "harness")],
                   check=True, capture_output=True, timeout=300)
    return out


# (document lengths, heads): every edge in one pack; a pack of two heads
CASES = {
    "edges": ([1, 63, 64, 65, 129, 130, 300], 1),
    "two_heads": ([130, 5, 64], 2),
}


@pytest.mark.parametrize("window", [-1, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_emulated_matches_plain(emulator, case, window):
    lens, heads = CASES[case]
    T = sum(lens)
    gen = torch.Generator().manual_seed(len(lens) * 7 + heads)
    q, k, v, do = (torch.randn(T, heads, va.HEAD_DIM, generator=gen)
                   for _ in range(4))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32)
    for name, t in (("q.f32", q), ("k.f32", k), ("v.f32", v),
                    ("dout.f32", do), ("offsets.i32", offsets)):
        t.contiguous().numpy().tofile(emulator / name)
    subprocess.run([str(emulator / "harness"), str(len(lens)), str(heads),
                    str(T), str(max(lens)), str(window)], cwd=emulator,
                   check=True, capture_output=True, timeout=600)

    def read(name):
        return torch.from_numpy(np.fromfile(emulator / name, np.float32)
                                .astype(np.float64))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o, lse = va.varlen_attention_forward_plain(q64, k64, v64, offsets,
                                               window)
    got_o = read("o.f32").view_as(o)
    got_lse = read("lse.f32").view_as(lse)
    # the backward of the kernel's own O and lse, as the Function hands it
    dq, dk, dv = va.varlen_attention_backward_plain(
        q64, k64, v64, got_o, got_lse, do64, offsets, window)
    for name, got, want in (("o", got_o, o), ("lse", got_lse, lse),
                            ("dq", read("dq1.f32").view_as(dq), dq),
                            ("dk", read("dk1.f32").view_as(dk), dk),
                            ("dv", read("dv1.f32").view_as(dv), dv)):
        assert not (got == -7777).any(), f"{name}: an entry not written"
        err = float((got - want).abs().max() / want.abs().max())
        assert err < _RTOL, (name, err)
    for name in ("dq", "dk", "dv"):
        assert (np.fromfile(emulator / f"{name}1.f32", np.float32).tobytes()
                == np.fromfile(emulator / f"{name}2.f32", np.float32)
                .tobytes()), f"{name}: two backward passes differ"


@pytest.mark.parametrize("window", [-1, 2])
def test_the_function_matches_autograd_of_the_masked_softmax(window):
    """The autograd Function on the CPU (the plain versions, forward and
    backward) against autograd through an explicit masked softmax of each
    document, in float64."""
    lens = [1, 5, 9]
    T, heads, d = sum(lens), 2, 8
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(T, heads, d, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32)
    out = va.varlen_attention(q, k, v, offsets, max(lens), window)
    w = torch.randn(out.shape, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want_out, a = [], 0
    for n in lens:
        s = torch.einsum("qhd,khd->hqk", q[a:a + n], k[a:a + n]) / d ** 0.5
        if window >= 0:
            i = torch.arange(n)
            s = s.masked_fill((i[:, None] - i[None, :]).abs() > window,
                              -torch.inf)
        want_out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                     v[a:a + n]))
        a += n
    want_out = torch.cat(want_out)
    want = torch.autograd.grad((want_out * w).sum(), (q, k, v))
    assert float((out - want_out).detach().abs().max()) < 1e-12
    for g, h in zip(got, want):
        assert float((g - h).abs().max()) < 1e-12
