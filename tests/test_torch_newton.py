"""Port parity for the random-effect Newton solvers: gdmix_tpu_torch.ops
(newton — primal and sample-space dual —, dual_variance, newton_lanes)
against the JAX package on the same numpy inputs.
The port runs its plain PyTorch versions here (CPU tensors); the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them."""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gdmix_tpu.ops.newton import densify_bucket as jax_densify
from gdmix_tpu.ops.newton import dual_variance as jax_dual_variance
from gdmix_tpu.ops.newton import newton_lr_batch as jax_newton
from gdmix_tpu.ops.pallas.newton_lanes import _fgd_call
from gdmix_tpu.ops.pallas.newton_lanes import \
    newton_lr_batch_lanes as jax_lanes
from gdmix_tpu_torch.ops import newton_lanes
from gdmix_tpu_torch.ops.newton import (densify_bucket, dual_variance,
                                        newton_lr_batch)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _problem(B, n, dim, seed, dtype=np.float64):
    """Ragged per-entity problems with both classes in every entity's real
    rows (an all-one-class entity with an unregularized intercept has an
    unbounded optimum)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(B, n, dim - 1) * 0.8
    X = np.concatenate([np.ones((B, n, 1)), X], axis=-1)
    counts = rng.randint(2, n + 1, B)
    w = (np.arange(n)[None, :] < counts[:, None]) \
        * rng.uniform(0.5, 2.0, (B, n))
    off = rng.randn(B, n) * 0.3
    z = np.einsum("bnd,bd->bn", X, rng.randn(B, dim)) + off
    y = (rng.uniform(size=(B, n)) < 1 / (1 + np.exp(-z))).astype(np.float64)
    y[:, 0] = 1.0
    y[:, 1] = 0.0
    return tuple(a.astype(dtype) for a in (X, y, w, off, counts))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,n,dim,unreg", [(40, 8, 7, True),
                                           (64, 16, 25, False),
                                           (33, 32, 40, True)])
def test_newton_lr_batch_f64_matches_jax(B, n, dim, unreg):
    X, y, w, off, cnt = _problem(B, n, dim, seed=B)
    mask = np.ones(dim)
    if unreg:
        mask[0] = 0.0
    kw = dict(l2_reg_weight=0.7, maxiter=100, ftol=1e-14, pgtol=1e-9)
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_mask=jnp.asarray(mask), **kw)
    got = newton_lr_batch(*_torch(th0, X, y, w, off, cnt),
                          l2_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.num_iterations.numpy(),
                                  np.asarray(want.num_iterations))
    assert got.converged.all()


def _well_posed(X, w, cnt):
    """Entities whose unregularized intercept problem is well determined:
    at least 4 real rows (the f32 parity bound is stated on these, as the
    JAX package states its lanes-vs-batch-major bound)."""
    return cnt >= 4


# f32 plain K1 vs the JAX lanes kernel: measured max |Δθ| 2.1e-4 at these
# shapes (bound 5e-3, the JAX package's own lanes-vs-batch-major bound)
@pytest.mark.parametrize("B,n,dim,unreg", [(130, 8, 25, True),
                                           (64, 16, 25, False),
                                           (40, 32, 17, True)])
def test_newton_full_plain_f32_matches_pallas_interpret(B, n, dim, unreg):
    X, y, w, off, cnt = _problem(B, n, dim, seed=3 * B, dtype=np.float32)
    kw = dict(maxiter=100, ftol=1e-12, pgtol=1e-5)
    th0 = np.zeros((B, dim), np.float32)
    want = jax_lanes(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                     l2_reg_weight=1.0, unreg_bias=unreg, interpret=True,
                     **kw)
    th, conv, iters = newton_lanes.newton_full(
        *_torch(th0, X, y, w, off, cnt), lam=1.0, unreg_bias=unreg, **kw)
    assert th.dtype == torch.float32 and iters.dtype == torch.int32
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want.converged))
    ok = _well_posed(X, w, cnt) & conv.numpy()
    err = np.abs(th.numpy() - np.asarray(want.theta))[ok].max()
    assert err <= 5e-3, err


def test_newton_full_plain_f64_reaches_jax_optimum():
    """Plain K1 in float64 at a tight pgtol lands on the optimum the JAX
    batch-major solver finds in float64: the algorithm, apart from f32
    rounding."""
    B, n, dim = 48, 16, 13
    X, y, w, off, cnt = _problem(B, n, dim, seed=11)
    mask = np.ones(dim)
    mask[0] = 0.0
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_reg_weight=0.5, l2_mask=jnp.asarray(mask),
                      maxiter=100, ftol=1e-16, pgtol=1e-10)
    th, conv, _ = newton_lanes.newton_full_plain(
        *_torch(th0, X, y, w, off, cnt), lam=0.5, unreg_bias=True,
        maxiter=100, ftol=1e-16, pgtol=1e-10)
    assert conv.all()
    np.testing.assert_allclose(th.numpy(), np.asarray(want.theta), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("n,dim,unreg", [(64, 25, True), (512, 9, False)])
def test_newton_fgd_plain_matches_pallas_interpret(n, dim, unreg):
    """One iteration's (f, g_scaled, δ) against the JAX _fgd_kernel, fed
    its lanes-last layout (d padded to 8, B to 128)."""
    B = 128
    X, y, w, off, cnt = _problem(B, n, dim, seed=n, dtype=np.float32)
    th = (np.random.RandomState(1).randn(B, dim) * 0.3).astype(np.float32)
    d = dim + (-dim) % 8
    Xl = np.zeros((n, d, B), np.float32)
    Xl[:, :dim, :] = X.transpose(1, 2, 0)
    thl = np.zeros((d, B), np.float32)
    thl[:dim] = th.T
    call = _fgd_call(n, d, dim, B, 0.8, unreg, True)
    f, g, delta = call(jnp.asarray(Xl), jnp.asarray(y.T), jnp.asarray(w.T),
                       jnp.asarray(off.T), jnp.asarray(cnt[None, :]),
                       jnp.asarray(thl))
    got_f, got_g, got_d = newton_lanes.newton_fgd_plain(
        *_torch(X, y, w, off, cnt, th), lam=0.8, unreg_bias=unreg)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(f)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(g)[:dim].T,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(delta)[:dim].T,
                               rtol=1e-3, atol=1e-4)


def test_lanes_dispatch_fgd_path_matches_jax():
    """n·d8 > 1024, where the JAX lanes path takes its per-iteration form:
    newton_lr_batch_lanes (the plain loop on the CPU) gives its result."""
    B, n, dim = 24, 64, 25
    X, y, w, off, cnt = _problem(B, n, dim, seed=5, dtype=np.float32)
    th0 = np.zeros((B, dim), np.float32)
    kw = dict(l2_reg_weight=1.0, unreg_bias=True, maxiter=60, ftol=1e-12,
              pgtol=1e-5)
    want = jax_lanes(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                     interpret=True, **kw)
    got = newton_lanes.newton_lr_batch_lanes(
        *_torch(th0, X, y, w, off, cnt), **kw)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=5e-3)


@pytest.mark.parametrize("B,n,dim,unreg", [(20, 128, 25, True),
                                           (16, 256, 12, False)])
def test_newton_block_plain_matches_pallas_interpret(B, n, dim, unreg):
    """The K2 wrapper (a whole solve now; its plain version on the CPU)
    against the JAX lanes path, which runs its per-iteration kernel in
    interpret mode at these shapes (n a multiple of that kernel's row
    block: see the next test)."""
    X, y, w, off, cnt = _problem(B, n, dim, seed=n + dim, dtype=np.float32)
    th0 = np.zeros((B, dim), np.float32)
    kw = dict(maxiter=60, ftol=1e-12, pgtol=1e-5)
    want = jax_lanes(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                     l2_reg_weight=0.9, unreg_bias=unreg, interpret=True,
                     **kw)
    th, conv, iters = newton_lanes.newton_block(
        *_torch(th0, X, y, w, off, cnt), lam=0.9, unreg_bias=unreg, **kw)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want.converged))
    ok = _well_posed(X, w, cnt) & conv.numpy()
    assert np.abs(th.numpy() - np.asarray(want.theta))[ok].max() <= 5e-3
    assert iters.dtype == torch.int32


def test_newton_block_plain_uses_every_row_past_a_power_of_two():
    """At n = 300 the JAX lanes path's per-iteration kernel sums only the
    first 256 rows into f, g and H (`_fgd_call`: n_blocks = n // nb; ROADMAP
    C.8); the port takes every row: in float64 its solve lands on the JAX
    batch-major solver's optimum, which reads all rows."""
    B, n, dim = 6, 300, 9
    X, y, w, off, cnt = _problem(B, n, dim, seed=17)
    cnt[:] = n
    w[:] = 1.0
    mask = np.ones(dim)
    mask[0] = 0.0
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_reg_weight=0.9, l2_mask=jnp.asarray(mask),
                      maxiter=100, ftol=1e-16, pgtol=1e-10)
    th, conv, _ = newton_lanes.newton_block(
        *_torch(th0, X, y, w, off, cnt), lam=0.9, unreg_bias=True,
        maxiter=100, ftol=1e-16, pgtol=1e-10)
    assert conv.all()
    np.testing.assert_allclose(th.numpy(), np.asarray(want.theta), rtol=0,
                               atol=1e-8)


def test_plain_loop_counts_its_host_reads():
    """The plain loop reads `done` on the host once per iteration and once
    per line-search trial, and counts each read; on a card the kernels
    read nothing back inside the solve."""
    X, y, w, off, cnt = _problem(8, 8, 5, seed=2, dtype=np.float32)
    th0 = np.zeros((8, 5), np.float32)
    before = newton_lanes.newton_lr_batch_lanes.host_syncs
    res = newton_lanes.newton_lr_batch_lanes(
        *_torch(th0, X, y, w, off, cnt), l2_reg_weight=1.0, unreg_bias=True,
        maxiter=50, ftol=1e-12, pgtol=1e-5)
    reads = newton_lanes.newton_lr_batch_lanes.host_syncs - before
    k = int(res.num_iterations.max())
    assert res.converged.all() and k >= 2
    # one read per iteration and at least one trial's per iteration, plus
    # the read that ends the loop
    assert reads >= 2 * k + 1


_GATE_N = sorted({1, 2, 7, 8, 9, 16, 31, 32, 33, 63, 64, 65, 96, 97, 127,
                  128, 129, 185, 186, 255, 256, 257, 300, 511, 512, 513,
                  1024, 1500, 1600, 2047, 2048, 4096, 10000})


def test_lanes_form_fits_each_forms_budget():
    """Every (n, dim) the gate sends to a form fits that form's
    shared-memory budget (the warp form's leaves WARP_FORM_MIN_WARPS warps
    resident on an SM, a resident block fits the opt-in), the forms follow
    each other as n grows, the primary tiers take the warp form and, at
    dim 25, the warp form ends between n = 128 and 256, where the card's
    times of the two forms cross."""
    nl = newton_lanes
    for dim in range(1, nl.MAX_DIM + 1):
        seen = []
        for n in _GATE_N:
            form = nl.lanes_form(n, dim)
            need = nl.form_smem_bytes(form, n, dim)
            if form == "warp":
                assert need <= nl.WARP_FORM_BLOCK_BYTES, (n, dim)
                per_sm = nl.SM_SMEM_BYTES // (need + nl.BLOCK_RESERVED_BYTES)
                assert 4 * per_sm >= nl.WARP_FORM_MIN_WARPS, (n, dim)
            else:
                assert nl.form_smem_bytes("warp", n, dim) \
                    > nl.WARP_FORM_BLOCK_BYTES, (n, dim)
                assert need <= nl.SMEM_OPTIN_BYTES, (n, dim, form)
            if form == "stream":
                assert nl.form_smem_bytes("block", n, dim) \
                    > nl.SMEM_OPTIN_BYTES, (n, dim)
            seen.append(nl.FORMS.index(form))
        assert seen == sorted(seen), dim
        assert seen[0] == 0 and seen[-1] == 2, dim
    assert [nl.lanes_form(n, 25) for n in (8, 16, 32, 64, 128, 256,
                                           2048)] == [
        "warp", "warp", "warp", "warp", "warp", "block", "stream"]


@pytest.mark.parametrize("n,dim", [(8, 0), (8, 65), (0, 5), (64, 200)])
def test_lanes_form_refuses_shapes_past_the_lanes_path(n, dim):
    with pytest.raises(ValueError, match="lanes path"):
        newton_lanes.lanes_form(n, dim)


def test_cuda_wrappers_refuse_shapes_they_do_not_take(monkeypatch):
    """On a card a wrapper handed a shape its kernel does not take raises:
    it never falls back to the plain version, and builds nothing."""
    from gdmix_tpu_torch.ops import _cuda
    nl = newton_lanes
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a, **k: None)

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_cuda, "load", no_build)
    monkeypatch.setattr(nl, "newton_full_plain", no_build)
    m = lambda *shape: torch.zeros(*shape, device="meta")
    kw = dict(lam=1.0, unreg_bias=True, maxiter=5, ftol=1e-12, pgtol=1e-5)
    args = lambda B, n, d: (m(B, d), m(B, n, d), m(B, n), m(B, n), m(B, n),
                            m(B))
    launches = (nl.newton_full.launches, nl.newton_block.launches)
    with pytest.raises(ValueError, match="use newton_block"):
        nl.newton_full(*args(4, 256, 25), **kw)       # the block form's
    for fn in (nl.newton_full, nl.newton_block):
        with pytest.raises(ValueError, match="lanes path: dim 65"):
            fn(*args(4, 8, 65), **kw)
        bad = list(args(4, 8, 5))
        bad[5] = m(3)                                  # counts of 3, not 4
        with pytest.raises(ValueError, match="shapes"):
            fn(*bad, **kw)
    assert (nl.newton_full.launches, nl.newton_block.launches) == launches


_EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cuda_emu")
_KERNEL_SRC = os.path.join(os.path.dirname(_EMU_DIR), "..",
                           "gdmix_tpu_torch", "csrc", "newton_lanes.cu")


def test_lanes_host_code_waits_on_nothing():
    """The kernels' host code makes no synchronising runtime call, which
    PyTorch's sync debug mode (the smoke's host-read count) cannot see: a
    launch returns at once and nothing inside a solve waits on the card."""
    with open(_KERNEL_SRC) as f:
        src = f.read()
    for call in ("cudaDeviceSynchronize", "cudaStreamSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy"):
        assert call not in src, call


@pytest.fixture(scope="module")
def newton_emulator(tmp_path_factory):
    """csrc/newton_lanes.cu built for the CPU with g++ against the stub CUDA
    runtime of tests/cuda_emu (one std::thread per CUDA thread): the
    kernels' own source, run here where there is no nvcc and no card."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's CPU emulation needs it")
    out = tmp_path_factory.mktemp("newton_emu")
    with open(_KERNEL_SRC) as f:
        src = f.read()
    decl = "extern __shared__ __align__(16) float smem[];"
    assert decl in src
    src = re.sub(r"<<<[^>]*>>>", "", src.replace(decl,
                                                "float* smem = g_smem;"))
    with open(out / "newton_lanes_emu.inc", "w") as f:
        f.write(src)
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-I", _EMU_DIR,
                    "-I", str(out),
                    os.path.join(_EMU_DIR, "newton_lanes_harness.cpp"),
                    "-o", str(out / "harness")],
                   check=True, capture_output=True, timeout=300)
    return out


def _emulate(emu, form, arrays, *, lam, unreg, maxiter=100, ftol=1e-12,
             pgtol=1e-5, lanes=None, n_lanes=None):
    """The harness's solve of `arrays` (θ0, X, y, w, off, cnt); with
    `lanes` [B] and `n_lanes`, over the first n_lanes of that lane list
    (its outputs filled with the harness's kUntouched* bits first)."""
    th0, X, y, w, off, cnt = arrays
    B, n, d = X.shape
    for name, a in zip(("th0", "X", "y", "w", "off", "cnt"), arrays):
        np.ascontiguousarray(a, np.float32).tofile(emu / f"{name}.f32")
    extra = []
    if lanes is not None:
        np.asarray(lanes, np.int32).tofile(emu / "lanes.i32")
        np.asarray([n_lanes], np.int32).tofile(emu / "nlanes.i32")
        extra = ["lanes"]
    subprocess.run([str(emu / "harness"), "solve", str(form), str(B), str(n),
                    str(d), repr(lam), str(int(unreg)), str(maxiter),
                    repr(ftol), repr(pgtol)] + extra,
                   cwd=emu, check=True, capture_output=True, timeout=300)
    return (np.fromfile(emu / "th.f32", np.float32).reshape(B, d),
            np.fromfile(emu / "conv.u8", np.uint8).astype(bool),
            np.fromfile(emu / "iters.i32", np.int32))


# (form, B, n, dim, unregularised intercept, padded)
_EMU_CASES = [(0, 9, 8, 25, True, True), (0, 5, 16, 7, False, False),
              (0, 4, 8, 64, True, False), (0, 9, 32, 25, True, True),
              (1, 3, 64, 25, True, True), (1, 3, 40, 33, False, False),
              (2, 3, 300, 25, True, True), (2, 2, 520, 9, False, False)]


@pytest.mark.parametrize("form,B,n,dim,unreg,padded", _EMU_CASES)
def test_kernel_source_emulated_matches_plain(newton_emulator, form, B, n,
                                              dim, unreg, padded):
    """The CUDA source of K1 (form 0, four entities a block, the last
    block part-filled at B = 9 and 5) and K2 (1 resident, 2 streamed, past
    one chunk of rows at n = 300 and 520), run on the CPU: it reaches the
    plain version's models (f32 bound of the lanes path) with the same converged
    flags; padded entities (count 0, weight 0) stop at the gradient test
    with 0 iterations, and a warm start is honoured."""
    X, y, w, off, cnt = _problem(B, n, dim, seed=7 * B + n + dim,
                                 dtype=np.float32)
    th0 = (np.random.RandomState(n).randn(B, dim) * 0.2).astype(np.float32)
    if padded:
        X[-2:] = 0.0
        w[-2:] = 0.0
        cnt[-2:] = 0.0
        th0[-2:] = 0.0
    th, conv, iters = _emulate(newton_emulator, form,
                               (th0, X, y, w, off, cnt), lam=0.8,
                               unreg=unreg)
    want, wconv, witers = newton_lanes.newton_full_plain(
        *_torch(th0, X, y, w, off, cnt), lam=0.8, unreg_bias=unreg,
        maxiter=100, ftol=1e-12, pgtol=1e-5)
    np.testing.assert_array_equal(conv, wconv.numpy())
    ok = (_well_posed(X, w, cnt) | (cnt == 0)) & conv
    assert ok.sum() >= B - 2
    assert np.abs(th - want.numpy())[ok].max() <= 5e-3
    assert np.abs(iters - witers.numpy()).max() <= 1
    if padded:
        assert (iters[-2:] == 0).all() and (th[-2:] == 0).all()


@pytest.mark.parametrize("n,dim", [(1, 1), (8, 25), (64, 25), (300, 64),
                                   (2048, 33)])
def test_kernel_layout_is_the_gates(newton_emulator, n, dim):
    """The shared-memory layout the kernels allocate is the one the gate
    (`lanes_form`) budgets, for each form."""
    out = subprocess.run([str(newton_emulator / "harness"), "layout", str(n),
                          str(dim)], check=True, capture_output=True,
                         text=True, timeout=60).stdout.split()
    assert [int(v) for v in out] == [
        newton_lanes._group_floats(n, dim, 1, False),
        newton_lanes._group_floats(n, dim, 4, False),
        newton_lanes._group_floats(n, dim, 4, True)]


def test_densify_bucket_accumulates_duplicates():
    rng = np.random.RandomState(2)
    B, n, K, u_cap = 6, 5, 4, 7
    idx = rng.randint(0, u_cap, (B, n, K)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]           # every record repeats an index
    val = rng.randn(B, n, K)
    for has_icpt in (True, False):
        want = np.asarray(jax_densify(jnp.asarray(idx), jnp.asarray(val),
                                      u_cap, has_icpt))
        got = densify_bucket(torch.from_numpy(idx), torch.from_numpy(val),
                             u_cap, has_icpt).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
        off = 1 if has_icpt else 0
        j = idx[0, 0, 0]
        dup = sum(val[0, 0, k] for k in range(K) if idx[0, 0, k] == j)
        np.testing.assert_allclose(got[0, 0, off + j], dup, rtol=1e-14)


def _wide(B, n, dim, seed, pad_lanes=0):
    """Samples-per-entity < dim (the dual's regime), float64, with
    `pad_lanes` all-zero padding lanes at the end (weight 0, count 0)."""
    X, y, w, off, cnt = _problem(B, n, dim, seed)
    if pad_lanes:
        X[-pad_lanes:] = 0.0
        w[-pad_lanes:] = 0.0
        cnt[-pad_lanes:] = 0
    return X, y, w, off, cnt.astype(np.float64)


def _objective(theta, X, y, w, off, cnt, lam, mask):
    z = np.einsum("bnd,bd->bn", X, theta) + off
    bce = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
    return (np.sum(w * bce, 1) + 0.5 * lam * np.sum(mask * theta ** 2, 1)) \
        / np.maximum(cnt, 1.0)


# both sides solve the n×n system by Cholesky in float64: θ to 1e-8. At
# λ = 0 with n < dim the minimizer is not unique (the loss sees only Xθ)
# and the two land on different points of the flat valley: there the
# objective values must agree, to 1e-12
@pytest.mark.parametrize("lam,reg_bias", [(0.5, False), (0.0, False),
                                          (1.0, True)])
def test_dual_newton_f64_matches_jax(lam, reg_bias):
    B, n, dim = 12, 8, 21
    X, y, w, off, cnt = _wide(B, n, dim, seed=int(10 * lam) + 3,
                              pad_lanes=2)
    mask = np.ones(dim)
    if not reg_bias:
        mask[0] = 0.0
    kw = dict(l2_reg_weight=lam, maxiter=60, ftol=1e-14, pgtol=1e-10,
              dual=True)
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_mask=jnp.asarray(mask), **kw)
    got = newton_lr_batch(*_torch(th0, X, y, w, off, cnt),
                          l2_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.num_iterations.numpy(),
                                  np.asarray(want.num_iterations))
    if lam > 0:
        np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                                   rtol=0, atol=1e-8)
    else:
        np.testing.assert_allclose(
            _objective(got.theta.numpy(), X, y, w, off, cnt, lam, mask),
            _objective(np.asarray(want.theta), X, y, w, off, cnt, lam, mask),
            rtol=0, atol=1e-12)
    assert got.converged.all()
    assert (got.num_iterations.numpy()[-2:] == 0).all()   # padded lanes


def test_dual_newton_plain_kernel_solve_matches_cholesky(monkeypatch):
    """The dual step through K4's plain version (the solve a card runs for
    n ≤ 128) lands where the Cholesky route does."""
    from gdmix_tpu_torch.ops import newton as tn
    B, n, dim = 10, 6, 15
    X, y, w, off, cnt = _wide(B, n, dim, seed=8)
    mask = np.ones(dim)
    mask[0] = 0.0
    args = _torch(np.zeros((B, dim)), X, y, w, off, cnt)
    kw = dict(l2_reg_weight=0.8, l2_mask=torch.from_numpy(mask), maxiter=60,
              ftol=1e-14, pgtol=1e-10, dual=True)
    chol = newton_lr_batch(*args, **kw)
    calls = []

    def kernel_route(L, rhs):
        K = L @ L.mT
        calls.append(K.shape)
        return tn.spd_solve_batched_mrhs(K, rhs)
    monkeypatch.setattr(tn, "_cho_solve_batched", kernel_route)
    gj = newton_lr_batch(*args, **kw)
    assert calls and calls[0] == (B, n, n)
    np.testing.assert_allclose(gj.theta.numpy(), chol.theta.numpy(),
                               rtol=0, atol=1e-8)


# same sample-space formulas, Cholesky on both sides: 1e-10 relative
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("reg_bias", [False, True])
def test_dual_variance_matches_jax(full, reg_bias):
    B, n, dim = 6, 7, 16
    X, y, w, off, _ = _wide(B, n, dim, seed=7)
    theta = 0.3 * np.random.RandomState(11).randn(B, dim)
    mask = np.ones(dim)
    if not reg_bias:
        mask[0] = 0.0
    kw = dict(l2_reg_weight=0.7, full=full, epsilon=1e-9)
    want = np.asarray(jax_dual_variance(
        *(jnp.asarray(a) for a in (theta, X, y, w, off)),
        l2_mask=jnp.asarray(mask), **kw))
    got = dual_variance(*_torch(theta, X, y, w, off),
                        l2_mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert (got > 0).all()
