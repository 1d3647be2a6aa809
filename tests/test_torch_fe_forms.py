"""The two fixed-effect pass kernels' wrappers (ops/fe_loss_grad.py
`fe_loss_grad_fused`, ops/fe_hybrid.py `fe_hybrid_hot`) on CPU tensors
against the JAX package, over the shapes that take the kernels' different
paths on a card (K = 16 and 12: 16-byte loads; K = 5, 1 and, for the
hot-side kernel, 39: the lane-group path; with and without an intercept;
logistic and linear; float64 and float32), with padding the kernels must
never read; the form choosers at their byte boundaries; the path and shape
each K and alignment take; the rank order of the compact ids the hot-side
kernel relies on; and the wrappers' shape and type errors. The kernels themselves
run only on a card, where `python3 chip_smoke.py` holds each form against
the plain versions used here. Inputs are made from a numpy seed and handed
to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.ops import logistic as jl
from gdmix_tpu.ops.pallas.fe_grad import fe_loss_grad_pallas
from gdmix_tpu.ops.pallas.fe_hybrid import fe_hybrid_hot_pallas
from gdmix_tpu_torch.ops import fe_hybrid as fh
from gdmix_tpu_torch.ops import fe_loss_grad as fe
from gdmix_tpu_torch.ops import fe_pass
from gdmix_tpu_torch.ops import logistic as tl
from gdmix_tpu_torch.ops.linsolve import SMEM_OPTIN

# against JAX's XLA objective in float64: the port in float64 (the same
# math summed in another order) and in float32 (its rounding over ≤ 16
# entries a record and 640 records)
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
# JAX's fused kernel computes in float32: the bound its own tests hold it to
# against the XLA objective (tests/test_fe_pallas_kernel.py)
KERNEL_LOSS_RTOL, KERNEL_GRAD_TOL = 1e-4, 1e-3
# JAX's K12 splits θ and v·r into two bf16 terms (~2^-17 relative): the
# bound of its own test against the plain objective
K12_TOL = 3e-5

N, D = 640, 97   # N: a multiple of the JAX kernels' 128-row tile


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _records(k, seed, linear=False, d=D):
    """Padded COO records [N, k]: ~30% value-0 entries whose ids are OUT OF
    RANGE, and a block of weight-0 rows whose ids are out of range too: a
    reader of either would fault. `idx_safe` has those ids set to 0, for
    the reference."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, (N, k)).astype(np.int32)
    val = rng.randn(N, k)
    pad = rng.rand(N, k) < 0.3
    val[pad] = 0.0
    w = rng.rand(N) + 0.5
    w[200:260] = 0.0
    inert = pad | (w == 0)[:, None]
    bad = np.where(rng.rand(N, k) < 0.5, d + 7 + rng.randint(0, 10**6, (N, k)),
                   -1 - rng.randint(0, 10**6, (N, k))).astype(np.int32)
    y = rng.randn(N) if linear else (rng.rand(N) < 0.5).astype(np.float64)
    return dict(idx=np.where(inert, bad, idx), idx_safe=np.where(inert, 0, idx),
                val=val, y=y, w=w, off=0.3 * rng.randn(N),
                x=0.2 * rng.randn(d + 1))


def _t(a, dtype):
    return torch.as_tensor(a, dtype=torch.int32 if a.dtype == np.int32
                           else dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("linear", [False, True], ids=["logistic", "linear"])
@pytest.mark.parametrize("has_intercept", [True, False],
                         ids=["intercept", "no_intercept"])
@pytest.mark.parametrize("k", [1, 5, 12, 16])
def test_fused_matches_jax(k, has_intercept, linear, dtype):
    dd = _records(k, seed=100 + k, linear=linear)
    x = dd["x"] if has_intercept else dd["x"][:-1]
    v, g = fe.fe_loss_grad_fused(
        _t(x, dtype), _t(dd["idx"], dtype), _t(dd["val"], dtype),
        _t(dd["y"], dtype), _t(dd["w"], dtype), _t(dd["off"], dtype), D,
        has_intercept=has_intercept, linear=linear)
    assert g.dtype == dtype and g.shape == x.shape
    batch = jl.SparseBatch(*(jnp.asarray(dd[f]) for f in
                             ("idx_safe", "val", "off", "y", "w")))
    jv, jg = jl.fixed_effect_value_and_grad(
        jnp.asarray(x), batch, D, has_intercept=has_intercept,
        regularize_bias=True, l2_reg_weight=0.0,
        model_type="linear_regression" if linear else "logistic_regression")
    jg = np.asarray(jg)
    tol = RTOL[dtype]
    np.testing.assert_allclose(float(v), float(jv), rtol=tol)
    np.testing.assert_allclose(g.double().numpy(), jg, rtol=0,
                               atol=tol * np.abs(jg).max())
    if has_intercept and dtype == torch.float32:
        # and JAX's fused Pallas kernel, in interpret mode
        kv, kg = fe_loss_grad_pallas(
            jnp.asarray(x, jnp.float32), jnp.asarray(dd["idx_safe"]),
            jnp.asarray(dd["val"]), jnp.asarray(dd["y"]),
            jnp.asarray(dd["w"]), jnp.asarray(dd["off"]), D, linear=linear,
            interpret=True)
        kg = np.asarray(kg, np.float64)
        np.testing.assert_allclose(float(v), float(kv), rtol=KERNEL_LOSS_RTOL)
        np.testing.assert_allclose(g.double().numpy(), kg, rtol=0,
                                   atol=KERNEL_GRAD_TOL * np.abs(kg).max())


def _hot_inputs(a, ids, seed, k=8):
    """Compact ids in [0, a] (a: the dump slot) for fe_hybrid_hot: "mixed"
    (rank-ordered, power-law, ~25% dumped), "dump" (every entry at the dump
    slot) or "zero" (every entry at compact id 0); value-0 entries and a
    block of weight-0 rows carry ids far out of range."""
    rng = np.random.RandomState(seed)
    if ids == "mixed":
        idx = np.minimum((a + 1) * rng.rand(N, k) ** 3, a).astype(np.int32)
        idx[rng.rand(N, k) < 0.25] = a
    else:
        idx = np.full((N, k), a if ids == "dump" else 0, np.int32)
    val = rng.randn(N, k).astype(np.float32)
    pad = rng.rand(N, k) < 0.2
    val[pad] = 0.0
    w = (rng.rand(N) + 0.5).astype(np.float32)
    w[100:140] = 0.0
    inert = pad | (w == 0)[:, None]
    return dict(idx=np.where(inert, a + 12345, idx).astype(np.int32),
                idx_safe=np.where(inert, a, idx).astype(np.int32), val=val,
                y=(rng.rand(N) < 0.5).astype(np.float32), w=w,
                off=(0.1 * rng.randn(N)).astype(np.float32),
                theta=(0.3 * rng.randn(a)).astype(np.float32))


@pytest.mark.parametrize("linear", [False, True], ids=["logistic", "linear"])
@pytest.mark.parametrize("a,ids", [(8, "mixed"), (64, "mixed"),
                                   (4096, "mixed"), (64, "dump"),
                                   (64, "zero")])
def test_hybrid_hot_matches_pallas(a, ids, linear):
    dd = _hot_inputs(a, ids, seed=a + len(ids))
    b = np.float32(0.2)
    y = dd["y"] + (0.3 * np.random.RandomState(1).randn(N).astype(np.float32)
                   if linear else 0)
    lv, g, rs, r = fh.fe_hybrid_hot(
        torch.as_tensor(dd["theta"]), torch.as_tensor(b),
        torch.as_tensor(dd["idx"]), torch.as_tensor(dd["val"]),
        torch.as_tensor(y), torch.as_tensor(dd["w"]),
        torch.as_tensor(dd["off"]), a, linear=linear)
    want = fe_hybrid_hot_pallas(
        jnp.asarray(dd["theta"]), jnp.asarray(b), jnp.asarray(dd["idx_safe"]),
        jnp.asarray(dd["val"]), jnp.asarray(y), jnp.asarray(dd["w"]),
        jnp.asarray(dd["off"]), hot=a, linear=linear, tile=128,
        interpret=True)
    jlv, jg, jrs, jr = [np.asarray(x) for x in want]
    assert g.shape == (a,) and r.shape == (N,)
    np.testing.assert_allclose(float(lv), jlv, rtol=K12_TOL)
    np.testing.assert_allclose(float(rs), jrs, rtol=K12_TOL,
                               atol=K12_TOL * np.abs(jr).sum())
    for t, j in ((g, jg), (r, jr)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=K12_TOL * max(np.abs(j).max(), 1e-30))
    if ids == "dump":
        assert not g.any()
    assert not r[100:140].any()


@pytest.mark.parametrize("linear", [False, True], ids=["logistic", "linear"])
def test_hybrid_hot_matches_pallas_at_k39(linear):
    """Criteo's K = 39 (the kernel's lane-group path on a card): the
    wrapper against JAX's K12 in interpret mode."""
    a, k = 512, 39
    dd = _hot_inputs(a, "mixed", seed=39, k=k)
    b = np.float32(-0.4)
    y = dd["y"] + (0.3 * np.random.RandomState(2).randn(N).astype(np.float32)
                   if linear else 0)
    lv, g, rs, r = fh.fe_hybrid_hot(
        torch.as_tensor(dd["theta"]), torch.as_tensor(b),
        torch.as_tensor(dd["idx"]), torch.as_tensor(dd["val"]),
        torch.as_tensor(y), torch.as_tensor(dd["w"]),
        torch.as_tensor(dd["off"]), a, linear=linear)
    want = fe_hybrid_hot_pallas(
        jnp.asarray(dd["theta"]), jnp.asarray(b), jnp.asarray(dd["idx_safe"]),
        jnp.asarray(dd["val"]), jnp.asarray(y), jnp.asarray(dd["w"]),
        jnp.asarray(dd["off"]), hot=a, linear=linear, tile=128,
        interpret=True)
    jlv, jg, jrs, jr = [np.asarray(x) for x in want]
    np.testing.assert_allclose(float(lv), jlv, rtol=K12_TOL)
    np.testing.assert_allclose(float(rs), jrs, rtol=K12_TOL,
                               atol=K12_TOL * np.abs(jr).sum())
    for t, j in ((g, jg), (r, jr)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=K12_TOL * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("item", [4, 8], ids=["f32", "f64"])
def test_privatised_form_at_its_byte_boundary(item):
    """The gradient stays in shared memory exactly while the table, the
    strips, the hashed table of frequent ids and the reserve fit the
    opt-in."""
    extra = (32 * fe_pass.STRIP_IDS * item
             + 4 * (2 * fe.HOT_BUCKETS + fe_pass.STRIP_IDS)
             + fe_pass.SMEM_RESERVE)
    d_max = (SMEM_OPTIN - extra) // item
    assert fe.privatised_form(d_max, item)
    assert not fe.privatised_form(d_max + 1, item)
    assert fe.privatised_form(1, item) and fe.privatised_form(10_000, item)
    assert not fe.privatised_form(1_000_000, item)
    assert d_max * item + extra <= SMEM_OPTIN < (d_max + 1) * item + extra


@pytest.mark.parametrize("item", [4, 8], ids=["f32", "f64"])
def test_shared_tier_at_its_byte_boundary(item):
    """S = A while the compact table fits beside the strips; past that S is
    what fits, and the ids in [S, A) go to device memory."""
    budget = SMEM_OPTIN - fe_pass.SMEM_RESERVE - fe_pass.strip_bytes(item)
    s_max = budget // item
    assert fh.shared_tier(s_max, item) == s_max
    assert fh.shared_tier(s_max + 1, item) == s_max
    assert fh.shared_tier(16_384, item) == 16_384
    assert fh.shared_tier(8, item) == 8
    assert fh.shared_tier(1 << 20, item) == s_max
    assert (s_max * item + fe_pass.strip_bytes(item) + fe_pass.SMEM_RESERVE
            <= SMEM_OPTIN)


def test_vector_path_needs_k_and_alignment():
    idx = torch.zeros(8, 16, dtype=torch.int32)
    val = torch.zeros(8, 16)
    assert fe_pass.vector_path(16, idx, val)
    assert fe_pass.vector_path(12, idx[:, :12].contiguous(), val)
    assert not fe_pass.vector_path(5, idx, val)
    assert not fe_pass.vector_path(20, idx, val)
    # a view that starts 4 bytes into its storage
    assert not fe_pass.vector_path(16, idx.reshape(-1)[1:], val)


# (K, rows 16-byte aligned, path, lanes, entries): the vector path only at
# K ≤ 16, K % 4 == 0 on aligned rows; every other shape the lane-group path,
# the fewest lanes that hold a record at ≤ 5 entries each (at least 3); past
# 32 lanes × 5 (K = 161) chunks of 160
PASS_SHAPES = [(3, True, "lanes", 1, 3), (5, True, "lanes", 1, 5),
               (16, True, "vector", 4, 4), (16, False, "lanes", 4, 4),
               (12, False, "lanes", 4, 3), (17, True, "lanes", 4, 5),
               (20, True, "lanes", 4, 5), (39, True, "lanes", 8, 5),
               (64, True, "lanes", 16, 4), (160, True, "lanes", 32, 5),
               (161, True, "lanes", 32, 5), (1, True, "lanes", 1, 3)]


@pytest.mark.parametrize("k,aligned,path,lanes,entries", PASS_SHAPES)
def test_pass_shape_by_k_and_alignment(k, aligned, path, lanes, entries):
    buf = torch.zeros(8 * k + 1, dtype=torch.int32)
    idx = (buf[:-1] if aligned else buf[1:]).view(8, k)
    assert (idx.data_ptr() % 16 == 0) == aligned
    shape = fe_pass.pass_shape(k, idx, torch.zeros(8, k))
    assert shape == (path, lanes, entries)
    if path == "lanes":
        assert shape == fe_pass.lane_group(k)
        # a record fits its lanes' registers, or (past the largest group
        # only) is read in chunks of them
        assert (lanes * entries >= k) == (k <= fe_pass.LANES_MAX_G
                                          * fe_pass.LANES_MAX_E)


def test_lane_group_is_the_fewest_lanes():
    """Over K = 1…400: lanes a power of two, entries within [3, 5], no
    smaller group holds the record at ≤ 5 entries a lane."""
    for k in range(1, 401):
        path, lanes, entries = fe_pass.lane_group(k)
        assert path == "lanes" and lanes & (lanes - 1) == 0
        assert fe_pass.LANES_MIN_E <= entries <= fe_pass.LANES_MAX_E
        if lanes > 1:
            assert -(-k // (lanes // 2)) > fe_pass.LANES_MAX_E
        if lanes < fe_pass.LANES_MAX_G:
            assert entries == max(-(-k // lanes), fe_pass.LANES_MIN_E)


def test_check_lane_group_catches_a_library_that_disagrees():
    want = lambda k: (lambda s: s.lanes * 100 + s.entries)(
        fe_pass.lane_group(k))
    fe_pass.check_lane_group(want, "ok")
    with pytest.raises(RuntimeError, match="records of 39 entries"):
        fe_pass.check_lane_group(
            lambda k: 1603 if k == 39 else want(k), "off")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_ids_are_in_descending_count_order(seed):
    """_hybrid_hot hands out compact ids hottest first, ties to the lower
    id, as jax.lax.top_k does in the JAX package: the hot-side kernel gives
    its lane-private strips to the lowest compact ids and sends the highest
    to device memory."""
    rng = np.random.RandomState(seed)
    # many ties: counts in 0..5 over 400 features
    counts = rng.randint(0, 6, 400).astype(np.int32)
    hot = 120
    ids, cum = tl._hybrid_hot(torch.as_tensor(counts), hot)
    j_ids, j_cum = jl._hybrid_hot_fn(hot)(jnp.asarray(counts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(j_cum))
    c = counts[ids.numpy()]
    assert (np.diff(c) <= 0).all()
    same = np.diff(c) == 0
    assert (np.diff(ids.numpy())[same] > 0).all()
    # and through the split: compact id r is the r-th most frequent feature
    k = 4
    idx = rng.choice(400, size=(300, k), p=(counts + 1e-9) / (counts.sum()
                     + 400e-9)).astype(np.int32)
    val = np.ones((300, k))
    aux = tl.build_hybrid_aux(torch.as_tensor(idx), torch.as_tensor(val), 400,
                              hot_features=50, cold_max_frac=1.0)
    per_compact = np.bincount(aux.hot_idx.numpy().reshape(-1), minlength=51)
    assert (np.diff(per_compact[:50]) <= 0).all()


def _fused_args(dtype=torch.float64, n=6, k=4, d=5):
    return [torch.zeros(d + 1, dtype=dtype),
            torch.zeros(n, k, dtype=torch.int32),
            torch.zeros(n, k, dtype=dtype), torch.zeros(n, dtype=dtype),
            torch.ones(n, dtype=dtype), torch.zeros(n, dtype=dtype), d]


@pytest.mark.parametrize("what,exc", [
    ("x_len", ValueError), ("values_shape", ValueError),
    ("labels_len", ValueError), ("ids_1d", ValueError),
    ("ids_int64", TypeError), ("mixed_floats", TypeError),
    ("float16", TypeError)])
def test_fused_wrapper_refuses(what, exc):
    a = _fused_args()
    if what == "x_len":
        a[0] = a[0][:-1]
    elif what == "values_shape":
        a[2] = a[2][:, :3]
    elif what == "labels_len":
        a[3] = a[3][:-1]
    elif what == "ids_1d":
        a[1] = a[1].reshape(-1)
    elif what == "ids_int64":
        a[1] = a[1].long()
    elif what == "mixed_floats":
        a[2] = a[2].float()
    elif what == "float16":
        a = _fused_args(torch.float16)
    with pytest.raises(exc, match="fe_loss_grad_fused"):
        fe.fe_loss_grad_fused(*a)
    assert fe.fe_loss_grad_fused.launches == 0


@pytest.mark.parametrize("what,exc", [
    ("theta_len", ValueError), ("values_shape", ValueError),
    ("weights_len", ValueError), ("ids_int64", TypeError),
    ("mixed_floats", TypeError)])
def test_hybrid_hot_wrapper_refuses(what, exc):
    n, k, a = 6, 4, 5
    f = lambda *s: torch.zeros(*s, dtype=torch.float32)
    args = [f(a), 0.0, torch.zeros(n, k, dtype=torch.int32), f(n, k), f(n),
            f(n), f(n), a]
    if what == "theta_len":
        args[0] = f(a + 1)
    elif what == "values_shape":
        args[3] = f(n, k + 1)
    elif what == "weights_len":
        args[5] = f(n + 1)
    elif what == "ids_int64":
        args[2] = args[2].long()
    elif what == "mixed_floats":
        args[4] = args[4].double()
    with pytest.raises(exc, match="fe_hybrid_hot"):
        fh.fe_hybrid_hot(*args)
    assert fh.fe_hybrid_hot.launches == 0
