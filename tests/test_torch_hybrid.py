"""Port parity of the wide-D fixed-effect hybrid (hot/cold feature split):
gdmix_tpu_torch's split builder, windowed layouts, the plain versions of its
two kernels (fe_hybrid_hot, windowed_scatter_add) and both hybrid
objectives against the JAX package's, with the JAX Pallas kernels run in
interpret mode, as tests/test_logistic_ops.py and
tests/test_fe_pallas_kernel.py run them; then FixedEffectLRModel fits
through grad_mode hybrid and pallas_hybrid. Inputs are made from a numpy
seed and handed to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.ops import logistic as jl
from gdmix_tpu.ops.pallas.fe_hybrid import fe_hybrid_hot_pallas
from gdmix_tpu.ops.pallas.windowed_scatter import windowed_scatter_add_pallas
from gdmix_tpu_torch.models import fixed_effect_lr as port_fe
from gdmix_tpu_torch.ops import fe_hybrid as fh
from gdmix_tpu_torch.ops import logistic as tl
from gdmix_tpu_torch.ops import windowed_scatter as ws
from gdmix_tpu_torch.io.input_pipeline import load_per_record as port_load
from test_fixed_effect_lr import _make_dataset
from test_torch_fixed_effect import _fit_both, _port_params

# float64 on both sides, the same math summed in another order (the bounds
# of JAX's own hybrid tests)
F64_RTOL, F64_GRAD_ATOL = 1e-12, 1e-10
# float32 windowed cold side against JAX's: the bound of JAX's own
# windowed-vs-flat test
WINDOWED_TOL = 1e-6
# JAX's K12 splits θ and v·r into two bf16 terms (~2^-17 relative): the
# bound of its own test against the plain objective
KERNEL_TOL = 3e-5
# float32 fits against float32 fits (JAX's hybrid fit tests hold them to
# the scipy oracle at the same bound)
F32_FIT_TOL = 5e-3


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _zipf(n=512, d=300, k=6, seed=0, dtype=np.float64, s=None):
    """Power-law padded COO (Zipf s=1 by default, or inverse-CDF Zipf(s)),
    ~20% zero-valued (padding) entries: the hybrid's regime."""
    rng = np.random.RandomState(seed)
    u = rng.rand(n, k)
    if s is None:
        idx = np.minimum(np.exp(u * np.log(d)).astype(int), d) - 1
    else:
        a = 1.0 - s
        idx = np.clip(((1.0 + u * (float(d) ** a - 1.0)) ** (1.0 / a))
                      .astype(int) - 1, 0, d - 1)
    vals = rng.randn(n, k)
    vals[rng.rand(n, k) < 0.2] = 0.0
    return dict(idx=idx.astype(np.int32), val=vals.astype(dtype),
                off=(0.1 * rng.randn(n)).astype(dtype),
                y=(rng.rand(n) < 0.5).astype(dtype),
                w=(rng.rand(n) + 0.5).astype(dtype))


_FIELDS = ("idx", "val", "off", "y", "w")


def _jbatch(dd):
    return jl.SparseBatch(*(jnp.asarray(dd[f]) for f in _FIELDS))


def _tbatch(dd):
    return tl.SparseBatch(*(torch.as_tensor(dd[f]) for f in _FIELDS))


def _assert_aux_equal(t_aux, j_aux):
    if j_aux is None:
        assert t_aux is None
        return
    for f in jl.HybridAux._fields:
        want = getattr(j_aux, f)
        got = getattr(t_aux, f)
        if f == "zs_nwin":
            assert got == (None if want is None else want.shape[0])
        elif want is None:
            assert got is None, f
        else:
            want = np.asarray(want)
            got = got.numpy()
            assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f)


BUILD_CASES = {
    # (data, build kwargs)
    "fixed": (dict(seed=31), dict(hot_features=32, cold_max_frac=0.9)),
    # the cost model's pick; many ids tie at counts 0 and 1, so the hot
    # set's order among ties shows
    "adaptive": (dict(n=4096, d=300_000, k=8, seed=2, s=1.2),
                 dict(hot_features=0, cold_max_frac=1.0)),
    "all_hot": (dict(n=256, k=5, seed=7),
                dict(hot_features=10_000, cold_max_frac=0.9)),
    "uniform_declines": (dict(n=256, k=5, seed=7),
                         dict(hot_features=8, cold_max_frac=0.3)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_hybrid_aux_equals_jax(case, dtype):
    data_kw, kw = BUILD_CASES[case]
    dd = _zipf(dtype=dtype, **data_kw)
    d = data_kw.get("d", 300)
    if case == "uniform_declines":
        dd["idx"] = np.random.RandomState(2).randint(
            0, d, dd["idx"].shape).astype(np.int32)
    j_aux = jl.build_hybrid_aux(jnp.asarray(dd["idx"]),
                                jnp.asarray(dd["val"]), d, **kw)
    t_aux = tl.build_hybrid_aux(torch.as_tensor(dd["idx"]),
                                torch.as_tensor(dd["val"]), d, **kw)
    _assert_aux_equal(t_aux, j_aux)
    if case == "uniform_declines":
        assert t_aux is None
    elif case == "fixed":
        assert int((t_aux.cold_val != 0).sum()) > 0
    elif case == "all_hot":
        assert int((t_aux.cold_val != 0).sum()) == 0
    else:
        assert t_aux.hot_ids.shape[0] in tl._HYBRID_A_CANDIDATES


@pytest.fixture(scope="module")
def windowed():
    """(data, D, JAX aux, port aux), windowed, from the windowed-cold test's
    data (tests/test_logistic_ops.py:526), float32."""
    n, d = 2048, 9000
    dd = _zipf(n=n, d=d, k=6, seed=0, dtype=np.float32)
    kw = dict(hot_features=32, cold_max_frac=1.0)
    j_aux = jl.extend_hybrid_aux_windowed(
        jl.build_hybrid_aux(jnp.asarray(dd["idx"]), jnp.asarray(dd["val"]),
                            d, **kw), d, n, tile_rows=8)
    t_aux = tl.extend_hybrid_aux_windowed(
        tl.build_hybrid_aux(torch.as_tensor(dd["idx"]),
                            torch.as_tensor(dd["val"]), d, **kw),
        d, n, tile_rows=8)
    return dd, d, j_aux, t_aux


def test_extend_hybrid_aux_windowed_equals_jax(windowed):
    _, _, j_aux, t_aux = windowed
    _assert_aux_equal(t_aux, j_aux)
    assert t_aux.gs_win.shape[0] > t_aux.zs_nwin > 0


def test_windowed_layout_equals_jax():
    """_windowed_layout on the JAX layout test's random keys
    (tests/test_logistic_ops.py:580), three windows."""
    rng = np.random.RandomState(9)
    mc, targets = 5000, 3 * tl.HYBRID_SCATTER_WINDOW
    key = rng.randint(0, targets, mc).astype(np.int32)
    val = rng.randn(mc).astype(np.float32)
    row = rng.randint(0, 100, mc).astype(np.int32)
    args = (targets, tl.HYBRID_SCATTER_WINDOW, 8)
    want = jl._windowed_layout(jnp.asarray(key), jnp.asarray(key),
                               jnp.asarray(row), jnp.asarray(val), *args)
    got = tl._windowed_layout(torch.as_tensor(key), torch.as_tensor(key),
                              torch.as_tensor(row), torch.as_tensor(val),
                              *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", ["gradient", "rows"])
def test_windowed_scatter_plain_matches_pallas(windowed, layout):
    """K13: the plain version against windowed_scatter_add_pallas in
    interpret mode, on the layout the split builds."""
    _, d, _, aux = windowed
    n = aux.hot_idx.shape[0]
    W = tl.HYBRID_SCATTER_WINDOW
    if layout == "gradient":
        idxl, win, nw = aux.gs_idxl, aux.gs_win, (d + W - 1) // W
        contrib = aux.gs_val * torch.as_tensor(
            np.random.RandomState(3).randn(n).astype(np.float32))[
            aux.gs_row.long()]
    else:
        idxl, win, nw = aux.zs_rowl, aux.zs_win, aux.zs_nwin
        contrib = aux.zs_val * torch.as_tensor(
            np.random.RandomState(4).randn(d).astype(np.float32))[
            aux.zs_idx.long()]
    tile_rows = idxl.shape[0] // win.shape[0]
    got = ws.windowed_scatter_add(idxl, contrib, win, nw, W, tile_rows)
    want = np.asarray(windowed_scatter_add_pallas(
        jnp.asarray(idxl.numpy()), jnp.asarray(contrib.numpy()),
        jnp.asarray(win.numpy()), num_windows=nw, window=W,
        tile_rows=tile_rows, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# 264: the kernel's grid on an H100 (132 SMs, two blocks each)
@pytest.mark.parametrize("blocks", [4, 64, 264])
@pytest.mark.parametrize("layout", ["gradient", "rows"])
def test_windowed_plan_reads_each_live_tile_once(windowed, layout, blocks):
    """The K13 kernel's plan (port only: JAX has none): its items read
    every tile holding a non-zero value exactly once and no other, each a
    run of at most T tiles of one window; every window has an item; a
    window's items beyond one share consecutive scratch rows and one
    counter; items come largest first."""
    _, d, _, aux = windowed
    W = tl.HYBRID_SCATTER_WINDOW
    if layout == "gradient":
        win, val, nw = aux.gs_win, aux.gs_val, (d + W - 1) // W
    else:
        win, val, nw = aux.zs_win, aux.zs_val, aux.zs_nwin
    plan = ws.windowed_plan(win, val, nw, W, blocks=blocks)
    items = plan.items.numpy()
    win = win.numpy()
    live = (val.reshape(win.shape[0], -1) != 0).any(1).numpy()
    reads = np.zeros(win.shape[0], int)
    for begin, end, w, part, first, parts, counter in items:
        assert 0 <= end - begin <= plan.tile_cap
        assert (win[begin:end] == w).all()
        reads[begin:end] += 1
        if part < 0:
            assert parts == 1
        else:
            assert parts > 1 and first <= part < first + parts
            assert 0 <= counter < plan.counters.shape[0] - 2
    np.testing.assert_array_equal(reads, live.astype(int))
    assert plan.tiles_read == live.sum()
    assert sorted(set(items[:, 2])) == list(range(nw))
    for w in range(nw):
        mine = items[items[:, 2] == w]
        if len(mine) > 1:
            assert sorted(mine[:, 3]) == list(range(mine[0, 4],
                                                    mine[0, 4] + len(mine)))
            assert len(set(mine[:, 6])) == 1
    sizes = items[:, 1] - items[:, 0]
    assert (np.diff(sizes) <= 0).all()
    assert plan.scratch.shape == ((items[:, 3] >= 0).sum(), W)
    assert int(plan.counters.abs().sum()) == 0


def test_windowed_plan_only_on_a_card(windowed):
    """Only the kernel reads a plan: the CPU build carries none, and a
    plan off a card must be told its blocks."""
    _, d, _, aux = windowed
    assert aux.gs_plan is None and aux.zs_plan is None
    with pytest.raises(ValueError, match="blocks"):
        ws.windowed_plan(aux.gs_win, aux.gs_val,
                         (d + tl.HYBRID_SCATTER_WINDOW - 1)
                         // tl.HYBRID_SCATTER_WINDOW,
                         tl.HYBRID_SCATTER_WINDOW)


@pytest.mark.parametrize("linear,has_intercept", [(False, True),
                                                  (True, True),
                                                  (False, False)])
def test_fe_hybrid_hot_plain_matches_pallas(linear, has_intercept):
    """K12: the plain version against fe_hybrid_hot_pallas in interpret
    mode on one split, float32."""
    dd = _zipf(seed=17, dtype=np.float32)
    a = 32
    aux = tl.build_hybrid_aux(torch.as_tensor(dd["idx"]),
                              torch.as_tensor(dd["val"]), 300,
                              hot_features=a, cold_max_frac=0.9)
    rng = np.random.RandomState(5)
    theta_c = (0.3 * rng.randn(a)).astype(np.float32)
    b = np.float32(0.2 if has_intercept else 0.0)
    y = dd["y"] + (0.3 * rng.randn(512).astype(np.float32) if linear else 0)
    args = (aux.hot_idx.numpy(), dd["val"], y, dd["w"], dd["off"])
    got = fh.fe_hybrid_hot(torch.as_tensor(theta_c), torch.as_tensor(b),
                           *(torch.as_tensor(x) for x in args), a,
                           linear=linear)
    want = fe_hybrid_hot_pallas(jnp.asarray(theta_c), jnp.asarray(b),
                                *(jnp.asarray(x) for x in args), hot=a,
                                linear=linear, tile=128, interpret=True)
    (lv, g, rs, r), (jlv, jg, jrs, jr) = got, [np.asarray(x) for x in want]
    np.testing.assert_allclose(float(lv), jlv, rtol=KERNEL_TOL)
    np.testing.assert_allclose(float(rs), jrs, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.abs(jr).sum())
    for t, j in ((g, jg), (r, jr)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=KERNEL_TOL * np.abs(j).max())


def test_fe_hybrid_hot_plain_matches_pallas_at_k39():
    """K12 at criteo's K = 39 (13 numeric ids in every row, 26 Zipf): the
    plain version against fe_hybrid_hot_pallas in interpret mode on one
    split, float32."""
    rng = np.random.RandomState(39)
    dd = _zipf(n=384, k=26, seed=39, dtype=np.float32, s=1.2)
    numeric = np.broadcast_to(np.arange(13, dtype=np.int32), (384, 13))
    idx = np.concatenate([numeric, dd["idx"] + 13], 1)
    val = np.concatenate([np.exp(rng.randn(384, 13)).astype(np.float32),
                          np.ones((384, 26), np.float32)], 1)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    aux = tl.build_hybrid_aux(torch.as_tensor(idx), torch.as_tensor(val),
                              313, hot_features=64, cold_max_frac=0.9)
    a = aux.hot_ids.shape[0]
    theta_c = (0.3 * rng.randn(a)).astype(np.float32)
    b = np.float32(-1.1)
    args = (aux.hot_idx.numpy(), val, dd["y"], dd["w"], dd["off"])
    got = fh.fe_hybrid_hot(torch.as_tensor(theta_c), torch.as_tensor(b),
                           *(torch.as_tensor(x) for x in args), a)
    want = fe_hybrid_hot_pallas(jnp.asarray(theta_c), jnp.asarray(b),
                                *(jnp.asarray(x) for x in args), hot=a,
                                tile=128, interpret=True)
    (lv, g, rs, r), (jlv, jg, jrs, jr) = got, [np.asarray(x) for x in want]
    assert aux.hot_idx.shape == (384, 39) and (aux.hot_idx == a).any()
    np.testing.assert_allclose(float(lv), jlv, rtol=KERNEL_TOL)
    np.testing.assert_allclose(float(rs), jrs, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.abs(jr).sum())
    for t, j in ((g, jg), (r, jr)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=KERNEL_TOL * np.abs(j).max())


_OBJ_CASES = [("logistic_regression", True), ("logistic_regression", False),
              ("linear_regression", True)]


def _objective_inputs(model_type, has_intercept, dtype, seed):
    d = 300
    dd = _zipf(seed=seed, dtype=dtype)
    if model_type == "linear_regression":
        dd["y"] = (dd["y"] + 0.3 * np.random.RandomState(3).randn(512)
                   ).astype(dtype)
    dim = d + (1 if has_intercept else 0)
    x = (0.3 * np.random.RandomState(4).randn(dim)).astype(dtype)
    return dd, d, x


@pytest.mark.parametrize("model_type,has_intercept", _OBJ_CASES)
def test_hybrid_objective_matches_jax(model_type, has_intercept):
    """fixed_effect_value_and_grad_hybrid against JAX's XLA hybrid in
    float64, both sides of the split active."""
    dd, d, x = _objective_inputs(model_type, has_intercept, np.float64, 31)
    kw = dict(hot_features=32, cold_max_frac=0.9)
    jb = _jbatch(dd)
    j_aux = jl.build_hybrid_aux(jb.indices, jb.values, d, **kw)
    jv, jg = jl.fixed_effect_value_and_grad_hybrid(
        jnp.asarray(x), jb, j_aux, d, chunk=128, has_intercept=has_intercept,
        model_type=model_type)
    tb = _tbatch(dd)
    t_aux = tl.build_hybrid_aux(tb.indices, tb.values, d, **kw)
    tv, tg = tl.fixed_effect_value_and_grad_hybrid(
        torch.as_tensor(x), tb, t_aux, d, has_intercept=has_intercept,
        model_type=model_type)
    assert tg.dtype == torch.float64
    np.testing.assert_allclose(float(tv), float(jv), rtol=F64_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=F64_GRAD_ATOL)
    # and the plain objective, which the split must not change
    pv, pg = tl.fixed_effect_value_and_grad(
        torch.as_tensor(x), tb, d, has_intercept=has_intercept,
        regularize_bias=True, l2_reg_weight=0.0, model_type=model_type)
    np.testing.assert_allclose(float(tv), float(pv), rtol=F64_RTOL)
    np.testing.assert_allclose(tg.numpy(), pg.numpy(), rtol=0,
                               atol=F64_GRAD_ATOL)


def test_hybrid_windowed_objective_matches_jax(windowed):
    """The windowed cold side (the plain K13 here, the Pallas K13 in
    interpret mode on the JAX side) in float32."""
    dd, d, j_aux, t_aux = windowed
    x = (0.1 * np.random.RandomState(0).randn(d + 1)).astype(np.float32)
    jv, jg = jl.fixed_effect_value_and_grad_hybrid(
        jnp.asarray(x), _jbatch(dd), j_aux, d, chunk=256, interpret=True)
    tv, tg = tl.fixed_effect_value_and_grad_hybrid(torch.as_tensor(x),
                                                   _tbatch(dd), t_aux, d)
    jg = np.asarray(jg)
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(float(tv), float(jv), rtol=WINDOWED_TOL)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=WINDOWED_TOL * np.abs(jg).max())
    # the flat cold side gives the same objective
    fv, fg = tl.fixed_effect_value_and_grad_hybrid(
        torch.as_tensor(x), _tbatch(dd), t_aux._replace(zs_win=None), d)
    np.testing.assert_allclose(float(tv), float(fv), rtol=WINDOWED_TOL)
    np.testing.assert_allclose(tg.numpy(), fg.numpy(), rtol=0,
                               atol=WINDOWED_TOL * np.abs(jg).max())


@pytest.mark.parametrize("model_type,has_intercept", _OBJ_CASES)
def test_hybrid_pallas_objective_matches_jax(model_type, has_intercept):
    """fixed_effect_value_and_grad_hybrid_pallas against JAX's (its K12 in
    interpret mode) in float32."""
    dd, d, x = _objective_inputs(model_type, has_intercept, np.float32, 17)
    kw = dict(hot_features=32, cold_max_frac=0.9)
    jb = _jbatch(dd)
    j_aux = jl.build_hybrid_aux(jb.indices, jb.values, d, **kw)
    jv, jg = jl.fixed_effect_value_and_grad_hybrid_pallas(
        jnp.asarray(x), jb, j_aux, d, has_intercept=has_intercept,
        model_type=model_type, tile=128, interpret=True)
    tb = _tbatch(dd)
    t_aux = tl.build_hybrid_aux(tb.indices, tb.values, d, **kw)
    tv, tg = tl.fixed_effect_value_and_grad_hybrid_pallas(
        torch.as_tensor(x), tb, t_aux, d, has_intercept=has_intercept,
        model_type=model_type)
    jg = np.asarray(jg)
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(float(tv), float(jv), rtol=KERNEL_TOL)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=KERNEL_TOL * np.abs(jg).max())


FIT_CASES = {
    # name: (grad_mode, params, tolerance against the JAX fit)
    "hybrid_f64": ("hybrid", dict(), 1e-6),
    "pallas_hybrid_f32": ("pallas_hybrid",
                          dict(dtype="float32", lbfgs_pgtol=1e-6),
                          F32_FIT_TOL),
    "hybrid_windowed_f32": ("hybrid",
                            dict(dtype="float32", lbfgs_pgtol=1e-6,
                                 hybrid_windowed_cold="on"), F32_FIT_TOL),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_matches_jax(tmp_path, case):
    """FixedEffectLRModel.fit_data through the hybrid modes, with half the
    features hot (both sides of the split active), against the JAX model's
    fit of the same mode."""
    mode, over, tol = FIT_CASES[case]
    over = dict(over, hot_features=3, hybrid_cold_max_frac=1.0,
                block_chunk_size=32)
    ds = _make_dataset(tmp_path, seed=29)
    jm, _, tm, bp = _fit_both(ds, mode, mode, **over)
    assert tm.last_fit["converged"] and tm.last_fit["funcalls"] > 1
    batch = tm._train_batch_cache[0]
    aux = tm.build_hybrid_aux_for(batch)
    assert aux is not None and int((aux.cold_val != 0).sum()) > 0
    assert (aux.zs_win is not None) == ("windowed" in case)
    np.testing.assert_allclose(tm.model_coefficients, jm.model_coefficients,
                               rtol=0, atol=tol)


def test_hybrid_aux_built_once_across_sweeps(tmp_path, monkeypatch):
    """The split depends only on indices/values, static across sweeps:
    sweep 2 reuses the cached HybridAux and still matches an uncached fit
    on the new offsets (the port of tests/test_device_cache.py:196)."""
    ds = _make_dataset(tmp_path, seed=45)
    mp, bp = _port_params(ds, grad_mode="hybrid", hot_features=3,
                          hybrid_cold_max_frac=1.0)
    model = port_fe.FixedEffectLRModel(mp, bp, device="cpu")
    data = port_load(ds["train_dir"], model.metadata, "global")
    builds = []
    orig = port_fe.build_hybrid_aux

    def spy(*a, **kw):
        builds.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(port_fe, "build_hybrid_aux", spy)
    cache = {}
    c1 = model.fit_data(data, bp, device_cache=cache)
    assert len(builds) == 1 and cache.get("hybrid_aux") is not None
    data.columns["offset"] = data.columns["offset"] + 0.3
    got = model.fit_data(data, bp, warm_start=c1, device_cache=cache)
    assert len(builds) == 1, "sweep 2 rebuilt the hybrid aux"
    want = model.fit_data(data, bp, warm_start=c1)
    assert len(builds) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
