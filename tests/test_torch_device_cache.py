"""The random-effect multi-sweep device cache and the warm-sweep downlink
skip in the port (RandomEffectLRModel.fit_groups' device_cache, which
_marshal_packed keeps under ("flat", tier); _bucket_moved), against the
port's uncached path and the JAX package's cached one, in float64 on the
CPU. Ports tests/test_device_cache.py (its sharded test is in
tests/test_torch_sharded_re.py) and tests/test_warm_downlink_skip.py."""
import copy

import numpy as np
import pytest
import torch

import gdmix_tpu_torch.models.random_effect_lr as port_re
from gdmix_tpu_torch.ops import re_pack
from gdmix_tpu_torch.ops.newton import newton_lr_batch
from gdmix_tpu_torch.ops.newton_lanes import (newton_full_plain,
                                              newton_lr_batch_lanes)
from test_random_effect_lr import _build_model, _make_groups, _write_dataset
from test_torch_random_effect import _torch_model

_JAX_TOL = 1e-8


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _perturb_offsets(groups, delta):
    out = copy.deepcopy(groups)
    for g in out:
        g.columns["offset"] = g.columns["offset"] + delta
    return out


def _setup(tmp_path, num_entities, seed, **over):
    groups, _ = _make_groups(num_entities=num_entities, seed=seed)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "torch"), **over)
    return groups, (md_file, train_dir, feature_file), model, schema


def _assert_tables_close(got, want, rtol, atol):
    assert set(got) == set(want)
    for eid in want:
        np.testing.assert_allclose(np.asarray(got[eid].theta),
                                   np.asarray(want[eid].theta), rtol=rtol,
                                   atol=atol, err_msg=eid)


def _spy_uploads(monkeypatch):
    """What a fit moves to the device: `upload`, each copy of the flat
    columns (FlatPack.upload's `static`: False, the offsets and the maps
    that pack them); `tier`, the tensors each tier's pack makes
    (FlatPack.tier; with `static` False only the offsets); `theta0`, the
    columns of each upload from the host (a prior's θ0)."""
    seen = {"upload": [], "tier": [], "theta0": []}
    upload, tier = re_pack.FlatPack.upload, re_pack.FlatPack.tier
    orig = port_re.newton_inputs_from_numpy

    def upload_spy(self, static=True):
        seen["upload"].append(static)
        return upload(self, static=static)

    def tier_spy(self, i, static=True):
        out = tier(self, i, static=static)
        seen["tier"].append(frozenset(out))
        return out

    def theta0_spy(arrays, device, dtype):
        seen["theta0"].append(frozenset(arrays))
        return orig(arrays, device, dtype)

    monkeypatch.setattr(re_pack.FlatPack, "upload", upload_spy)
    monkeypatch.setattr(re_pack.FlatPack, "tier", tier_spy)
    monkeypatch.setattr(port_re, "newton_inputs_from_numpy", theta0_spy)
    return seen


def test_cached_refit_matches_uncached_and_jax(tmp_path, monkeypatch):
    """Sweep 2 on new offsets through the cache: the static columns stay on
    the device (no upload of them, static_upload_count unchanged), only
    offsets and θ0 cross, and the result equals the uncached refit and the
    JAX package's cached refit."""
    groups, files, model, schema = _setup(tmp_path, 9, 31)
    cache = {}
    w1 = model.fit_groups(groups, {}, schema, device_cache=cache)
    n_buckets = len(cache)
    assert n_buckets and model.static_upload_count == n_buckets

    groups2 = _perturb_offsets(groups, 0.25)
    want = model.fit_groups(groups2, w1, schema)
    seen = _spy_uploads(monkeypatch)
    got = model.fit_groups(groups2, w1, schema, device_cache=cache)
    assert model.static_upload_count == n_buckets
    assert seen["upload"] == [False]
    assert seen["tier"] == [frozenset({"offsets"})] * n_buckets
    assert seen["theta0"] == [frozenset({"theta0"})] * n_buckets
    _assert_tables_close(got, want, rtol=1e-12, atol=1e-13)

    jm, jschema = _build_model(*files, tmp_path / "jax")
    jcache = {}
    jw1 = jm.fit_groups(groups, {}, jschema, device_cache=jcache)
    jgot = jm.fit_groups(groups2, dict(jw1), jschema, device_cache=jcache)
    assert jm.static_upload_count == len(jcache) == n_buckets
    _assert_tables_close(got, jgot, rtol=0, atol=_JAX_TOL)


def test_changed_data_rejects_cache(tmp_path, monkeypatch):
    """An entry from other data (entities, shapes, counts) is not used: the
    flat columns upload whole, each tier packs whole into the cache (θ0,
    a cold fit's zeros, made on the device), and the result is the
    uncached one."""
    groups, files, model, schema = _setup(tmp_path, 9, 32)
    cache = {}
    model.fit_groups(groups, {}, schema, device_cache=cache)
    before = model.static_upload_count
    groups2, _ = _make_groups(num_entities=7, seed=33)
    want = model.fit_groups(groups2, {}, schema)
    seen = _spy_uploads(monkeypatch)
    got = model.fit_groups(groups2, {}, schema, device_cache=cache)
    assert model.static_upload_count - before == len(seen["tier"]) > 0
    assert seen["upload"] == [True] and seen["theta0"] == []
    assert all(cols == frozenset(port_re._STATIC_COLS + ("offsets",))
               for cols in seen["tier"])
    _assert_tables_close(got, want, rtol=1e-12, atol=1e-13)


def test_cache_is_keyed_by_bucket_and_counts(tmp_path):
    """The same entities under another count are a miss: a hit needs the
    tier's sample cap, B, entity ids and sample counts."""
    groups, _, model, schema = _setup(tmp_path, 9, 34)
    cache = {}
    model.fit_groups(groups, {}, schema, device_cache=cache)
    before = model.static_upload_count
    fewer = copy.deepcopy(groups)
    g = fewer[0]
    g.columns = {k: v[:-1] for k, v in g.columns.items()}
    g.ragged_indices, g.ragged_values = (g.ragged_indices[:-1],
                                         g.ragged_values[:-1])
    model.fit_groups(fewer, {}, schema, device_cache=cache)
    assert model.static_upload_count > before


def test_pipeline_multi_sweep_uses_cache(tmp_path, monkeypatch):
    """A 2-sweep in-memory pipeline: sweep 2's RE fits upload no static
    column, and every coordinate's AUC equals an uncached run's."""
    from gdmix_tpu.data import movielens
    from gdmix_tpu_torch.workflow.pipeline import run_gdmix_in_memory
    from test_torch_pipeline import _config_dict
    from gdmix_tpu_torch.workflow.config import WorkflowConfig
    root = str(tmp_path / "ml")
    ml = movielens.prepare_gdmix_data(root, movielens.generate_synthetic(
        num_users=40, num_movies=50, num_ratings=1500, seed=9))
    RE = port_re.RandomEffectLRModel
    orig = RE.fit_groups
    calls = []

    def recorded(self, groups, weights, schema, device_cache=None):
        before = self.static_upload_count
        out = orig(self, groups, weights, schema, device_cache=device_cache)
        calls.append((id(self), device_cache is not None,
                      self.static_upload_count - before))
        return out

    monkeypatch.setattr(RE, "fit_groups", recorded)
    cached = run_gdmix_in_memory(WorkflowConfig.from_dict(
        _config_dict(ml, str(tmp_path / "cached"))), num_sweeps=2,
        device="cpu")
    models = sorted({c[0] for c in calls})
    assert len(models) == 2 and len(calls) == 4
    for m in models:
        (c1, up1), (c2, up2) = [(c, u) for i, c, u in calls if i == m]
        assert c1 and c2 and up1 > 0 and up2 == 0

    monkeypatch.setattr(RE, "fit_groups",
                        lambda self, g, w, s, device_cache=None:
                        orig(self, g, w, s))
    uncached = run_gdmix_in_memory(WorkflowConfig.from_dict(
        _config_dict(ml, str(tmp_path / "uncached"))), num_sweeps=2,
        device="cpu")
    assert set(cached) == set(uncached) == {"global", "per-user",
                                            "per-movie"}
    for name in cached:
        assert abs(cached[name] - uncached[name]) <= 1e-12, name


# ---- the warm-sweep downlink skip -----------------------------------------

def _spy_probe(monkeypatch):
    reads = []
    orig = port_re._moved_flags

    def spy(solved):
        out = orig(solved)
        reads.append(out)
        return out

    monkeypatch.setattr(port_re, "_moved_flags", spy)
    return reads


def test_unmoved_warm_refit_skips_and_matches(tmp_path, monkeypatch):
    """A warm refit on unchanged data, from a prior that converged at the
    gradient test, moves no bucket: one probe read for the fit, every
    bucket rebuilt from its host θ0, rows equal to the prior's, and the
    JAX package's warm refit the same. Changed data retrains."""
    groups, files, model, schema = _setup(
        tmp_path, 10, 17, lbfgs_pgtol=1e-6, lbfgs_tolerance=1e-12)
    cold = model.fit_groups(groups, {}, schema)
    assert model.last_fit_skipped == 0
    reads = _spy_probe(monkeypatch)
    warm = model.fit_groups(groups, cold, schema)
    assert len(reads) == 1 and reads[0] and not any(reads[0])
    assert model.last_fit_skipped == len(reads[0])
    assert list(warm.ids) == list(cold.ids)
    np.testing.assert_array_equal(warm.coef_vals, cold.coef_vals)
    np.testing.assert_array_equal(warm.icpt, cold.icpt)

    jm, jschema = _build_model(*files, tmp_path / "jax", lbfgs_pgtol=1e-6,
                               lbfgs_tolerance=1e-12)
    jcold = jm.fit_groups(groups, {}, jschema)
    jwarm = jm.fit_groups(groups, dict(jcold), jschema)
    _assert_tables_close(warm, jwarm, rtol=0, atol=_JAX_TOL)

    reads.clear()
    groups2, _ = _make_groups(num_entities=10, seed=18)
    again = model.fit_groups(groups2, cold, schema)
    assert len(reads) == 1 and any(reads[0])
    assert model.last_fit_skipped == reads[0].count(False)
    assert set(again) >= set(cold)


def test_skip_needs_a_prior_and_no_variance(tmp_path, monkeypatch):
    """The probe runs only with variance_mode None and a non-empty prior,
    as in the JAX package."""
    groups, files, model, schema = _setup(tmp_path, 8, 19)
    reads = _spy_probe(monkeypatch)
    cold = model.fit_groups(groups, {}, schema)
    assert reads == []
    vmodel, _ = _torch_model(*files, str(tmp_path / "v"),
                             random_effect_variance_mode="simple")
    vmodel.fit_groups(groups, cold, schema)
    assert reads == [] and vmodel.last_fit_skipped == 0


def _lanes_problem(B=64, n=16, dim=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, n, dim).astype(np.float32) * 0.7
    X[:, :, 0] = 1.0
    y = (rng.rand(B, n) < 0.5).astype(np.float32)
    y[:, 0], y[:, 1] = 1.0, 0.0
    w = np.ones((B, n), np.float32)
    off = (0.2 * rng.randn(B, n)).astype(np.float32)
    cnt = np.full(B, n, np.float32)
    return [torch.as_tensor(a) for a in (X, y, w, off, cnt)]


def test_plain_lanes_solve_returns_theta0_bitwise_at_gradient_test():
    """newton_full_plain (the CPU route of both lanes kernels) leaves θ0
    bit for bit where the gradient test passes before the first step: a
    restart from a solve's own result moves none of the entities that
    stopped there, and iterations stay 0."""
    X, y, w, off, cnt = _lanes_problem()
    kw = dict(lam=1.0, unreg_bias=True, maxiter=100, ftol=0.0, pgtol=1e-4)
    th, conv, _ = newton_full_plain(torch.zeros(X.shape[0], X.shape[2]),
                                    X, y, w, off, cnt, **kw)
    assert bool(conv.all())
    th2, conv2, it2 = newton_full_plain(th, X, y, w, off, cnt, **kw)
    at_start = it2 == 0
    assert int(at_start.sum()) == X.shape[0]
    assert torch.equal(th2, th)
    assert not bool(port_re._bucket_moved(th2, th))


def test_float64_model_always_moves_through_the_lanes():
    """The lanes solve runs in float32, so a float64 θ0 that float32 does
    not hold exactly comes back changed even when no step is taken: the
    probe says moved, and the skip never fires for a float64 model on
    the card."""
    X, y, w, off, cnt = _lanes_problem(B=8)
    th0 = torch.full((8, X.shape[2]), 0.1, dtype=torch.float64)
    res = newton_lr_batch_lanes(th0, X.double(), y, w, off, cnt,
                                l2_reg_weight=1.0, unreg_bias=True,
                                maxiter=0, ftol=0.0, pgtol=1e-4)
    assert res.theta.dtype == torch.float64
    assert bool(port_re._bucket_moved(res.theta, th0))
    # the float64 batch-major loop keeps θ0 exactly for a solve that takes
    # no step
    mask = torch.ones(X.shape[2], dtype=torch.float64)
    res64 = newton_lr_batch(th0, X.double(), y.double(), w.double(),
                            off.double(), cnt.double(), l2_reg_weight=1.0,
                            l2_mask=mask, maxiter=0)
    assert not bool(port_re._bucket_moved(res64.theta, th0))
