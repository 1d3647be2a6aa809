"""The entity-sharded random-effect plane of the port
(RandomEffectLRModel.fit_records_sharded, re_mode="sharded"): records routed
over a mesh of eight `cpu` entries (the JAX tests' eight virtual CPU
devices) to the shard owning their entity, grouped and packed there, and
solved by the host plane's ladder. In float64 on the CPU, each case must
equal the port's host plane (fit_groups) model for model to 5e-6, JAX's own
bound (tests/test_sharded_re.py:75), and the JAX package's
fit_records_sharded on its 8-device mesh to 1e-8. Ports
tests/test_sharded_re.py, the sharded case of tests/test_device_cache.py,
and holds the streamed and fit_flat entries to the same plane."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import gdmix_tpu_torch.models.random_effect_lr as port_re
from gdmix_tpu.io.input_pipeline import EntityGroup
from gdmix_tpu.io.model_avro import SparseModel as JaxSparseModel
from gdmix_tpu.io.model_avro import load_sparse_models_from_avro
from gdmix_tpu.parallel.mesh import get_mesh as jax_get_mesh
from gdmix_tpu_torch.data.bucketing import FlatGroups
from gdmix_tpu_torch.io.input_pipeline import PerRecordData
from gdmix_tpu_torch.io.model_avro import SparseModel
from gdmix_tpu_torch.parallel.mesh import get_mesh
from test_random_effect_lr import (D, _build_model, _ctx, _make_groups,
                                   _write_dataset)
from test_sharded_re import _groups_to_records
from test_torch_random_effect import _torch_model

_HOST_TOL = 5e-6     # the sharded plane against the host plane (JAX's)
_JAX_TOL = 1e-8      # the port against the JAX package, float64 both


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _cpu_mesh(p=8):
    return get_mesh([torch.device("cpu")] * p)


def _port_records(data):
    return PerRecordData(columns=dict(data.columns), indices=data.indices,
                         values=data.values, nnz=data.nnz,
                         num_samples=data.num_samples)


def _port_prior(prior):
    return {k: SparseModel(model_id=v.model_id, theta=v.theta,
                           variance=v.variance,
                           unique_global_indices=v.unique_global_indices)
            for k, v in prior.items()}


def _dense(sm, width, field="theta"):
    """A SparseModel's theta (or variance) on the dense [1 + width] layout."""
    vec = np.asarray(getattr(sm, field))
    v = np.zeros(1 + width)
    v[0] = vec[0]
    if len(sm.unique_global_indices):
        v[1 + np.asarray(sm.unique_global_indices)] = vec[1:]
    return v


def _assert_models_close(got, want, atol, width=D):
    assert set(got) == set(want)
    for eid in want:
        np.testing.assert_array_equal(
            np.sort(got[eid].unique_global_indices),
            np.sort(want[eid].unique_global_indices), err_msg=eid)
        np.testing.assert_allclose(_dense(got[eid], width),
                                   _dense(want[eid], width), rtol=0,
                                   atol=atol, err_msg=f"entity {eid}")


def _fit_three(tmp_path, groups, prior=None, width=D, shards=8, **over):
    """(port host plane, port sharded plane, JAX sharded plane) on one
    written dataset; the port's mesh has `shards` cpu entries, JAX's that
    many of its devices."""
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups,
                                                      width=width)
    jm, jschema = _build_model(md_file, train_dir, feature_file,
                               tmp_path / "jax", **over)
    tm, tschema = _torch_model(md_file, train_dir, feature_file,
                               str(tmp_path / "torch"), **over)
    port_prior = _port_prior(prior or {})
    host = tm.fit_groups(groups, dict(port_prior), tschema)
    data = _groups_to_records(groups)
    got = tm.fit_records_sharded(_port_records(data), tschema,
                                 model_weights=dict(port_prior),
                                 mesh=_cpu_mesh(shards))
    assert tm.last_fit_plane == "sharded"
    assert tm.last_fit_converged == (len(groups), len(groups))
    want = jm.fit_records_sharded(
        data, jschema, model_weights=dict(prior or {}),
        mesh=jax_get_mesh(jax.devices()[:shards]))
    return host, got, want


def _check(host, got, want, width=D):
    _assert_models_close(got, host, _HOST_TOL, width)
    _assert_models_close(got, want, _JAX_TOL, width)


def test_sharded_equals_host_path(tmp_path):
    groups, _ = _make_groups(num_entities=23, seed=3)
    _check(*_fit_three(tmp_path, groups))


# every entity stops on ‖g‖∞ ≤ 1e-7 on the L-BFGS rungs: below that an
# L-BFGS step moves f by less than float64 resolves, and two packages'
# stopping tests may part (tests/test_torch_random_effect.py:208)
_STOP_ON_GRADIENT = dict(lbfgs_tolerance=0.0, lbfgs_pgtol=1e-7)


def test_sharded_equals_host_path_lbfgs(tmp_path):
    groups, _ = _make_groups(num_entities=11, seed=4)
    _check(*_fit_three(tmp_path, groups, batch_solver="lbfgs",
                       **_STOP_ON_GRADIENT))


def test_sharded_skewed_entity_sizes(tmp_path):
    """One giant entity (150 records) among five small ones: fewer entities
    than shards, so most shards own none in a tier."""
    rng = np.random.RandomState(9)
    groups, _ = _make_groups(num_entities=5, seed=5)
    n = 150
    ragged_i = [np.sort(rng.choice(D, rng.randint(1, D + 1), replace=False))
                for _ in range(n)]
    ragged_v = [rng.randn(len(r)) for r in ragged_i]
    y = rng.randint(0, 2, n).astype(np.float64)
    groups = groups + [EntityGroup(
        entity_id="99999",
        columns={"uid": np.arange(10_000, 10_000 + n, dtype=np.int64),
                 "response": y, "offset": np.zeros(n, np.float32),
                 "weight": np.ones(n, np.float32)},
        ragged_indices=ragged_i, ragged_values=ragged_v)]
    _check(*_fit_three(tmp_path, groups))


def test_sharded_warm_start_reconciliation(tmp_path):
    """A prior with out-of-support features and one for an entity absent
    from the data (a dict prior): reconciled as the host plane does, the
    prior-only entity carried forward untouched."""
    groups, _ = _make_groups(num_entities=9, seed=6)
    prior = {
        groups[0].entity_id: JaxSparseModel(
            model_id=groups[0].entity_id,
            theta=np.array([0.5, 0.3, -0.2]), variance=None,
            unique_global_indices=np.array([0, D - 1])),
        "ghost-entity": JaxSparseModel(
            model_id="ghost-entity", theta=np.array([1.0, 2.0]),
            variance=None, unique_global_indices=np.array([2])),
    }
    host, got, want = _fit_three(tmp_path, groups, prior=prior)
    np.testing.assert_array_equal(got["ghost-entity"].theta,
                                  prior["ghost-entity"].theta)
    _check(host, got, want)


def test_sharded_variance(tmp_path):
    """FULL variance: rtol 1e-5, atol 1e-8 against the host plane (JAX's
    bound), 1e-8 against JAX."""
    groups, _ = _make_groups(num_entities=7, seed=7)
    host, got, want = _fit_three(tmp_path, groups,
                                 random_effect_variance_mode="full")
    assert set(got) == set(host) == set(want)
    for eid in host:
        np.testing.assert_allclose(_dense(got[eid], D, "variance"),
                                   _dense(host[eid], D, "variance"),
                                   rtol=1e-5, atol=1e-8, err_msg=eid)
        np.testing.assert_allclose(_dense(got[eid], D, "variance"),
                                   _dense(want[eid], D, "variance"),
                                   rtol=0, atol=_JAX_TOL, err_msg=eid)
    _check(host, got, want)


def _heavy_tail_groups():
    rng = np.random.RandomState(13)
    sizes = [1, 2, 3, 5, 7, 9, 14, 17, 33, 40, 70, 90, 200]
    groups, uid = [], 0
    for e, n in enumerate(sizes):
        ragged_i = [np.sort(rng.choice(D, rng.randint(1, D + 1),
                                       replace=False)) for _ in range(n)]
        ragged_v = [rng.randn(len(r)) for r in ragged_i]
        y = rng.randint(0, 2, n).astype(np.float64)
        if n > 1 and y.min() == y.max():
            y[0], y[-1] = 0.0, 1.0
        groups.append(EntityGroup(
            entity_id=str(1000 + e),
            columns={"uid": np.arange(uid, uid + n, dtype=np.int64),
                     "response": y, "offset": 0.1 * rng.randn(n),
                     "weight": np.ones(n)},
            ragged_indices=ragged_i, ragged_values=ragged_v))
        uid += n
    return groups


def test_sharded_heavy_tail_tiers(tmp_path):
    """Sizes 1–200 span six power-of-two tiers; a warm start reconciles
    across them."""
    groups = _heavy_tail_groups()
    prior = {groups[0].entity_id: JaxSparseModel(
        model_id=groups[0].entity_id, theta=np.array([0.2, 0.1]),
        variance=None, unique_global_indices=np.array([1]))}
    host, got, want = _fit_three(tmp_path, groups, prior=prior)
    _check(host, got, want)


def test_sharded_single_device_mesh(tmp_path):
    """P = 1: the exchange moves nothing."""
    groups, _ = _make_groups(num_entities=4, seed=8)
    _check(*_fit_three(tmp_path, groups, shards=1))


def test_sharded_wide_support_dense_path(tmp_path):
    """A 141-wide global space (past newton_max_dim): local indexing keeps
    each entity's solve in its compact support (dim ≤ 13) and puts the
    coefficients back on the right global ids."""
    width = 140
    groups, _ = _make_groups(num_entities=9, seed=11, width=width,
                             max_support=12)
    host, got, want = _fit_three(tmp_path, groups, width=width)
    _check(host, got, want, width=width)


# ---- the sharded sweep cache ----------------------------------------------

def _cache_records(rng, E=37, N=400, K=3, width=40):
    return PerRecordData(
        columns={"user_id": np.array([str(e + 100) for e in
                                      rng.integers(0, E, N)], object),
                 "uid": np.arange(N, dtype=np.int64),
                 "response": rng.integers(0, 2, N).astype(np.float64),
                 "offset": rng.normal(size=N) * 0.1},
        indices=rng.integers(0, width, (N, K)).astype(np.int64),
        values=rng.normal(size=(N, K)), nnz=np.full(N, K, np.int64),
        num_samples=N)


def test_sharded_cached_refit_matches_uncached(tmp_path, monkeypatch):
    """A refit through device_cache["sharded"] routes only the offsets
    again, runs no second support extraction, uploads no static column, and
    equals the uncached refit bit for bit, and JAX's cached refit to 1e-8
    (tests/test_device_cache.py:115). Changed data rejects the cache."""
    from gdmix_tpu.io.input_pipeline import PerRecordData as JaxRecords
    rng = np.random.default_rng(41)
    width = 40
    data = _cache_records(rng, width=width)
    md_file, train_dir, feature_file = _write_dataset(
        tmp_path, _make_groups(num_entities=3, seed=1)[0], width=width)
    model, base = _torch_model(md_file, train_dir, feature_file,
                               str(tmp_path / "torch"))
    jm, jbase = _build_model(md_file, train_dir, feature_file,
                             tmp_path / "jax")
    mesh = _cpu_mesh()
    cache, jcache = {}, {}
    w1 = model.fit_records_sharded(data, base, mesh=mesh, device_cache=cache)
    assert "sharded" in cache and model.static_upload_count == 1
    jw1 = jm.fit_records_sharded(JaxRecords(**dataclasses.asdict(data)),
                                 jbase, device_cache=jcache)
    _assert_models_close(w1, jw1, _JAX_TOL, width)

    cols2 = dict(data.columns, offset=data.columns["offset"] + 0.3)
    data2 = dataclasses.replace(data, columns=cols2)
    calls = []
    orig = port_re.RandomEffectLRModel._entity_supports
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_entity_supports",
                        staticmethod(lambda *a, **k: calls.append(1)
                                     or orig(*a, **k)))
    want = model.fit_records_sharded(data2, base, model_weights=w1,
                                     mesh=mesh)
    assert len(calls) == 1
    calls.clear()
    got = model.fit_records_sharded(data2, base, model_weights=w1,
                                    mesh=mesh, device_cache=cache)
    assert calls == [] and model.static_upload_count == 1
    assert list(got.ids) == list(want.ids)
    np.testing.assert_array_equal(got.coef_vals, want.coef_vals)
    np.testing.assert_array_equal(got.icpt, want.icpt)
    jgot = jm.fit_records_sharded(
        JaxRecords(**dataclasses.asdict(data2)), jbase,
        model_weights=dict(jw1), device_cache=jcache)
    _assert_models_close(got, jgot, _JAX_TOL, width)

    # another entity mix: the cache is rejected (and refilled)
    cols3 = dict(data.columns, user_id=np.array(
        [str(e + 100) for e in rng.integers(0, 42, data.num_samples)],
        object))
    data3 = dataclasses.replace(data, columns=cols3)
    want3 = model.fit_records_sharded(data3, base, mesh=mesh)
    got3 = model.fit_records_sharded(data3, base, mesh=mesh,
                                     device_cache=cache)
    assert model.static_upload_count == 2
    assert list(got3.ids) == list(want3.ids)
    np.testing.assert_array_equal(got3.coef_vals, want3.coef_vals)


# ---- the entry points: fit_flat and train() --------------------------------

def _flat(groups, order):
    """The groups as a port FlatGroups, entities in `order`."""
    gs = [groups[i] for i in order]
    K = max(len(ix) for g in gs for ix in g.ragged_indices)
    return FlatGroups(
        entity_ids=np.array([g.entity_id for g in gs], object),
        counts=np.array([len(g.columns["response"]) for g in gs], np.int64),
        columns={k: np.concatenate([g.columns[k] for g in gs])
                 for k in gs[0].columns},
        indices=np.vstack([np.array([np.pad(ix, (0, K - len(ix)))
                                     for ix in g.ragged_indices], np.int32)
                           for g in gs]),
        values=np.vstack([np.array([np.pad(v, (0, K - len(v)))
                                    for v in g.ragged_values])
                          for g in gs]),
        rec_nnz=np.concatenate([np.array([len(ix) for ix in
                                          g.ragged_indices], np.int32)
                                for g in gs]))


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_fit_flat_sharded_equals_host(tmp_path, monkeypatch, order):
    """fit_flat with re_mode="sharded" (P = 8, the pre-grouped entry that
    hands each entity's record run to the native support dedup) against
    the host plane, with the entities in sorted order and shuffled. The
    JAX package's fit_flat takes the runs in its sorted-id order whatever
    the FlatGroups' order (gdmix_tpu/models/random_effect_lr.py:1097-1102),
    so it is not the reference for the shuffled case (ROADMAP C.13)."""
    groups, _ = _make_groups(num_entities=23, seed=3)
    perm = (np.arange(23) if order == "sorted"
            else np.random.RandomState(0).permutation(23))
    fg = _flat(groups, perm)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "m"), re_mode="sharded")
    monkeypatch.setattr(port_re, "get_mesh", lambda device=None: _cpu_mesh())
    got = model.fit_flat(fg, {}, schema)
    assert model.last_fit_plane == "sharded"
    model.model_params.re_mode = "host"
    host = model.fit_flat(fg, {}, schema)
    assert model.last_fit_plane == "host"
    _assert_models_close(got, host, _HOST_TOL)


def _train_sharded(tmp_path, groups, sub, **over):
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / sub),
                                 **dict(dict(re_mode="sharded"), **over))
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp_path / sub), schema)
    return model, load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"),
        feature_file)


def test_streamed_train_sharded_equals_eager(tmp_path, monkeypatch):
    """train() with re_mode="sharded" over an 8-entry mesh, eagerly and in
    chunks of 4 entities (stream_chunk_entities): each chunk's fit_flat
    takes the sharded plane; the models agree to 1e-9, and with the eager
    host plane to 5e-6."""
    monkeypatch.setattr(port_re, "get_mesh", lambda device=None: _cpu_mesh())
    groups, _ = _make_groups(num_entities=23, seed=21)
    planes = []
    orig = port_re.RandomEffectLRModel.fit_records_sharded
    monkeypatch.setattr(port_re.RandomEffectLRModel, "fit_records_sharded",
                        lambda self, *a, **k: planes.append(1)
                        or orig(self, *a, **k))
    _, eager = _train_sharded(tmp_path, groups, "eager")
    assert len(planes) == 1
    m, streamed = _train_sharded(tmp_path, groups, "stream",
                                 stream_chunk_entities=4)
    assert len(planes) == 1 + 6 and m.last_fit_converged == (23, 23)
    _assert_models_close(streamed, eager, 1e-9)
    _, host = _train_sharded(tmp_path, groups, "host", re_mode="host")
    assert len(planes) == 7
    _assert_models_close(eager, host, _HOST_TOL)
