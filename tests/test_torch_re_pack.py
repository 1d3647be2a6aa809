"""The random-effect marshal on the model's device (ops/re_pack.py, the
packed route of RandomEffectLRModel.fit_groups), on the CPU through the
plain versions of its two passes.

Every tier tensor the solvers take must equal, bit for bit, what the host
bucketizer (data/bucketing.py iter_bucketize_flat) and
util/convert.py newton_inputs_from_numpy give on the same partition:
indices, values, labels, weights, offsets, sample counts and θ0, in dtype
and shape, with the same tiers, members, slot order and u_cap, and the
supports the collection reads back equal to the bucketizer's padded ones.
The cases: a pareto fleet whose heavy tail reaches n_cap ≥ 256, duplicate
ids within a record and an entity, zero-nnz records, an entity with no
live entry and one with no record, no nnz column (every entry live), a
weight column, float64, warm starts from a ModelTable and from a dict, and
the sweep cache's hit (only the offsets packed again). The fit's
ModelTable must then equal the host bucketizer's route entry for entry."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import gdmix_tpu_torch.models.random_effect_lr as port_re
from gdmix_tpu_torch.data.bucketing import FlatGroups, iter_bucketize_flat
from gdmix_tpu_torch.io.model_table import ModelTable
from gdmix_tpu_torch.ops import re_pack
from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy

D = 40          # the feature bag's width
_COLS = port_re._STATIC_COLS + port_re._DYNAMIC_COLS


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def fleet(seed, counts, K=4, nnz=True, weights=False):
    """A FlatGroups over entities of `counts` records: K entries a record,
    ids drawn with replacement from D (duplicates within a record and an
    entity), 0 to K of them live (nnz; with nnz False every entry is), a
    tenth of the live values exactly 0; the padding entries hold an id and
    a value that must not be read. Entity 1 has no live entry."""
    rng = np.random.RandomState(seed)
    counts = np.asarray(counts, np.int64)
    N, E = int(counts.sum()), len(counts)
    nz = rng.randint(0, K + 1, N).astype(np.int32)
    nz[counts[0]:counts[0] + counts[1]] = 0
    idx = rng.randint(0, D, (N, K)).astype(np.int32)
    val = rng.randn(N, K)
    val[rng.rand(N, K) < 0.1] = 0.0
    if nnz:
        pad = np.arange(K)[None, :] >= nz[:, None]
        idx[pad], val[pad] = D + 7, 5.0
    cols = {"uid": np.arange(N, dtype=np.int64),
            "response": (rng.rand(N) < 0.4).astype(np.float64),
            "offset": 0.1 * rng.randn(N)}
    if weights:
        cols["weight"] = rng.rand(N) + 0.5
    return FlatGroups(entity_ids=np.array([f"e{i}" for i in range(E)],
                                          object),
                      counts=counts, columns=cols, indices=idx, values=val,
                      rec_nnz=nz if nnz else None)


def _pareto_counts(seed, E, hi):
    rng = np.random.RandomState(seed)
    return np.minimum((rng.pareto(1.2, E) * 8 + 2).astype(np.int64), hi)


def _model(tmp_path, dtype="float32", weights=False):
    model, schema = chip_smoke.stage_model(D, str(tmp_path), dtype=dtype,
                                           device="cpu")
    if weights:
        schema = dataclasses.replace(schema, weight_column_name="weight")
    return model, schema


def _captured(monkeypatch):
    """(tier, arrays) of each solve the fit queues."""
    seen = []
    inner = port_re.RandomEffectLRModel._launch

    def spy(self, bucket, arrays, pending, rungs):
        seen.append((bucket, dict(arrays)))
        return inner(self, bucket, arrays, pending, rungs)
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_launch", spy)
    return seen


def _host_route(monkeypatch):
    """The fit's marshal through the host bucketizer, as before the packed
    route: iter_bucketize_flat's buckets, each uploaded."""
    def marshal(self, fg, weights, schema, cache, pending, rungs):
        self._marshal_buckets(iter_bucketize_flat, fg, weights, schema,
                              cache, pending, rungs)
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_marshal_packed",
                        marshal)
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_packed_supports",
                        lambda self, pack, tiers: None)


def _assert_tiers_equal(seen, fg, model, schema, prior):
    want = list(iter_bucketize_flat(fg, schema, "offset", has_intercept=True,
                                    prior_models=prior))
    assert [len(b.entity_ids) for b in want] \
        == [len(t.entity_ids) for t, _ in seen]
    for b, (t, got) in zip(want, seen):
        ref = newton_inputs_from_numpy({k: getattr(b, k) for k in _COLS},
                                       "cpu", model.dtype)
        for k in _COLS:
            assert got[k].dtype == ref[k].dtype, k
            assert got[k].shape == ref[k].shape, k
            assert torch.equal(got[k], ref[k]), k
        br = len(b.entity_ids)
        assert list(t.entity_ids) == list(b.entity_ids)
        assert (t.n_cap, t.u_cap) == (b.n_cap, b.u_cap)
        np.testing.assert_array_equal(t.u_count, b.u_count[:br])
        mask = np.arange(b.u_cap)[None, :] < b.u_count[:br, None]
        np.testing.assert_array_equal(t.support,
                                      b.unique_global_indices[:br][mask])
        if prior:
            np.testing.assert_array_equal(t.theta0, b.theta0)
    return want


def _assert_tables_equal(got, want):
    assert list(got.ids) == list(want.ids)
    for f in ("offs", "coef_ids", "coef_vals", "icpt"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


CASES = {
    # (counts, fleet kwargs, model kwargs)
    "pareto_heavy_tail": (lambda: _pareto_counts(1, 400, 600), {}, {}),
    "all_live_float64": (lambda: _pareto_counts(2, 150, 40), {"nnz": False},
                         {"dtype": "float64"}),
    "weights_empty_entities": (
        lambda: np.concatenate([[5, 3, 0], _pareto_counts(3, 120, 70)]),
        {"weights": True}, {"weights": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("prior", [None, "table", "dict"])
def test_packed_tiers_equal_host_bucketizer(tmp_path, monkeypatch, case,
                                            prior):
    counts, fkw, mkw = CASES[case]
    fg = fleet(7, counts(), **fkw)
    model, schema = _model(tmp_path, **mkw)
    weights = {}
    if prior:
        cold = model.fit_flat(fg, {}, schema)
        # a prior that misses some of these entities and holds another
        other = ModelTable(ids=np.array(["other"], object), offs=[0, 2],
                           coef_ids=[0, 3], coef_vals=[0.5, -0.25],
                           icpt=[0.1])
        weights = ModelTable.concat(
            [cold.select_rows(np.flatnonzero(np.arange(len(cold)) % 3)),
             other], has_intercept=True, with_variance=False)
        if prior == "dict":
            weights = dict(weights)
    seen = _captured(monkeypatch)
    got = model.fit_flat(fg, weights, schema)
    want = _assert_tiers_equal(seen, fg, model, schema, weights)
    if case == "pareto_heavy_tail":
        assert max(b.n_cap for b in want) >= 256
    monkeypatch.undo()
    _host_route(monkeypatch)
    _assert_tables_equal(got, model.fit_flat(fg, weights, schema))


def test_cache_hit_packs_offsets_only(tmp_path, monkeypatch):
    """A refit on new offsets through the sweep cache: no static column
    crosses again (static_upload_count unchanged, bytes up only the
    offsets, the maps and θ0), the solver's tensors equal the host
    bucketizer's on the new offsets, and so does the fit."""
    fg = fleet(8, _pareto_counts(4, 300, 300))
    model, schema = _model(tmp_path)
    cache = {}
    w1 = model.fit_flat(fg, {}, schema, device_cache=cache)
    n_tiers = len(cache)
    assert n_tiers > 1 and model.static_upload_count == n_tiers
    fg2 = dataclasses.replace(fg, columns=dict(
        fg.columns, offset=fg.columns["offset"] + 0.25))
    seen = _captured(monkeypatch)
    got = model.fit_flat(fg2, w1, schema, device_cache=cache)
    assert model.static_upload_count == n_tiers
    E = len(fg.counts)
    theta0 = sum(a["theta0"].numel() * 4 for _, a in seen)
    assert model.last_fit_bytes_up == fg.columns["offset"].nbytes \
        + E * (4 + 8 + 4) + theta0
    _assert_tiers_equal(seen, fg2, model, schema, w1)
    monkeypatch.undo()
    _host_route(monkeypatch)
    _assert_tables_equal(got, model.fit_flat(fg2, w1, schema))


def test_supports_plain_matches_a_loop():
    """Pass 1's plain version against a loop over the entities: sorted
    distinct live ids at starts·K, their counts, the largest nnz (raw, so
    past K too), and each tier's maxima."""
    counts = np.array([3, 0, 5, 1, 9, 2])
    fg = fleet(3, counts, K=3)
    nz = fg.rec_nnz.copy()
    nz[4] = 6                                       # past K: still K live
    starts = np.cumsum(counts) - counts
    tier_of = np.array([0, 1, 0, 1, 1, 0], np.int32)
    t = torch.as_tensor
    sup = re_pack.re_supports(t(fg.indices), t(nz), t(counts.astype(np.int32)),
                              t(starts), t(tier_of), 2, None)
    for e, (s, c) in enumerate(zip(starts, counts)):
        live = np.arange(3)[None, :] < nz[s:s + c, None]
        ids = np.unique(fg.indices[s:s + c][live])
        assert sup.u_count[e] == len(ids)
        np.testing.assert_array_equal(
            sup.uniq[s * 3:s * 3 + len(ids)].numpy(), ids)
        assert sup.max_nnz[e] == (nz[s:s + c].max() if c else 0)
    for tier in (0, 1):
        e = tier_of == tier
        assert sup.tier_max[tier, 0] == np.maximum(sup.u_count.numpy()[e],
                                                   1).max()
        assert sup.tier_max[tier, 1] == sup.max_nnz.numpy()[e].max()


def test_block_path_lists():
    """Pass 1's block path: the entities past WARP_KEYS entries, their
    keys in shared memory up to BLOCK_KEYS, past that at offsets of a
    workspace of their next powers of two."""
    K = 4
    counts = np.array([64, 65, 1024, 1025, 3, 5000])
    ents, ws_off, size = re_pack.block_path(counts, K)
    np.testing.assert_array_equal(ents, [1, 2, 3, 5])
    np.testing.assert_array_equal(ws_off, [-1, -1, 0, 8192])
    assert size == 8192 + 32768

