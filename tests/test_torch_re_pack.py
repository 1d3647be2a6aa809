"""The random-effect marshal on the model's device (ops/re_pack.py, the
one route of RandomEffectLRModel.fit_groups), on the CPU through the
plain versions of its two passes.

Every tier tensor the solvers take must equal, bit for bit, what the host
bucketizer (data/bucketing.py: iter_bucketize_flat for a FlatGroups,
bucketize for a List[EntityGroup]) and util/convert.py
newton_inputs_from_numpy give on the same partition: indices, values,
labels, weights, offsets, sample counts and θ0, in dtype and shape, with
the same tiers, members, slot order and u_cap, and the supports the
collection reads back equal to the bucketizer's padded ones. The cases: a
pareto fleet whose heavy tail reaches n_cap ≥ 256, duplicate ids within a
record and an entity, zero-nnz records, an entity with no live entry and
one with no record, no nnz column (every entry live), a weight column,
float64, warm starts from a ModelTable and from a dict, and the sweep
cache's hit (only the offsets packed again); the object path's ragged,
padded and mixed groups, with no offset column or no intercept; a
FlatGroups without a feature block. The fit's ModelTable must then equal
the host bucketizer's route entry for entry."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import gdmix_tpu_torch.models.random_effect_lr as port_re
from gdmix_tpu_torch.data.bucketing import (FlatGroups, bucketize,
                                            iter_bucketize_flat)
from gdmix_tpu_torch.io.input_pipeline import EntityGroup
from gdmix_tpu_torch.io.model_table import ModelTable
from gdmix_tpu_torch.ops import re_pack
from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy

D = 40          # the feature bag's width
_COLS = port_re._STATIC_COLS + ("offsets", "theta0")


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


def entity_groups(fg, form):
    """fg's entities as a List[EntityGroup]: "ragged", each record's live
    entries as arrays (an entity with no live entry lists no record, as
    the loader gives a group without features); "padded", the [n, K]
    block and its nnz as they are; "mixed", the two in turn."""
    counts = np.asarray(fg.counts, np.int64)
    starts = np.cumsum(counts) - counts
    nz = fg.rec_nnz
    groups = []
    for e, (s, n) in enumerate(zip(starts, counts)):
        rows = slice(s, s + n)
        g = EntityGroup(entity_id=fg.entity_ids[e],
                        columns={k: v[rows] for k, v in fg.columns.items()})
        if form == "padded" or (form == "mixed" and e % 2):
            g.padded_indices, g.padded_values = fg.indices[rows], \
                fg.values[rows]
            g.rec_nnz = nz[rows]
        elif nz[rows].any():
            g.ragged_indices = [fg.indices[r, :nz[r]].astype(np.int64)
                                for r in range(s, s + n)]
            g.ragged_values = [fg.values[r, :nz[r]] for r in range(s, s + n)]
        groups.append(g)
    return groups


def _pareto_counts(seed, E, hi):
    rng = np.random.RandomState(seed)
    return np.minimum((rng.pareto(1.2, E) * 8 + 2).astype(np.int64), hi)


def _model(tmp_path, dtype="float32", weights=False, **over):
    model, schema = chip_smoke.stage_model(D, str(tmp_path), dtype=dtype,
                                           device="cpu", **over)
    if weights:
        schema = dataclasses.replace(schema, weight_column_name="weight")
    return model, schema


def _captured(monkeypatch):
    """(tier, arrays) of each solve the fit queues."""
    seen = []
    inner = port_re.RandomEffectLRModel._launch

    def spy(self, tier, arrays, pending, rungs):
        seen.append((tier, dict(arrays)))
        return inner(self, tier, arrays, pending, rungs)
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_launch", spy)
    return seen


def _buckets(groups, model, schema, prior):
    """The host bucketizer's buckets of `groups`, as the fit would take
    them."""
    fn = (iter_bucketize_flat if isinstance(groups, FlatGroups)
          else bucketize)
    return list(fn(groups, schema, model.model_params.offset_column_name,
                   has_intercept=model.has_intercept, prior_models=prior))


def _host_route(monkeypatch):
    """The fit's marshal through the host bucketizer: each of _buckets'
    buckets uploaded whole (newton_inputs_from_numpy) and handed to
    _launch as a tier carrying the bucketizer's supports and θ0."""
    def marshal(self, groups, weights, schema, cache, pending, rungs):
        for b in _buckets(groups, self, schema, weights):
            br = len(b.entity_ids)
            t = port_re._PackedTier(np.asarray(b.entity_ids, object),
                                    b.sample_count[:br], b.n_cap,
                                    b.indices.shape[0])
            t.u_cap, t.u_count, t.theta0 = b.u_cap, b.u_count[:br], b.theta0
            t.support = b.unique_global_indices[:br][
                np.arange(b.u_cap)[None, :] < b.u_count[:br, None]]
            self._launch(t, newton_inputs_from_numpy(
                {k: getattr(b, k) for k in _COLS}, self.device, self.dtype),
                pending, rungs)
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_marshal_packed",
                        marshal)


def _prior(model, groups, schema, kind):
    """No prior, or a cold fit's models of two entities in three and one
    of an entity not in `groups`, as a ModelTable or a dict."""
    if kind is None:
        return {}
    cold = model.fit_groups(groups, {}, schema)
    other = ModelTable(ids=np.array(["other"], object), offs=[0, 2],
                       coef_ids=[0, 3], coef_vals=[0.5, -0.25],
                       icpt=[0.1] if model.has_intercept else None)
    weights = ModelTable.concat(
        [cold.select_rows(np.flatnonzero(np.arange(len(cold)) % 3)), other],
        has_intercept=model.has_intercept, with_variance=False)
    return dict(weights) if kind == "dict" else weights


def _assert_tiers_equal(seen, want, model, prior):
    """The captured tiers against the buckets `want`."""
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


def _assert_fit_equals_host_route(monkeypatch, model, groups, schema, prior,
                                  got):
    monkeypatch.undo()
    _host_route(monkeypatch)
    _assert_tables_equal(got, model.fit_groups(groups, prior, schema))


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
    weights = _prior(model, fg, schema, prior)
    seen = _captured(monkeypatch)
    got = model.fit_flat(fg, weights, schema)
    want = _assert_tiers_equal(seen, _buckets(fg, model, schema, weights),
                               model, weights)
    if case == "pareto_heavy_tail":
        assert max(b.n_cap for b in want) >= 256
    _assert_fit_equals_host_route(monkeypatch, model, fg, schema, weights,
                                  got)


OBJECT_CASES = {
    # (group form, fleet kwargs, columns dropped, model kwargs)
    "ragged": ("ragged", {}, (), {}),
    "padded_float64": ("padded", {}, (), {"dtype": "float64"}),
    "mixed_weights_no_intercept": ("mixed", {"weights": True}, (),
                                   {"weights": True,
                                    "has_intercept": False}),
    "ragged_no_offset": ("ragged", {}, ("offset",), {}),
}


@pytest.mark.parametrize("case", sorted(OBJECT_CASES))
@pytest.mark.parametrize("prior", [None, "table", "dict"])
def test_object_path_packs_as_bucketize(tmp_path, monkeypatch, case, prior):
    """A List[EntityGroup] through the one door (re_pack.flat_groups):
    every tier bit-equal to bucketize's, and the fit to the host route's.
    The fleet's zero-nnz records, its entity with no live entry (no record
    listed in the ragged form) and its entity with no record stay in; a
    weight column is missing from every third group."""
    form, fkw, drop, mkw = OBJECT_CASES[case]
    fg = fleet(9, np.concatenate([[4, 6, 0], _pareto_counts(5, 90, 60)]),
               **fkw)
    for name in drop:
        del fg.columns[name]
    groups = entity_groups(fg, form)
    for g in groups[::3]:
        g.columns.pop("weight", None)       # bucketize reads it as 1
    model, schema = _model(tmp_path, **mkw)
    weights = _prior(model, groups, schema, prior)
    seen = _captured(monkeypatch)
    got = model.fit_groups(groups, weights, schema)
    want = _assert_tiers_equal(seen, _buckets(groups, model, schema, weights),
                               model, weights)
    assert len(want) > 1
    _assert_fit_equals_host_route(monkeypatch, model, groups, schema,
                                  weights, got)


@pytest.mark.parametrize("prior", [None, "table", "dict"])
def test_featureless_flat_groups_pack_the_dummy_support(tmp_path,
                                                        monkeypatch, prior):
    """A FlatGroups without a feature block (an intercept-only coordinate)
    packs through the inert block flat_groups gives it: every entity with
    the dummy support [0], u_count 1, u_cap 8 and k 4, each tier bit-equal
    to iter_bucketize_flat's, and the fit to the host route's."""
    fg = dataclasses.replace(fleet(11, _pareto_counts(6, 120, 80)),
                             indices=None, values=None, rec_nnz=None)
    model, schema = _model(tmp_path)
    weights = _prior(model, fg, schema, prior)
    seen = _captured(monkeypatch)
    got = model.fit_groups(fg, weights, schema)
    _assert_tiers_equal(seen, _buckets(fg, model, schema, weights), model,
                        weights)
    assert len(seen) > 1
    for t, arrays in seen:
        assert t.u_cap == 8 and arrays["indices"].shape[2] == 4
        assert (t.u_count == 1).all() and not t.support.any()
        assert len(t.support) == len(t.entity_ids)
    _assert_fit_equals_host_route(monkeypatch, model, fg, schema, weights,
                                  got)


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
    _assert_tiers_equal(seen, _buckets(fg2, model, schema, w1), model, w1)
    _assert_fit_equals_host_route(monkeypatch, model, fg2, schema, w1, got)


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

