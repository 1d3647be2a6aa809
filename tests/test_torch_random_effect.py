"""Port parity, end to end: the random-effect trainer of gdmix_tpu_torch
against the JAX package's on one written dataset, in float64 on the CPU.
Both models are read back with one reader (the JAX package's) and must
agree, as must their score files; the warm start carries one prior into
both through util/convert.model_table_from_numpy."""
import os

import numpy as np
import pytest
import torch

from gdmix_tpu import constants
from gdmix_tpu.io.model_avro import load_sparse_models_from_avro
from gdmix_tpu.io.model_table import ModelTable as JaxModelTable
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu_torch import params as tparams
from gdmix_tpu_torch.gdmix import run as torch_cli
from gdmix_tpu_torch.models.random_effect_lr import \
    RandomEffectLRModel as TorchRE
from gdmix_tpu_torch.util.convert import model_table_from_numpy
from test_random_effect_lr import (_build_model, _ctx, _make_groups,
                                   _write_dataset)

_TOL = 1e-8   # model coefficients: float64 on both sides
# score files store float32: the two float64 logits agree to _TOL, and one
# float32 rounding step apart (2^-24 relative) is the bound after storage
_SCORE_RTOL = 2.0 ** -23


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _torch_model(md_file, train_dir, feature_file, model_dir, **over):
    base = dict(metadata_file=md_file, output_model_dir=model_dir,
                training_data_dir=train_dir, feature_bag="per_entity",
                feature_file=feature_file, partition_entity="user_id",
                l2_reg_weight=0.6, regularize_bias=False, dtype="float64",
                lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-10,
                num_of_lbfgs_iterations=500, sparsity_threshold=0.0)
    base.update(over)
    base_params = tparams.Params(
        action="train", stage="random_effect",
        model_type="logistic_regression", label_column_name="response",
        uid_column_name="uid", weight_column_name="weight",
        prediction_score_column_name="predictionScore")
    return TorchRE(tparams.REParams(**base), base_params, device="cpu"), \
        base_params


def _prior(entity_ids, width, seed, with_variance=False):
    """A prior over some of the data's entities plus one unseen entity,
    with coefficients on features in and out of each entity's support."""
    rng = np.random.RandomState(seed)
    ids = list(entity_ids[::2]) + ["unseen"]
    lens = rng.randint(1, width + 1, len(ids))
    coef_ids = np.concatenate([np.sort(rng.choice(width, k, replace=False))
                               for k in lens])
    offs = np.concatenate([[0], np.cumsum(lens)])
    var = (lambda k: rng.uniform(0.1, 2.0, k)) if with_variance else None
    return JaxModelTable(ids=np.asarray(ids, object), offs=offs,
                         coef_ids=coef_ids,
                         coef_vals=rng.randn(len(coef_ids)) * 0.3,
                         icpt=rng.randn(len(ids)) * 0.2,
                         coef_vars=var and var(len(coef_ids)),
                         icpt_vars=var and var(len(ids)))


def _port_prior(prior):
    return model_table_from_numpy(prior.ids, prior.offs, prior.coef_ids,
                                  prior.coef_vals, prior.icpt,
                                  coef_vars=prior.coef_vars,
                                  icpt_vars=prior.icpt_vars)


def _assert_models_equal(path_a, path_b, feature_file):
    a = load_sparse_models_from_avro(path_a, feature_file)
    b = load_sparse_models_from_avro(path_b, feature_file)
    assert set(a) == set(b) and len(a) > 0
    for eid in a:
        np.testing.assert_array_equal(a[eid].unique_global_indices,
                                      b[eid].unique_global_indices)
        np.testing.assert_allclose(a[eid].theta, b[eid].theta, rtol=0,
                                   atol=_TOL, err_msg=f"entity {eid}")
        assert (a[eid].variance is None) == (b[eid].variance is None)
        if a[eid].variance is not None:
            np.testing.assert_allclose(a[eid].variance, b[eid].variance,
                                       rtol=0, atol=_TOL,
                                       err_msg=f"entity {eid} variance")


def _assert_scores_equal(file_a, file_b, schema):
    sa, sb = read_scores(file_a, schema), read_scores(file_b, schema)
    oa, ob = np.argsort(sa["uid"]), np.argsort(sb["uid"])
    np.testing.assert_array_equal(sa["uid"][oa], sb["uid"][ob])
    for col in ("predictionScore", "predictionScorePerCoordinate"):
        np.testing.assert_allclose(sa[col][oa], sb[col][ob],
                                   rtol=_SCORE_RTOL, atol=_TOL)


@pytest.mark.parametrize("warm", [False, True])
def test_train_matches_jax(tmp_path, warm):
    groups, _ = _make_groups(num_entities=12, seed=7)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    jax_model, schema = _build_model(md_file, train_dir, feature_file,
                                     tmp_path / "jax")
    port_dir = str(tmp_path / "torch" / "models")
    port_model, port_schema = _torch_model(md_file, train_dir, feature_file,
                                           port_dir)
    if warm:
        prior = _prior([g.entity_id for g in groups], 5, seed=3)
        jax_model._save_model(os.path.join(jax_model.checkpoint_path,
                                           "part-00000.avro"), prior)
        port_model._save_model(os.path.join(port_dir, "part-00000.avro"),
                               _port_prior(prior))
    active = os.path.join(train_dir, "active")
    jax_ctx = _ctx(tmp_path / "jax")
    port_ctx = _ctx(tmp_path / "torch")
    jax_model.train(active, None, md_file, jax_model.checkpoint_path,
                    jax_ctx, schema)
    port_model.train(active, None, md_file, port_dir, port_ctx, port_schema)
    _assert_models_equal(
        os.path.join(jax_model.checkpoint_path, "part-00000.avro"),
        os.path.join(port_dir, "part-00000.avro"), feature_file)
    _assert_scores_equal(jax_ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE],
                         port_ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE],
                         schema)
    conv, total = port_model.last_fit_converged
    assert total == len(groups) and conv == total
    assert set(port_model.last_fit_phases) == {
        "marshal_dispatch", "solve_fetch_collect", "merge"}


def test_object_groups_fit_and_score_match_jax(tmp_path):
    """The List[EntityGroup] path (the fallback when the flat decoder
    cannot take a dataset): fit_groups and score_groups agree with JAX."""
    groups, _ = _make_groups(num_entities=10, seed=9)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    jax_model, schema = _build_model(md_file, train_dir, feature_file,
                                     tmp_path / "jax")
    port_model, port_schema = _torch_model(md_file, train_dir, feature_file,
                                           str(tmp_path / "torch"))
    want = jax_model.fit_groups(groups, {}, schema)
    got = port_model.fit_groups(groups, {}, port_schema)
    assert list(got.ids) == list(want.ids)
    np.testing.assert_array_equal(got.coef_ids, want.coef_ids)
    np.testing.assert_allclose(got.coef_vals, want.coef_vals, rtol=0,
                               atol=_TOL)
    np.testing.assert_allclose(got.icpt, want.icpt, rtol=0, atol=_TOL)
    s_want = jax_model.score_groups(groups, want, schema)
    s_got = port_model.score_groups(groups, got, port_schema)
    assert set(s_got) == set(s_want)
    np.testing.assert_array_equal(s_got["uid"], s_want["uid"])
    # a logit sums coefficients that agree to _TOL times feature values
    # (row Σ|x| ≤ 10 in this data)
    for k in ("total", "per_coordinate", "labels", "weights"):
        np.testing.assert_allclose(s_got[k], s_want[k], rtol=0,
                                   atol=10 * _TOL)


def test_cli_train_matches_jax(tmp_path):
    """python -m gdmix_tpu_torch.gdmix --action=train --stage=random_effect
    (run in-process) writes the same model and scores as the JAX trainer."""
    groups, _ = _make_groups(num_entities=9, seed=5)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    # RandomEffectDriver's partition layout: <dir>/active/partitionId=0
    active = os.path.join(train_dir, "active")
    part = os.path.join(active, "partitionId=0")
    os.makedirs(part)
    for f in os.listdir(active):
        if f.endswith(".tfrecord"):
            os.rename(os.path.join(active, f), os.path.join(part, f))
    plist = os.path.join(str(tmp_path), "partitionList.txt")
    with open(plist, "w") as f:
        f.write("0")
    model_dir = os.path.join(str(tmp_path), "cli_models")
    score_dir = os.path.join(str(tmp_path), "cli_scores")
    torch_cli([
        "--action=train", "--stage=random_effect",
        "--model_type=logistic_regression",
        "--label_column_name=response", "--uid_column_name=uid",
        "--weight_column_name=weight",
        "--prediction_score_column_name=predictionScore",
        f"--partition_list_file={plist}",
        f"--training_score_dir={score_dir}",
        f"--metadata_file={md_file}", f"--training_data_dir={train_dir}",
        "--feature_bag=per_entity", f"--feature_file={feature_file}",
        "--partition_entity=user_id", f"--output_model_dir={model_dir}",
        "--l2_reg_weight=0.6", "--regularize_bias=false",
        "--dtype=float64", "--lbfgs_tolerance=1e-14",
        "--lbfgs_pgtol=1e-10", "--num_of_lbfgs_iterations=500",
        "--sparsity_threshold=0.0", "--device=cpu"])
    jax_model, schema = _build_model(md_file, train_dir, feature_file,
                                     tmp_path / "jax")
    jax_ctx = _ctx(tmp_path / "jax")
    jax_model.train(part, None, md_file, jax_model.checkpoint_path, jax_ctx,
                    schema)
    _assert_models_equal(
        os.path.join(jax_model.checkpoint_path, "part-00000.avro"),
        os.path.join(model_dir, "part-00000.avro"), feature_file)
    _assert_scores_equal(
        jax_ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE],
        os.path.join(score_dir, "partitionId=0", "part-00000-active.avro"),
        schema)


_STOP_ON_GRADIENT = dict(re_mode="host", lbfgs_tolerance=0.0,
                         lbfgs_pgtol=1e-7)
_RUNGS = {
    "newton": dict(),
    "newton_dual": dict(batch_solver="newton_dual"),
    "lbfgs_dense": dict(batch_solver="lbfgs"),
    "lbfgs": dict(batch_solver="lbfgs", dense_lbfgs_max_elems=0),
}


@pytest.mark.parametrize("variance", [None, constants.SIMPLE,
                                      constants.FULL])
@pytest.mark.parametrize("rung", list(_RUNGS))
def test_rung_and_variance_match_jax(tmp_path, rung, variance):
    """Every rung of the solver ladder × every variance mode, through
    train(): the model avro (coefficients and variances) and the score
    file agree with the JAX package's. The SIMPLE cases warm-start from a
    prior that carries variances.

    Both sides train on the host plane (with several devices the JAX
    package's re_mode auto takes its sharded plane, whose shapes differ),
    and every entity stops on ‖g‖∞ ≤ 1e-7 (lbfgs_tolerance 0). Below that,
    an L-BFGS step moves f by less than float64 resolves, and the stopping
    and Wolfe tests of two runs that sum in other orders may part."""
    groups, _ = _make_groups(num_entities=12, seed=7)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    over = dict(_RUNGS[rung], random_effect_variance_mode=variance,
                **_STOP_ON_GRADIENT)
    jax_model, schema = _build_model(md_file, train_dir, feature_file,
                                     tmp_path / "jax", **over)
    port_dir = str(tmp_path / "torch" / "models")
    port_model, port_schema = _torch_model(md_file, train_dir, feature_file,
                                           port_dir, **over)
    if variance == constants.SIMPLE:
        prior = _prior([g.entity_id for g in groups], 5, seed=4,
                       with_variance=True)
        jax_model._save_model(os.path.join(jax_model.checkpoint_path,
                                           "part-00000.avro"), prior)
        port_model._save_model(os.path.join(port_dir, "part-00000.avro"),
                               _port_prior(prior))
    active = os.path.join(train_dir, "active")
    jax_ctx, port_ctx = _ctx(tmp_path / "jax"), _ctx(tmp_path / "torch")
    jax_model.train(active, None, md_file, jax_model.checkpoint_path,
                    jax_ctx, schema)
    port_model.train(active, None, md_file, port_dir, port_ctx, port_schema)
    _assert_models_equal(
        os.path.join(jax_model.checkpoint_path, "part-00000.avro"),
        os.path.join(port_dir, "part-00000.avro"), feature_file)
    _assert_scores_equal(jax_ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE],
                         port_ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE],
                         schema)
    conv, total = port_model.last_fit_converged
    assert total == len(groups) and conv == total
    assert set(port_model.last_fit_rungs) == {rung}


def test_auto_ladder_takes_dual_and_dense(tmp_path):
    """With newton_max_dim lowered on both sides, "auto" sends each bucket
    to the dual (n_cap < dim) or the dense L-BFGS rung, as JAX does."""
    groups, _ = _make_groups(num_entities=300, seed=21, width=24,
                             max_support=12)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups,
                                                      width=24)
    # buckets (B 256, n_cap 16, dim 17) → dual; (64, 24, 17) → dense
    over = dict(newton_max_dim=8, **_STOP_ON_GRADIENT)
    jax_model, schema = _build_model(md_file, train_dir, feature_file,
                                     tmp_path / "jax", **over)
    port_model, port_schema = _torch_model(md_file, train_dir, feature_file,
                                           str(tmp_path / "torch"), **over)
    want = jax_model.fit_groups(groups, {}, schema)
    got = port_model.fit_groups(groups, {}, port_schema)
    assert set(port_model.last_fit_rungs) == {"newton_dual", "lbfgs_dense"}
    assert list(got.ids) == list(want.ids)
    np.testing.assert_allclose(got.coef_vals, want.coef_vals, rtol=0,
                               atol=_TOL)
    np.testing.assert_allclose(got.icpt, want.icpt, rtol=0, atol=_TOL)


@pytest.mark.parametrize("over,item", [
    # the A.6, A.9 and two-phase cases keep their ids: they now assert that
    # the option trains
    pytest.param(dict(re_mode="sharded"), None, id="over0-A.6"),
    pytest.param(dict(newton_phase1_iters=2), None, id="over1-two-phase"),
    pytest.param(dict(stream_chunk_entities=4), None, id="over2-A.9"),
])
def test_unported_rungs_raise(tmp_path, over, item):
    """Every path the port lacks raises, naming its ROADMAP item; no option
    falls through to another path. The sharded plane, two-phase Newton and
    streaming (item None), once on this list, now train: a model for each
    of the 70 entities, on the plane asked for (two-phase on the host
    plane's one bucket of more than 64)."""
    groups, _ = _make_groups(num_entities=70, seed=1)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "m"), **over)
    train = lambda: model.train(os.path.join(train_dir, "active"), None,
                                md_file, model.checkpoint_path,
                                _ctx(tmp_path), schema)
    if item is None:
        train()
        models = load_sparse_models_from_avro(
            os.path.join(model.checkpoint_path, "part-00000.avro"),
            feature_file)
        assert set(models) == {g.entity_id for g in groups}
        assert model.last_fit_plane == (
            "sharded" if over.get("re_mode") == "sharded" else "host")
        if "newton_phase1_iters" in over:
            assert model.last_fit_rungs == {"newton_two_phase": 1}
        return
    with pytest.raises(NotImplementedError, match=item):
        train()


# ---- the bucket plan: one launch per tier ----------------------------------

def test_primary_plan_is_one_bucket_per_tier():
    """The smoke's primary workload (100,000 entities, seed 0): the port's
    plan keeps each sample-count tier whole — 4 buckets, one launch each —
    where the JAX package's plan at the same dispatch latency cuts three of
    the tiers into 128-entity pieces (305 buckets)."""
    import chip_smoke
    from gdmix_tpu.data.bucketing import plan_lane_buckets as jax_plan
    from gdmix_tpu_torch.data import bucketing as tb
    counts = np.asarray(chip_smoke.make_workload_flat(100_000, seed=0).counts)
    caps = tb._sample_caps(counts, 8)
    plan = tb.plan_lane_buckets(counts, caps, dispatch_latency_s=1e-3)
    assert [(c, len(m)) for c, m in plan] == [
        (8, 61178), (16, 18234), (32, 11253), (64, 9335)]
    np.testing.assert_array_equal(
        np.sort(np.concatenate([m for _, m in plan])), np.arange(len(counts)))
    assert len(jax_plan(counts, caps, dispatch_latency_s=1e-3)) == 305


def _records(E, seed, max_nnz=4, D=40):
    """Per-record data of E entities with 1–69 records each, in shuffled
    entity order (the port's PerRecordData)."""
    from gdmix_tpu_torch.io.input_pipeline import PerRecordData
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 70, E)
    N = int(counts.sum())
    ent = np.repeat(rng.permutation(E), counts)
    nnz = rng.integers(1, max_nnz + 1, N).astype(np.int32)
    values = rng.standard_normal((N, max_nnz))
    values[np.arange(max_nnz)[None, :] >= nnz[:, None]] = 0.0
    cols = {"uid": rng.integers(0, 1 << 40, N),
            "response": rng.integers(0, 2, N).astype(np.float64),
            "weight": rng.random(N) + 0.5, "offset": rng.standard_normal(N),
            "entity": np.asarray([f"e{v}" for v in ent], dtype=object)}
    return PerRecordData(columns=cols,
                         indices=rng.integers(0, D, (N, max_nnz)),
                         values=values, nnz=nnz, num_samples=N)


def test_object_and_columnar_paths_plan_alike():
    """bucketize (entity objects) and iter_bucketize_flat (columnar) give
    the same buckets, one per tier, on data whose largest tiers the JAX
    package's plan would cut into 128-entity pieces."""
    from types import SimpleNamespace
    from gdmix_tpu.data.bucketing import plan_lane_buckets as jax_plan
    from gdmix_tpu_torch.data import bucketing as tb
    from gdmix_tpu_torch.data.partitioner import (PartitionerConfig,
                                                  group_by_entity, group_flat)
    data = _records(1500, seed=4)
    cfg = PartitionerConfig(partition_entity="entity", num_partitions=1,
                            uid_column_name="uid")
    gids = np.zeros(data.num_samples, np.int64)
    groups = [g for _, _, g in group_by_entity(data, cfg, None, gids)]
    sp = SimpleNamespace(label_column_name="response",
                         weight_column_name="weight", uid_column_name="uid")
    slow = tb.bucketize(groups, sp, "offset")
    fast = list(tb.iter_bucketize_flat(group_flat(data, cfg, gids,
                                                  active_only=True),
                                       sp, "offset"))
    counts = np.array([g.sample_count for g in groups])
    caps = tb._sample_caps(counts, 8)
    assert [b.n_cap for b in slow] == [b.n_cap for b in fast] == list(caps)
    assert len(jax_plan(counts, caps, dispatch_latency_s=1e-3)) > len(caps)
    for a, b in zip(slow, fast):
        assert a.entity_ids == b.entity_ids
        for f in ("indices", "values", "offsets", "labels", "weights", "uids",
                  "sample_count", "unique_global_indices", "u_count",
                  "theta0"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def _by_entity(table):
    """{entity id: (coefficient ids, values, intercept)} of a ModelTable."""
    return {e: (table.coef_ids[table.offs[i]:table.offs[i + 1]],
                table.coef_vals[table.offs[i]:table.offs[i + 1]],
                table.icpt[i]) for i, e in enumerate(table.ids)}


def test_fit_flat_f64_matches_jax_where_the_old_plan_split_a_tier(tmp_path):
    """fit_flat in float64 on the CPU, port against JAX (its host plane), on
    a workload whose n = 16 tier (143 entities) the JAX package's plan cuts
    into two buckets and the port's keeps whole: the same models."""
    import chip_smoke
    from gdmix_tpu.data.bucketing import FlatGroups as JaxFlatGroups
    from gdmix_tpu.data.bucketing import plan_lane_buckets as jax_plan
    from gdmix_tpu.models.random_effect_lr import \
        RandomEffectLRModel as JaxRE
    from gdmix_tpu.params import Params as JaxParams
    from gdmix_tpu.params import REParams as JaxREParams
    from gdmix_tpu_torch.data import bucketing as tb
    fg = chip_smoke.make_workload_flat(800, seed=5)
    counts = np.asarray(fg.counts)
    caps = tb._sample_caps(counts, 8)
    assert len(jax_plan(counts, caps, dispatch_latency_s=1e-3)) == 5
    assert len(tb.plan_lane_buckets(counts, caps,
                                    dispatch_latency_s=1e-3)) == 4
    stop = dict(lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-10)
    port, schema = chip_smoke.stage_model(24, str(tmp_path / "port"),
                                          dtype="float64", device="cpu",
                                          **stop)
    got = port.fit_flat(fg, {}, schema)
    fields = dict(port.model_params.__dict__, re_mode="host")
    jax_schema = JaxParams(**{k: v for k, v in schema.__dict__.items()
                              if k in JaxParams.__dataclass_fields__})
    jax_model = JaxRE(JaxREParams(**{k: v for k, v in fields.items()
                                     if k in JaxREParams.__dataclass_fields__}),
                      jax_schema)
    want = jax_model.fit_flat(JaxFlatGroups(
        entity_ids=fg.entity_ids, counts=fg.counts, columns=fg.columns,
        indices=fg.indices, values=fg.values, rec_nnz=fg.rec_nnz), {},
        jax_schema)
    g, w = _by_entity(got), _by_entity(want)
    assert set(g) == set(w) and len(g) == len(fg)
    for e, (ids, vals, icpt) in w.items():
        np.testing.assert_array_equal(g[e][0], ids)
        np.testing.assert_allclose(g[e][1], vals, rtol=0, atol=1e-6)
        assert abs(g[e][2] - icpt) <= 1e-6
    conv, total = port.last_fit_converged
    assert conv == total == len(fg)
