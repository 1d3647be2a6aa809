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
    (dict(re_mode="sharded"), "A.6"),
    (dict(newton_phase1_iters=2), "two-phase"),
    (dict(stream_chunk_entities=4), "A.9"),
])
def test_unported_rungs_raise(tmp_path, over, item):
    """Every path the port lacks raises, naming its ROADMAP item; no option
    falls through to another path."""
    groups, _ = _make_groups(num_entities=70, seed=1)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "m"), **over)
    with pytest.raises(NotImplementedError, match=item):
        model.train(os.path.join(train_dir, "active"), None, md_file,
                    model.checkpoint_path, _ctx(tmp_path), schema)
