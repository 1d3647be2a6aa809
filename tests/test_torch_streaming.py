"""Out-of-core ingestion in the port: streamed fixed-effect and random-effect
training and scoring (stream_chunk_rows / stream_chunk_entities) against
the port's eager path and against the JAX package's streamed path on the
same files, in float64 on the CPU. Ports tests/test_streaming_fe.py and
tests/test_random_effect_lr.py:633-700."""
import gzip
import logging
import os

import numpy as np
import pytest
import torch

from gdmix_tpu import constants
from gdmix_tpu.io.input_pipeline import load_per_record as jax_load
from gdmix_tpu.io.input_pipeline import write_per_record
from gdmix_tpu.io.model_avro import load_sparse_models_from_avro
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel as JaxFE
from gdmix_tpu_torch import params as tparams
from gdmix_tpu_torch.gdmix import run as torch_cli
from gdmix_tpu_torch.io.input_pipeline import (iter_per_record_chunks,
                                               load_per_record as port_load)
from gdmix_tpu_torch.models import fixed_effect_lr as port_fe
from gdmix_tpu_torch.models import random_effect_lr as port_re
from gdmix_tpu_torch.models.fixed_effect_lr import \
    FixedEffectLRModel as TorchFE
from test_fixed_effect_lr import N, _make_dataset, _params, _scipy_fe_oracle
from test_random_effect_lr import (_build_model, _ctx, _make_groups,
                                   _write_dataset)
from test_torch_fixed_effect import _port_params
from test_torch_random_effect import _torch_model

_STREAM_TOL = 1e-9   # streamed against eager: the same solve, float64
_JAX_TOL = 1e-8      # the port against the JAX package, float64
_RE_LOGGER = "gdmix_tpu_torch.models.random_effect_lr"
_CTX = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
        constants.IS_CHIEF: True}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


# ---- fixed effect ---------------------------------------------------------

def _split_into_two_files(ds):
    """The single-file dataset rewritten as two files of 70 and 50 records
    (chunks then cross a file boundary)."""
    data = jax_load(ds["train_dir"], ds["metadata"], "global")
    for which, (lo, hi) in enumerate([(0, 70), (70, N)]):
        cols = {k: v[lo:hi] for k, v in data.columns.items()}
        write_per_record(
            os.path.join(ds["train_dir"], f"part-{which}.tfrecord"),
            ds["metadata"], cols, "global",
            [data.indices[i, :data.nnz[i]] for i in range(lo, hi)],
            [data.values[i, :data.nnz[i]] for i in range(lo, hi)])
    os.remove(os.path.join(ds["train_dir"], "data.tfrecord"))


def _two_file_dataset(tmp_path):
    ds = _make_dataset(tmp_path)
    _split_into_two_files(ds)
    return ds


def _port_train(ds, sub, **over):
    mp, bp = _port_params(ds, sub=sub, **over)
    tm = TorchFE(mp, bp, device="cpu")
    tm.train(mp.training_data_dir, None, ds["md_file"], mp.output_model_dir,
             _CTX, bp)
    return tm, bp


def _jax_train(ds, tmp_path, **over):
    mp, bp = _params(ds, tmp_path, **over)
    jm = JaxFE(mp, bp)
    jm.train(mp.training_data_dir, None, ds["md_file"], mp.output_model_dir,
             _CTX, bp)
    return jm


def test_fe_train_streamed_matches_eager_and_jax(tmp_path):
    """Chunks of 16 rows over two files (7 full chunks and a short one)
    train to the eager coefficients, to the scipy optimum and to the JAX
    package's streamed fit."""
    ds = _two_file_dataset(tmp_path)
    eager, _ = _port_train(ds, "eager")
    streamed, _ = _port_train(ds, "stream", stream_chunk_rows=16)
    assert streamed.last_ingest["chunks"] == 8
    assert streamed.last_ingest["rows"] == N
    np.testing.assert_allclose(streamed.model_coefficients,
                               eager.model_coefficients, rtol=0,
                               atol=_STREAM_TOL)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=0.7, regularize_bias=False)
    np.testing.assert_allclose(streamed.model_coefficients, oracle, atol=1e-6)
    jm = _jax_train(ds, tmp_path, stream_chunk_rows=16)
    np.testing.assert_allclose(streamed.model_coefficients,
                               jm.model_coefficients, rtol=0, atol=_JAX_TOL)


def test_fe_streamed_batch_equals_device_batch(tmp_path):
    """The streamed device batch is the batch _device_batch makes from the
    same records loaded in memory: element for element over the eager bag
    width, zeros beyond it (the stream pads to at least 8, as JAX's), uids
    in the same order."""
    ds = _two_file_dataset(tmp_path)
    mp, bp = _port_params(ds)
    tm = TorchFE(mp, bp, device="cpu")
    data = port_load(ds["train_dir"], tm.metadata, "global")
    want, want_uid, want_n = tm._device_batch(data, bp)
    got, got_uid, got_n = tm._device_batch_streamed(
        iter_per_record_chunks(ds["train_dir"], tm.metadata, "global",
                               chunk_rows=24), bp)
    assert got_n == want_n == N and tm.last_ingest["chunks"] == 5
    assert len(tm.last_ingest["decode_s"]) == 5
    np.testing.assert_array_equal(got_uid, want_uid)
    k = want.indices.shape[1]
    assert got.indices.shape[1] == max(k, 8)
    for name in ("indices", "values"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype
        torch.testing.assert_close(g[:, :k], w, rtol=0, atol=0)
        assert not g[:, k:].any()
    for name in ("offsets", "labels", "weights"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=0)


def test_fe_streamed_out_of_range_id_raises(tmp_path):
    """Every chunk passes the eager batch's range check."""
    ds = _make_dataset(tmp_path)
    mp, bp = _port_params(ds)
    tm = TorchFE(mp, bp, device="cpu")
    chunks = list(iter_per_record_chunks(ds["train_dir"], tm.metadata,
                                         "global", chunk_rows=64))
    chunks[1].indices[3, 0] = 6
    with pytest.raises(ValueError, match="outside"):
        tm._device_batch_streamed(iter(chunks), bp)


def test_fe_streamed_refuses_a_short_chunk_before_the_last(tmp_path):
    ds = _make_dataset(tmp_path)
    mp, bp = _port_params(ds)
    tm = TorchFE(mp, bp, device="cpu")
    chunks = list(iter_per_record_chunks(ds["train_dir"], tm.metadata,
                                         "global", chunk_rows=60))
    assert [c.num_samples for c in chunks] == [60, 60]
    with pytest.raises(AssertionError, match="short chunk"):
        tm._device_batch_streamed(iter(chunks), bp)


def test_fe_train_streamed_scores_align(tmp_path):
    """Training scores come from the streamed batch: uid and row stay
    aligned across chunk boundaries."""
    ds = _two_file_dataset(tmp_path)
    tm, bp = _port_train(ds, "stream", stream_chunk_rows=16)
    got = read_scores(bp.training_score_dir, bp)
    assert len(got["uid"]) == N
    w, b = tm.model_coefficients[:-1], tm.model_coefficients[-1]
    order = np.argsort(got["uid"])
    np.testing.assert_allclose(got["predictionScorePerCoordinate"][order],
                               ds["X"] @ w + b, atol=1e-5)


def test_fe_predict_streamed_matches_eager_and_jax(tmp_path):
    """Chunked scoring writes the eager path's scores, and the JAX
    package's streamed ones."""
    ds = _two_file_dataset(tmp_path)
    jm = _jax_train(ds, tmp_path)
    mp, bp = _port_params(ds, sub="eager")
    TorchFE(mp, bp, device="cpu").train(mp.training_data_dir, None,
                                        ds["md_file"], mp.output_model_dir,
                                        _CTX, bp)
    outs = {}
    for tag, over in (("eager", {}), ("stream", dict(stream_chunk_rows=16))):
        mp, bp = _port_params(ds, sub="eager", **over)
        outs[tag] = os.path.join(ds["root"], f"inf_{tag}")
        TorchFE(mp, bp, device="cpu").predict(
            outs[tag], ds["train_dir"], ds["md_file"], mp.output_model_dir,
            _CTX, bp)
    jp, jb = _params(ds, tmp_path, stream_chunk_rows=16)
    outs["jax"] = os.path.join(ds["root"], "inf_jax")
    JaxFE(jp, jb).predict(outs["jax"], ds["train_dir"], ds["md_file"],
                          jp.output_model_dir, _CTX, jb)
    want = read_scores(outs["eager"], bp)
    got = read_scores(outs["stream"], bp)
    ref = read_scores(outs["jax"], bp)
    ow, og, oj = (np.argsort(s["uid"]) for s in (want, got, ref))
    np.testing.assert_array_equal(want["uid"][ow], got["uid"][og])
    np.testing.assert_array_equal(ref["uid"][oj], got["uid"][og])
    for col in ("predictionScore", "predictionScorePerCoordinate"):
        np.testing.assert_allclose(got[col][og], want[col][ow], atol=1e-6)
        # score files store float32
        np.testing.assert_allclose(got[col][og], ref[col][oj],
                                   rtol=2.0 ** -23, atol=_JAX_TOL)
    assert jm.model_coefficients is not None


def test_fe_streamed_gzip_input(tmp_path):
    """A gzip shard streams through the chunker and trains as the plain
    one does."""
    ds = _make_dataset(tmp_path)
    eager, _ = _port_train(ds, "eager")
    src = os.path.join(ds["train_dir"], "data.tfrecord")
    with open(src, "rb") as f:
        raw = f.read()
    with gzip.open(src + ".gz", "wb") as f:
        f.write(raw)
    os.remove(src)
    streamed, _ = _port_train(ds, "stream", stream_chunk_rows=48)
    assert streamed.last_ingest["chunks"] == 3
    np.testing.assert_allclose(streamed.model_coefficients,
                               eager.model_coefficients, rtol=0,
                               atol=_STREAM_TOL)


def test_fe_streamed_hybrid_matches_eager(tmp_path):
    """The wide-D split under grad_mode="hybrid" builds from the streamed
    batch (wider bag, zeros beyond the eager width) and fits to the eager
    hybrid fit."""
    ds = _two_file_dataset(tmp_path)
    over = dict(grad_mode="hybrid", hot_features=3, hybrid_cold_max_frac=1.0,
                block_chunk_size=32)
    built = []
    orig = port_fe.build_hybrid_aux

    def spy(*a, **kw):
        built.append(orig(*a, **kw))
        return built[-1]

    port_fe.build_hybrid_aux = spy
    try:
        eager, _ = _port_train(ds, "eager", **over)
        streamed, _ = _port_train(ds, "stream", stream_chunk_rows=16, **over)
    finally:
        port_fe.build_hybrid_aux = orig
    assert len(built) == 2 and all(a is not None for a in built)
    np.testing.assert_allclose(streamed.model_coefficients,
                               eager.model_coefficients, rtol=0,
                               atol=_STREAM_TOL)


def _custom_loader(input_path, metadata, feature_bag, num_shards,
                   shard_index):
    from gdmix_tpu_torch.io.input_pipeline import read_per_record
    return read_per_record(input_path, metadata, feature_bag, num_shards,
                           shard_index)


def test_fe_streaming_needs_tfrecord_without_custom_input_fn(tmp_path,
                                                             caplog):
    """With custom_input_fn the trainer warns and loads eagerly, as the
    JAX package does."""
    ds = _make_dataset(tmp_path)
    eager, _ = _port_train(ds, "eager")
    with caplog.at_level(logging.WARNING,
                         logger="gdmix_tpu_torch.models.fixed_effect_lr"):
        tm, _ = _port_train(ds, "custom", stream_chunk_rows=16,
                            custom_input_fn="test_torch_streaming."
                                            "_custom_loader")
    assert any("loading eagerly" in r.getMessage() for r in caplog.records)
    assert tm.last_ingest == {}
    np.testing.assert_array_equal(tm.model_coefficients,
                                  eager.model_coefficients)


def test_fe_cli_carries_stream_chunk_rows(tmp_path, caplog):
    """`--stream_chunk_rows` reaches the trainer through the CLI and the
    params parser; the streamed CLI model equals the eager CLI model."""
    ds = _make_dataset(tmp_path)
    assert tparams.from_argv(tparams.FixedLRParams, [
        "--stream_chunk_rows=16", f"--metadata_file={ds['md_file']}",
        "--output_model_dir=m", "--training_data_dir=t",
        "--feature_bag=global"]).stream_chunk_rows == 16
    models = {}
    for tag, extra in (("eager", []), ("stream", ["--stream_chunk_rows=16"])):
        out = os.path.join(ds["root"], f"cli_{tag}")
        with caplog.at_level(logging.INFO,
                             logger="gdmix_tpu_torch.models.fixed_effect_lr"):
            caplog.clear()
            torch_cli([
                "--action=train", "--stage=fixed_effect",
                "--model_type=logistic_regression",
                "--label_column_name=response", "--uid_column_name=uid",
                "--weight_column_name=weight",
                "--prediction_score_column_name=predictionScore",
                f"--training_score_dir={out}/scores",
                f"--metadata_file={ds['md_file']}",
                f"--training_data_dir={ds['train_dir']}",
                "--feature_bag=global", f"--feature_file={ds['feature_file']}",
                f"--output_model_dir={out}/models", "--l2_reg_weight=0.7",
                "--regularize_bias=false", "--dtype=float64",
                "--lbfgs_tolerance=1e-14", "--lbfgs_pgtol=1e-10",
                "--num_of_lbfgs_iterations=500", "--device=cpu"] + extra)
        lines = [r.getMessage() for r in caplog.records
                 if "streamed ingestion" in r.getMessage()]
        assert bool(lines) == (tag == "stream")
        from gdmix_tpu.io.model_avro import load_linear_models_from_avro
        (models[tag],) = load_linear_models_from_avro(
            os.path.join(out, "models", "part-00000.avro"),
            ds["feature_file"])
    np.testing.assert_allclose(models["stream"], models["eager"], rtol=0,
                               atol=_STREAM_TOL)


# ---- random effect --------------------------------------------------------

def _re_train(md_file, train_dir, feature_file, sub, caplog=None, **over):
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 os.path.join(sub, "models"), **over)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(sub), schema)
    return model, schema, load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"),
        model.feature_file)


def test_re_streamed_matches_eager_and_jax(tmp_path, caplog):
    """stream_chunk_entities = 4 over 23 entities trains in 6 chunks and
    reproduces the eager fit and the JAX package's streamed fit."""
    groups, dense = _make_groups(num_entities=23, seed=21)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    outs = {}
    for tag, over in (("eager", {}), ("stream",
                                      dict(stream_chunk_entities=4))):
        with caplog.at_level(logging.INFO, logger=_RE_LOGGER):
            caplog.clear()
            model, _, outs[tag] = _re_train(md_file, train_dir, feature_file,
                                            str(tmp_path / tag), **over)
        lines = [r.getMessage() for r in caplog.records
                 if "streamed RE fit" in r.getMessage()]
        if tag == "stream":
            assert lines and "23 models over 6 chunks" in lines[0]
            assert model.last_fit_converged == (23, 23)
        else:
            assert not lines
    jm, jschema = _build_model(md_file, train_dir, feature_file,
                               tmp_path / "jax", re_mode="host",
                               stream_chunk_entities=4)
    jm.train(os.path.join(train_dir, "active"), None, md_file,
             jm.checkpoint_path, _ctx(tmp_path / "jax"), jschema)
    outs["jax"] = load_sparse_models_from_avro(
        os.path.join(jm.checkpoint_path, "part-00000.avro"), feature_file)
    assert set(outs["stream"]) == set(outs["eager"]) == set(outs["jax"]) \
        == set(dense)
    for eid in dense:
        for other, tol in (("eager", _STREAM_TOL), ("jax", _JAX_TOL)):
            np.testing.assert_array_equal(
                outs["stream"][eid].unique_global_indices,
                outs[other][eid].unique_global_indices)
            np.testing.assert_allclose(outs["stream"][eid].theta,
                                       outs[other][eid].theta, rtol=0,
                                       atol=tol, err_msg=f"{other} {eid}")


def test_re_streamed_warm_start_and_prior_carry(tmp_path):
    """The streamed fit warm-starts each chunk from its own entities' prior
    rows (a converged prior stays put) and carries prior-only entities
    forward."""
    groups, _ = _make_groups(num_entities=9, seed=22)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema, first = _re_train(md_file, train_dir, feature_file,
                                     str(tmp_path), stream_chunk_entities=2)
    from gdmix_tpu_torch.io.model_avro import SparseModel
    ghost = SparseModel(model_id="ghost", theta=np.array([0.5, -1.0]),
                        variance=None, unique_global_indices=np.array([2]))
    prior = dict(model._load_weights(os.path.join(model.checkpoint_path,
                                                  "part-00000.avro")))
    prior["ghost"] = ghost
    model._save_model(os.path.join(model.checkpoint_path, "part-00000.avro"),
                      prior)
    _, _, second = _re_train(md_file, train_dir, feature_file,
                             str(tmp_path), stream_chunk_entities=2)
    assert set(second) == set(first) | {"ghost"}
    np.testing.assert_allclose(second["ghost"].theta, ghost.theta, atol=1e-12)
    for eid in first:
        np.testing.assert_allclose(second[eid].theta, first[eid].theta,
                                   atol=1e-6)


def test_re_streamed_falls_back_to_eager(tmp_path, caplog, monkeypatch):
    """When the native grouped decoder refuses the data (a chunk of None)
    the trainer warns and trains eagerly, as the JAX package does."""
    groups, _ = _make_groups(num_entities=9, seed=23)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    _, _, want = _re_train(md_file, train_dir, feature_file,
                           str(tmp_path / "eager"))
    from gdmix_tpu_torch.io import input_pipeline

    def refuse(*a, **kw):
        yield None

    monkeypatch.setattr(input_pipeline, "iter_per_entity_grouped_flat_chunks",
                        refuse)
    with caplog.at_level(logging.WARNING, logger=_RE_LOGGER):
        _, _, got = _re_train(md_file, train_dir, feature_file,
                              str(tmp_path / "stream"),
                              stream_chunk_entities=2)
    assert any("loading eagerly" in r.getMessage() for r in caplog.records)
    assert set(got) == set(want)
    for eid in want:
        np.testing.assert_array_equal(got[eid].theta, want[eid].theta)


def test_re_predict_streamed_matches_eager_and_jax(tmp_path):
    """Entity-chunked scoring writes the eager path's scores (a model-less
    entity included: logits = offsets), and the JAX package's streamed
    ones."""
    groups, _ = _make_groups(num_entities=9, seed=21)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "m"))
    weights = model.fit_groups(groups, {}, schema)
    weights = {k: v for i, (k, v) in enumerate(weights.items()) if i != 2}
    active = os.path.join(train_dir, "active")
    outs = {}
    for tag, over in (("eager", {}), ("stream",
                                      dict(stream_chunk_entities=3))):
        m, s = _torch_model(md_file, train_dir, feature_file,
                            str(tmp_path / tag), **over)
        outs[tag] = str(tmp_path / f"{tag}.avro")
        m._predict_file(active, outs[tag], s, weights)
    from gdmix_tpu.io.model_avro import SparseModel as JaxSparseModel
    jm, jschema = _build_model(md_file, train_dir, feature_file,
                               tmp_path / "jax", stream_chunk_entities=3)
    outs["jax"] = str(tmp_path / "jax.avro")
    jm._predict_file(active, outs["jax"], jschema, {
        k: JaxSparseModel(model_id=k, theta=v.theta, variance=v.variance,
                          unique_global_indices=v.unique_global_indices)
        for k, v in weights.items()})
    want, got, ref = (read_scores(outs[t], schema)
                      for t in ("eager", "stream", "jax"))
    ow, og, oj = (np.argsort(s["uid"]) for s in (want, got, ref))
    np.testing.assert_array_equal(want["uid"][ow], got["uid"][og])
    np.testing.assert_array_equal(ref["uid"][oj], got["uid"][og])
    for col in ("predictionScore", "predictionScorePerCoordinate"):
        np.testing.assert_allclose(got[col][og], want[col][ow], rtol=0,
                                   atol=_STREAM_TOL)
        np.testing.assert_allclose(got[col][og], ref[col][oj],
                                   rtol=2.0 ** -23, atol=_JAX_TOL)


def test_re_streamed_scoring_builds_join_table_once(tmp_path, monkeypatch):
    """score_flat(_table=…): the streamed scorer builds the CSR join table
    once for all its chunks."""
    groups, _ = _make_groups(num_entities=9, seed=24)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "m"), stream_chunk_entities=2)
    weights = model.fit_groups(groups, {}, schema)
    built, scored = [], []
    orig_table = port_re.RandomEffectLRModel._model_table
    orig_score = port_re.RandomEffectLRModel.score_flat
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_model_table",
                        lambda self, w: built.append(1) or orig_table(self, w))
    monkeypatch.setattr(port_re.RandomEffectLRModel, "score_flat",
                        lambda self, *a, **kw: scored.append(1)
                        or orig_score(self, *a, **kw))
    model._predict_file(os.path.join(train_dir, "active"),
                        str(tmp_path / "s.avro"), schema, weights)
    assert len(scored) == 5 and len(built) == 1
    assert len(read_scores(str(tmp_path / "s.avro"), schema)["uid"]) == sum(
        len(g.columns["uid"]) for g in groups)


def test_re_cli_carries_stream_chunk_entities(tmp_path, caplog):
    """`--stream_chunk_entities` reaches the RE trainer through the CLI."""
    groups, _ = _make_groups(num_entities=9, seed=5)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
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
    with caplog.at_level(logging.INFO, logger=_RE_LOGGER):
        torch_cli([
            "--action=train", "--stage=random_effect",
            "--model_type=logistic_regression",
            "--label_column_name=response", "--uid_column_name=uid",
            "--weight_column_name=weight",
            "--prediction_score_column_name=predictionScore",
            f"--partition_list_file={plist}",
            f"--training_score_dir={tmp_path / 'cli_scores'}",
            f"--metadata_file={md_file}",
            f"--training_data_dir={train_dir}",
            "--feature_bag=per_entity", f"--feature_file={feature_file}",
            "--partition_entity=user_id", f"--output_model_dir={model_dir}",
            "--l2_reg_weight=0.6", "--regularize_bias=false",
            "--dtype=float64", "--stream_chunk_entities=4", "--device=cpu"])
    lines = [r.getMessage() for r in caplog.records
             if "streamed RE fit" in r.getMessage()]
    assert lines and "9 models over 3 chunks" in lines[0]
    models = load_sparse_models_from_avro(
        os.path.join(model_dir, "part-00000.avro"), feature_file)
    assert set(models) == {g.entity_id for g in groups}
