"""Port parity of the fixed-effect trainer: gdmix_tpu_torch's
FixedEffectLRModel against the JAX package's on one written dataset, in
float64 on the CPU (fit, scores, SIMPLE/FULL variance, the CLI stage, the
model-avro contract in both directions). The dataset and the JAX side come
from tests/test_fixed_effect_lr.py."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gdmix_tpu import constants
from gdmix_tpu.io.input_pipeline import load_per_record as jax_load
from gdmix_tpu.io.model_avro import load_linear_models_from_avro
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel as JaxFE
from gdmix_tpu_torch import params as tparams
from gdmix_tpu_torch.io.input_pipeline import load_per_record as port_load
from gdmix_tpu_torch.models.fixed_effect_lr import \
    FixedEffectLRModel as TorchFE
from test_fixed_effect_lr import _make_dataset, _params, _train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = 1e-8   # coefficients and logits: float64 on both sides
# score files store float32: one float32 rounding apart after storage
_SCORE_RTOL = 2.0 ** -23
# float32 (the kernels' working type) against float32: both stop at
# ‖g‖∞ ≤ 1e-6 on a λ = 0.7 objective
_F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _port_params(ds, sub="torch", **over):
    """The port's params with the JAX test's settings (_params), writing
    under <root>/<sub>."""
    jp, jb = _params(ds, None, **over)
    mp = tparams.FixedLRParams(**{
        **jp.__dict__,
        "output_model_dir": os.path.join(ds["root"], sub, "models")})
    bp = tparams.Params(**{
        **jb.__dict__,
        "training_score_dir": os.path.join(ds["root"], sub, "train_scores"),
        "validation_score_dir": os.path.join(ds["root"], sub,
                                             "validation_scores")})
    return mp, bp


def _fit_both(ds, jax_mode, port_mode, **over):
    jp, jb = _params(ds, None, grad_mode=jax_mode, **over)
    jm = JaxFE(jp, jb)
    mp, bp = _port_params(ds, grad_mode=port_mode, **over)
    tm = TorchFE(mp, bp, device="cpu")
    jm.fit_data(jax_load(ds["train_dir"], jm.metadata, jm.feature_bag_name),
                jb)
    tm.fit_data(port_load(ds["train_dir"], tm.metadata, tm.feature_bag_name),
                bp)
    return jm, jb, tm, bp


CASES = {
    "scatter": (dict(), "scatter", "scatter", {}),
    "auto": (dict(), "auto", "auto", {}),
    "pallas_flat": (dict(), "scatter", "pallas_flat", {}),
    "pallas_gather": (dict(), "scatter", "pallas_gather", {}),
    "no_intercept": (dict(), "scatter", "pallas",
                     dict(has_intercept=False, regularize_bias=False)),
    "intercept_only": (dict(), "scatter", "pallas",
                       dict(feature_bag=None, feature_file=None,
                            l2_reg_weight=0.0)),
    "linear": (dict(label_kind="real"), "scatter", "pallas_block",
               dict(model_type_="linear_regression")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_and_score_match_jax(tmp_path, case):
    ds_kw, jax_mode, port_mode, over = CASES[case]
    ds = _make_dataset(tmp_path, **ds_kw)
    jm, jb, tm, bp = _fit_both(ds, jax_mode, port_mode, **over)
    np.testing.assert_allclose(tm.model_coefficients, jm.model_coefficients,
                               rtol=0, atol=_TOL)
    assert tm.last_fit["converged"] and tm.last_fit["funcalls"] > 1
    got = tm.score_data(port_load(ds["train_dir"], tm.metadata,
                                  tm.feature_bag_name), bp)
    want = jm.score_data(jax_load(ds["train_dir"], jm.metadata,
                                  jm.feature_bag_name), jb)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["uid"], want["uid"])
    for k in ("total", "per_coordinate", "labels", "weights"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=10 * _TOL)


def test_float32_fused_matches_jax_pallas(tmp_path):
    """grad_mode=pallas in float32: the JAX fused kernel (interpret mode)
    against the port's fused path (its plain version on the CPU)."""
    ds = _make_dataset(tmp_path)
    jm, _, tm, _ = _fit_both(ds, "pallas", "pallas", dtype="float32",
                             lbfgs_pgtol=1e-6)
    np.testing.assert_allclose(tm.model_coefficients, jm.model_coefficients,
                               rtol=0, atol=_F32_TOL)


@pytest.mark.parametrize("mode", ["simple", "full"])
def test_variance_matches_jax(tmp_path, mode):
    ds = _make_dataset(tmp_path, with_weight=False)
    jm = _train(ds, tmp_path, fixed_effect_variance_mode=mode)
    mp, bp = _port_params(ds, fixed_effect_variance_mode=mode)
    tm = TorchFE(mp, bp, device="cpu")
    tm.train(mp.training_data_dir, None, ds["md_file"], mp.output_model_dir,
             {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
              constants.IS_CHIEF: True}, bp)
    np.testing.assert_allclose(tm.variances, jm.variances, rtol=1e-8)
    # the variances ride in the model avro both ways
    (jv,) = load_linear_models_from_avro(
        os.path.join(mp.output_model_dir, "part-00000.avro"),
        ds["feature_file"])
    np.testing.assert_allclose(jv, tm.model_coefficients, rtol=0, atol=1e-12)


def _cli(ds, out):
    return [
        sys.executable, "-m", "gdmix_tpu_torch.gdmix",
        "--action=train", "--stage=fixed_effect",
        "--model_type=logistic_regression", "--label_column_name=response",
        "--uid_column_name=uid", "--weight_column_name=weight",
        "--prediction_score_column_name=predictionScore",
        f"--training_score_dir={out}/train_scores",
        f"--validation_score_dir={out}/validation_scores",
        f"--metadata_file={ds['md_file']}",
        f"--training_data_dir={ds['train_dir']}",
        f"--validation_data_dir={ds['train_dir']}",
        "--feature_bag=global", f"--feature_file={ds['feature_file']}",
        f"--output_model_dir={out}/models", "--l2_reg_weight=0.7",
        "--regularize_bias=false", "--dtype=float64",
        "--lbfgs_tolerance=1e-14", "--lbfgs_pgtol=1e-10",
        "--num_of_lbfgs_iterations=500", "--sparsity_threshold=0.0",
        "--device=cpu"]


def test_cli_train_matches_jax(tmp_path):
    """python -m gdmix_tpu_torch.gdmix --stage=fixed_effect, in a fresh
    process: the JAX package reads its model and score files, and they
    agree with the JAX trainer's."""
    ds = _make_dataset(tmp_path)
    out = os.path.join(ds["root"], "cli")
    proc = subprocess.run(_cli(ds, out), cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    jm = _train(ds, tmp_path)
    (got,) = load_linear_models_from_avro(
        os.path.join(out, "models", "part-00000.avro"), ds["feature_file"])
    np.testing.assert_allclose(got, jm.model_coefficients, rtol=0, atol=_TOL)
    _, jb = _params(ds, tmp_path)
    want = read_scores(jb.training_score_dir, jb)
    ow = np.argsort(want["uid"])
    for sub in ("train_scores", "validation_scores"):
        s = read_scores(os.path.join(out, sub), jb)
        o = np.argsort(s["uid"])
        np.testing.assert_array_equal(s["uid"][o], want["uid"][ow])
        for col in ("predictionScore", "predictionScorePerCoordinate",
                    "response"):
            np.testing.assert_allclose(s[col][o], want[col][ow],
                                       rtol=_SCORE_RTOL, atol=_TOL)


def test_jax_model_warm_starts_the_port(tmp_path):
    """A JAX-trained model avro is the port's warm start: it loads to the
    same vector, scores identically, and a 1-iteration refit stays put."""
    ds = _make_dataset(tmp_path)
    jm = _train(ds, tmp_path)
    mp, bp = _params(ds, tmp_path)   # the JAX model's output dir
    mp = tparams.FixedLRParams(**{**mp.__dict__,
                                  "num_of_lbfgs_iterations": 1})
    bp = tparams.Params(**{**bp.__dict__, "training_score_dir": os.path.join(
        ds["root"], "torch_scores")})
    tm = TorchFE(mp, bp, device="cpu")
    np.testing.assert_array_equal(tm._load_model(), jm.model_coefficients)
    out = os.path.join(ds["root"], "torch_predict")
    tm.predict(out, ds["train_dir"], ds["md_file"], mp.output_model_dir,
               {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1}, bp)
    got, want = read_scores(out, bp), read_scores(
        _params(ds, tmp_path)[1].training_score_dir, bp)
    np.testing.assert_allclose(np.sort(got["predictionScore"]),
                               np.sort(want["predictionScore"]),
                               rtol=_SCORE_RTOL, atol=_TOL)
    tm.train(mp.training_data_dir, None, ds["md_file"], mp.output_model_dir,
             {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
              constants.IS_CHIEF: True}, bp)
    np.testing.assert_allclose(tm.model_coefficients, jm.model_coefficients,
                               rtol=0, atol=1e-7)


def test_device_cache_reuses_static_columns(tmp_path):
    """The multi-sweep cache ships the static columns once; a refit on new
    offsets through it equals a fit without it."""
    ds = _make_dataset(tmp_path)
    mp, bp = _port_params(ds)
    tm = TorchFE(mp, bp, device="cpu")
    data = port_load(ds["train_dir"], tm.metadata, tm.feature_bag_name)
    cache = {}
    tm.fit_data(data, bp, device_cache=cache)
    data.columns["offset"] = data.columns["offset"] * -2.0
    got = tm.fit_data(data, bp, device_cache=cache)
    assert tm.static_upload_count == 1
    want = TorchFE(mp, bp, device="cpu").fit_data(data, bp)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad_id", [-1, 6, 10_000])
def test_out_of_range_feature_id_raises(tmp_path, bad_id):
    """A feature id outside the bag is refused before any kernel sees it
    (the kernels would read and write out of bounds)."""
    ds = _make_dataset(tmp_path)
    mp, bp = _port_params(ds)
    tm = TorchFE(mp, bp, device="cpu")
    data = port_load(ds["train_dir"], tm.metadata, tm.feature_bag_name)
    data.indices[3, 0] = bad_id
    with pytest.raises(ValueError, match="outside"):
        tm.fit_data(data, bp)


@pytest.mark.parametrize("over,ctx,item", [
    # the A.9 and A.6 cases keep their ids: they now assert that the
    # option trains
    pytest.param(dict(stream_chunk_rows=64), {}, "A.9", id="over0-ctx0-A.9"),
    pytest.param(dict(), {constants.TASK_INDEX: 1, constants.NUM_WORKERS: 2},
                 "A.6", id="over1-ctx1-A.6"),
])
def test_unported_options_raise(tmp_path, over, ctx, item):
    """Streaming and a worker of several (items A.9, A.6), once on this
    list, now train. Streamed: in two chunks of 64 rows here, to a
    converged model of the bag's width. Worker 1 of 2 with no process
    group: on its sample shard of the one file (rows 1::2), to the model a
    one-process fit of those rows gives (tests/test_torch_multiprocess_fe.py
    holds the two-process fit)."""
    ds = _make_dataset(tmp_path)
    mp, bp = _port_params(ds, **over)
    tm = TorchFE(mp, bp, device="cpu")
    tm.train(mp.training_data_dir, None, ds["md_file"], mp.output_model_dir,
             {constants.TASK_INDEX: 0, **ctx}, bp)
    assert tm.last_fit["converged"]
    assert tm.model_coefficients.shape == (tm._dim,)
    if item == "A.9":
        assert tm.last_ingest["chunks"] == 2
        return
    batch, uid, n = tm._train_batch_cache
    assert n == len(uid) == ds["X"].shape[0] // 2
    np.testing.assert_array_equal(uid, np.arange(1, ds["X"].shape[0], 2))
    assert tm.last_fit["allreduce_calls"] == 0
