"""Two REAL processes of gdmix_tpu_torch training the fixed effect over a
gloo process group on the CPU (the port of tests/test_multiprocess_fe.py):
each process loads its file shard (or its sample shard of one file), every
funcall all-reduces [loss, gradient] once, and the replicated L-BFGS must
land, in float64, within 1e-6 of the JAX package's one-process fit of the
same files and of the scipy oracle (JAX's bound), with the coefficients
bit-equal on both ranks and the score files uid-aligned."""
import os
import sys

import numpy as np
import pytest

from gdmix_tpu import constants
from gdmix_tpu.io.model_avro import load_linear_models_from_avro
from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel as JaxFE
from gdmix_tpu.params import FixedLRParams as JaxFLP, Params as JaxParams

from tests.test_fixed_effect_lr import _scipy_fe_oracle
from tests.test_multiprocess_fe import D, _check_scores, _write_dataset
from tests.torch_multiproc_runner import (free_port, job_env, launch,
                                          run_procs)

TOL = 1e-6   # tests/test_multiprocess_fe.py


def _jax_fit(root, **over):
    """The JAX package's one-process fit of the same files."""
    mp = JaxFLP(metadata_file=os.path.join(root, "tensor_metadata.json"),
                output_model_dir=os.path.join(root, "models_jax"),
                training_data_dir=os.path.join(root, "trainingData"),
                feature_bag="global",
                feature_file=os.path.join(root, "features.csv"),
                l2_reg_weight=0.7, regularize_bias=False, dtype="float64",
                lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-10,
                num_of_lbfgs_iterations=500, sparsity_threshold=0.0, **over)
    bp = JaxParams(action="train", stage="fixed_effect",
                   model_type="logistic_regression",
                   label_column_name="response", uid_column_name="uid",
                   weight_column_name="weight",
                   prediction_score_column_name="predictionScore")
    model = JaxFE(mp, bp)
    model.train(mp.training_data_dir, None, mp.metadata_file,
                mp.output_model_dir,
                {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                 constants.IS_CHIEF: True}, bp)
    return model


def _write_zipf_dataset(root, sizes=(160, 120), d=64, k=6, seed=11):
    """_write_dataset's layout over D = `d` features with Zipf(1.2) ids:
    a few hot ids and a cold tail, so the hybrid split has a hot set."""
    from scipy.special import expit
    from gdmix_tpu.io.feature_list import write_feature_list
    from gdmix_tpu.io.input_pipeline import write_per_record
    from gdmix_tpu.io.metadata import DatasetMetadata
    import json
    rng = np.random.RandomState(seed)
    md_file = os.path.join(root, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "global", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "weight", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "int", "shape": [],
                        "isSparse": False}]}, f)
    md = DatasetMetadata.from_file(md_file)
    train_dir = os.path.join(root, "trainingData")
    os.makedirs(train_dir)
    w_true = rng.randn(d)
    Xs, ys, uid = [], [], 0
    for fi, n in enumerate(sizes):
        X = np.zeros((n, d))
        idx, val = [], []
        for i in range(n):
            ids = np.unique((rng.zipf(1.2, k) - 1) % d)
            v = rng.randn(len(ids))
            X[i, ids] = v
            idx.append(ids.astype(np.int64))
            val.append(v)
        y = (rng.rand(n) < expit(X @ w_true)).astype(np.int64)
        write_per_record(os.path.join(train_dir, f"part-{fi}.tfrecord"), md,
                         {"uid": np.arange(uid, uid + n, dtype=np.int64),
                          "weight": np.ones(n, np.float32), "response": y},
                         "global", idx, val)
        Xs.append(X)
        ys.append(y)
        uid += n
    write_feature_list([(f"f{i}", "") for i in range(d)],
                       os.path.join(root, "features.csv"))
    X = np.concatenate(Xs)
    return X, np.concatenate(ys).astype(np.float64), np.ones(len(X))


def _two_procs(root, **args):
    os.makedirs(os.path.join(root, "scores_mp"), exist_ok=True)
    res = launch("fe", dict(root=root, **args))
    assert [r["rank"] for r in res] == [0, 1]
    assert {r["backend"] for r in res} == {"gloo"}
    # the replicated L-BFGS took the same steps: bit-equal everywhere
    assert res[0]["sha"] == res[1]["sha"]
    assert res[0]["funcalls"] == res[1]["funcalls"] \
        == res[0]["allreduce_calls"]
    (saved,) = load_linear_models_from_avro(
        os.path.join(root, "models_mp", "part-00000.avro"),
        os.path.join(root, "features.csv"))
    np.testing.assert_array_equal(saved, res[0]["coefficients"])
    return np.asarray(res[0]["coefficients"]), res


@pytest.mark.parametrize("sizes,seed,stream_rows", [
    ([64, 64], 5, 0),     # even file shards
    ([64, 40], 6, 0),     # uneven: 64 rows against 40, no padding agreed
    ([96], 7, 0),         # one file: sample shards of 48
    ([64, 40], 9, 32),    # streamed in 32-row chunks, a short tail
    ([96, 0], 10, 0),     # an empty file: process 1 adds zeros
    ([96, 0], 10, 32),    # the same streamed: an empty stream
], ids=["even", "uneven", "one_file", "streamed", "empty_shard",
        "empty_stream"])
def test_two_process_fit_matches_jax_and_oracle(tmp_path, sizes, seed,
                                                stream_rows):
    root = str(tmp_path)
    X, y, w = _write_dataset(root, sizes, seed=seed)
    coeffs, res = _two_procs(root, stream_rows=stream_rows)
    if len(sizes) == 2:
        assert [r["rows"] for r in res] == sizes
    else:
        assert [r["rows"] for r in res] == [sizes[0] // 2] * 2
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=TOL)
    np.testing.assert_allclose(coeffs, _jax_fit(root).model_coefficients,
                               atol=TOL)
    _check_scores(root, X, coeffs)


def test_two_process_full_variance(tmp_path):
    """FULL variance from the all-reduced Hessian, against the JAX package's
    one-process variance and its finite-difference oracle
    (tests/test_multiprocess_fe.py test_two_process_full_variance)."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [48, 48], seed=8)
    coeffs, res = _two_procs(root, variance_mode="full")
    assert res[0]["variances"] == res[1]["variances"]
    got = np.asarray(res[0]["variances"])
    jax_model = _jax_fit(root, fixed_effect_variance_mode="full")
    np.testing.assert_allclose(coeffs, jax_model.model_coefficients,
                               atol=TOL)
    np.testing.assert_allclose(got, jax_model.variances, rtol=1e-6)

    def data_loss(x):
        z = X @ x[:-1] + x[-1]
        per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        return np.sum(w * per)

    dim, eps, lam = D + 1, 1e-5, 0.7
    H = np.zeros((dim, dim))
    for i in range(dim):
        for j in range(dim):
            e_i, e_j = np.eye(dim)[i] * eps, np.eye(dim)[j] * eps
            H[i, j] = (data_loss(coeffs + e_i + e_j)
                       - data_loss(coeffs + e_i - e_j)
                       - data_loss(coeffs - e_i + e_j)
                       + data_loss(coeffs - e_i - e_j)) / (4 * eps * eps)
    H += np.diag([lam + 1e-12] * dim)
    H[-1, -1] -= lam
    np.testing.assert_allclose(got, np.diagonal(np.linalg.inv(H)), rtol=1e-3)


@pytest.mark.parametrize("windowed,tol", [
    ("auto", TOL),
    # the windowed cold side sums into a float32 table (as the JAX
    # package's kernel does), so its gradient is float32-exact only
    ("on", 5e-4),
])
def test_two_process_wide_d_hybrid(tmp_path, windowed, tol):
    """grad_mode=auto past block_max_features takes the hot/cold split;
    each process builds its own split from its own rows (its hot set need
    not be the other's): the sum, and so the fit, is the one-process one.
    "auto" keeps the windowed cold side off on the CPU; "on" runs its plain
    version in each process."""
    root = str(tmp_path)
    X, y, w = _write_zipf_dataset(root)
    hybrid = dict(grad_mode="auto", block_max_features=16,
                  onehot_max_features=8, hot_features=24)
    coeffs, res = _two_procs(root, extra=dict(
        hybrid, hybrid_windowed_cold=windowed))
    assert all(r["hybrid"] for r in res)
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=tol)
    np.testing.assert_allclose(
        coeffs, _jax_fit(root, **hybrid).model_coefficients, atol=tol)


def test_two_process_trainer_cli_env_contract(tmp_path):
    """`python -m gdmix_tpu_torch.gdmix` with COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID set (what workflow/k8s.py injects): two
    processes over two files reproduce the oracle and the JAX package's
    one-process fit."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [64, 48], seed=8)
    for d in ("models_mp", "scores_mp"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    cmd = [sys.executable, "-m", "gdmix_tpu_torch.gdmix", "--device=cpu",
           "--action=train", "--stage=fixed_effect",
           "--model_type=logistic_regression",
           "--label_column_name=response", "--uid_column_name=uid",
           "--weight_column_name=weight",
           "--prediction_score_column_name=predictionScore",
           f"--metadata_file={os.path.join(root, 'tensor_metadata.json')}",
           f"--training_data_dir={os.path.join(root, 'trainingData')}",
           "--feature_bag=global",
           f"--feature_file={os.path.join(root, 'features.csv')}",
           f"--output_model_dir={os.path.join(root, 'models_mp')}",
           f"--training_score_dir={os.path.join(root, 'scores_mp')}",
           "--l2_reg_weight=0.7", "--regularize_bias=False",
           "--dtype=float64", "--lbfgs_tolerance=1e-14",
           "--lbfgs_pgtol=1e-10", "--num_of_lbfgs_iterations=500",
           "--sparsity_threshold=0.0"]
    port = free_port()
    outs = run_procs([(cmd, job_env(r, 2, port)) for r in range(2)])
    for out in outs:
        assert "backend gloo" in out, out[-2000:]
    (coeffs,) = load_linear_models_from_avro(
        os.path.join(root, "models_mp", "part-00000.avro"),
        os.path.join(root, "features.csv"))
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=TOL)
    np.testing.assert_allclose(coeffs, _jax_fit(root).model_coefficients,
                               atol=TOL)
    _check_scores(root, X, coeffs)
