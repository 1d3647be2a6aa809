"""The DeText pipeline through the port's entry points on the CPU: a deep
fixed-effect tower → per-user → per-movie random effects, on the data of
the JAX package's tests/test_e2e_detext_pipeline.py (80 users, 100 movies,
6,000 ratings, seed 5), through `workflow.main` (the default mode,
single_node, and --resume) and through the job DAG's train job, which is
`python -m gdmix_tpu_torch.gdmix --model_type=detext`, run in a subprocess
for train and then inference."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from gdmix_tpu.data import movielens
from gdmix_tpu_torch.io.scores import read_scores
from gdmix_tpu_torch.params import SchemaParams
from gdmix_tpu_torch.workflow.config import WorkflowConfig
from gdmix_tpu_torch.workflow.distributed import generate_job_dag
from gdmix_tpu_torch.workflow.main import main as workflow_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCHEMA = SchemaParams(uid_column_name="uid", label_column_name="response",
                       prediction_score_column_name="predictionScore")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ml(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("detext_pipe"))
    data = movielens.generate_synthetic(num_users=80, num_movies=100,
                                        num_ratings=6000, seed=5)
    return movielens.prepare_gdmix_data(root, data, with_detext=True)


def _config(ml, out_dir, num_epochs=5):
    """tests/test_e2e_detext_pipeline.py:15-62's configuration."""
    detext = os.path.join(ml, "detext")
    gdmix_config = {
        "model_type": "detext",
        "label_column_name": "response",
        "uid_column_name": "uid",
        "prediction_score_column_name": "predictionScore",
        "weight_column_name": "weight",
    }
    re_gdmix_config = dict(gdmix_config, model_type="logistic_regression")

    def re_coord(bag, entity):
        return {
            "training_data_dir": os.path.join(ml, bag, "trainingData"),
            "validation_data_dir": os.path.join(ml, bag, "validationData"),
            "feature_file": os.path.join(ml, bag, "featureList", bag),
            "feature_bag": bag,
            "metadata_file": os.path.join(ml, bag, "metadata",
                                          "tensor_metadata.json"),
            "l2_reg_weight": 1.0,
            "regularize_bias": False,
            "partition_entity": entity,
            "num_partitions": 1,
            "gdmix_config": re_gdmix_config,
        }
    return {
        "output_dir": out_dir,
        "fixed_effect_config": {"global": {
            "training_data_dir": os.path.join(detext, "trainingData"),
            "validation_data_dir": os.path.join(detext, "validationData"),
            "metadata_file": os.path.join(detext, "metadata",
                                          "tensor_metadata.json"),
            "vocab_file": os.path.join(detext, "vocab.txt"),
            "feature_bag": "wide_ftrs_sp",
            "num_epochs": num_epochs,
            "batch_size": 256,
            "num_units": 16,
            "num_filters": 8,
            "num_hidden": 16,
            "learning_rate": 0.02,
            "gdmix_config": gdmix_config,
        }},
        "random_effect_config": {
            "per-user": re_coord("per_user", "user_id"),
            "per-movie": re_coord("per_movie", "movie_id"),
        },
    }


def test_single_node_auc_climbs(ml, tmp_path):
    """`workflow.main --config_path X --device cpu` (single_node, the
    default): AUC climbs global > 0.55 → per-user → per-movie, as in the
    JAX test (:68-70); the tower's checkpoint is where the contract puts
    it; --resume returns the recorded metrics and trains nothing again."""
    out = str(tmp_path / "out")
    path = str(tmp_path / "detext.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_config(ml, out), f, sort_keys=False)
    metrics = workflow_main(["--config_path", path, "--device", "cpu"])
    assert metrics["global"] > 0.55
    assert metrics["per-user"] > metrics["global"]
    assert metrics["per-movie"] > metrics["per-user"]
    ckpt = os.path.join(out, "global", "models", "deep_tower_ckpt")
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "params.pt"]
    stamp = os.path.getmtime(os.path.join(ckpt, "params.pt"))
    again = workflow_main(["--config_path", path, "--device", "cpu",
                           "--resume"])
    assert again == metrics
    assert os.path.getmtime(os.path.join(ckpt, "params.pt")) == stamp


def _run(cmd):
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT,
                                   OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def test_dag_train_job_then_inference(ml, tmp_path):
    """The job DAG's global train job for a detext coordinate is the
    trainer CLI with --model_type=detext and the tower's flags, --device
    passed on: run it in a subprocess, then the same command with
    --action=inference into other score directories, which must write the
    train job's validation scores again."""
    out = str(tmp_path / "out")
    jobs = generate_job_dag(WorkflowConfig.from_dict(
        _config(ml, out, num_epochs=2)), device="cpu")
    (train,) = [j for j in jobs if j["name"] == "global-tf-train"]
    cmd = [sys.executable if a == "python" else a for a in train["command"]]
    assert "--model_type=detext" in cmd and "--device=cpu" in cmd
    assert any(a.startswith("--vocab_file=") for a in cmd)
    for sub in ("train_scores", "validation_scores"):
        os.makedirs(os.path.join(out, "global", sub))
    log = _run(cmd)
    launches = json.loads(log.rsplit("kernel launches: ", 1)[1]
                          .splitlines()[0])
    assert set(launches.values()) == {0}      # the tower has no kernel
    assert os.path.isfile(os.path.join(out, "global", "models",
                                       "deep_tower_ckpt", "params.pt"))

    pred = str(tmp_path / "pred")
    infer = [a for a in cmd if not a.startswith(
        ("--action=", "--training_score_dir=", "--validation_score_dir="))]
    infer += ["--action=inference",
              f"--training_score_dir={pred}/train",
              f"--validation_score_dir={pred}/valid"]
    _run(infer)
    warm = read_scores(os.path.join(out, "global", "validation_scores"),
                       _SCHEMA)
    cold = read_scores(os.path.join(pred, "valid"), _SCHEMA)
    np.testing.assert_array_equal(cold["uid"], warm["uid"])
    np.testing.assert_allclose(cold["predictionScore"],
                               warm["predictionScore"], rtol=0, atol=1e-5)
    assert len(read_scores(os.path.join(pred, "train"), _SCHEMA)["uid"]) > \
        len(cold["uid"])
