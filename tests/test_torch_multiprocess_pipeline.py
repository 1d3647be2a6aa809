"""Two REAL processes of gdmix_tpu_torch over a gloo process group on the
CPU running the whole pipeline (the port of
tests/test_multiprocess_pipeline.py), in float64:

- in memory, 2 sweeps, on both random-effect planes: the fixed effect fits
  on rank::2 rows with the gradient all-reduce, entities are owned
  round-robin and merged through the model-file exchange; every process
  ends with the same AUC ladder, within 2e-3 of the JAX package's
  one-process pipeline (JAX's bound, tests/test_multiprocess_pipeline.py:45)
  and of the port's one-process run;
- `--mode distributed`: the file-based pipeline in every process, the
  set-up and the data jobs on the chief alone (the JAX package runs them
  in every process and they race on one tree: ROADMAP C.14)."""
import json
import os

import pytest
import torch
import yaml

from gdmix_tpu.data import movielens
from gdmix_tpu.workflow.config import WorkflowConfig as JaxConfig
from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory as jax_in_memory
from gdmix_tpu.workflow.single_node import \
    run_gdmix_single_node as jax_single_node
from gdmix_tpu_torch.workflow.config import WorkflowConfig
from gdmix_tpu_torch.workflow.pipeline import \
    run_gdmix_in_memory as port_in_memory
from gdmix_tpu_torch.workflow.single_node import \
    run_gdmix_single_node as port_single_node
from tests.test_torch_pipeline import _config_dict
from tests.torch_multiproc_runner import launch

AUC_ATOL = 2e-3
COORDS = ("global", "per-user", "per-movie")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ml_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mlmp"))
    data = movielens.generate_synthetic(num_users=60, num_movies=70,
                                        num_ratings=3500, seed=17)
    return movielens.prepare_gdmix_data(root, data)


def _write(ml_data, out, path):
    with open(path, "w") as f:
        yaml.safe_dump(_config_dict(ml_data, out), f, sort_keys=False)
    return path


@pytest.mark.parametrize("re_mode", ["host", "sharded"])
def test_two_process_in_memory_matches_one(ml_data, tmp_path, re_mode):
    cfg = _write(ml_data, str(tmp_path / "mp"), str(tmp_path / "cfg.yaml"))
    res = launch("pipeline", dict(config=cfg, re_mode=re_mode,
                                  num_sweeps=2))
    # every process holds the same ladder (the merged models are equal)
    assert res[0]["metrics"] == res[1]["metrics"]
    got = res[0]["metrics"]
    plane = "fit_records_sharded" if re_mode == "sharded" else "fit_groups"
    for r in res:
        assert [p for p in r["planes"]] == [
            [plane, "user_id"], [plane, "movie_id"]] * 2, r["planes"]
        # one partial model file a process, each coordinate and sweep
        assert [(e["coordinate"], e["sweep"], e["files"])
                for e in r["exchanges"]] == [
            ("per-user", 0, 2), ("per-movie", 0, 2),
            ("per-user", 1, 2), ("per-movie", 1, 2)]
    want_jax = jax_in_memory(JaxConfig.from_dict(_config_dict(
        ml_data, str(tmp_path / "jax"))), num_sweeps=2, re_mode=re_mode)
    want_port = port_in_memory(WorkflowConfig.from_dict(_config_dict(
        ml_data, str(tmp_path / "one"))), num_sweeps=2, re_mode=re_mode,
        device="cpu")
    for c in COORDS:
        assert abs(got[c] - want_jax[c]) <= AUC_ATOL, (c, got, want_jax)
        assert abs(got[c] - want_port[c]) <= AUC_ATOL, (c, got, want_port)
    assert got["per-movie"] > got["global"]
    for c in COORDS:   # the chief wrote the final artifacts
        for sub in ("models/part-00000.avro", "metric/evalSummary.json"):
            assert os.path.isfile(os.path.join(str(tmp_path / "mp"), c, sub))


def test_two_process_distributed_mode(ml_data, tmp_path):
    out = str(tmp_path / "mp")
    cfg = _write(ml_data, out, str(tmp_path / "cfg.yaml"))
    res = launch("single_node", dict(config=cfg))
    assert res[0]["metrics"] == res[1]["metrics"]
    # C.14: the tree's set-up, the partitioner and the evaluator ran on the
    # chief alone, once a coordinate (two partitioner runs: the two RE
    # coordinates)
    assert res[0]["jobs"] == {"_create_subdirs": 3, "run_partitioner": 2,
                              "run_evaluator": 3}, res[0]["jobs"]
    assert res[1]["jobs"] == {}, res[1]["jobs"]
    got = res[0]["metrics"]
    for c in COORDS:
        with open(os.path.join(out, c, "metric", "evalSummary.json")) as f:
            assert json.load(f)["auc"] == got[c]
    want_jax = jax_single_node(JaxConfig.from_dict(_config_dict(
        ml_data, str(tmp_path / "jax"))))
    want_port = port_single_node(WorkflowConfig.from_dict(_config_dict(
        ml_data, str(tmp_path / "one"))), device="cpu")
    for c in COORDS:
        assert abs(got[c] - want_jax[c]) <= AUC_ATOL, (c, got, want_jax)
        assert abs(got[c] - want_port[c]) <= AUC_ATOL, (c, got, want_port)
    assert got["global"] < got["per-user"]
