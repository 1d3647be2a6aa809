"""Port parity of the file-based GDMix workflow (`--mode single_node`, the
CLI's default): gdmix_tpu_torch against the JAX package on the fixture of
tests/test_torch_pipeline.py, in float64 on the CPU; against the port's own
in-memory pipeline; `--resume`; a remote (mem://) output directory; the
sweep; and no silent CPU without a card."""
import base64
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from gdmix_tpu.data import movielens
from gdmix_tpu.io.model_avro import (load_linear_models_from_avro,
                                     load_sparse_models_from_avro)
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.params import SchemaParams
from gdmix_tpu.workflow.config import WorkflowConfig as JaxConfig
from gdmix_tpu.workflow.single_node import \
    run_gdmix_single_node as jax_single_node
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.workflow.config import WorkflowConfig
from gdmix_tpu_torch.workflow.main import main as torch_main
from gdmix_tpu_torch.workflow.pipeline import run_gdmix_in_memory
from gdmix_tpu_torch.workflow.single_node import run_gdmix_single_node
from tests.test_torch_pipeline import AUC_ATOL, MODEL_ATOL, _config_dict

# the JAX package's own bound between its in-memory and file-based runs
# (tests/test_in_memory_pipeline.py:29): the same math through two
# plumbings, whose solves stop at their own tolerances
MODES_AUC_ATOL = 2e-3
COORDS = (("global", "global"), ("per-user", "per_user"),
          ("per-movie", "per_movie"))
_SCHEMA = SchemaParams(uid_column_name="uid", label_column_name="response",
                       prediction_score_column_name="predictionScore")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ml_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mlwf"))
    data = movielens.generate_synthetic(num_users=100, num_movies=120,
                                        num_ratings=6000, seed=13)
    return movielens.prepare_gdmix_data(root, data)


@pytest.fixture(scope="module")
def port_run(ml_data, tmp_path_factory):
    """The port's single-node run in float64: (output dir, metrics)."""
    torch.set_num_threads(2)
    out = str(tmp_path_factory.mktemp("wfport") / "out")
    metrics = run_gdmix_single_node(
        WorkflowConfig.from_dict(_config_dict(ml_data, out)), device="cpu")
    return out, metrics


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs_ in os.walk(root) for f in fs_)


def _models(out, coord, bag, ml):
    ff = os.path.join(ml, bag, "featureList", bag)
    d = os.path.join(out, coord, "models")
    if coord == "global":
        (w,) = load_linear_models_from_avro(os.path.join(d, "part-00000.avro"),
                                            ff)
        return w
    models = {}
    for name in sorted(os.listdir(d)):
        models.update(load_sparse_models_from_avro(os.path.join(d, name), ff))
    return models


def test_single_node_matches_jax(ml_data, port_run, tmp_path):
    tdir, got = port_run
    jdir = str(tmp_path / "jax")
    want = jax_single_node(JaxConfig.from_dict(_config_dict(ml_data, jdir)))
    assert set(got) == set(want) == {c for c, _ in COORDS}
    for name in want:
        assert abs(got[name] - want[name]) <= AUC_ATOL, \
            (name, got[name], want[name])
    assert got["global"] < got["per-user"] < got["per-movie"]
    for coord, bag in COORDS:
        # the directory contract, file for file
        assert _files(os.path.join(tdir, coord)) == \
            _files(os.path.join(jdir, coord)), coord
        for scores in ("train_scores", "validation_scores"):
            g, j = (read_scores(os.path.join(d, coord, scores), _SCHEMA)
                    for d in (tdir, jdir))
            assert len(g["uid"]) == len(set(g["uid"])) > 0
            assert set(g["uid"]) == set(j["uid"]), (coord, scores)
        g, j = (_models(d, coord, bag, ml_data) for d in (tdir, jdir))
        if coord == "global":
            np.testing.assert_allclose(g, j, rtol=0, atol=MODEL_ATOL)
            continue
        assert set(g) == set(j) and len(g) > 0
        for eid in j:
            np.testing.assert_array_equal(g[eid].unique_global_indices,
                                          j[eid].unique_global_indices)
            np.testing.assert_allclose(g[eid].theta, j[eid].theta, rtol=0,
                                       atol=MODEL_ATOL,
                                       err_msg=f"{coord}/{eid}")


def test_single_node_matches_in_memory(ml_data, port_run, tmp_path):
    _, file_metrics = port_run
    mem_metrics = run_gdmix_in_memory(
        WorkflowConfig.from_dict(_config_dict(ml_data, str(tmp_path))),
        device="cpu")
    assert set(mem_metrics) == set(file_metrics)
    for name in mem_metrics:
        assert abs(mem_metrics[name] - file_metrics[name]) \
            < MODES_AUC_ATOL, (name, mem_metrics[name], file_metrics[name])


def test_resume_skips_completed_coordinates(ml_data, port_run, tmp_path):
    """--resume restarts a crashed pipeline from the first unfinished
    coordinate: completed coordinates keep their outputs untouched and their
    recorded metrics; wiped ones re-run to the same result. The run's
    output is copied (times kept), so the crash happens on the copy."""
    src, first = port_run
    out = str(tmp_path / "out")
    shutil.copytree(src, out)
    cfg = WorkflowConfig.from_dict(_config_dict(ml_data, out))

    def fingerprint(name):
        return os.path.getmtime(os.path.join(out, name, "models",
                                             "part-00000.avro"))

    fp_global, fp_user = fingerprint("global"), fingerprint("per-user")
    shutil.rmtree(os.path.join(out, "per-movie"))   # crash in the last one
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config_dict(ml_data, out), f, sort_keys=False)
    second = torch_main(["--config_path", cfg_path, "--resume",
                         "--device", "cpu"])
    assert second["global"] == first["global"]
    assert second["per-user"] == first["per-user"]
    assert second["per-movie"] == pytest.approx(first["per-movie"], abs=1e-9)
    assert fingerprint("global") == fp_global
    assert fingerprint("per-user") == fp_user
    # without --resume every coordinate runs again
    assert run_gdmix_single_node(cfg, device="cpu") == pytest.approx(
        first, abs=1e-9)
    assert fingerprint("global") != fp_global


def test_remote_output_dir(ml_data, port_run, tmp_path, monkeypatch):
    """A mem:// output directory: every stage reads and writes through the
    filesystem seam, a stale object in a coordinate's tree is cleared, a
    best-model copy lands there, and no local directory named after the
    URL appears (the JAX package's _create_subdirs makes one)."""
    from gdmix_tpu_torch.workflow.jobs import main as jobs_main
    store = fs.MemFS()
    monkeypatch.setitem(fs._registry, "mem", store)
    monkeypatch.chdir(tmp_path)
    out = "mem://bkt/run"
    with fs.open(f"{out}/per-movie/models/stale.avro", "wb") as f:
        f.write(b"stale")
    got = run_gdmix_single_node(
        WorkflowConfig.from_dict(_config_dict(ml_data, out)), device="cpu")
    assert got == pytest.approx(port_run[1], abs=1e-9)
    assert not fs.exists(f"{out}/per-movie/models/stale.avro")
    assert fs.find_files(f"{out}/per-user/models") == [
        f"{out}/per-user/models/part-0000{i}.avro" for i in (0, 1)]

    hp = base64.b64encode(json.dumps({"0": {"c": "per-user"},
                                      "1": {"c": "per-movie"}}).encode())
    jobs_main(["best-model",
               f"--inputMetricsPaths={out}/per-user/metric;"
               f"{out}/per-movie/metric",
               f"--inputModelPaths={out}/per-user/models;"
               f"{out}/per-movie/models",
               "--outputBestModelPath=mem://bkt/best",
               "--outputBestMetricsPath=mem://bkt/best_metrics",
               f"--hyperparameters={hp.decode()}", "--copyBestOutput=true"])
    with fs.open("mem://bkt/best/evals.json") as f:
        assert json.load(f)["best model index"] == 1
    for src, dst in (("per-movie/models/part-00000.avro",
                      "best/part-00000.avro"),
                     ("per-movie/metric/evalSummary.json",
                      "best_metrics/evalSummary.json")):
        with fs.open(f"{out}/{src}", "rb") as a, \
                fs.open(f"mem://bkt/{dst}", "rb") as b:
            assert a.read() == b.read()
    assert os.listdir(tmp_path) == []


def test_default_mode_needs_a_card_or_the_cpu_asked_for(ml_data, tmp_path,
                                                         monkeypatch):
    """No silent CPU: without a card, the CLI's default mode and the DAG
    raise before anything is written or launched."""
    out = str(tmp_path / "out")
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config_dict(ml_data, out), f, sort_keys=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--mode", "dag"], ["--resume"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_main(["--config_path", cfg_path] + extra)
    assert not os.path.exists(out)


def test_expand_grid_matches_jax():
    from gdmix_tpu.workflow.sweep import expand_grid as jax_grid
    from gdmix_tpu_torch.workflow.sweep import expand_grid
    grid = {"l2_reg_weight": [0.5, 2.0], "has_intercept": [True, False],
            "num_of_lbfgs_iterations": [100]}
    assert expand_grid(grid) == jax_grid(grid)
    assert len(expand_grid(grid)) == 4


def test_sweep_picks_the_same_best_as_jax(tmp_path):
    """Two l2_reg_weight points in float64: the port's sweep, in each mode,
    picks the JAX package's winner (its in-memory sweep on the host plane)
    and copies that run's model and metrics."""
    from gdmix_tpu.workflow.sweep import run_sweep as jax_sweep
    from gdmix_tpu_torch.workflow.sweep import run_sweep
    root = str(tmp_path)
    ml = movielens.prepare_gdmix_data(
        root, movielens.generate_synthetic(num_users=40, num_movies=50,
                                           num_ratings=2500, seed=31))
    cfg = {**_config_dict(ml, os.path.join(root, "ignored")),
           "re_mode": "host"}
    grid = {"l2_reg_weight": [0.1, 30.0]}
    want, jgrid = jax_sweep(JaxConfig.from_dict(cfg), grid, "per-movie",
                            os.path.join(root, "jax"))

    def aucs(side):
        return [json.load(open(os.path.join(
            root, side, f"run_{i}", "per-movie", "metric",
            "evalSummary.json")))["auc"] for i in range(2)]
    assert abs(aucs("jax")[0] - aucs("jax")[1]) > 10 * MODES_AUC_ATOL
    for mode, atol in (("in_memory", AUC_ATOL),
                       ("single_node", MODES_AUC_ATOL)):
        got, tgrid = run_sweep(WorkflowConfig.from_dict(cfg), grid,
                               "per-movie", os.path.join(root, mode),
                               mode=mode, device="cpu")
        assert (got, tgrid) == (want, jgrid), mode
        np.testing.assert_allclose(aucs(mode), aucs("jax"), rtol=0,
                                   atol=atol, err_msg=mode)
        with open(os.path.join(root, mode, "best_metrics",
                               "evalSummary.json")) as f:
            assert json.load(f)["auc"] == aucs(mode)[got]
        best = os.path.join(root, mode, "best")
        with open(os.path.join(best, "evals.json")) as f:
            assert json.load(f) == {"best model index": got,
                                    "model params": json.dumps(tgrid[got])}
        with open(os.path.join(best, "part-00000.avro"), "rb") as a, \
                open(os.path.join(root, mode, f"run_{got}", "per-movie",
                                  "models", "part-00000.avro"), "rb") as b:
            assert a.read() == b.read()
    with pytest.raises(ValueError, match="in_memory or single_node"):
        run_sweep(WorkflowConfig.from_dict(cfg), grid, "per-movie",
                  os.path.join(root, "x"), mode="dag", device="cpu")
