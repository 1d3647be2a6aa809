"""Port parity of the data-job CLI (`python -m gdmix_tpu_torch.workflow.jobs
<job>`) and the job DAG (`--mode dag`, `--compile_dag_to`): each of the six
jobs given the same argv as the JAX package's, outputs compared; the DAG's
jobs against the JAX package's; the executor's ordering and failure; and
the whole pipeline as eight subprocesses on the CPU."""
import base64
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from gdmix_tpu.data import movielens
from gdmix_tpu.io import avro
from gdmix_tpu.io.input_pipeline import read_per_record
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.io.model_avro import BAYESIAN_LINEAR_MODEL_SCHEMA
from gdmix_tpu.params import SchemaParams
from gdmix_tpu.workflow import jobs as jax_jobs
from gdmix_tpu.workflow.config import WorkflowConfig as JaxConfig
from gdmix_tpu.workflow.distributed import generate_job_dag as jax_dag
from gdmix_tpu_torch.io.scores import write_scores
from gdmix_tpu_torch.workflow import jobs
from gdmix_tpu_torch.workflow.config import WorkflowConfig
from gdmix_tpu_torch.workflow.distributed import (compile_dag,
                                                  execute_job_dag,
                                                  generate_job_dag,
                                                  iter_dependency_order)
from gdmix_tpu_torch.workflow.main import main as torch_main
from gdmix_tpu_torch.workflow.single_node import run_gdmix_single_node
from tests.test_e2e_pipeline import _config
from tests.test_torch_workflow import MODES_AUC_ATOL

COORDS = ("global", "per-user", "per-movie")
_SCHEMA = SchemaParams(uid_column_name="uid", label_column_name="response",
                       prediction_score_column_name="predictionScore")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ml_data(tmp_path_factory):
    """The JAX package's DAG fixture (tests/test_workflow_cli.py)."""
    root = str(tmp_path_factory.mktemp("mljobs"))
    data = movielens.generate_synthetic(num_users=50, num_movies=60,
                                        num_ratings=3000, seed=23)
    return movielens.prepare_gdmix_data(root, data)


def _config_dict(ml, out):
    cfg = _config(ml, out)
    return {"output_dir": cfg.output_dir,
            "fixed_effect_config": cfg.fixed_effect_config,
            "random_effect_config": cfg.random_effect_config}


def _write_config(ml, out, path):
    with open(path, "w") as f:
        # coordinate order is the coordinate-descent order
        yaml.safe_dump(_config_dict(ml, out), f, sort_keys=False)
    return path


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


# ------------------------------------------------------------------ jobs --

def _scores(ml, root, bag="global"):
    """Score files for every record of `bag`, as a previous coordinate
    writes them (total and per-coordinate score, label): (train, valid).
    Written by the port: the JAX package's writer can encode freed memory
    for the int32 labels (ROADMAP C.9)."""
    md = DatasetMetadata.from_file(os.path.join(
        ml, bag, "metadata", "tensor_metadata.json"))
    rng = np.random.RandomState(5)
    dirs = []
    for split in ("trainingData", "validationData"):
        data = read_per_record(os.path.join(ml, bag, split), md, bag)
        uids = data.columns["uid"].astype(np.int64)
        d = os.path.join(root, "scores", split)
        s = rng.randn(len(uids))
        write_scores(os.path.join(d, "part-00000.avro"), _SCHEMA, uids, s,
                     scores_per_coordinate=0.3 * s,
                     labels=data.columns["response"])
        dirs.append(d)
    return dirs


def _job_partitioner(ml, root, out):
    train_s, valid_s = _scores(ml, root)
    bag = os.path.join(ml, "per_user")
    argv = ["partitioner", f"--trainingDataDir={bag}/trainingData",
            f"--validationDataDir={bag}/validationData",
            f"--metadataFile={bag}/metadata/tensor_metadata.json",
            "--partitionId=user_id", "--numPartitions=2",
            "--featureBag=per_user", "--minNumOfSamplesPerModel=40",
            f"--partitionedTrainingDataDir={out}/trainingData",
            f"--partitionedValidationDataDir={out}/validationData",
            f"--outputMetadataFile={out}/metadata/tensor_metadata.json",
            f"--outputPartitionListFile={out}/partitionList.txt",
            f"--trainingScoreDir={train_s}",
            f"--validationScoreDir={valid_s}"]

    def check(got, want):
        g, w = _tree(got), _tree(want)
        assert g == w
        assert any("passive" in k for k in g) and any("active" in k
                                                      for k in g)
        assert "partitionList.txt" in g
    return argv, check


def _job_evaluator(ml, root, out):
    _, valid_s = _scores(ml, root)
    argv = ["evaluator", f"--metricsInputDir={valid_s}",
            f"--outputMetricFile={out}"]

    def check(got, want):
        g, w = (json.load(open(os.path.join(d, "evalSummary.json")))
                for d in (got, want))
        assert set(g) == set(w) == {"auc"}
        assert 0.4 < g["auc"] < 0.6   # random scores
        assert abs(g["auc"] - w["auc"]) <= 1e-12
    return argv, check


def _job_best_model(ml, root, out):
    metrics, models = [], []
    for i, value in enumerate([0.61, 0.83, 0.72]):
        m, d = (os.path.join(root, f"run_{i}", s) for s in ("metric",
                                                            "models"))
        os.makedirs(m)
        os.makedirs(os.path.join(d, "sub"))
        with open(os.path.join(m, "evalSummary.json"), "w") as f:
            json.dump({"auc": value}, f)
        for rel in ("part-00000.avro", "sub/part-00001.avro"):
            with open(os.path.join(d, rel), "wb") as f:
                f.write(f"model {i} {rel}".encode())
        metrics.append(m)
        models.append(d)
    hp = base64.b64encode(json.dumps(
        {str(i): {"l2_reg_weight": 10.0 ** i} for i in range(3)}).encode())
    argv = ["best-model", f"--inputMetricsPaths={';'.join(metrics)}",
            f"--inputModelPaths={';'.join(models)}",
            f"--outputBestModelPath={out}/best",
            f"--outputBestMetricsPath={out}/best_metrics",
            f"--hyperparameters={hp.decode()}", "--copyBestOutput=true"]

    def check(got, want):
        g = _tree(got)
        assert g == _tree(want)
        assert json.loads(g["best/evals.json"])["best model index"] == 1
        assert g["best/sub/part-00001.avro"] == b"model 1 sub/part-00001.avro"
        assert "best_metrics/evalSummary.json" in g
    return argv, check


def _job_splitter(ml, root, out):
    rng = np.random.RandomState(7)
    ntv = lambda e, f: {"name": f"u{e}_gdmixcross_f{f}", "term": f"t{f % 2}",
                        "value": float(rng.randn())}
    recs = [{"modelId": "global model", "modelClass": "x",
             "lossFunction": "", "means": [ntv(e, f) for e in range(5)
                                           for f in range(3)],
             "variances": [ntv(e, f) for e in range(5) for f in range(3)]}]
    src = os.path.join(root, "crossed")
    os.makedirs(src)
    avro.write_records(os.path.join(src, "part-00000.avro"),
                       BAYESIAN_LINEAR_MODEL_SCHEMA, recs)
    argv = ["lr-model-splitter", f"--modelInputDir={src}",
            f"--modelOutputDir={out}", "--numOutputFiles=2"]

    def check(got, want):
        g = _tree(got)
        assert g == _tree(want)
        assert sorted(g) == ["part-00000.avro", "part-00001.avro"]
        ids = [r["modelId"] for f in sorted(g)
               for r in avro.read_records(os.path.join(got, f))]
        assert ids == [f"u{e}" for e in range(5)]
    return argv, check


def _job_offset_updater(ml, root, out):
    train_s, valid_s = _scores(ml, root)
    bag = os.path.join(ml, "global")
    argv = ["offset-updater", f"--trainingDataDir={bag}/trainingData",
            f"--trainingScoreDir={train_s}",
            f"--trainingScorePerCoordinateDir={train_s}",
            f"--outputTrainingDataDir={out}/train",
            f"--validationDataDir={bag}/validationData",
            f"--validationScoreDir={valid_s}",
            f"--outputValidationDataDir={out}/valid",
            f"--metadataFile={bag}/metadata/tensor_metadata.json",
            f"--outputMetadataFile={out}/md.json", "--featureBag=global"]

    def check(got, want):
        with open(os.path.join(got, "md.json")) as f, \
                open(os.path.join(want, "md.json")) as g:
            assert json.load(f) == json.load(g)
        md = DatasetMetadata.from_file(os.path.join(got, "md.json"))
        for split in ("train", "valid"):
            g, w = (read_per_record(os.path.join(d, split), md, "global")
                    for d in (got, want))
            assert g.num_samples == w.num_samples > 0
            assert set(g.columns) == set(w.columns)
            og, ow = (np.argsort(x.columns["uid"]) for x in (g, w))
            for k in g.columns:
                np.testing.assert_allclose(
                    np.asarray(g.columns[k], np.float64)[og],
                    np.asarray(w.columns[k], np.float64)[ow], rtol=0,
                    atol=1e-12, err_msg=k)
            np.testing.assert_array_equal(g.indices[og], w.indices[ow])
            np.testing.assert_array_equal(g.values[og], w.values[ow])
            assert np.abs(g.columns["offset"]).max() > 0
    return argv, check


def _job_metadata_generator(ml, root, out):
    md_in = os.path.join(root, "md_in.json")
    with open(md_in, "w") as f:
        json.dump({"features": [{"name": "uid", "dtype": "long", "shape": [],
                                 "isSparse": False}], "labels": []}, f)
    argv = ["metadata-generator",
            f"--dataDir={ml}/per_movie/trainingData",
            f"--inputMetadataFile={md_in}", f"--outputMetadataFile={out}",
            "--extraColumns=extra_weight:float,tag:long"]

    def check(got, want):
        g, w = (json.load(open(p)) for p in (got, want))
        assert g == w
        names = {t["name"] for t in g["features"]}
        assert {"uid", "movie_id", "extra_weight", "tag"} <= names
    return argv, check


JOBS = {"partitioner": _job_partitioner, "evaluator": _job_evaluator,
        "best-model": _job_best_model, "lr-model-splitter": _job_splitter,
        "offset-updater": _job_offset_updater,
        "metadata-generator": _job_metadata_generator}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_job_matches_jax(job, ml_data, tmp_path):
    """The same argv through the JAX package's jobs CLI and the port's."""
    got, want = str(tmp_path / "torch"), str(tmp_path / "jax")
    argv, check = JOBS[job](ml_data, str(tmp_path), "{out}")
    jax_jobs.main([a.replace("{out}", want) for a in argv])
    jobs.main([a.replace("{out}", got) for a in argv])
    check(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
def test_score_encoder_holds_converted_columns(dtype):
    """The port's avro column encoder converts each column to int64 or
    float64 and encodes lazily, so the converted copies must outlive the
    call that made them: memory freed in between is overwritten here before
    the blocks are drawn (the JAX package's copy frees them, ROADMAP C.9)."""
    from gdmix_tpu_torch import native
    from gdmix_tpu_torch.io import avro as torch_avro
    from gdmix_tpu_torch.io.scores import inference_output_schema
    schema = inference_output_schema(_SCHEMA, has_label=True,
                                     has_weight=False,
                                     has_logits_per_coordinate=True)
    n = 5000
    labels = (np.arange(n) % 2).astype(dtype)
    scores = np.linspace(-1.0, 1.0, n).astype(dtype)
    blocks = native.encode_avro_column_blocks(schema, {
        "uid": np.arange(n), "predictionScore": scores, "response": labels,
        "predictionScorePerCoordinate": 0.5 * scores})
    junk = [np.full(n, 7.5e300) for _ in range(50)]  # noqa: F841
    buf = io.BytesIO()
    torch_avro.write_encoded_blocks(buf, schema, blocks)
    buf.seek(0)
    recs = list(torch_avro.read_records(buf))
    got = {k: np.array([r[k] for r in recs]) for k in recs[0]}
    np.testing.assert_array_equal(got["uid"], np.arange(n))
    np.testing.assert_array_equal(got["response"], labels.astype(np.float32))
    np.testing.assert_array_equal(got["predictionScore"],
                                  scores.astype(np.float32))
    np.testing.assert_array_equal(got["predictionScorePerCoordinate"],
                                  (0.5 * scores).astype(np.float32))


def test_jobs_usage_names_the_port():
    assert set(jobs._JOBS) == set(jax_jobs._JOBS) == set(JOBS)
    with pytest.raises(SystemExit,
                       match="python -m gdmix_tpu_torch.workflow.jobs"):
        jobs.main(["no-such-job"])


# ------------------------------------------------------------------- DAG --

def _mapped(dag):
    """JAX's DAG with the port's module names."""
    return [{**j, "command": [a.replace("gdmix_tpu.", "gdmix_tpu_torch.")
                              for a in j["command"]]} for j in dag]


def test_job_dag_matches_jax(tmp_path):
    d = _config_dict("/data/movieLens", str(tmp_path / "out"))
    want = _mapped(jax_dag(JaxConfig.from_dict(d)))
    assert generate_job_dag(WorkflowConfig.from_dict(d)) == want
    assert [j["name"] for j in want] == [
        "global-tf-train", "global-compute-metric",
        "per-user-partition", "per-user-tf-train", "per-user-compute-metric",
        "per-movie-partition", "per-movie-tf-train",
        "per-movie-compute-metric"]
    # a device asked for goes to the train jobs, and only to them
    cpu = generate_job_dag(WorkflowConfig.from_dict(d), device="cpu")
    for j, w in zip(cpu, want):
        extra = ["--device=cpu"] if j["type"] == "gdmix_tpu_train" else []
        assert j == {**w, "command": w["command"] + extra}
    assert [j["name"] for j in iter_dependency_order(cpu[::-1])] == \
        [j["name"] for j in want]


def test_compile_dag_cli(tmp_path):
    cfg = _write_config("/data/ml", str(tmp_path / "out"),
                        str(tmp_path / "c.yaml"))
    dag_file = str(tmp_path / "dag" / "dag.json")
    assert torch_main(["--config_path", cfg, "--compile_dag_to", dag_file,
                       "--device", "cpu"]) == {}
    with open(dag_file) as f:
        dag = json.load(f)
    assert dag == {"name": "gdmix-tpu-workflow",
                   "jobs": compile_dag(cfg, str(tmp_path / "again.json"),
                                       device="cpu")}
    assert len(dag["jobs"]) == 8
    assert sum("--device=cpu" in j["command"] for j in dag["jobs"]) == 3


def test_execute_job_dag_ordering_and_failure(tmp_path):
    """Executor unit semantics: dependency order, parallel ready-set, abort on
    failure (the reference launcher contract, launch_crd.py:31-101)."""
    marker = os.path.join(str(tmp_path), "order.txt")

    def j(name, deps, cmd=None):
        return {"name": name, "type": "t", "depends_on": deps,
                "command": cmd or ["bash", "-c", f"echo {name} >> {marker}"]}
    # diamond: a → (b, c) → d
    order = execute_job_dag([j("d", ["b", "c"]), j("b", ["a"]),
                             j("c", ["a"]), j("a", [])], max_parallel=2)
    assert order[0] == "a" and order[-1] == "d"
    lines = open(marker).read().split()
    assert lines[0] == "a" and lines[-1] == "d" and set(lines) == {
        "a", "b", "c", "d"}
    with pytest.raises(RuntimeError, match="'boom' failed .exit 3.:\nlast"):
        execute_job_dag([j("ok", []), j("never", ["boom"]),
                         j("boom", ["ok"], ["bash", "-c",
                                            "echo last; exit 3"])])
    with pytest.raises(RuntimeError, match="unknown"):
        execute_job_dag([j("x", ["ghost"])])
    with pytest.raises(RuntimeError, match="deadlock"):
        execute_job_dag([j("x", ["y"]), j("y", ["x"])])
    with pytest.raises(RuntimeError, match="deadlock"):
        list(iter_dependency_order([j("x", ["y"]), j("y", ["x"])]))


def test_dag_mode_runs_full_pipeline(ml_data, tmp_path, caplog):
    """`--mode dag --device cpu` runs the eight generated commands as
    subprocesses: the file-based pipeline driven purely through the DAG, to
    the single-node run's AUCs. Each train job's output, logged with its
    wall, ends with its kernel launches: none on the CPU."""
    out = str(tmp_path / "dag-out")
    cfg = _write_config(ml_data, out, str(tmp_path / "cfg.yaml"))
    with caplog.at_level("INFO", logger="gdmix_tpu_torch.workflow"):
        result = torch_main(["--config_path", cfg, "--mode", "dag",
                             "--device", "cpu"])
    assert len(result["jobs"]) == 8
    done = {r.job: r for r in caplog.records if hasattr(r, "job")}
    assert sorted(done) == sorted(result["jobs"])
    assert all(r.seconds > 0 for r in done.values())
    launches = {name: json.loads(r.output.split("kernel launches: ")[1]
                                 .splitlines()[0])
                for name, r in done.items() if name.endswith("-tf-train")}
    assert sorted(launches) == [f"{c}-tf-train" for c in sorted(COORDS)]
    for counts in launches.values():
        assert len(counts) == 12 and not any(counts.values()), counts
    aucs = {}
    for coord in COORDS:
        with open(os.path.join(out, coord, "metric",
                               "evalSummary.json")) as f:
            aucs[coord] = json.load(f)["auc"]
    assert aucs["global"] < aucs["per-user"] < aucs["per-movie"]
    single = run_gdmix_single_node(
        WorkflowConfig.from_dict(_config_dict(ml_data,
                                              str(tmp_path / "single"))),
        device="cpu")
    for coord in COORDS:
        assert abs(aucs[coord] - single[coord]) < MODES_AUC_ATOL, \
            (coord, aucs[coord], single[coord])
