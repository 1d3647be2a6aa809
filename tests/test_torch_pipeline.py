"""Port parity of the in-memory GDMix pipeline: global fixed effect →
per-user → per-movie, two coordinate-descent sweeps, gdmix_tpu_torch
against the JAX package (re_mode="host") on the fixture of
tests/test_in_memory_pipeline.py, in float64 on the CPU; and the AUC metric
against the JAX package's."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gdmix_tpu.data import movielens
from gdmix_tpu.io.model_avro import (load_linear_models_from_avro,
                                     load_sparse_models_from_avro)
from gdmix_tpu.ops.metrics import auc as jax_auc, mse as jax_mse
from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory as jax_run
from gdmix_tpu_torch.ops.metrics import auc as torch_auc, mse as torch_mse
from gdmix_tpu_torch.workflow.config import WorkflowConfig
from gdmix_tpu_torch.workflow.main import main as torch_main
from gdmix_tpu_torch.workflow.pipeline import \
    run_gdmix_in_memory as torch_run
from tests.test_e2e_pipeline import _config

# float64 on both sides, every solve run to convergence (the fixture's
# default 100 iterations stop the global model short of ftol, and two
# rounding-apart iterate paths then stop at two points). The global
# objective is flat in some directions: the two fits reach the same f to
# ~2e-10 relative with coefficients up to ~1.5e-5 apart, so models are held
# to 1e-4 and the AUCs, which see the scores, to 1e-6.
MODEL_ATOL = 1e-4
AUC_ATOL = 1e-6
_SOLVE = dict(dtype="float64", lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-9,
              num_of_lbfgs_iterations=2000)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ml_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mlport"))
    data = movielens.generate_synthetic(num_users=100, num_movies=120,
                                        num_ratings=6000, seed=13)
    return movielens.prepare_gdmix_data(root, data)


def _config_dict(ml_data, out_dir):
    cfg = _config(ml_data, out_dir)
    d = {"output_dir": cfg.output_dir,
         "fixed_effect_config": copy.deepcopy(cfg.fixed_effect_config),
         "random_effect_config": copy.deepcopy(cfg.random_effect_config)}
    for coords in (d["fixed_effect_config"], d["random_effect_config"]):
        for c in coords.values():
            c.update(_SOLVE)
    return d


def test_two_sweeps_match_jax(ml_data, tmp_path):
    from gdmix_tpu.workflow.config import WorkflowConfig as JaxConfig
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jax_run(JaxConfig.from_dict(_config_dict(ml_data, jdir)),
                   num_sweeps=2, re_mode="host")
    got = torch_run(WorkflowConfig.from_dict(_config_dict(ml_data, tdir)),
                    num_sweeps=2, re_mode="host", device="cpu")
    assert set(got) == set(want) == {"global", "per-user", "per-movie"}
    for name in want:
        assert abs(got[name] - want[name]) <= AUC_ATOL, \
            (name, got[name], want[name])
    # (on this small fixture the second sweep's per-movie step no longer
    # lifts AUC, on either side)
    assert got["global"] < got["per-user"]

    ff = os.path.join(ml_data, "global", "featureList", "global")
    (gw,), (jw,) = (load_linear_models_from_avro(
        os.path.join(d, "global", "models", "part-00000.avro"), ff)
        for d in (tdir, jdir))
    np.testing.assert_allclose(gw, jw, rtol=0, atol=MODEL_ATOL)
    for coord, bag in (("per-user", "per_user"), ("per-movie", "per_movie")):
        ff = os.path.join(ml_data, bag, "featureList", bag)
        g, j = (load_sparse_models_from_avro(
            os.path.join(d, coord, "models", "part-00000.avro"), ff)
            for d in (tdir, jdir))
        assert set(g) == set(j) and len(g) > 0
        for eid in j:
            np.testing.assert_array_equal(g[eid].unique_global_indices,
                                          j[eid].unique_global_indices)
            np.testing.assert_allclose(g[eid].theta, j[eid].theta, rtol=0,
                                       atol=MODEL_ATOL,
                                       err_msg=f"{coord}/{eid}")
        assert os.path.isfile(os.path.join(tdir, coord, "metric",
                                           "evalSummary.json"))


def test_cli_in_memory_and_unported_modes(ml_data, tmp_path, monkeypatch):
    out = str(tmp_path / "cli")
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config_dict(ml_data, out), f, sort_keys=False)
    metrics = torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                          "--device", "cpu"])
    assert metrics["global"] < metrics["per-user"] < metrics["per-movie"]
    # kubernetes compiles the DAG's eight jobs to manifests
    # (tests/test_torch_k8s.py holds them against the JAX package's)
    k8s = str(tmp_path / "k8s")
    assert len(torch_main(["--config_path", cfg_path, "--mode",
                           "kubernetes", "--k8s_output_dir", k8s])[
        "jobs"]) == 8
    assert os.path.isfile(os.path.join(k8s, "plan.json"))
    # single_node (the default), dag and distributed are ported: the CLI
    # hands them to their runners (tests/test_torch_workflow*.py and
    # tests/test_torch_multiprocess_pipeline.py run them end to end);
    # distributed with no job in the environment is one process
    from gdmix_tpu_torch.workflow import distributed, single_node
    calls = []
    monkeypatch.setattr(single_node, "run_gdmix_single_node",
                        lambda path, resume, device: calls.append(
                            ("single_node", resume, device)) or {})
    monkeypatch.setattr(distributed, "execute_job_dag",
                        lambda dag, max_parallel: calls.append(
                            ("dag", len(dag), max_parallel)) or [])
    for var in ("COORDINATOR_ADDRESS", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for argv in ([], ["--mode", "single_node", "--resume"],
                 ["--mode", "dag", "--max_parallel", "2"],
                 ["--mode", "distributed"]):
        torch_main(["--config_path", cfg_path, "--device", "cpu"] + argv)
    assert calls == [("single_node", False, "cpu"),
                     ("single_node", True, "cpu"), ("dag", 8, 2),
                     ("single_node", False, "cpu")]
    # --re_mode sharded, once refused, trains: the AUC ladder climbs
    metrics = torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                          "--re_mode", "sharded", "--device", "cpu"])
    assert metrics["global"] < metrics["per-user"] < metrics["per-movie"]


# ---- the entity-sharded RE plane in the pipeline ---------------------------

def _port_config(ml_data, out_dir):
    """The fixture's config as the port's WorkflowConfig, at its own
    (float32) settings."""
    cfg = _config(ml_data, out_dir)
    return WorkflowConfig.from_dict({
        "output_dir": cfg.output_dir,
        "fixed_effect_config": copy.deepcopy(cfg.fixed_effect_config),
        "random_effect_config": copy.deepcopy(cfg.random_effect_config)})


def _eight_cpus(monkeypatch):
    """The pipeline and the RE model see a mesh of eight cpu entries (the
    JAX tests' eight virtual devices)."""
    import gdmix_tpu_torch.models.random_effect_lr as port_re
    import gdmix_tpu_torch.workflow.pipeline as port_pipe
    from gdmix_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh((torch.device("cpu"),) * 8)
    monkeypatch.setattr(port_re, "get_mesh", lambda device=None: mesh)
    monkeypatch.setattr(port_pipe, "get_mesh", lambda device=None: mesh)


def _spy_planes(monkeypatch):
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    planes = {"sharded": [], "host": []}
    for plane, name in (("sharded", "fit_records_sharded"),
                        ("host", "fit_groups")):
        orig = getattr(RandomEffectLRModel, name)

        def spy(self, *a, _orig=orig, _plane=plane, **k):
            planes[_plane].append(self.model_params.partition_entity)
            return _orig(self, *a, **k)
        monkeypatch.setattr(RandomEffectLRModel, name, spy)
    return planes


def test_sharded_re_mode_matches_host_mode(ml_data, tmp_path, monkeypatch):
    """tests/test_in_memory_pipeline.py:39-72 on the port: the sharded
    plane over an 8-entry mesh reproduces the host-grouped pipeline, AUC
    within 1e-4 per coordinate and models within 1e-3 (float32, the JAX
    test's bounds)."""
    _eight_cpus(monkeypatch)
    host = torch_run(_port_config(ml_data, str(tmp_path / "h")),
                     re_mode="host", device="cpu")
    shard = torch_run(_port_config(ml_data, str(tmp_path / "s")),
                      re_mode="sharded", device="cpu")
    assert set(host) == set(shard)
    for name in host:
        assert abs(host[name] - shard[name]) < 1e-4, \
            (name, host[name], shard[name])
    for coord, bag in (("per-user", "per_user"), ("per-movie", "per_movie")):
        ff = os.path.join(ml_data, bag, "featureList", bag)
        h, g = (load_sparse_models_from_avro(
            os.path.join(str(tmp_path / d), coord, "models",
                         "part-00000.avro"), ff) for d in ("h", "s"))
        assert set(h) == set(g) and len(h) > 0
        for eid in h:
            np.testing.assert_allclose(g[eid].theta, h[eid].theta,
                                       atol=1e-3, err_msg=f"{coord}/{eid}")


def test_two_sweeps_sharded_match_jax(ml_data, tmp_path, monkeypatch):
    """Two sweeps on the sharded plane in float64, the port's over eight
    cpu entries against the JAX package's over its eight devices: sweep 2
    goes through each side's sharded sweep cache. AUC within 1e-6, models
    within 1e-4 (test_two_sweeps_match_jax's bounds)."""
    from gdmix_tpu.workflow.config import WorkflowConfig as JaxConfig
    _eight_cpus(monkeypatch)
    planes = _spy_planes(monkeypatch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jax_run(JaxConfig.from_dict(_config_dict(ml_data, jdir)),
                   num_sweeps=2, re_mode="sharded")
    got = torch_run(WorkflowConfig.from_dict(_config_dict(ml_data, tdir)),
                    num_sweeps=2, re_mode="sharded", device="cpu")
    assert planes["sharded"] == ["user_id", "movie_id"] * 2
    assert planes["host"] == []
    for name in want:
        assert abs(got[name] - want[name]) <= AUC_ATOL, \
            (name, got[name], want[name])
    for coord, bag in (("per-user", "per_user"), ("per-movie", "per_movie")):
        ff = os.path.join(ml_data, bag, "featureList", bag)
        g, j = (load_sparse_models_from_avro(
            os.path.join(d, coord, "models", "part-00000.avro"), ff)
            for d in (tdir, jdir))
        assert set(g) == set(j) and len(g) > 0
        for eid in j:
            np.testing.assert_allclose(g[eid].theta, j[eid].theta, rtol=0,
                                       atol=MODEL_ATOL,
                                       err_msg=f"{coord}/{eid}")


def test_cli_auto_routes_sharded_on_a_mesh(ml_data, tmp_path, monkeypatch):
    """tests/test_in_memory_pipeline.py:75-115 on the port: on an 8-entry
    mesh a plain `--mode in_memory` run takes the sharded plane for both
    RE coordinates; --re_mode host opts out; a YAML top-level re_mode key
    is honored."""
    _eight_cpus(monkeypatch)
    planes = _spy_planes(monkeypatch)
    cfg = _config_dict(ml_data, str(tmp_path / "out"))
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    metrics = torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                          "--device", "cpu"])
    assert planes["sharded"] == ["user_id", "movie_id"]
    assert planes["host"] == []
    assert metrics["per-movie"] > metrics["global"]
    planes["sharded"].clear()
    torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                "--re_mode", "host", "--device", "cpu"])
    assert planes["sharded"] == [] and len(planes["host"]) == 2
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(cfg, re_mode="sharded"), f, sort_keys=False)
    planes["host"].clear()
    torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                "--device", "cpu"])
    assert planes["sharded"] == ["user_id", "movie_id"]
    assert planes["host"] == []


def test_auto_single_device_routes_host(ml_data, tmp_path, monkeypatch):
    """tests/test_in_memory_pipeline.py:118-170 on the port: on a one-entry
    mesh (the CPU, or one card) auto keeps the host plane, in the pipeline
    and in fit_flat alike."""
    from gdmix_tpu_torch.data.bucketing import FlatGroups
    from test_random_effect_lr import _make_groups, _write_dataset
    from test_torch_random_effect import _torch_model
    planes = _spy_planes(monkeypatch)
    torch_run(_port_config(ml_data, str(tmp_path / "auto1")), device="cpu")
    assert planes["sharded"] == [] and len(planes["host"]) == 2
    planes["host"].clear()
    groups, _ = _make_groups(num_entities=3, seed=7)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, schema = _torch_model(md_file, train_dir, feature_file,
                                 str(tmp_path / "m"), re_mode="auto")
    K = max(len(ix) for g in groups for ix in g.ragged_indices)
    fg = FlatGroups(
        entity_ids=np.array([g.entity_id for g in groups], object),
        counts=np.array([len(g.columns["response"]) for g in groups],
                        np.int64),
        columns={k: np.concatenate([g.columns[k] for g in groups])
                 for k in groups[0].columns},
        indices=np.vstack([np.array([np.pad(ix, (0, K - len(ix)))
                                     for ix in g.ragged_indices], np.int32)
                           for g in groups]),
        values=np.vstack([np.array([np.pad(v, (0, K - len(v)))
                                    for v in g.ragged_values])
                          for g in groups]),
        rec_nnz=np.concatenate([np.array([len(ix) for ix in
                                          g.ragged_indices], np.int32)
                                for g in groups]))
    model.fit_flat(fg, {}, schema)
    assert planes["sharded"] == [] and planes["host"] == ["user_id"]


@pytest.mark.parametrize("weighted", [False, True])
def test_auc_and_mse_match_jax(weighted):
    """Ties (scores on a coarse grid) and sample weights."""
    rng = np.random.RandomState(0)
    s = np.round(rng.randn(2000), 1)
    y = (rng.rand(2000) < 1 / (1 + np.exp(-s))).astype(np.float64)
    w = rng.rand(2000) + 0.1 if weighted else None
    want = float(jax_auc(jnp.asarray(s), jnp.asarray(y),
                         None if w is None else jnp.asarray(w)))
    assert abs(float(torch_auc(s, y, w)) - want) <= 1e-12
    assert abs(float(torch_mse(s, y))
               - float(jax_mse(jnp.asarray(s), jnp.asarray(y)))) <= 1e-12
