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
    for mode in ("distributed", "kubernetes"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            torch_main(["--config_path", cfg_path, "--mode", mode])
    # single_node (the default) and dag are ported: the CLI hands them to
    # their runners (tests/test_torch_workflow*.py run them end to end)
    from gdmix_tpu_torch.workflow import distributed, single_node
    calls = []
    monkeypatch.setattr(single_node, "run_gdmix_single_node",
                        lambda path, resume, device: calls.append(
                            ("single_node", resume, device)) or {})
    monkeypatch.setattr(distributed, "execute_job_dag",
                        lambda dag, max_parallel: calls.append(
                            ("dag", len(dag), max_parallel)) or [])
    for argv in ([], ["--mode", "single_node", "--resume"],
                 ["--mode", "dag", "--max_parallel", "2"]):
        torch_main(["--config_path", cfg_path, "--device", "cpu"] + argv)
    assert calls == [("single_node", False, "cpu"),
                     ("single_node", True, "cpu"), ("dag", 8, 2)]
    with pytest.raises(NotImplementedError, match="A.6"):
        torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                    "--re_mode", "sharded"])


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
