"""gdmix_tpu_torch/tools/prewarm.py, as tests/test_prewarm.py holds the JAX
package's tool: both planes through the command line on the CPU, its
synthetic records equal to the JAX tool's, its models equal to an
in-process fit of the same data in float64, and GDMIX_TPU_COMPILE_CACHE
moving the CUDA libraries' build directory. That a second process over a
filled directory compiles nothing is shown on the card (chip_smoke.py
`prewarm`): there is no nvcc here."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gdmix_tpu.tools import prewarm as jax_prewarm
from gdmix_tpu_torch.tools import prewarm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--tiers", "8,16", "--entities_per_tier", "24", "--support", "8",
         "--num_features", "300"]


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "GDMIX_TPU_COMPILE_CACHE"}
    env.update(extra, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return env


@pytest.mark.parametrize("host_plane", [False, True])
def test_prewarm_cli_on_the_cpu(tmp_path, host_plane):
    cache = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-m", "gdmix_tpu_torch.tools.prewarm"] + SMALL
        + ["--device", "cpu"] + (["--host_plane"] if host_plane else []),
        cwd=ROOT, env=_env(GDMIX_TPU_COMPILE_CACHE=cache),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads("{" + out.stderr.rsplit("prewarm: {", 1)[1]
                     .splitlines()[0])
    assert rep["build_dir"] == cache
    assert rep["cuda"] == {}            # no CUDA library on the CPU
    assert set(rep["native"]) == {"io", "avro", "bucketize"}
    assert rep["models"] == 48 and rep["converged"] == [48, 48]
    assert rep["plane"] == ("host" if host_plane else "sharded")
    assert rep["fit_s"] > 0 and not any(rep["launches"].values())


@pytest.mark.parametrize("support,k", [(8, 8), (24, 8), (5, 8)])
def test_synthesize_equals_jax(support, k):
    args = ([8, 16, 32], [24, 3, 5], support, k, 300)
    got, want = prewarm.synthesize(*args), jax_prewarm.synthesize(*args)
    assert got.num_samples == want.num_samples
    for name in ("indices", "values", "nnz"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert set(got.columns) == set(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(got.columns[c], want.columns[c])


def _reference_fit(tmp_path, host_plane):
    """The same data and settings as the tool's float64 run, fit in this
    process through the model API: fit_flat on the host plane, or
    fit_records_sharded twice through a device cache."""
    from gdmix_tpu_torch.data.partitioner import (PartitionerConfig,
                                                  assign_group_ids,
                                                  group_flat)
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.params import Params, REParams
    md_file = str(tmp_path / "md.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "bag", "dtype": "float", "shape": [300],
             "isSparse": True},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "entity", "dtype": "long", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "int", "shape": [],
                        "isSparse": False}]}, f)
    model = RandomEffectLRModel(
        REParams(metadata_file=md_file, output_model_dir=str(tmp_path),
                 feature_bag="bag", partition_entity="entity",
                 l2_reg_weight=1.0, regularize_bias=False,
                 num_of_lbfgs_iterations=100, lbfgs_tolerance=1e-12,
                 lbfgs_pgtol=1e-5, num_of_lbfgs_curvature_pairs=10,
                 batch_solver="auto", dtype="float64",
                 re_mode="host" if host_plane else "auto"),
        Params(label_column_name="response", uid_column_name="uid"),
        device="cpu")
    base = model.base_params
    data = prewarm.synthesize([8, 16], [24, 24], 8, 8, 300)
    if host_plane:
        gids = assign_group_ids(data.columns["entity"], data.columns["uid"],
                                None, None)
        fg = group_flat(data, PartitionerConfig(
            partition_entity="entity", num_partitions=1,
            uid_column_name="uid"), gids, active_only=True)
        return model.fit_flat(fg, {}, base)
    cache = {}
    out = model.fit_records_sharded(data, base, device_cache=cache)
    return model.fit_records_sharded(data, base, model_weights=dict(out),
                                     device_cache=cache)


@pytest.mark.parametrize("host_plane", [False, True])
def test_prewarm_models_equal_an_in_process_fit(tmp_path, host_plane):
    got, rep = prewarm.run(SMALL + ["--dtype", "float64", "--device", "cpu"]
                           + (["--host_plane"] if host_plane else []))
    want = _reference_fit(tmp_path, host_plane)
    assert tuple(rep["converged"]) == (48, 48)
    assert set(got) == set(want) and len(want) == 48
    for e in want:
        np.testing.assert_array_equal(got[e].unique_global_indices,
                                      want[e].unique_global_indices)
        np.testing.assert_allclose(got[e].theta, want[e].theta, rtol=0,
                                   atol=1e-10, err_msg=e)


def test_compile_cache_moves_the_build_dir(tmp_path):
    code = "from gdmix_tpu_torch.ops import _cuda; print(_cuda.BUILD_DIR)"

    def build_dir(**env):
        return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=_env(**env), capture_output=True,
                              text=True, timeout=120).stdout.strip()
    assert build_dir(GDMIX_TPU_COMPILE_CACHE=str(tmp_path)) == str(tmp_path)
    assert build_dir() == os.path.join(ROOT, "build", "gdmix_tpu_torch")


def test_compile_libraries_on_the_cpu_builds_no_cuda():
    rep = prewarm.compile_libraries("cpu")
    assert rep["cuda"] == {}
    assert set(rep["native"]) == {"io", "avro", "bucketize"}
