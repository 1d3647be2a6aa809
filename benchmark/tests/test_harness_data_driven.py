"""A cell, a configuration and a per-layer metric added as files alone are
found and run by the harness, with no edit to any file it had."""
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import ROOT

_RUN = """
import sys, time, json
sys.path.insert(0, {tmp!r})
import torch
from benchmark import harness as h, run
assert h.BENCH.startswith({tmp!r}), h.BENCH
m = h.manifest()
w = next(x for x in m["workloads"] if x["name"] == "tiny-movielens.re-fleet")
code, line = run.run_cell(m, w, 5, 0.2, True, torch.device("cpu"),
                          time.perf_counter())
print(line)
"""


def test_new_cell_config_and_metric_are_files_alone(tmp_path):
    tmp = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    before = {os.path.relpath(os.path.join(d, f), tmp):
              open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(tmp) for f in fs}
    b = os.path.join(tmp, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "lr-movielens.json")))
    cfg["name"] = "tiny-movielens"
    json.dump(cfg, open(os.path.join(b, "configs", "tiny-movielens.json"),
                        "w"))
    t = json.load(open(os.path.join(b, "traffic",
                                    "lr-movielens.re-fleet.json")))
    t.update(config="tiny-movielens", entities=300)
    json.dump(t, open(os.path.join(b, "traffic",
                                   "tiny-movielens.re-fleet.json"), "w"))
    with open(os.path.join(b, "metrics", "fits.tiny.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['units'])\n")
    m = json.load(open(os.path.join(tmp, "BENCHMARK.json")))
    m["configs"].append({"name": "tiny-movielens", "source": "a test",
                         "file": "benchmark/configs/tiny-movielens.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny-movielens.re-fleet",
                           "config": "tiny-movielens", "traffic": "re-fleet",
                           "chips": 1, "why": "a test"})
    m["end_to_end"][1].setdefault("workloads", []).append(
        "tiny-movielens.re-fleet")
    m["per_layer"].append({"name": "fits.tiny", "unit": "fits",
                           "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "re_models_per_s",
                           "workloads": ["tiny-movielens.re-fleet"]})
    json.dump(m, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([tmp, ROOT]),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _RUN.format(tmp=tmp)],
                         capture_output=True, text=True, env=env, cwd=tmp,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["fits.tiny"]["value"] == line["attempted"]
    assert "re_marshal_share.fleet" not in line["metrics"]
    after = {os.path.relpath(os.path.join(d, f), tmp):
             open(os.path.join(d, f), "rb").read()
             for d, _, fs in os.walk(tmp) for f in fs
             if "__pycache__" not in d}
    changed = [k for k in before if k in after and after[k] != before[k]]
    assert changed == ["BENCHMARK.json"]
