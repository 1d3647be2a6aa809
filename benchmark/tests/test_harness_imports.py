"""No module of JAX or of the JAX package in a run; the reference imports
nothing of the program."""
import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import BENCH, FORBIDDEN, ROOT

_REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
import pytest
from benchmark.tests.small import run_small
from benchmark import harness as h
mp = pytest.MonkeyPatch()
code, line = run_small(mp, {cell!r})
print(json.dumps({{"code": code, "loaded": h.forbidden_modules(),
                   "names": sorted({{k.split(".")[0] for k in sys.modules}})}}))
"""


@pytest.mark.parametrize("cell", ["lr-movielens.re-fleet", "lr-criteo.fe-fit"])
def test_a_rehearsed_cell_loads_no_jax(cell):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _REHEARSE.format(root=ROOT, cell=cell)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["code"] == 0
    assert got["loaded"] == []
    assert not set(got["names"]) & set(FORBIDDEN)
    assert "gdmix_tpu_torch" in got["names"]      # the program did run


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    files = [f for f in os.listdir(ref) if f.endswith(".py")]
    assert files
    for f in files:
        for name in _imports(os.path.join(ref, f)):
            top = name.split(".")[0]
            assert top not in ("gdmix_tpu_torch",) + FORBIDDEN, (f, name)
            if top == "benchmark":      # only the reference's own modules
                assert name.startswith("benchmark.reference"), (f, name)


def test_the_guard_compares_whole_names(monkeypatch):
    from benchmark import harness as h
    monkeypatch.setitem(sys.modules, "gdmix_tpu_torch_x", sys)
    assert "gdmix_tpu_torch_x" not in h.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gdmix_tpu.ops", sys)
    assert h.forbidden_modules() == ["gdmix_tpu.ops"]


_STUB_READER = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {stub!r})
import pytest
from benchmark.tests.small import run_small
from benchmark import harness as h
reader = h.reader


def importing_jax(name):
    def read(ctx):
        import jax                      # the stub
        return reader(name)(ctx)
    return read


mp = pytest.MonkeyPatch()
mp.setattr(h, "reader", importing_jax)
code, line = run_small(mp, "lr-movielens.re-fleet", traced=True)
print(json.dumps({{"code": code, "line": line,
                   "stub": "jax" in sys.modules}}))
"""


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The guard runs after the metric readers: a reader that imports
    (a stub of) jax makes the run end with no result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c",
         _STUB_READER.format(root=ROOT, stub=str(stub))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["stub"]
    assert got["code"] != 0 and got["line"] is None
    assert "modules of JAX" in out.stderr
