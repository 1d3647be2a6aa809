"""gdmix_tpu_torch/bench.py against the repository's root bench.py (the JAX
package's bench) on the CPU: the workloads array for array, the bucket
solves entity by entity, the FE id transforms on shared uniforms, and the
module end to end in a subprocess (its line, the no-card exit, the
watchdog's partial line); and the RE model's byte counters that its stage
decomposition reads."""
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.data.bucketing import bucketize as jax_bucketize
from gdmix_tpu_torch import bench
from gdmix_tpu_torch.data.bucketing import iter_bucketize_flat
from gdmix_tpu_torch.ops import re_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench as jax_bench  # noqa: E402  (the root bench.py)
import chip_smoke  # noqa: E402

# the JAX bench's float32 solves against the port's, entity by entity: the
# package's own lanes-vs-batch-major bound (chip_smoke.F32_TOL)
F32_TOL = 5e-3
# the knobs of a CPU run of the whole module, well inside a minute
SMALL = dict(BENCH_ENTITIES="2000", BENCH_HEAVY_ENTITIES="500",
             BENCH_WIDE_ENTITIES="128", BENCH_FE_N="20000",
             BENCH_SCORE_RECORDS="20000", BENCH_REPS="2")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _run(args, timeout=60, **env):
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(env, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "gdmix_tpu_torch.bench"]
                          + args, cwd=ROOT, env=full, capture_output=True,
                          text=True, timeout=timeout)


# ---- the workloads ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_workloads_equal_jax(seed):
    got, want = bench.make_workload(500, seed), jax_bench.make_workload(
        500, seed)
    assert len(got) == len(want) == 500
    for g, w in zip(got, want):
        assert g.entity_id == w.entity_id
        assert set(g.columns) == set(w.columns)
        for k in w.columns:
            np.testing.assert_array_equal(g.columns[k], w.columns[k])
        for k in ("padded_indices", "padded_values", "rec_nnz"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    got = bench.make_workload_flat(500, seed, d=512, max_nnz=16,
                                   count_lo=32)
    want = jax_bench.make_workload_flat(500, seed, d=512, max_nnz=16,
                                        count_lo=32)
    np.testing.assert_array_equal(got.entity_ids, want.entity_ids)
    for k in ("counts", "indices", "values", "rec_nnz"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert set(got.columns) == set(want.columns)
    for k in want.columns:
        np.testing.assert_array_equal(got.columns[k], want.columns[k])


# ---- the RE solves ---------------------------------------------------------

def _jax_solves(groups):
    """{entity: (θ over its support, converged)} by the JAX bench's
    solve_two_phase, float32, its own bucket plan."""
    out = {}
    for b in jax_bucketize(groups, jax_bench._Schema, "offset",
                           has_intercept=True, batch_align=8):
        arrays = dict(
            theta0=b.theta0.astype(np.float32), indices=b.indices,
            values=b.values.astype(np.float32),
            offsets=b.offsets.astype(np.float32),
            labels=b.labels.astype(np.float32),
            weights=b.weights.astype(np.float32),
            sample_count=b.sample_count.astype(np.float32))
        th, conv = jax_bench.solve_two_phase(b.u_cap, arrays, jnp.float32)
        th, conv = np.asarray(th), np.asarray(conv)
        for i, e in enumerate(b.entity_ids):
            out[e] = (th[i, :1 + b.u_count[i]], bool(conv[i]))
    return out


@pytest.mark.parametrize("workload", ["primary", "wide_support"])
def test_re_solves_equal_jax(workload):
    """The port's bucket solves (its plan: one bucket per tier) against
    the JAX bench's (its plan: 128-entity pieces) on the same entities:
    θ per entity within F32_TOL in float32, every entity converged in
    both."""
    make = ((lambda m: m.make_workload(2000)) if workload == "primary"
            else (lambda m: m.make_workload(128, seed=2, d=512, max_nnz=16,
                                            count_lo=32, count_hi=64)))
    want = _jax_solves(make(jax_bench))
    buckets, arrays = bench.upload_buckets(make(bench), torch.device("cpu"))
    results = bench.solve_buckets(buckets, arrays)
    assert bench.converged_share(buckets, results) == 1.0
    assert all(c for _, c in want.values())
    seen, worst = 0, 0.0
    for b, (theta, _) in zip(buckets, results):
        theta = theta.numpy()
        for i, e in enumerate(b.entity_ids):
            w = want[e][0]
            worst = max(worst, float(np.max(np.abs(theta[i, :len(w)] - w))))
            seen += 1
    assert seen == len(want)
    assert worst <= F32_TOL, worst


def test_rungs_follow_the_jax_ladder():
    """bucket_solver picks the JAX bench's rung for each shape."""
    from gdmix_tpu_torch.models import random_effect_lr as port_re
    rung = {port_re._newton_solver: "newton",
            port_re._newton_dual_solver: "newton_dual",
            port_re._lbfgs_dense_solver: "lbfgs_dense",
            port_re._lbfgs_solver: "lbfgs"}
    for args, solver, want in (((24, 128, 8), "newton", "newton"),
                               ((127, 128, 8), "newton", "newton"),
                               ((360, 128, 64), "newton", "newton_dual"),
                               ((360, 128, 512), "newton", "lbfgs_dense"),
                               ((360, 1 << 20, 512), "newton", "lbfgs"),
                               ((24, 128, 8), "lbfgs", "lbfgs_dense")):
        seen = []
        for fn in rung:
            orig = fn

            def spy(*a, _name=rung[fn], _orig=orig):
                seen.append(_name)
                return _orig(*a)
            setattr(bench, fn.__name__, spy)
        try:
            bench.bucket_solver(*args, solver=solver)
        finally:
            for fn in rung:
                setattr(bench, fn.__name__, fn)
        assert seen == [want], (args, solver, seen)


# ---- the FE ids ------------------------------------------------------------

@pytest.mark.parametrize("zipf_s", [1.0, 1.2])
@pytest.mark.parametrize("d", [10_000, 1_000_000])
def test_fe_ids_equal_jax(zipf_s, d):
    """fe_ids against the JAX bench's inverse-CDF expressions
    (bench.py:568-576) on the same float64 uniforms (fe_batch draws
    float64): equal ids but at a bin edge, where the two packages' pow and
    exp may round apart by one id (at most 1e-4 of them)."""
    u = np.random.RandomState(7).uniform(1e-7, 1.0, (200_000,))
    uj = jnp.asarray(u)
    if zipf_s == 1.0:
        want = jnp.clip(jnp.exp(uj * jnp.log(float(d))).astype(jnp.int32)
                        - 1, 0, d - 1)
    else:
        a = 1.0 - zipf_s
        want = jnp.clip(((1.0 + uj * (float(d) ** a - 1.0)) ** (1.0 / a))
                        .astype(jnp.int32) - 1, 0, d - 1)
    want = np.asarray(want)
    got = bench.fe_ids(torch.from_numpy(u), d, zipf_s).numpy()
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < d
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-4 * u.size


def test_fe_batch_distributions():
    """The FE batch's columns: ids in range (id 0 the most frequent under
    Zipf), labels 0/1 near half, weights 1, float32, K 16."""
    b = bench.fe_batch(50_000, 10_000, 1.2, torch.device("cpu"))
    assert b.indices.shape == b.values.shape == (50_000, 16)
    assert b.indices.dtype == torch.int32 and b.values.dtype == torch.float32
    counts = torch.bincount(b.indices.reshape(-1).long(), minlength=10_000)
    assert int(counts.argmax()) == 0 and int(b.indices.max()) < 10_000
    assert abs(float(b.labels.mean()) - 0.5) < 0.02
    assert torch.equal(b.weights, torch.ones(50_000))
    u = bench.fe_batch(50_000, 10_000, 0.0, torch.device("cpu")).indices
    assert 0 <= int(u.min()) and int(u.max()) < 10_000


# ---- the module end to end ---------------------------------------------------

def test_bench_end_to_end_on_the_cpu():
    proc = _run(["--device", "cpu"], **SMALL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "submetrics", "device"}
    assert line["metric"] == "random_effect_models_per_sec_per_chip"
    assert line["unit"] == "models/sec" and line["vs_baseline"] is None
    assert line["device"] == "cpu"
    sub = line["submetrics"]
    # the JAX bench's submetrics (bench.py:695-752) but the TPU multiple
    assert set(sub) == set(bench.SUBMETRICS)
    want = set(re.findall(r'submetrics\["(\w+)"\]',
                          open(os.path.join(ROOT, "bench.py")).read()))
    assert set(sub) == want - {"fe_speedup_vs_round1"}
    decomp = sub.pop("re_stage_decomposition")
    assert line["value"] > 0 and all(v > 0 for v in sub.values()), sub
    assert set(decomp) == {"wall_s", "warm_fit_s", "plane", "bytes_up",
                           "bytes_down", "phases", "serial_link_s_est",
                           "link_fraction"}
    assert decomp["plane"] == "host" and decomp["bytes_up"] > 0
    assert set(decomp["phases"]) == {"marshal_dispatch",
                                     "solve_fetch_collect", "merge"}
    conv = re.findall(r"converged ([0-9.]+)", proc.stderr)
    assert len(conv) == 6 and set(conv) == {"1.000"}, proc.stderr
    kernels = json.loads(proc.stderr.split("bench[kernels]: ")[1]
                         .splitlines()[0])
    assert set(kernels) == set(chip_smoke.KERNELS[i][0]
                               for i in range(len(chip_smoke.KERNELS)))
    assert not any(kernels.values())   # the CPU runs the plain versions
    assert "bench[device]: cpu" in proc.stderr


def test_bench_without_a_card_exits_2():
    """No card and no --device cpu: the reason on stderr, exit 2, no
    JSON line."""
    proc = _run([], CUDA_VISIBLE_DEVICES="", **SMALL)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "no measurement taken" in proc.stderr


def test_bench_budget_prints_the_primary():
    """A budget that runs out after the primary: one line, partial, the
    primary in it, exit 0."""
    proc = _run(["--device", "cpu"], BENCH_BUDGET_S="0.05",
                **dict(SMALL, BENCH_HEAVY_ENTITIES="3000"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] > 0
    assert "re_heavy_tail_models_per_sec" not in line["submetrics"]
    assert "BUDGET EXPIRED" in proc.stderr


def test_two_phase_newton_raises(monkeypatch):
    """BENCH_PHASE1 > 0 once raised; it now takes two-phase Newton by the
    JAX bench's rule (bench.py:168: solver newton, dim ≤ 128, B > 64) and
    the ladder elsewhere."""
    from gdmix_tpu_torch.models import random_effect_lr as port_re
    two = port_re._newton_two_phase_solver
    seen = []
    monkeypatch.setattr(bench, "_newton_two_phase_solver",
                        lambda *a: seen.append(a[-1]) or two(*a))
    for args, solver, phase1, taken in (((24, 128, 8), "newton", 2, True),
                                        ((24, 65, 8), "newton", 3, True),
                                        ((24, 64, 8), "newton", 2, False),
                                        ((127, 128, 8), "newton", 2, True),
                                        ((128, 128, 8), "newton", 2, False),
                                        ((24, 128, 8), "lbfgs", 2, False),
                                        ((24, 128, 8), "newton", 0, False)):
        seen.clear()
        assert callable(bench.bucket_solver(*args, solver=solver,
                                            phase1=phase1))
        assert seen == ([phase1] if taken else []), (args, solver, phase1)


# ---- the RE model's byte counters --------------------------------------------

def _bucket_bytes(fg, model, schema):
    """(θ0 bytes, bytes down, supports' bytes) of a fit by the host
    bucketizer's plan: each bucket's θ0 in the model's dtype; each bucket's
    real rows of θ and its converged count; the supports the packed route
    reads back (int32: the [E] counts, then the ids, at least one an
    entity)."""
    item = torch.tensor([], dtype=model.dtype).element_size()
    th0 = down = n_ids = 0
    for b in iter_bucketize_flat(fg, schema, "offset", has_intercept=True):
        th0 += b.theta0.size * item
        down += len(b.entity_ids) * b.theta0.shape[1] * item + 8
        n_ids += int(b.u_count[:len(b.entity_ids)].sum())
    return th0, down, 4 * (len(fg.counts) + n_ids)


def _flat_bytes(fg, static):
    """Bytes the packed route copies up before any θ0: with `static` the
    int32 ids and nnz, the values, labels and offsets as they are, the [E]
    counts, starts, order and tier maps and the block path's lists; else
    the offsets and the three maps that pack them."""
    E = len(fg.counts)
    up = fg.columns["offset"].nbytes + E * (4 + 8 + 4)
    if not static:
        return up
    ents, ws_off, _ = re_pack.block_path(fg.counts, fg.indices.shape[1])
    return (up + fg.indices.size * 4 + fg.values.nbytes + fg.rec_nnz.size * 4
            + fg.columns["response"].nbytes + E * 4 + ents.nbytes
            + ws_off.nbytes)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fit_byte_counters_host_plane(tmp_path, dtype):
    """last_fit_bytes_up / _down on the host plane, whose packed route
    copies the partition's flat columns once: all of them on a cold fit,
    only the offsets and the maps that pack them on a cached one, θ₀ where
    a prior gives one; down each bucket's real rows of θ and its converged
    count, and the supports where the fit packed them; reset at each
    fit."""
    fg = chip_smoke.make_workload_flat(1500, seed=4)
    model, schema = chip_smoke.stage_model(24, str(tmp_path), dtype=dtype,
                                           device="cpu")
    th0, down, sup = _bucket_bytes(fg, model, schema)
    up = _flat_bytes(fg, static=True)
    cold = model.fit_flat(fg, {}, schema)
    assert (model.last_fit_bytes_up, model.last_fit_bytes_down) \
        == (up, down + sup)
    cache = {}
    model.fit_flat(fg, cold, schema, device_cache=cache)
    nb = len(cache)
    assert model.last_fit_bytes_up == up + th0   # the cache's first fill
    model.fit_flat(fg, cold, schema, device_cache=cache)
    warm_up = _flat_bytes(fg, static=False) + th0
    assert 0 < model.last_fit_bytes_up == warm_up < up
    # the warm fits probe each bucket's moved flag: one bool a bucket
    moved_rows = model.last_fit_bytes_down - nb
    assert 0 < moved_rows <= down


def test_fit_byte_counters_sharded_plane(tmp_path):
    """The same counters on the sharded plane: positive on a cold fit,
    smaller up on a refit through the sweep cache (only the offsets are
    routed again), the fetched rows the same."""
    fg = chip_smoke.make_workload_flat(1500, seed=4)
    model, schema = chip_smoke.stage_model(24, str(tmp_path), device="cpu",
                                           re_mode="sharded")
    cache = {}
    cold = model.fit_flat(fg, {}, schema, device_cache=cache)
    assert model.last_fit_plane == "sharded"
    up, down = model.last_fit_bytes_up, model.last_fit_bytes_down
    assert up > 0 and down > 0
    model.fit_flat(fg, cold, schema, device_cache=cache)
    assert 0 < model.last_fit_bytes_up < up
    assert model.last_fit_bytes_down == down
