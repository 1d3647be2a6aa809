"""The port's bench: random-effect models trained per second per card, and
its submetrics, measured on the card.

    python -m gdmix_tpu_torch.bench [--device cpu]

A port of the repository's root bench.py (the JAX package's bench, which
imports JAX): the same workloads from the same numpy draws, the same
environment knobs with the same defaults, and the same one JSON line on
stdout with the same metric names, measured through this package's own
modules on the card (or on the CPU with --device cpu, where every kernel
wrapper runs its plain version).

Primary metric: a movieLens-per-user-shaped fleet of 100,000 independent
per-entity logistic regressions (pareto sample counts 2..64, 24 features),
bucketed on the host once and uploaded once; the timed reps are the bucket
solves alone (the solver ladder of models/random_effect_lr.py over arrays
already on the card), each rep from θ₀ perturbed by 1e-6·(rep+1) and ended
by one synchronize.

Submetrics:
  re_heavy_tail_models_per_sec — pareto counts 2..2,048 (straggler mix)
  re_wide_support_models_per_sec — 512-wide support, 32..64 samples
  dispatch_latency_ms, link_up_mb_per_s — probe_link: a launch-and-read
      round trip, 8 MB host → card (pageable memory)
  re_stage_models_per_sec — fit_flat + model avro export + reload through
      RandomEffectLRModel (the stage the reference's trainer runs)
  re_stage_solve_bound_models_per_sec + re_stage_decomposition — a warm
      fit through the sweep cache (device_cache: offsets and θ₀ cross, the
      static columns stay on the card), and the stage's wall, phases,
      bytes up and down, and the serial seconds those bytes take at
      probe_link's rates
  detext_rows_per_sec — the deep tower's Adam step (cnn, B 4,096, L 16,
      vocabulary 30,000, wide 10,000, K 8)
  re_score_records_per_sec — score_records over 1,000,000 records
  re_sharded_heavy_tail_models_per_sec — the heavy tail through the
      entity-sharded plane (re_mode="sharded", a mesh of the one card)
  fe_funcalls_per_sec — FixedEffectLRModel._objective_fun at N 4,997,120,
      D 10k, K 16, uniform ids made on the card
  fe_wide_d_funcalls_per_sec / fe_wide_d_uniform_funcalls_per_sec — the
      same at D 1M, Zipf(1.2) ids (the hot/cold split) and uniform ids

Left out of the JAX bench's line: fe_speedup_vs_round1 (a multiple of a
TPU funcall time). `vs_baseline` is null: the JAX bench divides by a target
set for its TPU round. The line adds `device`: the card's name and count,
or "cpu".

Knobs (environment, the JAX bench's names and defaults): BENCH_ENTITIES,
BENCH_HEAVY_ENTITIES, BENCH_WIDE_ENTITIES, BENCH_STAGE_ENTITIES, BENCH_FE,
BENCH_FE_N, BENCH_FE_WIDE, BENCH_DETEXT, BENCH_SCORE_RECORDS, BENCH_REPS,
BENCH_BUDGET_S, BENCH_DEVICE_TIMEOUT, BENCH_SOLVER, BENCH_RE_MODE,
BENCH_PHASE1. BENCH_PHASE1 > 0 solves the bucket solves' Newton buckets
(BENCH_SOLVER newton, dim ≤ 128, more than 64 entities) by two-phase
Newton with that many phase-1 iterations, the JAX bench's rule
(bench.py:165-175).

Once the primary is measured the line is printed even if BENCH_BUDGET_S
runs out: a watchdog prints it with the submetrics done by then. Two lines
on stderr name what ran: `bench[kernels]`, each hand-written kernel's
launches in this process, and `bench[device]`, the card's name and power
limit as nvidia-smi reports them.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from gdmix_tpu_torch.data.bucketing import FlatGroups, bucketize
from gdmix_tpu_torch.device import pop_device_flag, resolve_device
from gdmix_tpu_torch.io.input_pipeline import EntityGroup
from gdmix_tpu_torch.models.random_effect_lr import (
    _lbfgs_dense_solver, _lbfgs_solver, _newton_dual_solver, _newton_solver,
    _newton_two_phase_solver)
from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy
from gdmix_tpu_torch.util.timing import measure_dispatch_latency_s

METRIC = "random_effect_models_per_sec_per_chip"
SUBMETRICS = (
    "re_heavy_tail_models_per_sec", "re_wide_support_models_per_sec",
    "dispatch_latency_ms", "link_up_mb_per_s", "re_stage_models_per_sec",
    "re_stage_decomposition", "re_stage_solve_bound_models_per_sec",
    "detext_rows_per_sec", "re_score_records_per_sec",
    "re_sharded_heavy_tail_models_per_sec", "fe_funcalls_per_sec",
    "fe_wide_d_funcalls_per_sec", "fe_wide_d_uniform_funcalls_per_sec")
# the bucket columns the solvers read (a tier's tensors in fit_groups)
BUCKET_COLS = ("indices", "values", "offsets", "labels", "weights",
               "sample_count", "theta0")
# the solver settings of the JAX bench (its _KEY): intercept, bias not
# regularised, λ 1, 100 iterations, ftol 1e-12, pgtol 1e-5, 10 pairs, no
# variance
_KEY = dict(has_intercept=True, regularize_bias=False, lam=1.0, maxiter=100,
            ftol=1e-12, pgtol=1e-5, m=10, variance_mode=None)
# the ladder's size limits (the JAX bench's, REParams' defaults)
_MAX_ELEMS = 200_000_000


class _Schema:
    uid_column_name = "uid"
    label_column_name = "response"
    weight_column_name = None
    prediction_score_column_name = "predictionScore"
    prediction_score_per_coordinate_column_name = "predictionScorePerCoordinate"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _say(line: str) -> None:
    sys.stderr.write(line + "\n")
    sys.stderr.flush()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- workloads --

def _draws(num_entities, seed, d, max_nnz, count_lo, count_hi, pareto_a):
    """The JAX bench's draws, in its order (bench.py:107-119)."""
    rng = np.random.RandomState(seed)
    counts = np.clip((rng.pareto(pareto_a, num_entities) * 8
                      + count_lo).astype(int), count_lo, count_hi)
    total = int(counts.sum())
    idx_all = rng.randint(0, d, size=(total, max_nnz)).astype(np.int32)
    val_all = rng.randn(total, max_nnz)
    nnz_all = rng.randint(1, max_nnz + 1, size=total).astype(np.int32)
    mask = np.arange(max_nnz)[None, :] < nnz_all[:, None]
    val_all = val_all * mask
    w_true = np.repeat(rng.randn(num_entities), counts)
    z = val_all.sum(1) * 0.5 + w_true
    y_all = (rng.rand(total) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return rng, counts, idx_all, val_all, nnz_all, y_all


def make_workload(num_entities: int, seed: int = 0, d: int = 24,
                  max_nnz: int = 4, count_lo: int = 2, count_hi: int = 64,
                  pareto_a: float = 1.5):
    """Long-tail per-entity datasets as a list of EntityGroup (padded
    blocks, the partitioner's fast form): the JAX bench's make_workload,
    the same draws."""
    rng, counts, idx_all, val_all, nnz_all, y_all = _draws(
        num_entities, seed, d, max_nnz, count_lo, count_hi, pareto_a)
    total = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    off_all = 0.1 * rng.randn(total)
    uid_all = np.arange(total, dtype=np.int64)
    groups = []
    for e in range(num_entities):
        sl = slice(int(starts[e]), int(starts[e]) + int(counts[e]))
        groups.append(EntityGroup(
            entity_id=str(e),
            columns={"uid": uid_all[sl], "response": y_all[sl],
                     "offset": off_all[sl]},
            padded_indices=idx_all[sl], padded_values=val_all[sl],
            rec_nnz=nnz_all[sl]))
    return groups


def make_workload_flat(num_entities: int, seed: int = 0, d: int = 24,
                       max_nnz: int = 4, count_lo: int = 2,
                       count_hi: int = 64, pareto_a: float = 1.5):
    """make_workload as a columnar FlatGroups, the same draws."""
    rng, counts, idx_all, val_all, nnz_all, y_all = _draws(
        num_entities, seed, d, max_nnz, count_lo, count_hi, pareto_a)
    total = int(counts.sum())
    return FlatGroups(
        entity_ids=np.array([str(e) for e in range(num_entities)], object),
        counts=counts.astype(np.int64),
        columns={"uid": np.arange(total, dtype=np.int64), "response": y_all,
                 "offset": 0.1 * rng.randn(total)},
        indices=idx_all, values=val_all, rec_nnz=nnz_all)


def heavy_tail(num_entities: int, flat: bool = False):
    """The heavy-tail workload (bench.py:693-694, :730-731)."""
    make = make_workload_flat if flat else make_workload
    return make(num_entities, seed=1, count_hi=2048, pareto_a=1.2)


def wide_support(num_entities: int):
    """The wide-support workload (bench.py:698-699)."""
    return make_workload(num_entities, seed=2, d=512, max_nnz=16,
                         count_lo=32, count_hi=64)


# ------------------------------------------------------------ RE solves --

def bucket_solver(u_cap: int, batch_b: int, n_cap: int,
                  solver: str = "newton", phase1: int = 0):
    """The solve of a [batch_b, n_cap] bucket by the JAX bench's ladder
    (bench.py:143-175, REParams.batch_solver="auto"): primal Newton up to
    dim 128 (two-phase with `phase1` > 0 past 64 entities), the
    sample-space dual Newton for n_cap < dim, densified L-BFGS where the
    bucket fits, sparse L-BFGS last."""
    k = _KEY
    key = (u_cap, k["has_intercept"], k["regularize_bias"], k["lam"],
           k["maxiter"], k["ftol"], k["pgtol"], k["m"], k["variance_mode"])
    dim = u_cap + 1
    elems = batch_b * n_cap * dim
    if phase1 and solver == "newton" and dim <= 128 and batch_b > 64:
        return _newton_two_phase_solver(*key, phase1)
    if solver == "newton" and dim <= 128:
        return _newton_solver(*key)
    if solver != "lbfgs" and 0 < n_cap < dim \
            and batch_b * n_cap * n_cap <= _MAX_ELEMS \
            and elems <= _MAX_ELEMS:
        return _newton_dual_solver(*key)
    if elems <= _MAX_ELEMS:
        return _lbfgs_dense_solver(*key)
    return _lbfgs_solver(*key)


def upload_buckets(groups, device, dtype=torch.float32):
    """(buckets, [the solver's arrays of each bucket on `device`]): the
    port's plan (batch_align 8, one bucket per tier), each bucket uploaded
    once."""
    buckets = bucketize(groups, _Schema, "offset", has_intercept=True,
                        batch_align=8)
    return buckets, [newton_inputs_from_numpy(
        {k: getattr(b, k) for k in BUCKET_COLS}, device, dtype)
        for b in buckets]


def solve_buckets(buckets, arrays, eps: float = 0.0,
                  solver: str = "newton", phase1: int = 0):
    """Every bucket's solve queued, none read back: [(θ, converged)]. θ₀
    moved by `eps` where it is not 0."""
    out = []
    for b, a in zip(buckets, arrays):
        if eps:
            a = dict(a, theta0=a["theta0"] + eps)
        theta, _, conv = bucket_solver(b.u_cap, b.indices.shape[0],
                                       b.indices.shape[1], solver,
                                       phase1)(a)
        out.append((theta, conv))
    return out


def converged_share(buckets, results) -> float:
    """Converged entities over real entities (padding rows left out)."""
    n = sum(len(b.entity_ids) for b in buckets)
    return sum(int(c[:len(b.entity_ids)].sum())
               for b, (_, c) in zip(buckets, results)) / max(n, 1)


def count_syncs(fn, device: torch.device):
    """(fn(), {"file:line": count} of the synchronizing calls PyTorch made
    inside it): its sync debug mode set to warn, each warning counted by
    the line of Python that made it. Empty on the CPU, where there is
    nothing to wait for."""
    if device.type != "cuda":
        return fn(), {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = {}
    for w in seen:
        if "called a synchronizing" in str(w.message):
            at = f"{os.path.relpath(w.filename, pkg)}:{w.lineno}"
            lines[at] = lines.get(at, 0) + 1
    return out, lines


def run_re(groups, tag: str, reps: int, device: torch.device,
           solver: str = "newton", phase1: int = 0) -> float:
    """Models/sec of the bucket solves over `groups` (bench.py:197-258):
    bucketize and upload once, solve each bucket once to warm, then `reps`
    timed reps, each every bucket's solve queued and one synchronize; the
    minimum over the reps."""
    t0 = time.perf_counter()
    buckets, arrays = upload_buckets(groups, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    solve_buckets(buckets, arrays, solver=solver,   # warm: first launches
                  phase1=phase1)
    _sync(device)
    rep_times, results = [], None
    for rep in range(reps):
        t0 = time.perf_counter()
        results = solve_buckets(buckets, arrays, 1e-6 * (rep + 1), solver,
                                phase1)
        _sync(device)
        rep_times.append(time.perf_counter() - t0)
    # the same dispatch once more, its host reads counted (not timed)
    _, syncs = count_syncs(
        lambda: solve_buckets(buckets, arrays, 1e-6 * (reps + 1), solver,
                              phase1),
        device)
    elapsed = min(rep_times)
    n_models = sum(len(b.entity_ids) for b in buckets)
    _say(f"bench[{tag}]: {n_models} models in {elapsed:.5f}s (reps "
         f"{[round(t, 5) for t in rep_times]}) on {device} "
         f"({len(buckets)} buckets, u_cap<= "
         f"{max(b.u_cap for b in buckets)}, setup {setup_s:.1f}s, "
         f"host syncs a rep {sum(syncs.values())} {syncs} "
         f"+ 1 synchronize, "
         f"converged {converged_share(buckets, results):.3f})")
    return n_models / elapsed


# -------------------------------------------------------- the RE stage --

def _stage_model(d: int, tmp: str, device):
    """RandomEffectLRModel over a synthetic d-wide feature bag with the JAX
    bench's settings (bench.py:287-322; metadata and feature list written
    under tmp)."""
    from gdmix_tpu_torch.io.feature_list import write_feature_list
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.params import Params, REParams

    md_file = os.path.join(tmp, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "per_entity", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "user_id", "dtype": "string", "shape": [],
             "isSparse": False},
            {"name": "uid", "dtype": "long", "shape": [],
             "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "float",
                        "shape": [], "isSparse": False}]}, f)
    feature_file = os.path.join(tmp, "features.csv")
    write_feature_list([(f"f{i}", "") for i in range(d)], feature_file)
    model_params = REParams(
        metadata_file=md_file, output_model_dir=tmp,
        feature_bag="per_entity", feature_file=feature_file,
        partition_entity="user_id", l2_reg_weight=1.0,
        regularize_bias=False, dtype="float32", lbfgs_tolerance=1e-12,
        lbfgs_pgtol=1e-5, num_of_lbfgs_iterations=100,
        sparsity_threshold=1e-4,
        re_mode=os.environ.get("BENCH_RE_MODE", "auto"))
    base_params = Params(
        action="train", stage="random_effect",
        model_type="logistic_regression", label_column_name="response",
        uid_column_name="uid",
        prediction_score_column_name="predictionScore")
    return (RandomEffectLRModel(model_params, base_params, device=device),
            base_params)


def _converged(model) -> float:
    conv, n = model.last_fit_converged
    return conv / max(n, 1)


def run_re_stage(fg, reps: int, device):
    """(stage models/sec, solve-bound models/sec, decomposition): fit_flat
    + avro export + reload through the production class, the minimum over
    reps after a warm-up rep (bench.py:325-385); then warm fits through the
    sweep cache, where only offsets and θ₀ cross to the card. The
    decomposition holds the last uncached fit's plane, phases and bytes up
    and down (RandomEffectLRModel.last_fit_bytes_*)."""
    d = int(fg.indices.max()) + 1
    tmp = tempfile.mkdtemp(prefix="gdx_bench_stage_")
    try:
        model, base_params = _stage_model(d, tmp, device)
        model_file = os.path.join(tmp, "part-00000.avro")
        rep_times, n_loaded = [], 0
        for _ in range(max(reps, 2)):  # rep 0: the first launches
            t0 = time.perf_counter()
            weights = model.fit_flat(fg, {}, base_params)
            model._save_model(model_file, weights)
            n_loaded = len(model._load_weights(model_file))
            rep_times.append(time.perf_counter() - t0)
        elapsed = min(rep_times[1:])
        cold = dict(plane=model.last_fit_plane,
                    bytes_up=int(model.last_fit_bytes_up),
                    bytes_down=int(model.last_fit_bytes_down),
                    phases=dict(model.last_fit_phases),
                    converged=_converged(model))
        dev_cache, warm_times = {}, []
        for _ in range(3):   # rep 0 fills the cache
            t0 = time.perf_counter()
            model.fit_flat(fg, weights, base_params, device_cache=dev_cache)
            warm_times.append(time.perf_counter() - t0)
        warm_s = min(warm_times[1:])
        n_models = len(fg)
        if n_loaded != n_models:
            raise RuntimeError(f"re-stage: {n_loaded} models reloaded of "
                               f"{n_models}")
        _say(f"bench[re-stage]: warm cached fit "
             f"{[round(t, 4) for t in warm_times]} (bytes up "
             f"{model.last_fit_bytes_up}, down {model.last_fit_bytes_down}, "
             f"converged {_converged(model):.3f})")
        _say(f"bench[re-stage]: {n_models} models fit+export+reload in "
             f"{elapsed:.4f}s (reps {[round(t, 4) for t in rep_times]}, "
             f"plane {cold['plane']}, converged {cold['converged']:.3f})")
        decomp = dict(
            wall_s=round(elapsed, 4), warm_fit_s=round(warm_s, 4),
            plane=cold["plane"], bytes_up=cold["bytes_up"],
            bytes_down=cold["bytes_down"],
            phases={k: round(v, 4) for k, v in cold["phases"].items()})
        return n_models / elapsed, n_models / warm_s, decomp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_re_score(fg, num_records: int, reps: int, device) -> float:
    """Records scored per second through score_records (bench.py:388-431):
    the models of a stage-shaped fit, ~3% of the records on entities
    without a model (their logits are their offsets). The records (their
    string entity ids included) are made before the timed reps."""
    from gdmix_tpu_torch.io.input_pipeline import PerRecordData
    d = int(fg.indices.max()) + 1
    tmp = tempfile.mkdtemp(prefix="gdx_bench_score_")
    try:
        model, base_params = _stage_model(d, tmp, device)
        weights = model.fit_flat(fg, {}, base_params)
        rng = np.random.RandomState(7)
        E = len(fg)
        k = fg.indices.shape[1]
        ent = rng.randint(0, int(E * 1.03), num_records)
        data = PerRecordData(
            columns={"user_id": np.array([str(e) for e in ent], object),
                     "uid": np.arange(num_records, dtype=np.int64),
                     "offset": 0.1 * rng.randn(num_records)},
            indices=rng.randint(0, d, (num_records, k)).astype(np.int32),
            values=rng.randn(num_records, k),
            nnz=np.full(num_records, k, np.int64),
            num_samples=num_records)
        times = []
        for _ in range(max(reps, 2)):   # rep 0: the first launches
            t0 = time.perf_counter()
            out = model.score_records(data, weights, base_params)
            if len(out["total"]) != num_records:
                raise RuntimeError("re-score: a record was not scored")
            times.append(time.perf_counter() - t0)
        elapsed = min(times[1:])
        _say(f"bench[re-score]: {num_records} records x {E} models in "
             f"{elapsed:.4f}s (reps {[round(t, 4) for t in times]})")
        return num_records / elapsed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_re_sharded(fg, tag: str, reps: int, device) -> float:
    """Models/sec of fit_flat on the entity-sharded plane alone
    (re_mode="sharded" whatever BENCH_RE_MODE says; bench.py:490-518)."""
    d = int(fg.indices.max()) + 1
    tmp = tempfile.mkdtemp(prefix="gdx_bench_shard_")
    try:
        model, base_params = _stage_model(d, tmp, device)
        model.model_params.re_mode = "sharded"
        rep_times, n_models = [], 0
        for _ in range(max(reps, 2)):  # rep 0: the first launches
            t0 = time.perf_counter()
            n_models = len(model.fit_flat(fg, {}, base_params))
            rep_times.append(time.perf_counter() - t0)
        elapsed = min(rep_times[1:])
        if n_models != len(fg):
            raise RuntimeError(f"{tag}: {n_models} models of {len(fg)}")
        _say(f"bench[{tag}]: {n_models} models via the sharded plane in "
             f"{elapsed:.4f}s (reps {[round(t, 4) for t in rep_times]}, "
             f"converged {_converged(model):.3f})")
        return n_models / elapsed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------------------------------------- detext --

def run_detext(reps: int, device) -> float:
    """Rows/sec of the deep tower's Adam step (bench.py:434-487): the
    port's _TextWideTower (cnn, windows 2 and 3, 64 filters, 64 units, 128
    hidden) at B 4,096, L 16, vocabulary 30,000, wide D 10,000, K 8,
    torch.optim.Adam(lr=1e-3) on the mean stable_bce; the batch drawn on
    the device from a seeded generator. The minimum over the timed steps,
    each ended by reading the loss back."""
    from gdmix_tpu_torch.models.deep_tower import _TextWideTower, init_state
    from gdmix_tpu_torch.ops.logistic import stable_bce
    B, L, V, D, K = 4096, 16, 30_000, 10_000, 8
    tower = _TextWideTower(vocab_size=V, num_wide=D, num_units=64,
                           windows=(2, 3), num_filters=64, num_hidden=128,
                           ftr_ext="cnn")
    tower.load_state_dict(init_state(tower,
                                     torch.Generator().manual_seed(1)))
    tower = tower.to(device)
    g = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, V, (B, 1, L), generator=g, device=device)
    mask = (torch.rand(B, 1, L, generator=g, device=device) < 0.9).float()
    widx = torch.randint(0, D, (B, K), generator=g, device=device)
    wval = torch.randn(B, K, generator=g, device=device)
    labels = torch.bernoulli(torch.full((B,), 0.5, device=device),
                             generator=g)
    opt = torch.optim.Adam(tower.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(stable_bce(tower(tokens, mask, widx, wval),
                                     labels))
        loss.backward()
        opt.step()
        return loss.item()

    step()   # the first launches
    times = []
    for _ in range(max(reps, 2)):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    _say(f"bench[detext]: step {elapsed * 1e3:.2f}ms at B={B} "
         f"(reps {[round(t, 5) for t in times]})")
    return B / elapsed


# ------------------------------------------------------------------ FE --

def fe_ids(u: torch.Tensor, d: int, zipf_s: float) -> torch.Tensor:
    """Feature ids on [0, d) from uniforms `u` in (0, 1) by the JAX
    bench's inverse-CDF transforms (bench.py:568-576), in u's type:
    log-uniform for s = 1, Zipf(s) on [1, d] shifted to 0 otherwise (id 0
    the most frequent; s = 1.2 is the item-popularity class)."""
    if zipf_s == 1.0:
        ids = torch.exp(u * float(np.log(float(d)))).to(torch.int32) - 1
    else:
        a = 1.0 - zipf_s
        ids = ((1.0 + u * (float(d) ** a - 1.0)) ** (1.0 / a)
               ).to(torch.int32) - 1
    return ids.clamp_(0, d - 1)


def fe_batch(n: int, d: int, zipf_s: float, device, k: int = 16,
             seed: int = 0, dtype=torch.float32):
    """The JAX bench's FE batch (bench.py:562-582) drawn on the device
    from a seeded torch.Generator: ids uniform on [0, d) (zipf_s 0) or by
    fe_ids from float64 uniforms on [1e-7, 1), values N(0, 1), offsets
    0.1·N(0, 1), labels Bernoulli(0.5), weights 1, in `dtype` (the bench's
    float32 by default). The same distributions as JAX's, not its
    draws."""
    from gdmix_tpu_torch.ops.logistic import SparseBatch
    g = torch.Generator(device=device).manual_seed(seed)
    if zipf_s == 0.0:
        idx = torch.randint(0, d, (n, k), generator=g, device=device,
                            dtype=torch.int32)
    else:
        u = torch.empty(n, k, dtype=torch.float64, device=device) \
            .uniform_(1e-7, 1.0, generator=g)
        idx = fe_ids(u, d, zipf_s)
        del u
    values = torch.randn(n, k, generator=g, device=device, dtype=dtype)
    offsets = 0.1 * torch.randn(n, generator=g, device=device, dtype=dtype)
    labels = torch.bernoulli(torch.full((n,), 0.5, device=device,
                                        dtype=dtype), generator=g)
    return SparseBatch(idx, values, offsets, labels,
                       torch.ones(n, device=device, dtype=dtype))


def run_fe(device, reps: int = 4, d: int = 10_000, tag: str = "fe",
           zipf_s: float = 0.0) -> float:
    """FE loss+grad funcalls/sec through FixedEffectLRModel._objective_fun
    (bench.py:521-619), the (value, grad) every fit_data funcall
    evaluates, its grad_mode "auto" resolved by the model: N 4,997,120
    (BENCH_FE_N), K 16, λ 1, float32, the batch made on the device. The
    hot/cold split is built through build_hybrid_aux_for first (None where
    auto takes no split or the data declines it); its seconds go to
    stderr. Each timed funcall ends by reading back the value and Σg."""
    from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu_torch.params import FixedLRParams, Params
    n = _env_int("BENCH_FE_N", 4_997_120)
    tmp = tempfile.mkdtemp(prefix="gdx_bench_fe_")
    try:
        md_file = os.path.join(tmp, "tensor_metadata.json")
        with open(md_file, "w") as f:
            json.dump({"features": [
                {"name": "global", "dtype": "float", "shape": [d],
                 "isSparse": True},
                {"name": "uid", "dtype": "long", "shape": [],
                 "isSparse": False},
                {"name": "offset", "dtype": "float", "shape": [],
                 "isSparse": False}],
                "labels": [{"name": "response", "dtype": "float",
                            "shape": [], "isSparse": False}]}, f)
        model_params = FixedLRParams(
            metadata_file=md_file, output_model_dir=tmp,
            feature_bag="global", l2_reg_weight=1.0, regularize_bias=False,
            dtype="float32")
        base_params = Params(
            action="train", stage="fixed_effect",
            model_type="logistic_regression", label_column_name="response",
            uid_column_name="uid",
            prediction_score_column_name="predictionScore")
        model = FixedEffectLRModel(model_params, base_params, device=device)
        batch = fe_batch(n, d, zipf_s, device)
        _sync(device)
        t0 = time.perf_counter()
        aux = model.build_hybrid_aux_for(batch)
        _sync(device)
        if aux is not None:
            _say(f"bench[{tag}]: hybrid aux built in "
                 f"{time.perf_counter() - t0:.3f}s "
                 f"(A={aux.hot_ids.shape[0]}, "
                 f"mc_pad={aux.cold_idx.shape[0]})")
        fun = model._objective_fun(batch, aux)
        x = torch.zeros(model._dim, dtype=torch.float32, device=device)
        v, g = fun(x)
        float(v)   # the first launches
        times = []
        for _ in range(reps):
            x = x - 1e-4 * g
            t0 = time.perf_counter()
            v, g = fun(x)
            float(v), float(torch.sum(g))   # read back: the sync
            times.append(time.perf_counter() - t0)
        _say(f"bench[{tag}]: funcall min={min(times):.5f}s "
             f"(reps {[round(t, 5) for t in times]}, "
             f"grad_mode {model._grad_mode()})")
        return 1.0 / min(times)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- link --

def probe_link(device, mb: int = 8):
    """(host→device bytes/s, device→host bytes/s, dispatch latency s):
    `mb` MB of float64 copied from pageable host memory to the device and
    back, each copy timed alone after a warm one and ended by a
    synchronize; the latency from util/timing.measure_dispatch_latency_s.
    On the CPU both copies are host memcpy."""
    lat = measure_dispatch_latency_s(device)
    host = torch.from_numpy(np.random.RandomState(0).rand(mb << 20 >> 3))
    dev = torch.empty_like(host, device=device)
    back = torch.empty_like(host)
    dev.copy_(host)
    back.copy_(dev)
    _sync(device)
    t0 = time.perf_counter()
    dev.copy_(host)
    _sync(device)
    up_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back.copy_(dev)
    _sync(device)
    down_s = time.perf_counter() - t0
    nb = host.numel() * host.element_size()
    _say(f"bench[link]: up {nb / up_s / 1e6:.1f} MB/s, down "
         f"{nb / down_s / 1e6:.1f} MB/s, dispatch {lat * 1e3:.3f} ms")
    return nb / up_s, nb / down_s, lat


# --------------------------------------------------------------- driver --

def _require_devices(device, timeout_s: float) -> torch.device:
    """The device to measure on: the CPU where asked for; else the card,
    found within timeout_s, or the reason on stderr and exit 2 with no
    JSON line."""
    if device is not None and torch.device(device).type == "cpu":
        _say("bench: device cpu (the kernels' plain versions)")
        return torch.device("cpu")
    out = {}

    def probe():
        try:
            out["count"] = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
        except RuntimeError as e:
            out["error"] = repr(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if out.get("count"):
        dev = resolve_device(device)
        _say(f"bench: devices {out['count']} x "
             f"{torch.cuda.get_device_name(dev)}, measuring on {dev}")
        return dev
    why = (f"failed: {out['error']}" if "error" in out
           else "found no CUDA device" if "count" in out
           else f"timed out after {timeout_s:.0f}s")
    _say(f"bench: device init {why} (pass --device cpu for the CPU) — no "
         f"measurement taken")
    sys.exit(2)


def _device_line(device) -> None:
    """bench[device]: the card's name and power limit (nvidia-smi)."""
    if device.type != "cuda":
        _say("bench[device]: cpu")
        return
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = (smi.stdout.strip().splitlines() or [smi.stderr.strip()])[0]
    except (OSError, subprocess.TimeoutExpired) as e:
        line = f"nvidia-smi failed: {e}"
    _say(f"bench[device]: {line}")


class _Line:
    """The one JSON line, printed once: the watchdog and the normal path
    may race, and the first wins."""

    def __init__(self, device):
        self.device = device
        self._lock = threading.Lock()
        self._printed = False

    def emit(self, primary: float, submetrics: dict,
             partial: bool = False) -> None:
        from gdmix_tpu_torch.gdmix import kernel_launches
        with self._lock:
            if self._printed:
                return
            self._printed = True
            if partial:
                _say("bench: BUDGET EXPIRED — emitting completed "
                     f"submetrics only ({sorted(submetrics)})")
            _say(f"bench[kernels]: {json.dumps(kernel_launches())}")
            _device_line(self.device)
            dev = self.device
            print(json.dumps({
                "metric": METRIC,
                "value": round(primary, 1),
                "unit": "models/sec",
                "vs_baseline": None,
                "submetrics": submetrics,
                "device": ({"kind": torch.cuda.get_device_name(dev),
                            "count": torch.cuda.device_count()}
                           if dev.type == "cuda" else "cpu"),
            }), flush=True)


def main(argv=None) -> None:
    argv, device = pop_device_flag(sys.argv[1:] if argv is None else argv)
    if argv:
        raise SystemExit(f"bench: unknown arguments {argv} (the knobs are "
                         f"BENCH_* environment variables)")
    device = _require_devices(device,
                              float(os.environ.get("BENCH_DEVICE_TIMEOUT",
                                                   900)))
    reps = _env_int("BENCH_REPS", 5)
    solver = os.environ.get("BENCH_SOLVER", "newton")
    phase1 = _env_int("BENCH_PHASE1", 0)
    num_entities = _env_int("BENCH_ENTITIES", 100_000)
    heavy_n = _env_int("BENCH_HEAVY_ENTITIES", 20_000)
    wide_n = _env_int("BENCH_WIDE_ENTITIES", 4_096)
    stage_n = _env_int("BENCH_STAGE_ENTITIES", num_entities)
    run_fe_cells = os.environ.get("BENCH_FE", "1") != "0"
    line = _Line(device)

    primary = run_re(make_workload(num_entities), "movielens", reps, device,
                     solver, phase1)
    submetrics = {}

    # once the primary exists the line is guaranteed: a timer thread
    # prints it with the submetrics done so far and ends the process
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 1500))
    t_start = time.time()

    def _watchdog():
        line.emit(primary, dict(submetrics), partial=True)
        os._exit(0)

    watchdog = threading.Timer(budget_s, _watchdog)
    watchdog.daemon = True
    if budget_s > 0:
        watchdog.start()
    if heavy_n:
        submetrics["re_heavy_tail_models_per_sec"] = round(
            run_re(heavy_tail(heavy_n), "heavy-tail", max(reps - 2, 1), device,
                   solver, phase1), 1)
    if wide_n:
        submetrics["re_wide_support_models_per_sec"] = round(
            run_re(wide_support(wide_n), "wide-support", max(reps - 2, 1),
                   device, solver, phase1), 1)
    if stage_n:
        up_bw, down_bw, dispatch_lat = probe_link(device)
        submetrics["dispatch_latency_ms"] = round(dispatch_lat * 1e3, 4)
        submetrics["link_up_mb_per_s"] = round(up_bw / 1e6, 1)
        stage_rate, warm_rate, decomp = run_re_stage(
            make_workload_flat(stage_n, seed=3), max(reps - 2, 2), device)
        submetrics["re_stage_models_per_sec"] = round(stage_rate, 1)
        # the serial seconds the stage's bytes take at this run's link
        # rates; they can exceed the wall (copies overlap the solves)
        link_s = decomp["bytes_up"] / up_bw + decomp["bytes_down"] / down_bw
        decomp["serial_link_s_est"] = round(link_s, 4)
        decomp["link_fraction"] = round(min(link_s / decomp["wall_s"], 1.0),
                                        3)
        submetrics["re_stage_decomposition"] = decomp
        submetrics["re_stage_solve_bound_models_per_sec"] = round(
            warm_rate, 1)
    if os.environ.get("BENCH_DETEXT", "1") != "0":
        submetrics["detext_rows_per_sec"] = round(
            run_detext(max(reps - 2, 2), device), 1)
    score_records = _env_int("BENCH_SCORE_RECORDS", 1_000_000)
    if stage_n and score_records:
        submetrics["re_score_records_per_sec"] = round(
            run_re_score(make_workload_flat(stage_n, seed=3), score_records,
                         max(reps - 2, 2), device), 1)
    if heavy_n:
        submetrics["re_sharded_heavy_tail_models_per_sec"] = round(
            run_re_sharded(heavy_tail(heavy_n, flat=True), "sharded-heavy-tail",
                           max(reps - 2, 1), device), 1)
    if run_fe_cells:
        submetrics["fe_funcalls_per_sec"] = round(run_fe(device), 2)
    if run_fe_cells and os.environ.get("BENCH_FE_WIDE", "1") != "0":
        submetrics["fe_wide_d_funcalls_per_sec"] = round(
            run_fe(device, max(reps - 2, 2), d=1_000_000, tag="fe-wide-d",
                   zipf_s=1.2), 2)
        # uniform ids have no hot set: the split declines, and the same
        # auto path takes the fused kernel
        submetrics["fe_wide_d_uniform_funcalls_per_sec"] = round(
            run_fe(device, max(reps - 2, 2), d=1_000_000,
                   tag="fe-wide-d-uniform"), 2)
    watchdog.cancel()
    _say(f"bench: total wall {time.time() - t_start:.1f}s")
    line.emit(primary, submetrics)


if __name__ == "__main__":
    main()
