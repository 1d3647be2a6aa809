#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`gdmix_tpu_torch`), one H100.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one result line; any failure exits non-zero:
  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — the hand-written CUDA kernels from csrc/, one nvcc per
                source for sm_90a, all started together.
  3. kernels  — each kernel against its plain PyTorch version at the main
                path's shapes, with its least time on the card (bytes or
                flops at the published peak) and, where one PyTorch call
                computes the same function, that call's time: the RE
                kernels on inputs made from a numpy seed (K1 and K2, whole
                solves, at B = 65,536 with n = 8/16/32, at every lanes tier
                of the primary fit's plan, K2 at n = 64/512 and streamed at
                n = 2,048, each with a shared-memory bound beside the
                bytes/flops one, and K1 at the old 128-entity launch shape;
                the SPD solves at d = 100, 160, 200,
                256 and the dual's n = 32, 64, 128, at B = 4,096, at the
                wide fit's buckets of 128 and at the support_120 fit's own
                bucket shape, each also against the kernel's LDLᵀ
                arithmetic in float64, and timed against
                torch.linalg.solve in turns, medians of 5, which it must
                not be slower than; and one K3 and one K4 row in float64
                on damped systems of condition ~1e11); the FE
                kernels at the JAX bench's full width
                (N = 4,997,120, D = 10,000, K = 16) with uniform and
                Zipf(1.2) ids, logistic and linear; the fused kernel in
                both of its forms there (privatised and device-memory; the
                privatised one must not be the slower on uniform ids,
                medians of 5 turns), the privatised form at the largest D
                it takes, the device-memory form at D = 100,000 Zipf and
                D = 1,000,000 uniform, cuts at K = 5 and 12, without an
                intercept and with weight-0 rows, and float64, and at
                criteo's K = 39 (Zipf(1.2) over D = 1,000,000, the
                lane-group path) with its bound and plain time; the flat
                entry scatter (K10/K11, on the fused kernel's table) at
                uniform and Zipf ids at D = 10,000 in float32 and float64,
                at the largest privatised D, at D = 100,000 Zipf and
                D = 1,000,000 uniform, each against its plain version in
                float64 and timed beside index_add_.
  4. fit      — RandomEffectLRModel.fit_flat at full width: the primary
                random-effect workload (100k entities, 24 features, pareto
                sample counts 2..64), a moderate-support cut
                (64 < dim ≤ 128) that runs the batch-major Newton and its
                linear solve, and the bench's heavy tail (20k entities,
                counts 2..2,048) whose tiers take every form of K1/K2; one
                lanes launch per tier of each form, no host read inside a
                Newton solve; the primary warm and profiled (idle share);
                small cuts of the primary and the heavy tail against the
                float64 CPU solve.
     two_phase — two-phase Newton (newton_phase1_iters = 2): K1 and K2
                (both forms) over a lane list on the card against their
                plain versions, at every tier of the primary and the heavy
                tail, phase 1 of 1 and 2 iterations, cold and warm (every
                20th entity cold): inside the prefix within F32_TOL,
                outside it untouched; a bucket's two-phase dispatch makes
                the host reads of the single-phase one (sync debug mode),
                on every bucket of the primary, and a tier's dispatch cut
                over 2 and 4 shards no more than the single-phase one;
                fit_flat of both workloads on the host plane and on the
                sharded plane at P = 1, 2 and 4 (the card repeated):
                converged ≥ 0.999, well-posed entities within F32_TOL of
                the single-phase fit, two launches a shard of a tier past
                64 entities; on the mesh of 4 each shard's phase-2 inputs
                and lane list captured, the lists equal to a numpy cut of
                the tier's flags and K1/K2 over them against their plain
                versions; the primary's
                four tiers timed with and without two-phase, cold and
                warm, and K1 at B = 65,536, n = 8 without a lane list;
                `BENCH_PHASE1=2 python -m gdmix_tpu_torch.bench` (its RE
                cells), converged ≥ 0.999, no host read a bucket beyond
                the single-phase dispatch's.
     wide     — the bench's wide-support workload (4,096 entities, d = 512,
                ≤ 16 nnz, 32–64 samples) cold and warm through the dual
                Newton and its multi-RHS solve; SIMPLE and FULL variance;
                cuts that take the densified and the sparse L-BFGS rungs
                and the primal Newton past dim 128; slices of the dual
                (with and without variance), dense and sparse cuts
                against a float64 CPU fit.
  5. fe_fit   — FixedEffectLRModel.fit_data at full width through the fused
                kernel (grad_mode auto) and through the flat pair
                (grad_mode pallas_flat), each against an L-BFGS fit of the
                same objective through the plain version on the card.
     wide_d   — the bench's wide-D FE workload (D = 1,000,000, Zipf(1.2)
                ids, N and K as above): the hot/cold split's build, the
                objective through auto (K12 + 2×K13), pallas_hybrid and
                scatter (the fused kernel) against the plain version, a
                fit_data through auto (held to its objective at its final
                point: it does not converge in 100 iterations at λ = 1),
                the same fit at λ = 10⁴, which converges, against a
                plain-version fit, K12
                (A = 16,384, A = 65,536 through the tiered table, float64,
                and uniform compact ids) and K13
                (gradient and row layouts, through their work plans; two
                calls equal) against their plain versions, and K13 on a
                layout with a split, an owned, a padding, a value-0 and an
                unreached window into a table allocated onto NaN;
                uniform ids at D = 1M, where the split declines; criteo's
                K = 39: the objective through auto and K12 at A = 16,384
                against the plain version, every K12 launch on the
                lane-group path.
  6. pipeline — `python -m gdmix_tpu_torch.workflow.main --mode in_memory
                --num_sweeps 2` (run in this process, so the launch counts
                can be read) on the synthetic movieLens data: global →
                per-user → per-movie; validation AUC must climb; sweep 2's
                RE fits upload no static column through the sweep cache
                and each equals an uncached refit of its inputs bit for
                bit; with the global coordinate held at its zero model,
                the cached and the uncached run agree within 1e-6 AUC.
     single_node — the file-based pipeline through the CLI's default mode
                (`workflow.main --config_path X`, no --mode) in this
                process, on synthetic data at MovieLens-100K's counts (943
                users, 1,682 movies, 100,000 ratings; per-user in 2
                partitions): AUC per coordinate, each coordinate's
                partition / train / evaluate seconds, the launches of K5,
                K1 and K2; the AUC must climb, the directory contract be
                there, K5 and K1 launch, and an in-memory run (one sweep)
                on the same data and config agree within 2e-3 AUC; K1/K2
                at every lanes tier of the run's per-user and per-movie
                partition plans and K5 on its global training batch
                (D = 44) against their plain versions; then both modes
                again under torch.profiler (device busy, idle).
     dag      — the same pipeline as the job DAG (`--mode dag`): eight
                subprocesses on the card, each `python -m
                gdmix_tpu_torch.…` loading the kernels built above; each
                job's wall and each train job's kernel launches (its last
                log line): K5 in the global job, K1 in both RE jobs; each
                AUC within 2e-3 of the single-node run's.
     sharded  — the entity-sharded RE plane (re_mode="sharded": records
                routed to the mesh shard owning their entity, grouped and
                packed on the card): the primary at full width through
                fit_flat on both planes at P = 1, cold and warm (median of
                3), walls, the sharded plane's phases and tiers, each
                plane's K1/K2 launches and idle share (torch.profiler),
                max|Δθ| between the planes ≤ F32_TOL; the primary on
                meshes repeating the card two and four times (the P > 1
                exchange and per-shard solves on CUDA tensors; one card,
                so no launch crosses a device) against P = 1; the heavy
                tail against the host plane, K1 and K2 at its largest-B
                sharded tier of each, on the arrays the plane packed,
                against their plain versions; the wide-support and
                support_120 cuts (the rungs each plane took, well-posed
                entities ≤ F32_TOL); a refit through the sharded device
                cache bit-equal to the uncached one with no static upload;
                the movieLens in-memory pipeline with --re_mode sharded
                against --re_mode host (AUC within 1e-4 a coordinate), and
                the trainer CLI's RE stage with --re_mode=sharded in a
                fresh process.
  7. cli      — `python -m gdmix_tpu_torch.gdmix --action=train` in a fresh
                process: --stage=random_effect on a small written dataset,
                --stage=fixed_effect on the movieLens global data, eagerly
                and with --stream_chunk_rows (objectives within 1e-6).
  8. stream   — out-of-core ingestion at full width: the primary RE
                workload as a grouped tfrecord partition through
                RandomEffectLRModel.train eagerly and in chunks of 16,384
                entities (models within F32_TOL, K1/K2 at the first
                chunk's tiers, streamed scores), the FE uniform batch as 4
                per-record tfrecord files through FixedEffectLRModel.train
                eagerly and in chunks of 1,048,576 records (device batches
                equal, fits within 1e-6, K5 on the streamed batch,
                streamed predict), host and device peaks; the RE sweep
                cache (a cached refit bit-equal to the uncached one, no
                static upload) and the warm-sweep downlink skip (one host
                read of the probe).
  8b. varlen_attention — ModernBERT's attention kernel
                (csrc/varlen_attention.cu), forward and backward, against
                the plain versions in float64 and bit-equal over two
                backward passes, on a pack of documents at the tiles' and
                the window's edges and at the ModernBERT cell's shapes (16
                documents of 64–8,192 rows, 12 heads), whole documents and
                a window of 64, with each direction's ms and bound. Alone:
                `python3 -c "import chip_smoke as c; card =
                c.phase_device(); print(c.phase_varlen_attention(card))"`.
     modernbert — the kernel on the main path: ModernBERT-base's tower
                (benchmark/configs/detext-modernbert-base.json's widths)
                through DeepTowerModel._fit_rows, two steps of 4
                documents of 64–8,192 positions and the validation's
                forward: 22 forward launches a forward pass and 22
                backward launches a step, finite losses and scores; the
                kernels line's varlen_attention launches. Alone:
                `python3 -c "import chip_smoke as c, tempfile; card =
                c.phase_device(); print(c.phase_modernbert(card,
                tempfile.mkdtemp()))"`.
  9. detext   — the deep fixed effect (DeText): the JAX bench's deep-tower
                cell (B = 4,096, L = 16, vocabulary 30,000, wide D =
                10,000, K = 8; cnn windows 2 and 3, 64 filters, 64 units,
                128 hidden), one step on the card against the CPU's
                float64 step (loss for every encoder, gradients for the
                cnn), the warm step's rate (detext_rows_per_sec) for the
                cnn, the lstm (2 layers, with cuDNN and without) and the
                transformer (2 layers, 4 heads); then the detext pipeline
                (deep tower → per-user → per-movie) through the CLI's
                default mode at MovieLens-100K's counts, the tower at
                DeepTowerParams' defaults for 10 epochs: AUC climbing
                from above 0.55, stage seconds, the tower's fit, a cold
                predict from its checkpoint equal to the warm scores,
                K1/K2 at every lanes tier of its RE partitions against
                their plain versions, and the tower's train under
                torch.profiler (device busy, idle).
     multiprocess — multi-process training (ROADMAP A.6b): two processes
                sharing the card over a gloo process group (NCCL refuses
                two ranks on one card), each joined through the JAX
                package's environment contract (COORDINATOR_ADDRESS /
                NUM_PROCESSES / PROCESS_ID). Through the model API: the FE
                uniform cell fit on rows rank::2 (one all-reduce of [loss,
                gradient] a funcall; profiled: each process's idle share)
                and the wide-D cell at λ = 10⁴ through auto (K12 + 2×K13
                on each process's own split), θ bit-equal on both ranks and
                within the FE limits of one process's fit; the in-memory
                movieLens-100K pipeline, 2 sweeps, on the host and the
                sharded RE plane (the model-file exchange), AUC within
                2e-3 of one process; the deep tower (cnn, batch 512, 3
                epochs; float32, and float64 held to 1e-6) against one
                process. The trainer CLI over the FE
                cell's 4 tfrecord files (two a process), eagerly and in
                chunks of 1,048,576 rows; `workflow.main --mode
                distributed` against the single-node run. Every process's
                kernel launches add to the kernels line.
 10. bench    — `python -m gdmix_tpu_torch.bench` at its full defaults in a
                fresh process (the JAX bench's workloads and line through
                the port): exit 0, every key of the line, every rate > 0,
                no expired budget, converged ≥ 0.999 on every RE line; its
                kernel launches (its bench[kernels] line) add to the
                kernels line.
     prewarm  — tools/prewarm at its defaults with GDMIX_TPU_COMPILE_CACHE
                an empty directory (every CUDA library built there, the
                ladder fit twice on the sharded plane), then a fresh
                process that fits the primary over that directory and
                builds nothing (0.0 s for every CUDA and native library),
                its second fit under util/timing's device_profile (a trace
                with kernel events), beside a cold process over another
                empty directory whose first fit includes its nvcc.
Launch counts are zeroed just before each main-path run (4, two_phase, wide, 5,
wide_d, 6, single_node, sharded, multiprocess — in each child process —,
stream, modernbert, detext, bench and prewarm in theirs) and read just after. Then one JSON line of per-kernel results
and, last, the device line. Exits non-zero without a result when no card is present.
Imports no JAX.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 5e-3     # the JAX package's own lanes-vs-batch-major bound
F64_REL_TOL = 1e-9
# the LDLᵀ kernel against its own arithmetic (ldlt_solve_plain) in float64:
# the same panel-blocked operations, summed in other orders, on systems of
# condition ≤ ~5 (H = QQᵀ/d + I)
LDLT_F64_RTOL = 1e-12
# the same on damped, badly conditioned systems (eigenvalues 1e-6…1e6,
# cond ≈ 2.4e11): two backward-stable solves sit up to cond·ε apart; the
# CPU mirror, Gauss–Jordan and LAPACK's LU sit ≤ 2e-6 apart there
# (tests/test_torch_linsolve.py), so 1e-5 relative. The residual
# max|H·x − R| / (max|H|·max|x|), which conditioning does not enlarge,
# is ~1e-16 for each, so 1e-12
ILL_F64_RTOL, ILL_F64_RESID = 1e-5, 1e-12
SOLVE_ROUNDS = 5   # kernel and library timed in turns; medians
# a float32 variance against the float64 fit's: the variance follows the
# weights p(1−p) at the fitted margins, |d ln p(1−p)/dz| ≤ 1, so its
# relative gap is at most the margins' gap, a few 1e-3 at the θ gaps the
# dual cut shows (~3e-4 over ≤ 16 values a record)
VAR_RTOL = 1e-2
# FE kernels against their plain versions: the f32 sums run in another
# order (atomics), so loss ≤ 1e-5 relative and max|Δg| ≤ 1e-4·max|g|; in
# float64 both ≤ 1e-12 relative
FE_LOSS_RTOL, FE_GRAD_RTOL, FE_F64_RTOL = 1e-5, 1e-4, 1e-12
# the fitted objective against the plain-version fit: both stop at ftol
# 1e-12 or ‖g‖∞ ≤ 1e-5 from float32 gradients summed in other orders
FE_FIT_RTOL = 1e-6
FE_N, FE_D, FE_K = 4_997_120, 10_000, 16    # bench.py:536-537, :521
# the width of a criteo row (13 numeric and 26 categorical features): past
# the pass kernels' vector path, on their lane-group path
CRITEO_K = 39
# the file-based pipeline against the in-memory one, and the DAG against
# the file-based pipeline: the JAX package's own bound between its two modes
# (tests/test_in_memory_pipeline.py:29), the same math through two plumbings
MODES_AUC_ATOL = 2e-3
# MovieLens-100K's counts (the reference's movieLens example), synthetic:
# the real files are not in the repository
ML100K = dict(num_users=943, num_movies=1682, num_ratings=100_000, seed=7)
COORDINATES = ("global", "per-user", "per-movie")
DEV = "cuda:0"


def _say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs after one warm-up, by CUDA
    events (the plain versions synchronize inside; the events still bracket
    all of their device work)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ inputs --

def lr_problem(B, n, dim, seed):
    """Per-entity LR problems, batch-major float32: X [B, n, dim] with the
    intercept column first, ragged counts, weights 0 on padding rows, both
    classes in every entity's real rows."""
    rng = np.random.RandomState(seed)
    X = np.empty((B, n, dim), np.float32)
    X[:, :, 0] = 1.0
    X[:, :, 1:] = rng.randn(B, n, dim - 1).astype(np.float32) * 0.8
    cnt = rng.randint(2, n + 1, B)
    w = ((np.arange(n)[None, :] < cnt[:, None])
         * rng.uniform(0.5, 2.0, (B, n))).astype(np.float32)
    off = rng.randn(B, n).astype(np.float32) * 0.3
    z = np.einsum("bnd,bd->bn", X, rng.randn(B, dim).astype(np.float32)) + off
    y = (rng.uniform(size=(B, n)) < 1 / (1 + np.exp(-z))).astype(np.float32)
    y[:, 0] = 1.0
    y[:, 1] = 0.0
    return X, y, w, off, cnt.astype(np.float32)


def make_workload_flat(*args, **kwargs):
    """The JAX bench's random-effect workload as a columnar FlatGroups
    (gdmix_tpu_torch/bench.py make_workload_flat): long-tail (pareto)
    per-entity sample counts, sparse records over a d-wide feature bag,
    labels from a per-entity logistic model."""
    from gdmix_tpu_torch.bench import make_workload_flat as make
    return make(*args, **kwargs)


def support_120_workload():
    """The moderate-support RE cut: 16,384 entities, 120 features, ≤ 8 nnz,
    16–64 samples: dims 81–121, the batch-major primal Newton and K3."""
    return make_workload_flat(16384, seed=4, d=120, max_nnz=8, count_lo=16,
                              count_hi=64)


def _write_metadata(tmp, d):
    from gdmix_tpu_torch.io.feature_list import write_feature_list
    os.makedirs(tmp, exist_ok=True)
    md_file = os.path.join(tmp, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "per_entity", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "user_id", "dtype": "string", "shape": [],
             "isSparse": False},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "float", "shape": [],
                        "isSparse": False}]}, f)
    feature_file = os.path.join(tmp, "features.csv")
    write_feature_list([(f"f{i}", "") for i in range(d)], feature_file)
    return md_file, feature_file


def stage_model(d, tmp, dtype="float32", device=None, **over):
    """RandomEffectLRModel with the primary workload's settings (the JAX
    bench's, bench.py:287-310), REParams fields overridden by `over`."""
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.params import Params, REParams
    md_file, feature_file = _write_metadata(tmp, d)
    fields = dict(
        metadata_file=md_file, output_model_dir=tmp,
        feature_bag="per_entity", feature_file=feature_file,
        partition_entity="user_id", l2_reg_weight=1.0,
        regularize_bias=False, dtype=dtype, lbfgs_tolerance=1e-12,
        lbfgs_pgtol=1e-5, num_of_lbfgs_iterations=100,
        sparsity_threshold=0.0)
    fields.update(over)
    model_params = REParams(**fields)
    base_params = Params(
        action="train", stage="random_effect",
        model_type="logistic_regression", label_column_name="response",
        uid_column_name="uid",
        prediction_score_column_name="predictionScore")
    return RandomEffectLRModel(model_params, base_params,
                               device=device), base_params


def fe_problem(ids, seed=0, n=None, dtype=None, d=FE_D, k=FE_K):
    """The JAX bench's FE batch (bench.py:562-582) on the card, drawn by
    gdmix_tpu_torch/bench.py fe_batch: ids "uniform" on [0, d) or "zipf",
    inverse-CDF Zipf(1.2) shifted to 0 (the item-popularity class: id 0 is
    the hottest); FE_N rows of k entries unless `n` is given."""
    import torch
    from gdmix_tpu_torch.bench import fe_batch
    return fe_batch(n or FE_N, d, 0.0 if ids == "uniform" else 1.2,
                    torch.device(DEV), k=k, seed=seed,
                    dtype=dtype or torch.float32)


def fe_stage_model(tmp, grad_mode, d=FE_D, **over):
    """FixedEffectLRModel with the JAX bench's settings (bench.py:541-559),
    FixedLRParams fields overridden by `over`."""
    from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu_torch.params import FixedLRParams, Params
    os.makedirs(tmp, exist_ok=True)
    md_file = os.path.join(tmp, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "global", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "float", "shape": [],
                        "isSparse": False}]}, f)
    model_params = FixedLRParams(**{
        **dict(metadata_file=md_file, output_model_dir=tmp,
               feature_bag="global", l2_reg_weight=1.0,
               regularize_bias=False, dtype="float32", grad_mode=grad_mode),
        **over})
    base_params = Params(
        action="train", stage="fixed_effect",
        model_type="logistic_regression", label_column_name="response",
        uid_column_name="uid",
        prediction_score_column_name="predictionScore")
    return FixedEffectLRModel(model_params, base_params,
                              device=DEV), base_params


def movielens_config(ml, out_dir):
    """The reference's movieLens workflow (gdmix-workflow/test/resources/
    lr-movieLens.yaml): global fixed effect, per-user and per-movie random
    effects, with the repo's e2e settings."""
    gdmix_config = {"model_type": "logistic_regression",
                    "label_column_name": "response",
                    "uid_column_name": "uid",
                    "prediction_score_column_name": "predictionScore",
                    "weight_column_name": "weight"}

    def coord(bag, **extra):
        return dict(
            training_data_dir=os.path.join(ml, bag, "trainingData"),
            validation_data_dir=os.path.join(ml, bag, "validationData"),
            feature_file=os.path.join(ml, bag, "featureList", bag),
            feature_bag=bag,
            metadata_file=os.path.join(ml, bag, "metadata",
                                       "tensor_metadata.json"),
            l2_reg_weight=1.0, regularize_bias=False,
            gdmix_config=gdmix_config, **extra)
    return {"output_dir": out_dir,
            "fixed_effect_config": {"global": coord("global")},
            "random_effect_config": {
                "per-user": coord("per_user", partition_entity="user_id"),
                "per-movie": coord("per_movie",
                                   partition_entity="movie_id")}}


# ------------------------------------------------------------------ phases --

def phase_device():
    import torch
    _check(torch.cuda.is_available(), "no CUDA device (torch.cuda)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120)
    _check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say("device", kind=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build():
    from gdmix_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    _cuda.load_all(("fe_loss_grad", "ldlt_solve", "newton_lanes",
                    "fe_hybrid", "windowed_scatter", "re_pack",
                    "varlen_attention"))
    _say("build", seconds=round(time.perf_counter() - t0, 2),
         nvcc={k: round(v, 2) for k, v in _cuda.build_seconds.items()})
    for name, rep in _cuda.ptxas_report.items():
        for line in _cuda.ptxas_lines(rep):
            print(f"  ptxas[{name}] {line}")


def phase_kernels():
    import torch
    from gdmix_tpu_torch.ops import newton_lanes as nl
    dev = torch.device("cuda:0")
    res = {}
    kw = dict(lam=1.0, unreg_bias=True, maxiter=100, ftol=1e-12, pgtol=1e-5)

    res.update(_lanes_rows())

    # K3: damped SPD solves at the batch-major Newton's width (d = 100), at
    # the widths the primal rung admits past 128 (shared memory up to
    # d = 308 in f32 and 208 in f64; d = 256 in f64 in the device-memory
    # workspace), and at the support_120 fit's most frequent bucket shape,
    # read from its bucket plan; K4: the dual Newton's n×n systems, r = 2,
    # n = 32, 64 and 128; then K4 at the wide fit's own launches, one
    # bucket of B = 128 at its n_cap 32 and 64
    f32, f64 = torch.float32, torch.float64
    shapes = _support_120_k3_shapes()
    (b_fit, d_fit), _ = shapes.most_common(1)[0]
    _say("kernels", support_120_k3_buckets={f"B{b}_d{dd}": c for (b, dd), c
                                            in sorted(shapes.items())},
         linalg_library=torch.backends.cuda.preferred_linalg_library())
    for name, B, d, r, dts in (
            ("spd_solve_batched", 4096, 100, 1, (f32, f64)),
            ("spd_solve_batched", 4096, 200, 1, (f32,)),
            ("spd_solve_batched", 4096, 160, 1, (f64,)),
            ("spd_solve_batched", 4096, 256, 1, (f32, f64)),
            ("spd_solve_batched", b_fit, d_fit, 1, (f32,)),
            ("spd_solve_batched_mrhs", 4096, 32, 2, (f32,)),
            ("spd_solve_batched_mrhs", 4096, 64, 2, (f32, f64)),
            ("spd_solve_batched_mrhs", 4096, 128, 2, (f32, f64)),
            ("spd_solve_batched_mrhs", 128, 32, 2, (f32,)),
            ("spd_solve_batched_mrhs", 128, 64, 2, (f32,))):
        row = _solve_row(name, B, d, r, dts, seed=B + d + r)
        if (name, B, d) in (("spd_solve_batched", 4096, 100),
                            ("spd_solve_batched_mrhs", 4096, 64)):
            res[name] = row
    # both near singularity, where a tiled sum or a pivot gone wrong shows
    _ill_conditioned_row("spd_solve_batched", 128, d_fit, 1)
    _ill_conditioned_row("spd_solve_batched_mrhs", 128, 128, 2)
    return res


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM 3.35 TB/s;
# 67 TFLOP/s float32 outside the tensor cores, 67 TFLOP/s float64 through
# the FP64 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}   # by element size in bytes


def _bound(nbytes: float, flops: float, item: int = 4):
    """(least ms, "bytes" or "operations"): the larger of moving `nbytes`
    at the memory rate and doing `flops` at the peak rate of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[item] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _spd_solve_flops(d: int, r: int) -> float:
    """Flops that one d×d SPD system with r right-hand sides needs,
    whatever algorithm runs it: a Cholesky factorisation (d³/3) and a
    forward and a back substitution per column (d² each)."""
    return d ** 3 / 3 + 2 * d * d * r


def _plan_buckets(fg, d):
    """[(B, n_cap, dim, rung)] of `fg`'s bucket plan, read from
    iter_bucketize_flat in order, with the rung _select_solver gives each
    bucket (the plan is host work: the model only answers that)."""
    from gdmix_tpu_torch.data.bucketing import iter_bucketize_flat
    out = []
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_plan_") as tmp:
        model, schema = stage_model(d, tmp, device="cpu")
        for b in iter_bucketize_flat(
                fg, schema, model.model_params.offset_column_name,
                has_intercept=model.has_intercept):
            B = b.indices.shape[0]
            rung, _ = model._select_solver(b.u_cap, B, b.n_cap)
            out.append((B, b.n_cap, b.u_cap + int(model.has_intercept),
                        rung))
    return out


# 32 banks of 4 bytes each, one access a clock, on every SM (Hopper): the
# card's shared-memory rate is this times the SMs times the SM clock
SMEM_BYTES_PER_CLOCK = 128


@functools.lru_cache(maxsize=None)
def _max_sm_clock_hz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=120)
    _check(out.returncode == 0, f"nvidia-smi clocks: {out.stderr.strip()}")
    return float(out.stdout.split()[0]) * 1e6


def _lanes_smem_wavefronts(form, n, d, iters):
    """128-byte shared-memory wavefronts that the lanes kernels' design
    needs (csrc/newton_lanes.cu) for entities of n rows and d coefficients
    taking `iters` [B] iterations: per entity the staging and an exact z/g
    pass; per iteration another z/g pass, the Hessian's 4×4 tiles (two
    16-byte X loads and one weight a row and a tile a lane), in the block
    forms the sum of four warps' tiles, the LDLᵀ and back substitution
    (8 a column), the u = Xδ pass and one line-search trial. A lower
    count: the trials past the first are left out."""
    D4 = (d + 4) // 4
    tiles = -(-(D4 * (D4 + 1) // 2) // 32)
    groups = -(-n // 32)                  # 32-row groups of a row pass
    stage = -(-n * d // 32) + 3 * groups
    zg = 5 * D4 * groups + n * (1 + -(-4 * D4 // 32))
    hess = 3 * n * tiles + (0 if form == "warp" else 96 * tiles)
    per_iter = zg + hess + 8 * d + 5 * D4 * groups + 4 * groups + 2
    return len(iters) * (stage + zg) + float(iters.sum()) * per_iter


def _lanes_row(fn, B, n, d, tag, reps=5, inputs=None):
    """K1 or K2 (`fn`) at one launch shape against its plain version on the
    card, on lr_problem's entities (or on `inputs`, the (θ0, X, y, w, off,
    counts) a fit launched it with): max|Δθ| ≤ F32_TOL where both converge,
    converged flags agreeing on ≥ 0.999 of the entities; timed, with its
    bound and the shared-memory traffic it needs beside it."""
    import torch
    from gdmix_tpu_torch.ops import newton_lanes as nl
    dev = torch.device(DEV)
    kw = dict(lam=1.0, unreg_bias=True, maxiter=100, ftol=1e-12, pgtol=1e-5)
    smem_rate = (SMEM_BYTES_PER_CLOCK * _max_sm_clock_hz()
                 * torch.cuda.get_device_properties(0).multi_processor_count)
    if inputs is None:
        X, y, w, off, cnt = (torch.from_numpy(a).to(dev)
                             for a in lr_problem(B, n, d, seed=n + d))
        th0 = torch.zeros(B, d, device=dev)
    else:
        th0, X, y, w, off, cnt = inputs
    B = X.shape[0]
    k = lambda: fn(th0, X, y, w, off, cnt, **kw)
    p = lambda: nl.newton_full_plain(th0, X, y, w, off, cnt, **kw)
    (thk, ck, ik), (thp, cp, _) = k(), p()
    torch.cuda.synchronize()
    both = ck & cp
    err = float((thk - thp).abs()[both].max())
    agree = float((ck == cp).float().mean())
    form = "warp" if fn is nl.newton_full else (
        "stream" if nl.lanes_form(n, d) == "stream" else "block")
    ms = _time_ms(k, reps)
    pms = _time_ms(p, 1)
    iters = ik.cpu().numpy()
    # bytes: X, y, w, offsets, counts, θ0 in; θ, flags, counts out.
    # flops per iteration and entity: the symmetric Hessian
    # (n·d·(d+1)), its SPD solve, gradient, margins and line search
    # (~6·n·d), over the iterations this run's entities took
    bound, by = _bound(
        4 * (B * n * d + 3 * B * n + B + 2 * B * d) + 5 * B,
        float(iters.sum()) * (n * d * (d + 1) + _spd_solve_flops(d, 1)
                              + 6 * n * d))
    smem = (_lanes_smem_wavefronts(form, n, d, iters)
            * SMEM_BYTES_PER_CLOCK / smem_rate * 1e3)
    _say("kernels", kernel=fn.__name__, shape=tag, form=form, B=B, n=n,
         dim=d, max_abs_dtheta=f"{err:.3e}",
         converged_agree=f"{agree:.6f}",
         converged=f"{float(ck.float().mean()):.6f}",
         iters_mean=f"{iters.mean():.3f}", iters_max=int(iters.max()),
         ms=f"{ms:.4f}", plain_ms=f"{pms:.3f}", bound_ms=f"{bound:.4f}",
         bound_by=by, smem_bound_ms=f"{smem:.4f}")
    _check(err <= F32_TOL, f"{fn.__name__} {tag} n={n}: max|dθ| {err}")
    _check(agree >= 0.999, f"{fn.__name__} {tag} n={n}: converged "
                           f"flags agree on {agree}")
    return dict(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                library_ms=None, smem_bound_ms=smem, max_abs_err=err)


def _lanes_rows():
    """K1 (newton_full) and K2 (newton_block), each a whole solve in one
    launch, against their plain version on the card: max|Δθ| ≤ F32_TOL where
    both converge, converged flags agreeing on ≥ 0.999 of the entities. K1
    at B = 65,536 and n = 8, 16, 32; each at every lanes tier of the primary
    and the heavy-tail fits' plans (read from iter_bucketize_flat), in the
    form the gate gives the tier, and both forms at the gate's crossover
    (`_gate_crossover`); K2 at n = 64 (B = 16,384), n = 512 (B = 2,048)
    and, streamed, n = 2,048 (B = 64); K1 at the old launch shape of 128
    entities. Bounds at each launch shape: bytes and flops (`_bound`), and,
    printed beside them, the shared-memory traffic this design needs at the
    card's shared-memory rate (`smem_bound_ms`). The K1 row of the kernels
    line is B = 65,536, n = 8 (the primary's largest tier), K2's the
    heavy tail's largest-B K2 tier."""
    import torch
    from gdmix_tpu_torch.ops import newton_lanes as nl
    dev = torch.device(DEV)
    kw = dict(lam=1.0, unreg_bias=True, maxiter=100, ftol=1e-12, pgtol=1e-5)
    worst = {"newton_full": 0.0, "newton_block": 0.0}

    def row(fn, B, n, d, tag, reps=5):
        r = _lanes_row(fn, B, n, d, tag, reps)
        worst[fn.__name__] = max(worst[fn.__name__], r["max_abs_err"])
        return r

    res = {}
    for n in (8, 16, 32):
        r = row(nl.newton_full, 65536, n, 25, "B65536")
        if n == 8:
            res["newton_full"] = r
    # every lanes tier of the primary and the heavy-tail plans, in the form
    # the gate gives it; K2's headline row is its largest-B heavy-tail tier
    heavy = _lanes_tiers(_plan_buckets(heavy_tail_workload(), 24))
    for tag, tiers in (("primary_tier", _lanes_tiers(_plan_buckets(
            make_workload_flat(100_000, seed=0), 24))),
                       ("heavy_tail_tier", heavy)):
        tier_ms = 0.0
        for B, n, d, form in tiers:
            fn = nl.newton_full if form == "warp" else nl.newton_block
            r = row(fn, B, n, d, tag)
            tier_ms += r["ms"]
            if fn is nl.newton_block and B >= res.get(
                    "newton_block", {}).get("B", 0):
                res["newton_block"] = dict(r, B=B)
        _say("kernels", **{f"{tag}s_ms": f"{tier_ms:.4f}"})
    _gate_crossover(row, heavy)
    for n, B in ((64, 16384), (512, 2048), (2048, 64)):
        row(nl.newton_block, B, n, 25, f"B{B}")
    # every other register tiling of both kernels (T = ⌈tiles/32⌉ = 2, 3,
    # 4, 5 at dim 33, 44, 56, 64; the rows above have T = 1), in each form
    for d in (33, 44, 56, 64):
        for fn, B, n, form in ((nl.newton_full, 8192, 32, "warp"),
                               (nl.newton_block, 4096, 128, "block"),
                               (nl.newton_block, 64, 2048, "stream")):
            _check(nl.lanes_form(n, d) == form,
                   f"lanes_form({n}, {d}) is not {form}")
            row(fn, B, n, d, f"dim{d}", reps=2)
    # the old launch shape: a bucket of 128 entities
    for n in (8, 16, 32):
        X, y, w, off, cnt = (torch.from_numpy(a).to(dev)
                             for a in lr_problem(128, n, 25, seed=n))
        th0 = torch.zeros(128, 25, device=dev)
        ms128, dev128 = _launch_shape_ms(
            lambda: nl.newton_full(th0, X, y, w, off, cnt, **kw))
        _say("kernels", kernel="newton_full", shape="B128", n=n, dim=25,
             ms=f"{ms128:.4f}", device_ms=f"{dev128:.4f}")
    for name, err in worst.items():
        res[name]["max_abs_err"] = err
    return res


def _gate_crossover(row, tiers):
    """K1 against K2 on each of `tiers`' tiers from n = 64 up where both
    forms fit the opt-in, on the same inputs in this call, with the warps
    per SM each form's shared memory leaves: the measurement behind
    lanes_form's WARP_FORM_MIN_WARPS. The warp form's budget is lifted to
    the opt-in for these calls alone."""
    from gdmix_tpu_torch.ops import newton_lanes as nl

    def warps(form, n, d):
        per_block = nl.form_smem_bytes(form, n, d) + nl.BLOCK_RESERVED_BYTES
        return 4 * (nl.SM_SMEM_BYTES // per_block)

    budget = nl.WARP_FORM_BLOCK_BYTES
    for B, n, d, form in tiers:
        if (form == "stream" or n < 64
                or nl.form_smem_bytes("warp", n, d) > nl.SMEM_OPTIN_BYTES):
            continue
        block_ms = row(nl.newton_block, B, n, d, "gate_block")["ms"]
        nl.WARP_FORM_BLOCK_BYTES = nl.SMEM_OPTIN_BYTES
        try:
            warp_ms = row(nl.newton_full, B, n, d, "gate_warp")["ms"]
        finally:
            nl.WARP_FORM_BLOCK_BYTES = budget
        _say("kernels", gate_crossover=f"B{B}_n{n}_dim{d}", gate=form,
             warp_ms=f"{warp_ms:.4f}", block_ms=f"{block_ms:.4f}",
             warp_form_warps_per_sm=warps("warp", n, d),
             block_form_warps_per_sm=warps("block", n, d))


def _support_120_k3_shapes():
    """{(B, dim): buckets} of the support_120 fit's plan whose solve reaches
    K3 (the primal rung past the lanes path's dim 64): the shapes the fit
    launches K3 at."""
    from collections import Counter
    return Counter((B, dim) for B, _, dim, rung
                   in _plan_buckets(support_120_workload(), 120)
                   if rung == "newton" and dim > 64)


def _lanes_tiers(plan):
    """[(B, n_cap, dim, form)] of a plan's buckets on the lanes path (the
    primal Newton at dim ≤ 64), with the form lanes_form gives each."""
    from gdmix_tpu_torch.ops import newton_lanes as nl
    return [(B, n, dim, nl.lanes_form(n, dim)) for B, n, dim, rung in plan
            if rung == "newton" and dim <= nl.MAX_DIM]


def heavy_tail_workload():
    """The JAX bench's heavy-tail RE workload (bench.py:693-694): 20,000
    entities, pareto 1.2 sample counts 2..2048, seed 1; its tiers reach
    every form of the lanes path."""
    return make_workload_flat(20_000, seed=1, count_hi=2048, pareto_a=1.2)


def _medians_ms(fns, reps, rounds=SOLVE_ROUNDS):
    """Median device ms of each of `fns` over `rounds` rounds, timed in
    turns within each round: a library call's time moves between calls
    (27 to 107 ms at d = 256 on one H100), and a median of turns in one
    call is what decides kernel against library."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(_time_ms(fn, reps))
    return [float(np.median(t)) for t in times]


def _launch_shape_ms(fn):
    """(ms a call by CUDA events over back-to-back calls, device-busy ms a
    call by torch.profiler) at a launch of one bucket of 128: the first
    includes the wrapper's host time where that, not the card, sets the
    rate; the second is the card's own."""
    return _time_ms(fn, 20), _top_kernels(fn, reps=10)[0]


def _solve_row(name, B, d, r, dtypes, seed):
    """K3 (r = 1) or K4 against its plain version, against the kernel's own
    LDLᵀ arithmetic (ldlt_solve_plain) in float64, and against
    torch.linalg.solve (the yardstick, which the port never calls) on
    damped SPD systems H = QQᵀ/d + I. Tolerances: max|Δx| ≤ 1e-4·max|x| in
    float32 and 1e-9 relative in float64 against the Gauss–Jordan plain
    version; 1e-12 relative in float64 against ldlt_solve_plain. Kernel
    and library are timed in turns (medians of SOLVE_ROUNDS). Returns the
    first dtype's result row."""
    import torch
    from gdmix_tpu_torch.ops import linsolve
    dev = torch.device("cuda:0")
    rng = np.random.RandomState(seed)
    Q = torch.from_numpy(rng.randn(B, d, d)).to(dev)
    H64 = Q @ Q.transpose(1, 2) / d + torch.eye(d, dtype=Q.dtype,
                                                device=dev)
    del Q
    R64 = torch.from_numpy(rng.randn(B, d, r)).to(dev)

    def kernel(H, R):
        if r == 1:
            return linsolve.spd_solve_batched(H, R[..., 0].contiguous())
        return linsolve.spd_solve_batched_mrhs(H, R)
    x64 = kernel(H64, R64).reshape(B, d, r)
    ref = linsolve.ldlt_solve_plain(H64, R64)
    ldlt_rel = _rel(x64, ref)
    _check(ldlt_rel <= LDLT_F64_RTOL,
           f"{name} B={B} d={d}: float64 against ldlt_solve_plain, rel "
           f"{ldlt_rel}")
    del x64, ref
    first = None
    for dt in dtypes:
        H = H64.to(dt).contiguous()
        R = R64.to(dt).contiguous()
        if r == 1:
            R = R[..., 0].contiguous()
            k = lambda: linsolve.spd_solve_batched(H, R)
            p = lambda: linsolve.gj_solve_plain(H, R)
            lib = lambda: torch.linalg.solve(H, R)
        else:
            k = lambda: linsolve.spd_solve_batched_mrhs(H, R)
            p = lambda: linsolve.gj_solve_mrhs_plain(H, R)
            lib = lambda: torch.linalg.solve(H, R)
        xk, xp = k(), p()
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        rel = err / float(xp.abs().max())
        tol = F64_REL_TOL if dt == torch.float64 else 1e-4
        ms, lms = _medians_ms((k, lib), 5)
        pms = _time_ms(p, 2)
        extra = ({} if B > 256 else
                 dict(device_ms=f"{_top_kernels(k, reps=10)[0]:.4f}"))
        # bytes: the lower triangle of H (all that the function needs of a
        # symmetric H, and all that the kernel reads), R in and X out
        item = H.element_size()
        bound, by = _bound(item * (B * d * (d + 1) // 2 + 2 * B * d * r),
                           B * _spd_solve_flops(d, r), item)
        ws = linsolve._workspace(1, d, r, H) is not None
        _say("kernels", kernel=name, B=B, d=d, r=r,
             dtype=str(dt).split(".")[1], memory="global" if ws else "shared",
             max_abs_dx=f"{err:.3e}", rel=f"{rel:.3e}",
             ldlt_f64_rel=f"{ldlt_rel:.3e}", ms=f"{ms:.4f}",
             plain_ms=f"{pms:.3f}", library_ms=f"{lms:.4f}",
             kernel_le_library=ms <= lms,
             bound_ms=f"{bound:.4f}", bound_by=by, **extra)
        _check(rel <= tol, f"{name} d={d} {dt}: rel err {rel}")
        _check(ms <= lms, f"{name} B={B} d={d} {dt}: kernel {ms} ms slower "
                          f"than torch.linalg.solve {lms} ms")
        if first is None:
            first = dict(ms=ms, plain_ms=pms, max_abs_err=err,
                         library_ms=lms, bound_ms=bound, bound_by=by)
        del H, R, xk, xp
    return first


def _ill_conditioned_row(name, B, d, r):
    """K3 (r = 1) or K4 in float64 on damped, badly conditioned systems:
    eigenvalues over 1e-6…1e6 plus the primal Newton's damping
    1e-10·(1 + |diag|), as tests/test_torch_linsolve.py builds them. The
    kernel must be finite, within ILL_F64_RTOL of ldlt_solve_plain and of
    the Gauss–Jordan plain version, and its residual within
    ILL_F64_RESID."""
    import torch
    from gdmix_tpu_torch.ops import linsolve
    rng = np.random.RandomState(d + r)
    V = np.linalg.qr(rng.randn(B, d, d))[0]
    H = np.einsum("bij,j,bkj->bik", V, np.logspace(-6, 6, d), V)
    H = (H + H.transpose(0, 2, 1)) / 2
    diag = np.arange(d)
    H[:, diag, diag] += 1e-10 * (1.0 + np.abs(H[:, diag, diag]))
    H = torch.from_numpy(H).to(DEV)
    R = torch.from_numpy(rng.randn(B, d, r)).to(DEV)
    if r == 1:
        x = linsolve.spd_solve_batched(H, R[..., 0].contiguous())[..., None]
    else:
        x = linsolve.spd_solve_batched_mrhs(H, R)
    ldlt_rel = _rel(x, linsolve.ldlt_solve_plain(H, R))
    gj_rel = _rel(x, linsolve.gj_solve_mrhs_plain(H, R))
    resid = float((H @ x - R).abs().max() / (H.abs().max() * x.abs().max()))
    finite = bool(torch.isfinite(x).all())
    _say("kernels", kernel=name, B=B, d=d, r=r, dtype="float64",
         systems="ill_conditioned", finite=finite,
         ldlt_f64_rel=f"{ldlt_rel:.3e}", gj_f64_rel=f"{gj_rel:.3e}",
         residual=f"{resid:.3e}")
    _check(finite and ldlt_rel <= ILL_F64_RTOL and gj_rel <= ILL_F64_RTOL
           and resid <= ILL_F64_RESID,
           f"{name} B={B} d={d} badly conditioned: finite {finite}, against "
           f"ldlt_solve_plain {ldlt_rel}, against Gauss–Jordan {gj_rel}, "
           f"residual {resid}")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _device_form(fe):
    """Context: `fe_loss_grad_fused` takes its device-memory form whatever
    the shape (the wrapper's chooser is swapped for the block; the main
    path never runs under it)."""
    import contextlib

    @contextlib.contextmanager
    def forced():
        keep = fe.privatised_form
        fe.privatised_form = (
            lambda num_features, element_size: fe.FORM_DEVICE)
        try:
            yield
        finally:
            fe.privatised_form = keep
    return forced()


def _largest_privatised_d(fe, item):
    """The largest D whose gradient `privatised_form` keeps in shared
    memory at this element size."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fe.privatised_form(mid, item) else (lo, mid - 1)
    return lo


def _fe_fused_row(tag, args, reps=10, device=False, **kw):
    """K5 against its plain version on one batch, in the form the wrapper
    chooses or (device=True) the device-memory form: FE_LOSS_RTOL and
    FE_GRAD_RTOL in float32, FE_F64_RTOL in float64. The plain version runs
    in float64 on the same values: under Zipf ids ~10⁷ float32 additions
    into one slot round by a few 1e-5 of max|g| in whatever order they are
    made, and the error reported should be the kernel's, not the
    reference's. Returns (ms, max|Δg|, the kernel call)."""
    import contextlib
    import torch
    from gdmix_tpu_torch.ops import fe_loss_grad as fe
    x, d = args[0], args[-1]
    form = (lambda: _device_form(fe)) if device else contextlib.nullcontext

    def k():
        with form():
            return fe.fe_loss_grad_fused(*args, **kw)
    f64 = x.dtype == torch.float64
    ref = tuple(t.double() if torch.is_tensor(t) and t.is_floating_point()
                else t for t in args)
    (lv, gv), (lp, gp) = k(), fe.fe_loss_grad_plain(*ref, **kw)
    del ref
    torch.cuda.synchronize()
    l_rel = abs(float(lv - lp)) / abs(float(lp))
    g_rel = _rel(gv, gp)
    _check(gv.dtype == x.dtype
           and l_rel <= (FE_F64_RTOL if f64 else FE_LOSS_RTOL)
           and g_rel <= (FE_F64_RTOL if f64 else FE_GRAD_RTOL),
           f"fe_loss_grad_fused {tag}: loss rel {l_rel}, grad rel {g_rel}")
    ms = _time_ms(k, reps)
    shared = not device and fe.privatised_form(d, x.element_size())
    _say("kernels", kernel="fe_loss_grad_fused", cut=tag, N=args[1].shape[0],
         D=d, K=args[1].shape[1], dtype=str(x.dtype).split(".")[1],
         form="privatised" if shared else "device_memory",
         loss_rel=f"{l_rel:.2e}", grad_rel=f"{g_rel:.2e}", ms=f"{ms:.3f}",
         **{k_: v for k_, v in kw.items()})
    return ms, float((gv - gp).abs().max()), k


def _fe_edge_rows():
    """The two pass kernels at ragged sizes the full-width batches never
    reach (N not a multiple of a warp's records, K = 3, 4, 5, 8, 17, 20, 39
    and 64, and K = 16 with rows one element off a 16-byte boundary, tables
    of 1, 7, 44, 300 and 1,000 ids, ~30% value-0 entries and a run of
    weight-0 rows, both with out-of-range ids), float32 and float64, each
    against its plain version in float64 on sanitised ids; the fused kernel
    in the form the wrapper chooses and in its device-memory form. Every
    shape but the aligned K = 4, 8 and 16 takes the lane-group path (each
    call's path is counted and checked)."""
    import torch
    from gdmix_tpu_torch.ops import fe_hybrid as fh, fe_loss_grad as fe
    from gdmix_tpu_torch.ops import fe_pass
    worst = {"fe_loss_grad_fused": 0.0, "fe_hybrid_hot": 0.0}
    for n, k, d, shift in ((1001, 8, 44, 0), (37, 3, 7, 0), (4099, 20, 300, 0),
                           (513, 4, 1, 0), (70_001, 16, 300, 0),
                           (70_001, 16, 300, 1), (2999, 5, 44, 0),
                           (3001, 17, 300, 0), (20_011, 39, 1000, 0),
                           (777, 64, 300, 0)):
        rng = np.random.RandomState(n + k + shift)
        idx = rng.randint(0, d + 1, (n, k))        # d: K12's dump slot
        val = rng.randn(n, k) * (rng.rand(n, k) < 0.7)
        w = rng.rand(n) + 0.5
        w[n // 3:n // 3 + n // 10] = 0.0
        inert = (val == 0) | (w == 0)[:, None]
        raw = np.where(inert, d + 1_000_003, idx).astype(np.int32)
        y = (rng.rand(n) < 0.5).astype(np.float64)
        off, x = 0.3 * rng.randn(n), 0.2 * rng.randn(d + 1)
        for dt in (torch.float32, torch.float64):
            t = lambda a, dtype=dt: torch.as_tensor(a, dtype=dtype,
                                                    device=DEV)

            def rows_of(a, dtype):
                # [n, k] rows `shift` elements into a fresh buffer
                flat = torch.empty(n * k + shift, dtype=dtype, device=DEV)
                flat[shift:].copy_(torch.as_tensor(a, dtype=dtype).reshape(-1))
                return flat[shift:].view(n, k)
            ti = lambda a: torch.as_tensor(a, dtype=torch.int32, device=DEV)
            tol = FE_F64_RTOL if dt == torch.float64 else FE_GRAD_RTOL
            tval = rows_of(val, dt)
            want_path = ("vector" if shift == 0 and fe_pass.vector_shape(k)
                         else "lanes")
            for c in (fe.fe_loss_grad_fused, fh.fe_hybrid_hot):
                c.path_launches = {"vector": 0, "lanes": 0}
            # K5: ids in [0, d); the entries drawn at d take id 0
            ids5 = np.where(idx == d, 0, idx)
            k5 = (t(x), rows_of(np.where(inert, raw, ids5), torch.int32),
                  tval, t(y), t(w), t(off), d)
            got = fe.fe_loss_grad_fused(*k5)
            with _device_form(fe):
                gotd = fe.fe_loss_grad_fused(*k5)
            want = fe.fe_loss_grad_plain(
                t(x, torch.float64), ti(np.where(inert, 0, ids5)),
                t(val, torch.float64), t(y, torch.float64),
                t(w, torch.float64), t(off, torch.float64), d)
            # K12: compact ids in [0, d], d the dump slot
            gotk = fh.fe_hybrid_hot(t(x[:-1]), t(x[-1]),
                                    rows_of(raw, torch.int32), tval, t(y),
                                    t(w), t(off), d)
            wantk = fh.fe_hybrid_hot_plain(
                t(x[:-1], torch.float64), t(x[-1], torch.float64),
                ti(np.where(inert, d, idx)), t(val, torch.float64),
                t(y, torch.float64), t(w, torch.float64),
                t(off, torch.float64), d)
            torch.cuda.synchronize()
            rels = dict(
                k5_loss=abs(float(got[0] - want[0])) / abs(float(want[0])),
                k5_grad=_rel(got[1], want[1]),
                k5_device_loss=abs(float(gotd[0] - want[0]))
                / abs(float(want[0])),
                k5_device_grad=_rel(gotd[1], want[1]),
                k12_loss=abs(float(gotk[0] - wantk[0])) / abs(float(wantk[0])),
                k12_grad=_rel(gotk[1], wantk[1]),
                k12_r=_rel(gotk[3], wantk[3]),
                k12_rsum=abs(float(gotk[2] - wantk[2]))
                / float(wantk[3].abs().sum()))
            paths = {c.__name__: dict(c.path_launches)
                     for c in (fe.fe_loss_grad_fused, fh.fe_hybrid_hot)}
            _say("kernels", kernel="fe_pass_edges", N=n, K=k, D=d,
                 unaligned=bool(shift), dtype=str(dt).split(".")[1],
                 path=want_path, shape=tuple(fe_pass.pass_shape(k, tval)),
                 **{k_: f"{v:.2e}" for k_, v in rels.items()})
            # K5 twice (its two forms), K12 once, all on want_path
            _check(all(v[want_path] == sum(v.values()) == calls
                       for v, calls in zip(paths.values(), (2, 1))),
                   f"FE pass kernels at K={k} shift={shift}: paths {paths}, "
                   f"want {want_path}")
            _check(max(rels.values()) <= tol
                   and max(rels["k5_loss"], rels["k5_device_loss"],
                           rels["k12_loss"]) <= min(tol, FE_LOSS_RTOL),
                   f"FE pass kernels at N={n} K={k} D={d} {dt}: {rels}")
            worst["fe_loss_grad_fused"] = max(
                worst["fe_loss_grad_fused"],
                float((got[1] - want[1]).abs().max()),
                float((gotd[1] - want[1]).abs().max()))
            worst["fe_hybrid_hot"] = max(
                worst["fe_hybrid_hot"],
                float((gotk[1] - wantk[1]).abs().max()))
    return worst


def _entry_contributions(b, x):
    """The flat pair's entry contributions ce = v·r of a batch at x (the
    logistic residuals): K10's input on the pallas_flat path."""
    import torch
    from gdmix_tpu_torch.ops import fe_loss_grad as fe
    n, k = b.indices.shape
    idx, val = b.indices.reshape(-1), b.values.reshape(-1)
    z = torch.sum(fe.fe_gather_entries_plain(x[:-1], idx, val).reshape(n, k),
                  1) + b.offsets + x[-1]
    return (b.values * (b.weights * (torch.sigmoid(z) - b.labels))[:, None]
            ).reshape(-1)


def _k10_row(tag, idx, ce, d):
    """K10/K11 against its plain version on the card, which runs in float64
    on the same contributions (under Zipf ids ~10⁷ float32 additions meet in
    id 0, and the error reported should be the kernel's): rel ≤
    FE_GRAD_RTOL in float32, FE_F64_RTOL in float64; the kernel adds with
    atomics in another order than `index_add_`. Times: CUDA events over
    back-to-back calls, device time by torch.profiler, the plain version and
    `index_add_` in the working type; the bound reads ids and
    contributions once and writes the table once, one add an entry."""
    import torch
    from gdmix_tpu_torch.ops import fe_loss_grad as fe
    item = ce.element_size()
    k = lambda: fe.fe_scatter_entries(idx, ce, d)
    p = lambda: fe.fe_scatter_entries_plain(idx, ce, d)
    lib = lambda: torch.zeros(d, dtype=ce.dtype, device=DEV).index_add_(
        0, idx, ce)
    got, want = k(), fe.fe_scatter_entries_plain(idx, ce.double(), d)
    torch.cuda.synchronize()
    err, rel = float((got.double() - want).abs().max()), _rel(got.double(),
                                                              want)
    tol = FE_F64_RTOL if item == 8 else FE_GRAD_RTOL
    _check(got.dtype == ce.dtype and rel <= tol,
           f"fe_scatter_entries {tag}: rel {rel}")
    ms, pms, lms = _time_ms(k, 20), _time_ms(p, 5), _time_ms(lib, 5)
    dev_ms = _top_kernels(k, reps=10)[0]
    E = idx.shape[0]
    bound, by = _bound((4 + item) * E + item * d, E, item)
    form = ("privatised" if fe.privatised_form(d, item) == fe.FORM_BLOCK
            else "device_memory")
    _say("kernels", kernel="fe_scatter_entries", cut=tag, E=E, D=d,
         dtype=str(ce.dtype).split(".")[1], form=form,
         max_abs_err=f"{err:.3e}", rel=f"{rel:.2e}", ms=f"{ms:.4f}",
         device_ms=f"{dev_ms:.4f}", plain_ms=f"{pms:.3f}",
         library_ms=f"{lms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by)
    return dict(ms=ms, device_ms=dev_ms, plain_ms=pms, library_ms=lms,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def phase_fe_kernels():
    """The three FE kernels against their plain versions at full width,
    uniform and Zipf(1.2) ids, logistic and linear; the fused kernel in
    both of its forms at D = 10,000 (the privatised one must not be the
    slower on uniform ids), the privatised form at the largest D it takes
    in float32 and float64, the device-memory form at D = 100,000 Zipf and
    D = 1,000,000 uniform, and cuts at K = 5 and K = 12, without an
    intercept, with a block of weight-0 rows and in float64 (both forms);
    the device-memory form at criteo's K = 39 over D = 1,000,000 (the
    lane-group path); first, both pass kernels at small ragged sizes
    (_fe_edge_rows)."""
    import torch
    from gdmix_tpu_torch.ops import fe_loss_grad as fe
    res = {n: dict(max_abs_err=0.0) for n in (
        "fe_loss_grad_fused", "fe_gather_entries", "fe_scatter_entries")}
    fused = res["fe_loss_grad_fused"]
    fused["forms"] = {}

    def worst(err):
        fused["max_abs_err"] = max(fused["max_abs_err"], err)
    worst(_fe_edge_rows()["fe_loss_grad_fused"])
    g = torch.Generator(device=DEV).manual_seed(1)
    x = 0.05 * torch.randn(FE_D + 1, generator=g, device=DEV)
    for ids in ("uniform", "zipf"):
        b = fe_problem(ids)
        args = (x, b.indices, b.values, b.labels, b.weights, b.offsets, FE_D)
        for linear in (False, True):
            k = lambda: fe.fe_loss_grad_fused(*args, linear=linear)
            fl = lambda: fe.fe_loss_grad_flat(*args, linear=linear)
            p = lambda: fe.fe_loss_grad_plain(*args, linear=linear)
            (lp, gp) = p()
            errs = {}
            for name, (lv, gv) in (("fused", k()), ("flat", fl())):
                l_rel = abs(float(lv - lp)) / abs(float(lp))
                g_rel = _rel(gv, gp)
                errs[name] = f"{l_rel:.2e}/{g_rel:.2e}"
                _check(l_rel <= FE_LOSS_RTOL and g_rel <= FE_GRAD_RTOL,
                       f"FE {name} {ids} linear={linear}: loss rel {l_rel}"
                       f", grad rel {g_rel}")
                if name == "fused":
                    worst(float((gv - gp).abs().max()))
            ms, fms, pms = _time_ms(k, 10), _time_ms(fl, 10), _time_ms(p, 5)
            _say("kernels", kernel="fe_loss_grad", ids=ids, linear=linear,
                 N=FE_N, D=FE_D, K=FE_K, fused_ms=f"{ms:.3f}",
                 flat_ms=f"{fms:.3f}", plain_ms=f"{pms:.3f}",
                 loss_rel_grad_rel=errs)
            if not linear:
                fused["forms"][f"privatised_{ids}_ms"] = ms
            if ids == "uniform" and not linear:
                # ids and values [N, K], labels/weights/offsets [N] and θ
                # in, the gradient and loss out; per entry a gather and a
                # scatter multiply-add, per record ~10 flops
                bound, by = _bound(
                    4 * (2 * FE_N * FE_K + 3 * FE_N + 2 * (FE_D + 1)) + 4,
                    4 * FE_N * FE_K + 10 * FE_N)
                fused.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                             library_ms=None)
        # the device-memory form on the same batch, and the two forms in
        # turns: the privatised one must not be the slower on uniform ids
        dms, err, kd = _fe_fused_row(f"{ids}_device_form", args, device=True)
        worst(err)
        fused["forms"][f"device_memory_{ids}_ms"] = dms
        if ids == "uniform":
            pm, dm = _medians_ms(
                (lambda: fe.fe_loss_grad_fused(*args), kd), 10)
            _say("kernels", kernel="fe_loss_grad_fused", ids=ids, D=FE_D,
                 privatised_median_ms=f"{pm:.4f}",
                 device_memory_median_ms=f"{dm:.4f}",
                 privatised_le_device=pm <= dm,
                 blocks_per_sm=fe.fused_blocks_per_sm(FE_D, torch.float32,
                                                      FE_K))
            _check(pm <= dm, f"fe_loss_grad_fused D={FE_D} uniform: the "
                             f"privatised form {pm} ms is slower than the "
                             f"device-memory form {dm} ms")
            # cuts of the same batch: the general loop (K = 5, in both
            # forms) and the 16-byte path at another width (K = 12); no
            # intercept; linear without intercept; a block of weight-0 rows
            for kk in (5, 12):
                cut = (x, b.indices[:, :kk].contiguous(),
                       b.values[:, :kk].contiguous()) + args[3:]
                worst(_fe_fused_row(f"K{kk}", cut, reps=5)[1])
                if kk == 5:
                    worst(_fe_fused_row("K5_device_form", cut, reps=5,
                                        device=True)[1])
            no_b = (x[:-1].contiguous(),) + args[1:]
            worst(_fe_fused_row("no_intercept", no_b, reps=5,
                                has_intercept=False)[1])
            worst(_fe_fused_row("no_intercept_linear", no_b, reps=5,
                                has_intercept=False, linear=True)[1])
            w0 = b.weights.clone()
            w0[FE_N // 3:FE_N // 3 + 100_000] = 0.0
            worst(_fe_fused_row("weight_0_rows", args[:4] + (w0,) + args[5:],
                                reps=5)[1])
        # the flat pair's kernels alone, on the logistic entry residuals:
        # the gather reads ids, values and θ and writes [E], one flop an
        # entry; the scatter (K10) in _k10_row
        idx, val = b.indices.reshape(-1), b.values.reshape(-1)
        ce = _entry_contributions(b, x)
        E = FE_N * FE_K
        kf = lambda: fe.fe_gather_entries(x[:-1], idx, val)
        pf = lambda: fe.fe_gather_entries_plain(x[:-1], idx, val)
        out_k, out_p = kf(), pf()
        err, rel = float((out_k - out_p).abs().max()), _rel(out_k, out_p)
        _check(rel <= FE_GRAD_RTOL, f"fe_gather_entries {ids}: rel {rel}")
        ms, pms = _time_ms(kf, 10), _time_ms(pf, 5)
        bound, by = _bound(4 * (3 * E + FE_D), E)
        _say("kernels", kernel="fe_gather_entries", ids=ids, E=E,
             max_abs_err=f"{err:.3e}", rel=f"{rel:.2e}", ms=f"{ms:.3f}",
             plain_ms=f"{pms:.3f}", library_ms=None,
             bound_ms=f"{bound:.4f}", bound_by=by)
        gat = res["fe_gather_entries"]
        gat["max_abs_err"] = max(gat["max_abs_err"], err)
        if ids == "uniform":
            gat.update(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound,
                       bound_by=by)
        row = _k10_row(ids, idx, ce, FE_D)
        sca = res["fe_scatter_entries"]
        sca["max_abs_err"] = max(sca["max_abs_err"], row["max_abs_err"])
        sca.setdefault("forms", {})[f"{ids}_ms"] = row["ms"]
        if ids == "uniform":
            sca.update({k_: row[k_] for k_ in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        del b, args, ce, idx, val, out_k, out_p
    # other widths of the table: the largest D the privatised form takes,
    # and the device-memory form at D = 100,000 Zipf and D = 1,000,000
    # uniform
    for tag, ids, d in (
            ("largest_privatised", "uniform",
             _largest_privatised_d(fe, 4)),
            ("D100k_zipf", "zipf", 100_000),
            ("D1M_uniform", "uniform", 1_000_000)):
        bd = fe_problem(ids, seed=5, d=d)
        xd = 0.05 * torch.randn(d + 1, generator=g, device=DEV)
        ms, err, _ = _fe_fused_row(tag, (
            xd, bd.indices, bd.values, bd.labels, bd.weights, bd.offsets, d))
        worst(err)
        fused["forms"][f"{tag}_ms"] = ms
        # K10 at the same widths: its forms follow the same chooser
        row = _k10_row(tag, bd.indices.reshape(-1),
                       _entry_contributions(bd, xd), d)
        sca = res["fe_scatter_entries"]
        sca["max_abs_err"] = max(sca["max_abs_err"], row["max_abs_err"])
        sca["forms"][f"{tag}_ms"] = row["ms"]
        del bd
    # criteo's shape: K = 39 Zipf(1.2) ids over D = 1,000,000 (the
    # device-memory form) on the lane-group path, with the bound and the
    # plain version's time
    bc = fe_problem("zipf", seed=6, d=WIDE_D, k=CRITEO_K)
    xc = 0.05 * torch.randn(WIDE_D + 1, generator=g, device=DEV)
    cargs = (xc, bc.indices, bc.values, bc.labels, bc.weights, bc.offsets,
             WIDE_D)
    fe.fe_loss_grad_fused.path_launches = {"vector": 0, "lanes": 0}
    ms, err, _ = _fe_fused_row("criteo_K39", cargs, reps=10)
    worst(err)
    paths = dict(fe.fe_loss_grad_fused.path_launches)
    _check(paths["vector"] == 0 and paths["lanes"] > 0,
           f"fe_loss_grad_fused criteo_K39: paths {paths}")
    pms = _time_ms(lambda: fe.fe_loss_grad_plain(*cargs), 3)
    bound, by = _bound(
        4 * (2 * FE_N * CRITEO_K + 3 * FE_N + 2 * (WIDE_D + 1)) + 4,
        4 * FE_N * CRITEO_K + 10 * FE_N)
    _say("kernels", kernel="fe_loss_grad_fused", cut="criteo_K39", N=FE_N,
         D=WIDE_D, K=CRITEO_K, ms=f"{ms:.3f}", plain_ms=f"{pms:.3f}",
         bound_ms=f"{bound:.4f}", bound_by=by, paths=paths,
         blocks_per_sm=fe.fused_blocks_per_sm(WIDE_D, torch.float32,
                                              CRITEO_K))
    fused["forms"].update(criteo_K39_ms=ms, criteo_K39_plain_ms=pms,
                          criteo_K39_bound_ms=bound)
    del bc, xc, cargs
    # float64: the kernels must not quietly run in float32; the privatised
    # form at D = 10,000 and at the largest D it takes in float64, and the
    # device-memory form (its cache and shared atomics in double) at both
    n64 = FE_N // 10
    for tag, d in (("float64", FE_D),
                   ("float64_largest_privatised",
                    _largest_privatised_d(fe, 8))):
        b = fe_problem("uniform", seed=2, n=n64, dtype=torch.float64, d=d)
        x = torch.linspace(-0.05, 0.05, d + 1, dtype=torch.float64,
                           device=DEV)
        args = (x, b.indices, b.values, b.labels, b.weights, b.offsets, d)
        _check(fe.privatised_form(d, 8), f"{tag}: not the privatised form")
        _fe_fused_row(tag, args, reps=5)
        _fe_fused_row(f"{tag}_device_form", args, reps=5, device=True)
        if d == FE_D:
            # K11, the float64 scatter, at uniform and Zipf(1.2) ids
            for ids in ("uniform", "zipf"):
                bk = b if ids == "uniform" else fe_problem(
                    ids, seed=2, n=n64, dtype=torch.float64, d=d)
                row = _k10_row(f"{ids}_float64", bk.indices.reshape(-1),
                               _entry_contributions(bk, x), d)
                sca = res["fe_scatter_entries"]
                sca["forms"][f"{ids}_float64_ms"] = row["ms"]
                del bk
            lp, gp = fe.fe_loss_grad_plain(*args)
            lv, gv = fe.fe_loss_grad_flat(*args)
            l_rel = abs(float(lv - lp)) / abs(float(lp))
            g_rel = _rel(gv, gp)
            _say("kernels", kernel="fe_flat", dtype="float64", N=n64,
                 loss_rel=f"{l_rel:.2e}", grad_rel=f"{g_rel:.2e}")
            _check(gv.dtype == torch.float64 and l_rel <= FE_F64_RTOL
                   and g_rel <= FE_F64_RTOL,
                   f"FE flat float64: loss rel {l_rel}, grad rel {g_rel}")
    return res


def _converged_share(model):
    conv, total = model.last_fit_converged
    return conv / max(total, 1)


def _f64_check(fg, idx, gm, schema, tmp, tag):
    """max|Δθ| between `gm`'s fit of the entities `idx` of `fg` on the card
    and a float64 fit of them on the CPU (batch-major Cholesky, no kernel),
    over the well-posed ones; fails past F32_TOL."""
    from gdmix_tpu_torch.data.bucketing import select_entities
    small = select_entities(fg, idx)
    cm, _ = stage_model(24, os.path.join(tmp, f"{tag}_cpu"), dtype="float64",
                        device="cpu")
    tg, tc = gm.fit_flat(small, {}, schema), cm.fit_flat(small, {}, schema)
    eids = np.asarray(small.entity_ids)[_well_posed_rows(small)]
    dmax = max(float(np.abs(tg[e].theta - tc[e].theta).max()) for e in eids)
    _say("fit", workload=tag, reference="float64 cpu", entities=len(small),
         compared=len(eids), max_abs_dtheta=f"{dmax:.3e}")
    _check(dmax <= F32_TOL, f"{tag} fit vs float64 reference: {dmax}")


def phase_fit(card):
    """The RE fits at full width: the primary workload, support_120 and the
    bench's heavy tail, each cold; the primary warm, and warm again under
    the profiler for its device-busy share. Each of K1 and K2 launches once
    per lanes tier of its form in the plan (the primary's four tiers all
    take K1; the heavy tail's tiers from n = 256 take K2, streamed at
    n = 2,048), and nothing reads the host inside a Newton solve: PyTorch's
    sync debug mode counts no read inside the lanes solves (_sync_counted,
    itself probed with one read first)."""
    import torch
    from collections import Counter
    from gdmix_tpu_torch.ops import linsolve, newton, newton_lanes as nl
    counters = (nl.newton_full, nl.newton_block, linsolve.spd_solve_batched)
    lanes = nl.newton_lr_batch_lanes
    # the counter itself sees a read: one `.all()` read back
    probe = _sync_counted(lambda t: bool(t.all()))
    probe(torch.ones(4, dtype=torch.bool, device=DEV))
    _check(sum(probe.reads.values()) == 1, f"host-read probe: {probe.reads}")
    newton.newton_lr_batch_lanes = _sync_counted(lanes)
    try:
        return _fits(card, counters, lanes, newton.newton_lr_batch_lanes)
    finally:
        newton.newton_lr_batch_lanes = lanes


def _sync_counted(fn):
    """`fn` run under PyTorch's sync debug mode ("warn"): the wrapper counts
    in `.reads` each device→host synchronisation PyTorch makes inside a
    call (a `.all()` or `.item()` read back, a copy to the host), by the
    Python line that made it (gdmix_tpu_torch/bench.py count_syncs); on a
    CPU-only PyTorch it counts nothing."""
    from collections import Counter
    import torch
    from gdmix_tpu_torch.bench import count_syncs
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")

    def counted(*args, **kwargs):
        out, lines = count_syncs(lambda: fn(*args, **kwargs), dev)
        counted.reads.update(lines)
        return out

    counted.reads = Counter()
    return counted


def _fits(card, counters, lanes, counted):
    """phase_fit's fits, with the lanes solve `counted` (_sync_counted)."""
    import torch
    from collections import Counter
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_fit_") as tmp:
        work = {"primary": (make_workload_flat(100_000, seed=0), 24),
                "support_120": (support_120_workload(), 120),
                "heavy_tail": (heavy_tail_workload(), 24)}
        models = {tag: stage_model(d, os.path.join(tmp, tag))
                  for tag, (_, d) in work.items()}
        tiers = {tag: Counter(form for *_, form in _lanes_tiers(
            _plan_buckets(fg, d))) for tag, (fg, d) in work.items()}
        runs, tables = {}, {}
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path: one cold fit of each workload ----
        for tag, (fg, _) in work.items():
            model, schema = models[tag]
            for c in counters:
                c.launches = 0
            lanes.host_syncs = 0
            counted.reads.clear()
            t0 = time.perf_counter()
            tables[tag] = model.fit_flat(fg, {}, schema)
            torch.cuda.synchronize()
            runs[tag] = dict(cold_s=time.perf_counter() - t0,
                             launches={c.__name__: c.launches
                                       for c in counters},
                             host_syncs=lanes.host_syncs,
                             host_reads=dict(counted.reads))
        # ----
        launches = {c.__name__: sum(r["launches"][c.__name__]
                                    for r in runs.values())
                    for c in counters}
        fg, _ = work["primary"]
        model, schema = models["primary"]
        t0 = time.perf_counter()
        model.fit_flat(fg, {}, schema)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_phases = dict(model.last_fit_phases)
        prof_s, busy_ms = _profiled(lambda: model.fit_flat(fg, {}, schema))
        for tag, r in runs.items():
            m = models[tag][0]
            E = len(work[tag][0])
            share = _converged_share(m)
            extra = {}
            if tag == "primary":
                extra = dict(warm_s=f"{warm_s:.3f}",
                             models_per_s=f"{E / warm_s:.1f}",
                             warm_phases={k: round(v, 3)
                                          for k, v in warm_phases.items()},
                             profiled_s=f"{prof_s:.3f}",
                             device_busy_ms=f"{busy_ms:.1f}",
                             idle_share=f"{1 - busy_ms / 1e3 / prof_s:.4f}",
                             peak_gib="{:.2f}".format(
                                 torch.cuda.max_memory_allocated() / 2**30))
            _say("fit", workload=tag, entities=E, converged=f"{share:.6f}",
                 cold_s=f"{r['cold_s']:.3f}",
                 phases={k: round(v, 3) for k, v in m.last_fit_phases.items()},
                 rungs=m.last_fit_rungs, lanes_tiers=dict(tiers[tag]),
                 launches=r["launches"], host_syncs=r["host_syncs"],
                 host_reads=r["host_reads"], card=repr(card), **extra)
            _check(share >= 0.999, f"{tag} converged share {share}")
            _check(len(tables[tag]) == E, f"{tag}: model count")
            _check(bool(np.isfinite(tables[tag].coef_vals).all()
                        and np.isfinite(tables[tag].icpt).all()),
                   f"{tag}: non-finite model")
            # one launch per lanes tier of each form, and no host read
            # inside a Newton solve: neither the plain loop's (host_syncs;
            # the wrappers raise on a card rather than take it) nor any
            # other that PyTorch makes (host_reads)
            want = {"newton_full": tiers[tag]["warp"],
                    "newton_block": tiers[tag]["block"]
                    + tiers[tag]["stream"]}
            got = {k: r["launches"][k] for k in want}
            _check(got == want, f"{tag}: lanes launches {got}, plan {want}")
            _check(r["host_syncs"] == 0 and not r["host_reads"],
                   f"{tag}: {r['host_syncs']} + {r['host_reads']} host reads "
                   f"in Newton solves")
        _check(sum(runs["primary"]["launches"][k]
                   for k in ("newton_full", "newton_block")) <= 4,
               f"primary fit: {runs['primary']['launches']}")
        _check(runs["support_120"]["launches"]["spd_solve_batched"] > 0,
               f"support_120 never launched K3: {runs['support_120']}")
        _check(all(v > 0 for v in launches.values()),
               f"a kernel of the path never launched: {launches}")

        # the exported model reloads intact
        path = os.path.join(tmp, "part-00000.avro")
        model._save_model(path, tables["primary"])
        back = model._load_weights(path)
        _check(len(back) == len(fg), "avro reload count")

        # small cuts against the float64 CPU solve: the primary's first
        # 4,096 entities (K1) and heavy-tail entities of the K2 tiers
        gm, _ = stage_model(24, os.path.join(tmp, "primary_gpu"))
        _f64_check(fg, np.arange(min(4096, len(fg))), gm, schema, tmp,
                   "primary")
        heavy, _ = work["heavy_tail"]
        counts = np.asarray(heavy.counts)
        idx = np.concatenate([np.flatnonzero(counts > 1024)[:32],
                              np.flatnonzero((counts > 64)
                                             & (counts <= 1024))[:96]])
        hm, _ = stage_model(24, os.path.join(tmp, "heavy_gpu"))
        _f64_check(heavy, np.sort(idx), hm, schema, tmp, "heavy_tail")
    return launches


# ------------------------------------------------------------ two_phase --

TWO_PHASE_ITERS = (1, 2)   # phase-1 iterations of the lane-list rows
TWO_PHASE_WARM_EVERY = 20  # the warm rows start every 20th entity cold
TWO_PHASE_FIT_ITERS = 2    # newton_phase1_iters of the fits and the bench


def _lanes_check(fn, th1, inputs, lanes, n_lanes, tag, solver, **extra):
    """K1 or K2 (`fn`) over the lane list (`lanes`, `n_lanes`) from phase
    1's θ on one tier's (or shard's) inputs (θ0, X, y, w, off, counts),
    against its plain version over the same list; `solver`: the kernels'
    lam, unreg_bias, ftol, pgtol and maxiter. Over the count max|Δθ|
    ≤ F32_TOL where both converge and the flags agree on ≥ 0.999; past it
    the kernel wrote nothing (θ bit-equal to phase 1's, converged, 0
    iterations). Returns max|Δθ|."""
    import torch
    from gdmix_tpu_torch.ops import newton_lanes as nl
    _, X, y, w, off, cnt = inputs
    B, n, d = X.shape
    kw = dict(solver, lanes=lanes, n_lanes=n_lanes)
    k = lambda: fn(th1, X, y, w, off, cnt, **kw)
    thk, ck, ik = k()
    thp, cp, _ = nl.newton_full_plain(th1, X, y, w, off, cnt, **kw)
    torch.cuda.synchronize()
    P = int(n_lanes[0])
    pre, rest = lanes[:P].long(), lanes[P:].long()
    both = (ck & cp)[pre]
    err = (float((thk - thp)[pre][both].abs().max()) if bool(both.any())
           else 0.0)
    agree = (float((ck[pre] == cp[pre]).float().mean()) if P else 1.0)
    kept = bool((thk[rest] == th1[rest]).all() and ck[rest].all()
                and (ik[rest] == 0).all())
    ms = _time_ms(k, 3)
    # the solved lanes' work alone, as _lanes_row counts a whole launch's
    bound, by = _bound(
        4 * (P * n * d + 3 * P * n + P + 2 * P * d) + 5 * P,
        float(ik[pre].sum()) * (n * d * (d + 1) + _spd_solve_flops(d, 1)
                                + 6 * n * d))
    _say("two_phase", kernel=fn.__name__, tier=tag, B=B, n=n, dim=d,
         form=nl.lanes_form(n, d), **extra, lanes=P,
         max_abs_dtheta=f"{err:.3e}", converged_agree=f"{agree:.6f}",
         converged=f"{float(ck.float().mean()):.6f}",
         phase2_ms=f"{ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by)
    _check(err <= F32_TOL, f"two_phase {fn.__name__} {tag}: max|dθ| {err}")
    _check(agree >= 0.999, f"two_phase {fn.__name__} {tag}: flags agree "
                           f"on {agree}")
    _check(kept, f"two_phase {fn.__name__} {tag}: an entity past the "
                 f"{P} lanes of its list was written")
    return err


def _two_phase_row(fn, inputs, phase1, tag):
    """K1 or K2 (`fn`) on one tier's inputs: phase 1 by the kernel for
    `phase1` iterations and the tier's cut on the card (a tier of one
    shard: two_phase_order and prefix_size_on_card), its count held to the
    host's prefix_size; then phase 2 over that list, _lanes_check. Returns
    max|Δθ|."""
    from gdmix_tpu_torch.ops import newton_lanes as nl
    solver = dict(lam=1.0, unreg_bias=True, ftol=1e-12, pgtol=1e-5)
    th0, X, y, w, off, cnt = inputs
    th1, conv1, _ = fn(th0, X, y, w, off, cnt, maxiter=phase1, **solver)
    _, n_un, [(lanes, n_lanes)] = nl.two_phase_shard_lanes([conv1],
                                                           X.shape[0])
    P = nl.prefix_size(int(n_un[0]), X.shape[0])
    _check(int(n_lanes[0]) == P, f"two_phase {tag}: {int(n_lanes[0])} "
                                 f"lanes, the host's prefix {P}")
    return _lanes_check(fn, th1, inputs, lanes, n_lanes, tag,
                        dict(solver, maxiter=100), phase1=phase1,
                        n_unconverged=int(n_un[0]))


def _numpy_cut(flags, b_cap):
    """The JAX solver's cut of a tier's phase-1 flags in numpy (a stable
    argsort, the ladder prefix over all its lanes), split by owning shard
    into local slots."""
    order = np.argsort(flags, kind="stable")
    n_un = int((~flags).sum())
    P = 64
    while P < n_un and P < flags.size:
        P *= 2
    pre = order[:min(P, flags.size)]
    return [pre[pre // b_cap == s] - s * b_cap
            for s in range(flags.size // b_cap)]


def _captured_cuts(record):
    """ops.newton's newton_two_phase_lanes wrapped to append, for
    each tier it solves, its shards' kernel inputs (as the wrapper
    converts them), the phase-1 flags the cut got and the lists it handed
    the shards. Returns a function that restores both."""
    import torch
    from gdmix_tpu_torch.ops import newton, newton_lanes as nl
    orig, orig_cut = newton.newton_two_phase_lanes, \
        nl.two_phase_shard_lanes

    def cut(converged, b_cap):
        out = orig_cut(converged, b_cap)
        record[-1]["flags"] = [c.clone() for c in converged]
        record[-1]["lists"] = [(lanes.clone(), n.clone())
                               for lanes, n in out[2]]
        return out

    def solve(shards, **kw):
        f32 = torch.float32
        record.append(dict(shards=[tuple(
            [t.to(f32).contiguous() for t in sh[:5]]
            + [torch.clamp_min(sh[5].to(f32), 1.0).contiguous()])
            for sh in shards], kw=kw))
        return orig(shards, **kw)
    newton.newton_two_phase_lanes = solve
    nl.two_phase_shard_lanes = cut

    def restore():
        newton.newton_two_phase_lanes = orig
        nl.two_phase_shard_lanes = orig_cut
    return restore


def _shard_rows(record, tag):
    """K1/K2 over the lane lists of the tiers a sharded two-phase fit cut
    (_captured_cuts), each tier twice. Cold: the fit's own lists, held to
    _numpy_cut of the flags the cut got (integers equal), and each shard's
    phase 1 by the kernel again giving those flags. Warm (_warm: a few
    entities to move, so shards hold part of the prefix or none of it):
    phase 1 on each shard, two_phase_shard_lanes, the lists held to the
    numpy cut. Then each shard's phase 2 over its list, _lanes_check.
    Returns ({kernel: max|Δθ|}, tiers checked)."""
    import torch
    from gdmix_tpu_torch.ops import newton_lanes as nl
    errs = {"newton_full": 0.0, "newton_block": 0.0}
    for i, tier in enumerate(record):
        b_cap, n, d = tier["shards"][0][1].shape
        fn = (nl.newton_full if nl.lanes_form(n, d) == "warp"
              else nl.newton_block)
        kw = tier["kw"]
        solver = dict(lam=kw["l2_reg_weight"], unreg_bias=kw["unreg_bias"],
                      ftol=kw["ftol"], pgtol=kw["pgtol"])
        for start in ("cold", "warm"):
            shards = (tier["shards"] if start == "cold"
                      else [_warm(sh) for sh in tier["shards"]])
            first = [fn(*sh, maxiter=kw["phase1_iters"], **solver)
                     for sh in shards]
            flags = [conv for _, conv, _ in first]
            if start == "cold":
                lists = tier["lists"]
                _check(all(torch.equal(a, b)
                           for a, b in zip(flags, tier["flags"])),
                       f"two_phase {tag} tier {i}: phase 1 again gave "
                       f"other flags")
            else:
                lists = nl.two_phase_shard_lanes(flags, b_cap)[2]
            want = _numpy_cut(torch.cat(flags).cpu().numpy(), b_cap)
            got = [lanes[:int(c[0])].cpu().numpy() for lanes, c in lists]
            _check(len(got) == len(want) and all(
                np.array_equal(g, w) for g, w in zip(got, want)),
                f"two_phase {tag} tier {i} {start}: the shards' lists are "
                f"not the numpy cut ({[g.size for g in got]} against "
                f"{[w.size for w in want]})")
            for s, (sh, (th1, conv, _), (lanes, c)) in enumerate(zip(
                    shards, first, lists)):
                err = _lanes_check(fn, th1, sh, lanes, c,
                                   f"{tag}{i}_{start}_s{s}",
                                   dict(solver, maxiter=kw["maxiter"]),
                                   shard=s, shards=len(shards),
                                   shard_stragglers=int((~conv).sum()))
                errs[fn.__name__] = max(errs[fn.__name__], err)
    return errs, len(record)


def _warm(inputs):
    """`inputs` with θ0 the lanes kernel's solution, every
    TWO_PHASE_WARM_EVERY-th entity back at 0: a warm sweep with a few
    entities to move."""
    from gdmix_tpu_torch.ops import newton_lanes as nl
    th0, X, y, w, off, cnt = inputs
    fn = (nl.newton_full if nl.lanes_form(*X.shape[1:]) == "warp"
          else nl.newton_block)
    th, _, _ = fn(th0, X, y, w, off, cnt, lam=1.0, unreg_bias=True,
                  maxiter=100, ftol=1e-12, pgtol=1e-5)
    th[::TWO_PHASE_WARM_EVERY] = 0.0
    return (th, X, y, w, off, cnt)


def _two_phase_times(tiers):
    """Device ms of the primary's tier solves, summed over its tiers, one
    phase (newton_lr_batch_lanes) against two (newton_two_phase_lanes), in
    turns A B B A (means of 3 each), with each run's converged share."""
    import torch
    from gdmix_tpu_torch.ops import newton_lanes as nl
    kw = dict(l2_reg_weight=1.0, unreg_bias=True, maxiter=100, ftol=1e-12,
              pgtol=1e-5)
    one = [lambda t=t: nl.newton_lr_batch_lanes(*t, **kw) for t in tiers]
    two = [lambda t=t: nl.newton_two_phase_lanes(
        [t], phase1_iters=TWO_PHASE_FIT_ITERS, **kw)[0] for t in tiers]
    run = lambda fns: [f() for f in fns]
    ms = {"single": 0.0, "two_phase": 0.0}
    for tag in ("single", "two_phase", "two_phase", "single"):
        ms[tag] += _time_ms(lambda: run(one if tag == "single" else two),
                            3) / 2
    share = {}
    for tag, fns in (("single", one), ("two_phase", two)):
        res = run(fns)
        share[tag] = float(sum(int(r.converged.sum()) for r in res)
                           / sum(r.converged.numel() for r in res))
    torch.cuda.synchronize()
    return ms, share


def _two_phase_syncs(fg, tmp):
    """Host reads (sync debug mode, by Python line) of each of the primary
    plan's bucket dispatches, single-phase and two-phase, each after one
    warm run; the two must be the same on every bucket. Each bucket past
    64 entities is also cut into SHARDED_MESHES shards, as a tier of the
    sharded plane: the two-phase rung's solve.tier over them may read no
    more than single-phase's solve of each shard. Returns the single-phase
    reads of one bucket."""
    import torch
    from gdmix_tpu_torch.bench import BUCKET_COLS, count_syncs
    from gdmix_tpu_torch.data.bucketing import iter_bucketize_flat
    from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy
    one, schema = stage_model(24, os.path.join(tmp, "sync_one"))
    two, _ = stage_model(24, os.path.join(tmp, "sync_two"),
                         newton_phase1_iters=TWO_PHASE_FIT_ITERS)
    dev = torch.device(DEV)
    per_bucket = None

    def reads(fn):
        fn()
        torch.cuda.synchronize()
        _, lines = count_syncs(fn, dev)
        torch.cuda.synchronize()
        return lines

    for b in iter_bucketize_flat(fg, schema,
                                 one.model_params.offset_column_name,
                                 has_intercept=one.has_intercept):
        a = newton_inputs_from_numpy({k: getattr(b, k) for k in BUCKET_COLS},
                                     one.device, one.dtype)
        shape = (b.u_cap, b.indices.shape[0], b.n_cap)
        got, solvers = {}, {}
        for tag, m in (("single", one), ("two_phase", two)):
            rung, solve = m._select_solver(*shape)
            solvers[tag] = solve
            got[tag] = (rung, reads(lambda: solve(a)))
        _say("two_phase", bucket=f"B{shape[1]}_n{shape[2]}",
             rungs=[got[t][0] for t in got],
             host_reads={t: got[t][1] for t in got})
        _check(got["two_phase"][0] == "newton_two_phase",
               f"two_phase: bucket {shape} took {got['two_phase'][0]}")
        _check(got["two_phase"][1] == got["single"][1],
               f"two_phase: bucket {shape} host reads {got}")
        per_bucket = got["single"][1]
        for p in SHARDED_MESHES:
            if shape[1] % p:
                continue
            shards = [{k: v.view(p, -1, *v.shape[1:])[s]
                       for k, v in a.items()} for s in range(p)]
            single = reads(lambda: [solvers["single"](sh) for sh in shards])
            tier = reads(lambda: solvers["two_phase"].tier(shards))
            _say("two_phase", tier=f"B{shape[1]}_n{shape[2]}", shards=p,
                 host_reads={"single": single, "two_phase": tier})
            _check(all(single.get(k, 0) >= v for k, v in tier.items()),
                   f"two_phase: tier {shape} over {p} shards host reads "
                   f"{tier}, single-phase {single}")
    return per_bucket


def _re_pack_bytes(pack) -> tuple:
    """Bytes each pass of ops/re_pack.py must move over a FlatPack after
    its upload, each once: pass 1 reads the ids, the nnz and three
    [E] maps and writes the distinct ids and two [E] counts; pass 2 reads
    the records' ids, values, nnz, labels and offsets (weights where
    given), the members' maps and distinct ids, and writes every tier's
    padded tensors and the compact ids."""
    c, sup = pack.cols, pack.sup
    N, K = c.indices.shape
    E = pack.E
    item = c.values.element_size()
    n_ids = int(sup.u_count.long().sum())
    n_sup = pack.support_ids.shape[0] - E
    cols = sum(t.numel() * t.element_size()
               for t in (c.labels, c.offsets, c.weights, c.nnz)
               if t is not None)
    pass1 = N * K * 4 + N * 4 + E * 16 + n_ids * 4 + E * 8
    pass2 = N * K * (4 + item) + cols + n_ids * 4 + E * 24 + n_sup * 4
    for t, k in zip(pack.tiers, pack.k):
        rows = t.b * t.n_cap
        pass2 += rows * k * (8 + item) + rows * 3 * item + t.b * item
    return float(pass1), float(pass2)


def _entity_groups(fg):
    """fg's entities as a List[EntityGroup], the object path's input: in
    turn the padded [n, K] block with its nnz, and per-record arrays of
    the live entries (ragged)."""
    from gdmix_tpu_torch.io.input_pipeline import EntityGroup
    counts = np.asarray(fg.counts, np.int64)
    starts = np.cumsum(counts) - counts
    groups = []
    for e, (s, n) in enumerate(zip(starts, counts)):
        rows = slice(s, s + n)
        g = EntityGroup(entity_id=fg.entity_ids[e],
                        columns={k: v[rows] for k, v in fg.columns.items()})
        if e % 2:
            g.padded_indices, g.padded_values = fg.indices[rows], \
                fg.values[rows]
            g.rec_nnz = fg.rec_nnz[rows]
        else:
            nz = fg.rec_nnz
            g.ragged_indices = [fg.indices[r, :nz[r]].astype(np.int64)
                                for r in range(s, s + n)]
            g.ragged_values = [fg.values[r, :nz[r]] for r in range(s, s + n)]
        groups.append(g)
    return groups


def _re_pack_equal(data, schema, dev, what):
    """Pack `data` (a FlatGroups, or a List[EntityGroup]) through
    ops/re_pack.py's FlatPack on `dev` and check every
    tier's tensors equal the host bucketizer's (iter_bucketize_flat, or
    bucketize) through newton_inputs_from_numpy bit for bit (indices,
    values, labels, weights, offsets, sample counts) and the supports the
    host reads back equal the bucketizer's padded ones. Returns the
    FlatPack, packed, and its number of tiers."""
    import torch
    from gdmix_tpu_torch.data.bucketing import (FlatGroups, bucketize,
                                                iter_bucketize_flat)
    from gdmix_tpu_torch.models import random_effect_lr as re_model
    from gdmix_tpu_torch.ops import re_pack
    from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy
    pack = re_pack.FlatPack(data, label_column="response",
                            weight_column=None, offset_column="offset",
                            device=dev, dtype=torch.float32)
    pack.upload()
    pack.supports()
    tiers = [pack.tier(i) for i in range(len(pack.tiers))]
    ids = pack.support_ids.cpu().numpy()
    cols = re_model._STATIC_COLS + ("offsets",)
    n = 0
    bucketizer = (iter_bucketize_flat if isinstance(data, FlatGroups)
                  else bucketize)
    for i, b in enumerate(bucketizer(data, schema, "offset")):
        want = newton_inputs_from_numpy({k: getattr(b, k) for k in cols},
                                        dev, torch.float32)
        for k in cols:
            _check(tiers[i][k].dtype == want[k].dtype
                   and torch.equal(tiers[i][k], want[k]),
                   f"re_pack: {what} tier {i} {k} differs from the "
                   "bucketizer's")
        br = len(b.entity_ids)
        u, sup = pack.host_supports(ids, i)
        mask = np.arange(b.u_cap)[None, :] < b.u_count[:br, None]
        _check(pack.u[i] == b.u_cap
               and np.array_equal(np.maximum(u, 1), b.u_count[:br])
               and np.array_equal(sup, b.unique_global_indices[:br][mask]),
               f"re_pack: {what} tier {i} supports differ")
        n += 1
    _check(n == len(pack.tiers), f"re_pack: {what} {len(pack.tiers)} "
           f"tiers, the bucketizer {n}")
    return pack, n


def phase_re_pack(card):
    """The random-effect marshal's kernels (csrc/re_pack.cu through
    ops/re_pack.py). Checks, by _re_pack_equal against the host bucketizer
    bit for bit: the lr-movielens.re-fleet cell's size (1,000,000
    entities, pareto 1.5 counts 2–64, K 4, a 20-wide bag: pass 1 a warp an
    entity throughout) and the heavy-tail workload (20,000 entities,
    counts to 2,048 at K 4: pass 1's block path with its keys in shared
    memory past 64 records and in the device workspace past 1,024, both
    checked to be taken), 2,000 of the heavy tail's entities as a
    List[EntityGroup] (padded and ragged in turn, against bucketize) and
    the whole heavy tail without its feature block (the inert [N, 1] block
    of flat_groups: every entity the dummy support, K 1 on pass 1's warp
    path and its shared-memory block path); a fleet fit through fit_flat
    launches both passes, and so does a fit_groups on the entity groups.
    Records both passes' device time at the fleet's size (CUDA events,
    medians of 5 rounds), their byte bound and the plain versions'
    time on the card, the fit's phases and its host syncs (PyTorch's sync
    debug mode)."""
    import dataclasses

    import torch
    from gdmix_tpu_torch.data.bucketing import select_entities
    from gdmix_tpu_torch.ops import re_pack
    fg = make_workload_flat(1_000_000, seed=5, d=20)
    dev = torch.device(DEV)
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_pack_") as tmp:
        model, schema = stage_model(20, tmp)
        heavy_fg = heavy_tail_workload()
        groups = _entity_groups(select_entities(heavy_fg, np.arange(2000)))
        _, n_groups = _re_pack_equal(groups, schema, dev, "entity_groups")
        bare = dataclasses.replace(heavy_fg, indices=None, values=None,
                                   rec_nnz=None)
        _, n_bare = _re_pack_equal(bare, schema, dev, "featureless")
        del bare
        before = (re_pack.re_supports.launches,
                  re_pack.re_pack_tier.launches)
        n_models = len(model.fit_groups(groups, {}, schema))
        _check(n_models == len(groups)
               and re_pack.re_supports.launches - before[0] == 1
               and re_pack.re_pack_tier.launches - before[1]
               == n_groups, f"re_pack: fit_groups on {len(groups)} entity "
               f"groups gave {n_models} models in {n_groups} tiers")
        del groups
        heavy, n_heavy = _re_pack_equal(heavy_fg, schema, dev, "heavy_tail")
        ws_off = heavy._dev["ws_off"].cpu().numpy()
        n_block, n_ws = len(ws_off), int((ws_off >= 0).sum())
        _check(n_block > n_ws > 0, f"re_pack: heavy_tail {n_block} block "
               f"entities, {n_ws} of them in the workspace")
        del heavy
        t0 = time.perf_counter()
        pack, n = _re_pack_equal(fg, schema, dev, "fleet")
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        _check(len(pack._dev["block_ents"]) == 0,
               "re_pack: the fleet takes pass 1's block path")

        d, c = pack._dev, pack.cols
        block = re_pack.BlockPath(d["block_ents"], d["ws_off"],
                                  pack._ws_size)

        def pass1():
            re_pack.re_supports(c.indices, c.nnz, c.counts, c.starts,
                                d["tier_of"], len(pack.tiers), block)

        def pass2():
            for i in range(len(pack.tiers)):
                pack.tier(i)

        def plain1():
            return re_pack.re_supports_plain(c.indices, c.nnz, c.counts,
                                             c.starts, d["tier_of"],
                                             len(pack.tiers))

        def plain2():
            for i, t in enumerate(pack.tiers):
                sl = slice(t.base, t.base + len(t.members))
                re_pack.re_pack_tier_plain(
                    c, pack.sup, d["order"][sl], pack._coff[sl], t.b,
                    t.n_cap, pack.k[i], torch.float32,
                    sup_out=pack.support_ids)

        ms1, ms2 = (float(np.median([_time_ms(f, 3) for _ in range(5)]))
                    for f in (pass1, pass2))
        plain1_ms, plain2_ms = _time_ms(plain1, 1), _time_ms(plain2, 1)
        (b1, by1), (b2, by2) = (_bound(b, 0.0)
                                for b in _re_pack_bytes(pack))
        del pack, c, d
        # ---- the main path: a fleet fit ----
        before = (re_pack.re_supports.launches,
                  re_pack.re_pack_tier.launches)
        model.fit_flat(fg, {}, schema)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit_flat(fg, {}, schema)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        phases = dict(model.last_fit_phases)
        counted = _sync_counted(lambda: model.fit_flat(fg, {}, schema))
        counted()
        launches = {"re_supports": re_pack.re_supports.launches - before[0],
                    "re_pack_tier": re_pack.re_pack_tier.launches
                    - before[1]}
        _check(launches["re_supports"] >= 3 and launches["re_pack_tier"]
               >= 3 * n, f"re_pack: a fleet fit launched {launches}")
        peak = torch.cuda.max_memory_allocated(dev)
    _say("re_pack", tiers=n, supports_ms=f"{ms1:.3f}",
         supports_bound_ms=f"{b1:.3f}", supports_plain_ms=f"{plain1_ms:.3f}",
         pack_ms=f"{ms2:.3f}", pack_bound_ms=f"{b2:.3f}",
         pack_plain_ms=f"{plain2_ms:.3f}",
         heavy_tail=dict(tiers=n_heavy, block=n_block, workspace=n_ws),
         entity_groups_tiers=n_groups, featureless_tiers=n_bare,
         check_s=f"{check_s:.3f}", fit_s=f"{fit_s:.3f}",
         models_per_s=f"{len(fg) / fit_s:.1f}",
         phases={k: round(v, 3) for k, v in phases.items()},
         host_syncs=sum(counted.reads.values()),
         sync_lines=dict(counted.reads), peak_gb=f"{peak / 1e9:.2f}",
         launches=launches, card=repr(card))
    rows = {"re_supports": dict(max_abs_err=0.0, ms=ms1, plain_ms=plain1_ms,
                                bound_ms=b1, bound_by=by1, library_ms=None),
            "re_pack_tier": dict(max_abs_err=0.0, ms=ms2, plain_ms=plain2_ms,
                                 bound_ms=b2, bound_by=by2, library_ms=None)}
    return rows, launches


def phase_two_phase(card):
    """Two-phase Newton on the card (newton_phase1_iters > 0; the JAX
    package's _newton_two_phase_solver): K1 and K2 over lane lists against
    their plain versions at each tier of the primary and the heavy tail,
    the host reads of a bucket's and a sharded tier's dispatch against
    single-phase, fit_flat of both on the host plane and on the sharded
    plane at P = 1, 2 and 4 against their single-phase fits, K1/K2 over
    the lists the mesh of 4 handed its shards, the primary's tiers timed
    both ways, K1 without a lane list, and the bench with BENCH_PHASE1.
    Returns ({kernel: max|Δθ|}, {kernel: launches})."""
    import re
    import torch
    from gdmix_tpu_torch.ops import newton, newton_lanes as nl
    phase_t0 = time.perf_counter()
    errs = {"newton_full": 0.0, "newton_block": 0.0}
    launches = {"newton_full": 0, "newton_block": 0}
    counters = (nl.newton_full, nl.newton_block)
    captured_cuts = {}
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_2p_") as tmp:
        work = {"primary": make_workload_flat(100_000, seed=0),
                "heavy_tail": heavy_tail_workload()}
        # single-phase reference fits, their lanes inputs captured
        ref, captured = {}, {}
        for tag, fg in work.items():
            model, schema = stage_model(24, os.path.join(tmp, tag))
            captured[tag] = []
            orig = _captured_lanes(captured[tag])
            try:
                ref[tag] = model.fit_flat(fg, {}, schema)
            finally:
                newton.newton_lr_batch_lanes = orig
        # ---- the main path: fit_flat with two-phase, host plane and
        # sharded plane at P = 1, 2, 4; single-phase beside each mesh ----
        for tag, fg in work.items():
            ids = np.asarray(fg.entity_ids)[_well_posed_rows(fg)]
            for plane, p in (("host", 1), ("sharded", 1)) + tuple(
                    ("sharded", p) for p in SHARDED_MESHES):
                mesh = (_mesh_of(_repeated_mesh(p)) if p > 1
                        else contextlib.nullcontext())
                single_s = None
                with mesh:
                    if p > 1:
                        one, schema = stage_model(
                            24, os.path.join(tmp, f"{tag}_{plane}{p}_one"),
                            re_mode=plane)
                        t0 = time.perf_counter()
                        one.fit_flat(fg, {}, schema)
                        torch.cuda.synchronize()
                        single_s = time.perf_counter() - t0
                    model, schema = stage_model(
                        24, os.path.join(tmp, f"{tag}_{plane}{p}"),
                        re_mode=plane,
                        newton_phase1_iters=TWO_PHASE_FIT_ITERS)
                    record = []
                    restore = (_captured_cuts(record)
                               if p == max(SHARDED_MESHES) else None)
                    try:
                        for c in counters:
                            c.launches = 0
                        t0 = time.perf_counter()
                        table = model.fit_flat(fg, {}, schema)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                        got = {c.__name__: c.launches for c in counters}
                    finally:
                        if restore is not None:
                            restore()
                if restore is not None:
                    captured_cuts[tag] = record
                for k, v in got.items():
                    launches[k] += v
                share = _converged_share(model)
                gap = _table_gap(table, ref[tag], ids)
                # a launch a tier and shard, two where the tier passes 64
                if plane == "host":
                    tiers, shards = [t[1].shape for t in captured[tag]], 1
                else:
                    lay = model.last_fit_sharding
                    tiers, shards = lay["tiers"], lay["shards"]
                _check(shards == p, f"two_phase {tag}: {shards} shards, "
                                    f"not {p}")
                want = {"newton_full": 0, "newton_block": 0}
                for B, n, d in tiers:
                    k = ("newton_full" if nl.lanes_form(n, d) == "warp"
                         else "newton_block")
                    want[k] += (2 if B > 64 else 1) * shards
                _say("two_phase", fit=tag, plane=plane, shards=p,
                     entities=len(fg), converged=f"{share:.6f}",
                     fit_s=f"{wall:.3f}",
                     single_phase_fit_s=(None if single_s is None
                                         else f"{single_s:.3f}"),
                     rungs=model.last_fit_rungs, launches=got, want=want,
                     max_abs_dtheta_vs_single=f"{gap:.3e}",
                     compared=len(ids), card=repr(card))
                what = f"two_phase {tag} {plane} P={p}"
                _check(share >= 0.999, f"{what}: converged {share}")
                _check("newton_two_phase" in model.last_fit_rungs,
                       f"{what}: {model.last_fit_rungs}")
                _check(gap <= F32_TOL, f"{what}: max|dθ| vs single-phase "
                                       f"{gap}")
                _check(got == want, f"{what}: launches {got}, want {want}")
        # ----
        _check(all(v > 0 for v in launches.values()),
               f"two_phase: a kernel of the path never launched {launches}")
        per_bucket = _two_phase_syncs(work["primary"], tmp)
    # K1/K2 over the lists the mesh of 4 handed its shards
    for tag, record in captured_cuts.items():
        got, n_tiers = _shard_rows(record, f"{tag}_P{max(SHARDED_MESHES)}")
        _check(n_tiers > 0, f"two_phase {tag}: no sharded tier captured")
        for k, v in got.items():
            errs[k] = max(errs[k], v)
    # K1/K2 over lane lists on the fits' own tier inputs
    for tag, tiers in captured.items():
        for i, inputs in enumerate(tiers):
            _, n, d = inputs[1].shape
            fn = (nl.newton_full if nl.lanes_form(n, d) == "warp"
                  else nl.newton_block)
            for start, ins in (("cold", inputs), ("warm", _warm(inputs))):
                for phase1 in TWO_PHASE_ITERS:
                    err = _two_phase_row(fn, ins, phase1,
                                         f"{tag}{i}_{start}")
                    errs[fn.__name__] = max(errs[fn.__name__], err)
    for start in ("cold", "warm"):
        tiers = captured["primary"]
        if start == "warm":
            tiers = [_warm(t) for t in tiers]
        ms, share = _two_phase_times(tiers)
        _say("two_phase", primary_tiers=start,
             single_ms=f"{ms['single']:.4f}",
             two_phase_ms=f"{ms['two_phase']:.4f}",
             converged={k: f"{v:.6f}" for k, v in share.items()},
             card=repr(card))
        _check(min(share.values()) >= 0.999,
               f"two_phase: primary tiers {start} converged {share}")
    null = _lanes_row(nl.newton_full, 65536, 8, 25, "B65536_null_list")
    _say("two_phase", k1_null_list_ms=f"{null['ms']:.4f}", card=repr(card))
    # the bench's RE cells with two-phase, in a fresh process
    out, err, wall = _run([sys.executable, "-m", "gdmix_tpu_torch.bench"],
                          "bench (BENCH_PHASE1)", BENCH_TIMEOUT_S,
                          BENCH_PHASE1=str(TWO_PHASE_FIT_ITERS), BENCH_FE="0",
                          BENCH_DETEXT="0", BENCH_STAGE_ENTITIES="0")
    for ln in err.splitlines():
        if ln.startswith("bench"):
            print(f"  {ln}")
    line = json.loads(out.strip().splitlines()[-1])
    conv = [float(c) for c in re.findall(r"converged ([0-9.]+)", err)]
    primary = re.search(r"bench\[movielens\]: .*?\((\d+) buckets.*?host "
                        r"syncs a rep (\d+)", err)
    _check(primary is not None, "bench (BENCH_PHASE1): no primary line")
    buckets, syncs = int(primary.group(1)), int(primary.group(2))
    child = _log_json(err, "bench[kernels]: ")
    for k in launches:
        launches[k] += child[k]
    _say("two_phase", bench_models_per_s=line["value"],
         bench_heavy_tail=line["submetrics"].get(
             "re_heavy_tail_models_per_sec"), converged=conv,
         host_syncs_a_rep=syncs, buckets=buckets, launches=child,
         wall_s=f"{wall:.1f}", card=repr(card))
    _check(line["value"] > 0, f"bench (BENCH_PHASE1): {line['value']}")
    _check(len(conv) >= 4 and min(conv) >= 0.999,
           f"bench (BENCH_PHASE1): converged {conv}")
    _check(syncs == buckets * sum(per_bucket.values()),
           f"bench (BENCH_PHASE1): {syncs} host syncs a rep over {buckets} "
           f"buckets; single-phase {per_bucket} a bucket")
    _check(child["newton_full"] > 0, f"bench (BENCH_PHASE1): {child}")
    _say("two_phase", phase_s=f"{time.perf_counter() - phase_t0:.3f}")
    return errs, launches


def _re_counters():
    from gdmix_tpu_torch.ops import linsolve, newton_lanes as nl
    return (nl.newton_full, nl.newton_block, linsolve.spd_solve_batched,
            linsolve.spd_solve_batched_mrhs)


def _well_posed_rows(fg):
    """Entities with 16+ records of both classes: one class sends the
    unregularized intercept off to infinity, where float32 and float64
    stop at different points of a flat objective."""
    counts = np.asarray(fg.counts)
    pos = np.add.reduceat(fg.columns["response"], np.cumsum(counts) - counts)
    return np.flatnonzero((counts >= 16) & (pos > 0) & (pos < counts))


def _against_f64_cpu(fg, d, tmp, tag, **over):
    """Fit the first 256 entities of `fg` on the card (float32) and on the
    CPU in float64 through the same rung; max |Δθ| over well-posed
    entities and, where `over` asks for a variance mode, the largest
    relative gap of their variances."""
    from gdmix_tpu_torch.data.bucketing import select_entities
    small = select_entities(fg, np.arange(256))
    gm, schema = stage_model(d, os.path.join(tmp, f"{tag}_gpu"), **over)
    cm, _ = stage_model(d, os.path.join(tmp, f"{tag}_cpu"), dtype="float64",
                        device="cpu", **over)
    tg, tc = gm.fit_flat(small, {}, schema), cm.fit_flat(small, {}, schema)
    eids = np.asarray(small.entity_ids)[_well_posed_rows(small)]
    dmax = max(float(np.abs(tg[e].theta - tc[e].theta).max()) for e in eids)
    var = {}
    if over.get("random_effect_variance_mode") is not None:
        _check(tg.with_variance and tc.with_variance,
               f"{tag}: a fit dropped its variances")
        var["max_rel_dvar"] = "{:.3e}".format(max(float(
            (np.abs(tg[e].variance - tc[e].variance) / tc[e].variance).max())
            for e in eids))
    _say("wide", cut=tag, reference="float64 cpu", entities=len(small),
         compared=len(eids), rungs=gm.last_fit_rungs,
         cpu_rungs=cm.last_fit_rungs, max_abs_dtheta=f"{dmax:.3e}", **var)
    _check(gm.last_fit_rungs == cm.last_fit_rungs,
           f"{tag}: card and CPU took other rungs")
    _check(dmax <= F32_TOL, f"{tag} vs float64 reference: {dmax}")
    if var:
        _check(float(var["max_rel_dvar"]) <= VAR_RTOL,
               f"{tag} variance vs float64 reference: {var}")


def _cut(tag, fg, d, tmp, want_rung, **over):
    """One fit of a ladder cut; returns (model, table, launches)."""
    import torch
    model, schema = stage_model(d, os.path.join(tmp, tag), **over)
    for c in _re_counters():
        c.launches = 0
    t0 = time.perf_counter()
    table = model.fit_flat(fg, {}, schema)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in _re_counters()}
    share = _converged_share(model)
    _say("wide", cut=tag, entities=len(fg), rungs=model.last_fit_rungs,
         converged=f"{share:.6f}", fit_s=f"{wall:.3f}",
         models_per_s=f"{len(fg) / wall:.1f}", launches=launches)
    _check(set(model.last_fit_rungs) == {want_rung},
           f"{tag}: rungs {model.last_fit_rungs}, want {want_rung}")
    _check(bool(np.isfinite(table.coef_vals).all()
                and np.isfinite(table.icpt).all()), f"{tag}: non-finite")
    return model, table, launches


def _profiled(fn):
    """(wall seconds, device-busy ms) of fn() under torch.profiler: the sum
    of the device's own event times (kernels and copies; one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy_us / 1e3


def phase_wide(card):
    """The JAX bench's wide-support RE workload (bench.py:697-701: 4,096
    entities, d = 512, ≤ 16 nnz, 32–64 samples) at full size through
    fit_flat, cold then warm: its buckets take the dual Newton and K4.
    Then cuts that reach every other rung: SIMPLE and FULL variance on the
    same workload, densified L-BFGS (d = 160, 192–384 samples), sparse
    L-BFGS, the primal Newton past dim 128 (K3 at d > 128); and slices of
    the dual (θ, and the SIMPLE and FULL variances), dense and sparse cuts
    against a float64 CPU fit."""
    import torch
    from gdmix_tpu_torch import constants
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_wide_") as tmp:
        fg = make_workload_flat(4096, seed=2, d=512, max_nnz=16,
                                count_lo=32, count_hi=64)
        model, schema = stage_model(512, os.path.join(tmp, "wide"))
        for c in _re_counters():
            c.launches = 0
        # ---- the main path: one cold fit ----
        t0 = time.perf_counter()
        table = model.fit_flat(fg, {}, schema)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in _re_counters()}
        # ----
        share, rungs = _converged_share(model), dict(model.last_fit_rungs)
        t0 = time.perf_counter()
        model.fit_flat(fg, {}, schema)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        E = len(fg)
        prof_s, busy_ms = _profiled(lambda: model.fit_flat(fg, {}, schema))
        idle = (f"{1 - busy_ms / (1e3 * prof_s):.3f}" if busy_ms > 0
                else "not measured")
        _say("wide", workload="re_wide_support", entities=E,
             converged=f"{share:.6f}", cold_s=f"{cold_s:.3f}",
             warm_s=f"{warm_s:.3f}", models_per_s=f"{E / warm_s:.1f}",
             phases={k: round(v, 3) for k, v in model.last_fit_phases.items()},
             rungs=rungs, launches=launches,
             profiled_fit_s=f"{prof_s:.3f}", device_busy_ms=f"{busy_ms:.1f}",
             idle_share=idle, card=repr(card))
        _check(share >= 0.999, f"wide converged share {share}")
        _check(launches["spd_solve_batched_mrhs"] >= 1,
               f"the wide fit never launched K4: {launches}")
        _check(len(table) == E and bool(np.isfinite(table.coef_vals).all()
                                        and np.isfinite(table.icpt).all()),
               "wide: model count or non-finite model")

        for mode in (constants.SIMPLE, constants.FULL):
            vm, vt, _ = _cut(f"variance_{mode}", fg, 512, tmp, "newton_dual",
                             random_effect_variance_mode=mode)
            ok = (vt.with_variance and np.isfinite(vt.coef_vars).all()
                  and (vt.coef_vars > 0).all()
                  and np.isfinite(vt.icpt_vars).all()
                  and (vt.icpt_vars > 0).all())
            _say("wide", cut=f"variance_{mode}",
                 coef_var_range=f"{vt.coef_vars.min():.3e}.."
                                f"{vt.coef_vars.max():.3e}")
            _check(bool(ok), f"{mode} variance: not all finite and > 0")

        dense_fg = make_workload_flat(2048, seed=5, d=160, max_nnz=16,
                                      count_lo=192, count_hi=384)
        _cut("lbfgs_dense", dense_fg, 160, tmp, "lbfgs_dense")
        sparse_fg = make_workload_flat(512, seed=6, d=512, max_nnz=16,
                                       count_lo=32, count_hi=64)
        sparse_over = dict(batch_solver="lbfgs", dense_lbfgs_max_elems=0)
        _cut("lbfgs_sparse", sparse_fg, 512, tmp, "lbfgs", **sparse_over)
        primal_fg = make_workload_flat(2048, seed=7, d=200, max_nnz=8,
                                       count_lo=16, count_hi=64)
        _, _, pl = _cut("newton_dim200", primal_fg, 200, tmp, "newton",
                        newton_max_dim=256)
        _check(pl["spd_solve_batched"] > 0,
               f"the primal cut past dim 128 never launched K3: {pl}")

        _against_f64_cpu(fg, 512, tmp, "newton_dual")
        for mode in (constants.SIMPLE, constants.FULL):
            _against_f64_cpu(fg, 512, tmp, f"newton_dual_{mode}",
                             random_effect_variance_mode=mode)
        _against_f64_cpu(dense_fg, 160, tmp, "lbfgs_dense")
        _against_f64_cpu(sparse_fg, 512, tmp, "lbfgs", **sparse_over)
    return launches


def _write_cli_dataset(tmp, num_users=2000, d=24, seed=11):
    """A per-user grouped TFRecord dataset in RandomEffectDriver's layout:
    <tmp>/trainingData/active/partitionId=0/data.tfrecord."""
    from gdmix_tpu_torch.io.feature_list import write_feature_list
    from gdmix_tpu_torch.io.input_pipeline import (EntityGroup,
                                                   write_per_entity_grouped)
    rng = np.random.RandomState(seed)
    groups, uid = [], 0
    for e in range(num_users):
        n = int(rng.randint(4, 64))
        idx = [np.sort(rng.choice(d, rng.randint(1, 5), replace=False))
               for _ in range(n)]
        val = [rng.randn(len(i)) for i in idx]
        logit = rng.randn() + np.array([v.sum() * 0.5 for v in val])
        y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
        groups.append(EntityGroup(
            entity_id=str(e + 1000),
            columns={"uid": np.arange(uid, uid + n, dtype=np.int64),
                     "response": y,
                     "offset": (0.1 * rng.randn(n)).astype(np.float32),
                     "weight": np.ones(n, np.float32)},
            ragged_indices=[i.astype(np.int64) for i in idx],
            ragged_values=val))
        uid += n
    md_file = os.path.join(tmp, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "per_entity", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "user_id", "dtype": "long", "shape": [],
             "isSparse": False},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "weight", "dtype": "float", "shape": [],
             "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "float", "shape": [],
                        "isSparse": False}]}, f)
    part = os.path.join(tmp, "trainingData", "active", "partitionId=0")
    os.makedirs(part)
    write_per_entity_grouped(os.path.join(part, "data.tfrecord"), groups,
                             "user_id", "long", "per_entity")
    feature_file = os.path.join(tmp, "features.csv")
    write_feature_list([(f"f{i}", "") for i in range(d)], feature_file)
    plist = os.path.join(tmp, "partitionList.txt")
    with open(plist, "w") as f:
        f.write("0")
    return md_file, feature_file, plist, uid


def _cli_re_stage(tmp, phase, extra=()):
    """`python -m gdmix_tpu_torch.gdmix --action=train
    --stage=random_effect` in a fresh process on _write_cli_dataset's
    2,000 users, with `extra` flags: its models and scores must be there
    (a model a user, a finite score a record). Returns its stderr."""
    from gdmix_tpu_torch.io.model_avro import load_sparse_models_from_avro
    from gdmix_tpu_torch.io.scores import read_scores
    from gdmix_tpu_torch.params import SchemaParams
    md_file, feature_file, plist, n_rec = _write_cli_dataset(tmp)
    model_dir = os.path.join(tmp, "models")
    score_dir = os.path.join(tmp, "scores")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gdmix_tpu_torch.gdmix",
         "--action=train", "--stage=random_effect",
         "--model_type=logistic_regression",
         "--label_column_name=response", "--uid_column_name=uid",
         "--weight_column_name=weight",
         "--prediction_score_column_name=predictionScore",
         f"--partition_list_file={plist}",
         f"--training_score_dir={score_dir}",
         f"--metadata_file={md_file}",
         f"--training_data_dir={os.path.join(tmp, 'trainingData')}",
         "--feature_bag=per_entity", f"--feature_file={feature_file}",
         "--partition_entity=user_id",
         f"--output_model_dir={model_dir}", "--l2_reg_weight=1.0",
         "--regularize_bias=false", "--dtype=float32", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    _check(proc.returncode == 0, f"CLI exit code {proc.returncode}")
    models = load_sparse_models_from_avro(
        os.path.join(model_dir, "part-00000.avro"), feature_file)
    schema = SchemaParams(uid_column_name="uid",
                          label_column_name="response",
                          prediction_score_column_name="predictionScore")
    scores = read_scores(os.path.join(score_dir, "partitionId=0"), schema)
    ok = (len(models) == 2000 and len(scores["uid"]) == n_rec
          and bool(np.isfinite(scores["predictionScore"]).all()))
    _say(phase, stage="random_effect", flags=list(extra),
         rc=proc.returncode, models=len(models),
         score_rows=len(scores["uid"]), wall_s=f"{wall:.2f}")
    _check(ok, "CLI outputs: model count, score rows or finite scores")
    return proc.stderr


def phase_cli():
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_cli_") as tmp:
        _cli_re_stage(tmp, "cli")


def _fe_counters():
    from gdmix_tpu_torch.ops import fe_loss_grad as fe
    return (fe.fe_loss_grad_fused, fe.fe_gather_entries,
            fe.fe_scatter_entries)


def phase_fe_fit(card):
    """The FE fit at full width through each kernel path, against an L-BFGS
    fit of the same objective through the plain version on the card."""
    import torch
    from gdmix_tpu_torch.io.input_pipeline import PerRecordData
    from gdmix_tpu_torch.ops.fe_loss_grad import fe_loss_grad_plain
    from gdmix_tpu_torch.ops.lbfgs import lbfgs
    from gdmix_tpu_torch.ops.logistic import l2_value_and_grad
    b = fe_problem("uniform")
    data = PerRecordData(
        columns={"uid": np.arange(FE_N, dtype=np.int64),
                 "response": b.labels.cpu().numpy(),
                 "offset": b.offsets.cpu().numpy()},
        indices=b.indices.cpu().numpy(), values=b.values.cpu().numpy(),
        num_samples=FE_N)
    del b
    launches, fits = {}, {}
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_fe_") as tmp:
        for mode, path in (("auto", ("fe_loss_grad_fused",)),
                           ("pallas_flat", ("fe_gather_entries",
                                            "fe_scatter_entries"))):
            model, schema = fe_stage_model(os.path.join(tmp, mode), mode)
            for c in _fe_counters():
                c.launches = 0
            # ---- the main path: one fit ----
            t0 = time.perf_counter()
            coef = model.fit_data(data, schema)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {c.__name__: c.launches for c in _fe_counters()}
            # ----
            for name in path:
                launches[name] = counts[name]
            _check(all(counts[n] > 0 for n in path),
                   f"FE fit {mode}: a kernel of the path never launched: "
                   f"{counts}")
            lf = model.last_fit
            batch = model._train_batch_cache[0]
            fun = model._objective_fun(batch)
            x = torch.as_tensor(coef, dtype=torch.float32, device=DEV)
            fun_ms = _time_ms(lambda: fun(x), 20)
            busy, top = _top_kernels(lambda: fun(x))
            fits[mode] = lf["f"]
            _say("fe_fit", grad_mode=mode, N=FE_N, D=FE_D, K=FE_K,
                 iterations=lf["iterations"], funcalls=lf["funcalls"],
                 converged=lf["converged"], host_syncs=lf["host_syncs"],
                 fit_s=f"{lf['seconds']:.3f}", wall_s=f"{wall:.3f}",
                 funcalls_per_s=f"{lf['funcalls'] / lf['seconds']:.1f}",
                 objective_ms=f"{fun_ms:.3f}",
                 objective_device_busy_ms=f"{busy:.3f}",
                 objective_top_device_ms=dict(list(top.items())[:3]),
                 fe_funcalls_per_sec=f"{1000.0 / fun_ms:.1f}",
                 f=f"{lf['f']:.6f}", launches=counts, card=repr(card))
            _check(lf["converged"] and np.isfinite(coef).all()
                   and coef.shape == (FE_D + 1,),
                   f"FE fit {mode}: not converged or bad coefficients")

        def plain(x):
            v, g = fe_loss_grad_plain(x, batch.indices, batch.values,
                                      batch.labels, batch.weights,
                                      batch.offsets, FE_D)
            lv, lg = l2_value_and_grad(x, 1.0, has_intercept=True,
                                       regularize_bias=False,
                                       intercept_at_end=True)
            return v + lv, g + lg
        t0 = time.perf_counter()
        ref = lbfgs(plain, torch.zeros(FE_D + 1, device=DEV))
        ref_s = time.perf_counter() - t0
    rel = {m: abs(f - ref.f) / abs(ref.f) for m, f in fits.items()}
    _say("fe_fit", reference="plain version", iterations=ref.num_iterations,
         funcalls=ref.num_funcalls, converged=ref.converged,
         fit_s=f"{ref_s:.3f}",
         funcalls_per_s=f"{ref.num_funcalls / ref_s:.1f}",
         f=f"{ref.f:.6f}", f_rel={m: f"{r:.2e}" for m, r in rel.items()})
    _check(ref.converged and all(r <= FE_FIT_RTOL for r in rel.values()),
           f"FE fit against the plain-version fit: {rel}")
    return launches


WIDE_D = 1_000_000    # the bench's fe_wide_d workload (bench.py:740-754)
WIDE_D_CONVERGED_LAMBDA = 1e4


def _fe_objective_plain(b, d, x, lam=1.0):
    """The FE objective at λ (bias unregularized) through the plain
    version: the yardstick of every wide_d objective and fit."""
    from gdmix_tpu_torch.ops.fe_loss_grad import fe_loss_grad_plain
    from gdmix_tpu_torch.ops.logistic import l2_value_and_grad
    v, g = fe_loss_grad_plain(x, b.indices, b.values, b.labels, b.weights,
                              b.offsets, d)
    lv, lg = l2_value_and_grad(x, lam, has_intercept=True,
                               regularize_bias=False, intercept_at_end=True)
    return v + lv, g + lg


def _hybrid_counters():
    from gdmix_tpu_torch.ops import fe_hybrid as fh, windowed_scatter as ws
    return (fh.fe_hybrid_hot, ws.windowed_scatter_add) + _fe_counters()


def _counted(fn):
    """(fn(), launches by kernel) with every count zeroed just before."""
    import torch
    for c in _hybrid_counters():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in _hybrid_counters()}


def _top_kernels(fn, reps=5, top=8):
    """Device ms per call of fn's largest device events under
    torch.profiler, and the device-busy ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / reps
    ev.sort(key=lambda e: -e.self_device_time_total)
    return busy, {e.key[:60]: round(e.self_device_time_total / 1e3 / reps, 4)
                  for e in ev[:top]}


def _k12_args(aux, b, x, dtype):
    """`fe_hybrid_hot`'s arguments on one split's hot side (θc = w[hot],
    off₂ = offsets + z_cold), in `dtype`."""
    import torch
    w = x[:-1].to(dtype)
    z_cold = torch.zeros(b.labels.shape[0], dtype=dtype,
                         device=DEV).index_add_(
        0, aux.cold_row.long(), w[aux.cold_idx.long()] * aux.cold_val.to(dtype))
    A = aux.hot_ids.shape[0]
    return (w[aux.hot_ids.long()], x[-1].to(dtype), aux.hot_idx,
            b.values.to(dtype), b.labels.to(dtype), b.weights.to(dtype),
            b.offsets.to(dtype) + z_cold, A)


def _k12_row(tag, args):
    """K12 against its plain version on `fe_hybrid_hot`'s arguments; returns
    (the result row, the plain version's r)."""
    import torch
    from gdmix_tpu_torch.ops import fe_hybrid as fh, fe_pass
    dtype, A = args[0].dtype, args[-1]
    k = lambda: fh.fe_hybrid_hot(*args)
    p = lambda: fh.fe_hybrid_hot_plain(*args)
    (lk, gk, sk, rk), (lp, gp, sp, rp) = k(), p()
    torch.cuda.synchronize()
    tol = FE_F64_RTOL if dtype == torch.float64 else FE_GRAD_RTOL
    l_rel = abs(float(lk - lp)) / abs(float(lp))
    s_rel = abs(float(sk - sp)) / float(rp.abs().sum())
    g_rel, r_rel = _rel(gk, gp), _rel(rk, rp)
    _check(gk.dtype == dtype and l_rel <= min(tol, FE_LOSS_RTOL)
           and max(g_rel, r_rel, s_rel) <= tol,
           f"fe_hybrid_hot {tag}: loss {l_rel} g {g_rel} r {r_rel} "
           f"Σr {s_rel}")
    ms, pms = _time_ms(k, 10), _time_ms(p, 3)
    item = torch.finfo(dtype).bits // 8
    n, kk = args[2].shape
    # ids and values [N, K], y, w, off₂ and θc in; g [A] and r [N] out; per
    # entry a gather and a scatter multiply-add, per record ~10 flops
    bound, by = _bound(4 * n * kk + item * (n * kk + 4 * n + 2 * A),
                       4 * n * kk + 10 * n, item)
    _say("kernels", kernel="fe_hybrid_hot", cut=tag, N=n, K=kk, A=A,
         dtype=str(dtype).split(".")[1],
         path=tuple(fe_pass.pass_shape(kk, args[2], args[3])),
         shared_tier=fh.shared_tier(A, item),
         blocks_per_sm=fh.hot_blocks_per_sm(A, dtype, kk),
         loss_rel=f"{l_rel:.2e}", grad_rel=f"{g_rel:.2e}",
         r_rel=f"{r_rel:.2e}", ms=f"{ms:.3f}", plain_ms=f"{pms:.3f}",
         bound_ms=f"{bound:.4f}", bound_by=by)
    return dict(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                library_ms=None, max_abs_err=float((gk - gp).abs().max())), rp


def _k13_row(tag, idxl, contrib, win, nw, plan):
    """K13 against its plain version and `index_add_` into the table (the
    yardstick, with the per-entry targets made beforehand); two calls in a
    row must be equal (the split windows' counters are back at 0, and a
    stream sorted within each window sums in one order). The bound reads
    the tiles the plan reads (it leaves out those whose values are all 0:
    their contributions are 0 in every call), their tile ids, and writes
    the table."""
    import torch
    from gdmix_tpu_torch.ops import windowed_scatter as ws
    from gdmix_tpu_torch.ops.logistic import HYBRID_SCATTER_WINDOW as W
    tile_rows = idxl.shape[0] // win.shape[0]
    k = lambda: ws.windowed_scatter_add(idxl, contrib, win, nw, W, tile_rows,
                                        plan)
    p = lambda: ws.windowed_scatter_add_plain(idxl, contrib, win, nw, W,
                                              tile_rows)
    target = (win.long().repeat_interleave(tile_rows * 16) * W
              + idxl.reshape(-1).long())
    flat = contrib.reshape(-1)
    lib = lambda: torch.zeros(nw * W, device=DEV).index_add_(0, target, flat)
    tk, tk2, tp = k().clone(), k(), p()
    torch.cuda.synchronize()
    err, rel = float((tk - tp).abs().max()), _rel(tk, tp)
    _check(rel <= FE_GRAD_RTOL and bool(torch.equal(tk, tk2)),
           f"windowed_scatter_add {tag}: rel {rel}, two calls equal "
           f"{bool(torch.equal(tk, tk2))}")
    ms, pms, lms = _time_ms(k, 50), _time_ms(p, 5), _time_ms(lib, 5)
    dev_ms = _top_kernels(k, reps=20)[0]
    M, n_tiles = flat.shape[0], win.shape[0]
    n_read = plan.tiles_read
    m_read = n_read * tile_rows * 16
    bound, by = _bound(8 * m_read + 4 * n_read + 4 * nw * W, m_read)
    bound_all = _bound(8 * M + 4 * n_tiles + 4 * nw * W, M)[0]
    _say("kernels", kernel="windowed_scatter_add", layout=tag, M=M,
         M_read=m_read, tiles=n_tiles, tiles_read=n_read, windows=nw,
         items=plan.items.shape[0], split_items=plan.scratch.shape[0],
         tile_cap=plan.tile_cap, max_abs_err=f"{err:.3e}", rel=f"{rel:.2e}",
         ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}", plain_ms=f"{pms:.3f}",
         library_ms=f"{lms:.3f}", bound_ms=f"{bound:.4f}", bound_by=by,
         bound_all_tiles_ms=f"{bound_all:.4f}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=pms, bound_ms=bound,
                bound_by=by, library_ms=lms, max_abs_err=err)


def _k13_edge_row():
    """K13 on a layout with every kind of window: one split over several
    items, owned ones, one that collects the cold padding, one whose
    entries all have value 0 and one no entry reaches (a tile of padding
    each, both left out of the plan). The table comes from torch.empty,
    here onto memory just filled with NaN: every window must be written,
    the slots no entry reaches exactly 0; two calls equal; the counters
    back at 0."""
    import torch
    from gdmix_tpu_torch.ops import windowed_scatter as ws
    from gdmix_tpu_torch.ops.logistic import (HYBRID_SCATTER_TILE_ROWS as TR,
                                              HYBRID_SCATTER_WINDOW as W,
                                              _windowed_layout)
    rng = np.random.RandomState(8)
    nw = 7
    parts = [rng.randint(1, W, 300), W + rng.randint(0, W, 60_000),
             2 * W + rng.randint(0, W, 500), 4 * W + rng.randint(0, W, 3000),
             5 * W + rng.randint(0, W // 2, 9000), [6 * W + 7]]
    key = np.concatenate(parts + [np.zeros(5000, int)]).astype(np.int32)
    val = rng.randn(key.shape[0]).astype(np.float32)
    val[-5000:] = 0.0                          # the cold arrays' padding
    val[(key >= 4 * W) & (key < 5 * W)] = 0.0  # a window of value-0 entries
    t = lambda a: torch.as_tensor(a, device=DEV)
    idxl, _, _, v, win = _windowed_layout(t(key), t(key), t(key), t(val),
                                          nw * W, W, TR)
    plan = ws.windowed_plan(win, v, nw, W, blocks=16)
    contrib = v * t(rng.randn(*v.shape).astype(np.float32))
    want = ws.windowed_scatter_add_plain(idxl, contrib, win, nw, W, TR)
    torch.empty(nw * W, device=DEV).fill_(float("nan"))   # freed: reused
    got = ws.windowed_scatter_add(idxl, contrib, win, nw, W, TR, plan).clone()
    again = ws.windowed_scatter_add(idxl, contrib, win, nw, W, TR, plan)
    torch.cuda.synchronize()
    reached = torch.zeros(nw * W, dtype=torch.bool, device=DEV)
    live = v.reshape(-1) != 0
    reached[(win.long().repeat_interleave(TR * 16) * W
             + idxl.reshape(-1).long())[live]] = True
    items = plan.items.cpu().numpy()
    split = int((items[:, 3] >= 0).sum())
    rel = _rel(got, want)
    ok = dict(finite=bool(torch.isfinite(got).all()),
              untouched_zero=bool((got[~reached] == 0).all()),
              equal_twice=bool(torch.equal(got, again)),
              counters_zero=int(plan.counters.abs().sum()) == 0,
              split=split > 0, rel=rel <= FE_GRAD_RTOL)
    _say("kernels", kernel="windowed_scatter_add", layout="edges",
         windows=nw, tiles=win.shape[0], tiles_read=plan.tiles_read,
         items=items.shape[0], split_items=split, rel=f"{rel:.2e}",
         **{k_: v_ for k_, v_ in ok.items() if k_ != "rel"})
    _check(all(ok.values()), f"windowed_scatter_add edges: {ok}")
    return float((got - want).abs().max())


def phase_wide_d(card):
    """The JAX bench's wide-D FE workload (bench.py:521-582, :740-754) at
    full width: N = 4,997,120, D = 1,000,000, K = 16, Zipf(1.2) ids, f32,
    λ = 1, through FixedEffectLRModel with grad_mode auto, which resolves
    to the hot/cold hybrid. The split's build (cold and warm); the
    objective at one x through auto (K12 + 2×K13), pallas_hybrid (K12, the
    cold side in PyTorch) and scatter (the fused K5: this workload's path
    before the hybrid), each against the plain version; one fit_data
    through auto (the main path: K12 once and K13 twice per funcall),
    with a plain-version L-BFGS fit beside it, then both at λ = 10⁴, where
    they converge and must agree; K12 and K13 against their plain
    versions at this split's shapes, plus K12 at hot_features 65,536 (the
    tiered table), in float64 and on uniform compact ids; uniform ids,
    where the split declines and the fused kernel runs; and criteo's K =
    39, whose K12 launches must all take the lane-group path. Returns
    (kernel rows, launches)."""
    import torch
    from gdmix_tpu_torch.io.input_pipeline import PerRecordData
    from gdmix_tpu_torch.ops.lbfgs import lbfgs
    from gdmix_tpu_torch.ops.logistic import (HYBRID_SCATTER_WINDOW as W,
                                              build_hybrid_aux)
    D = WIDE_D
    rows = {}
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_wide_d_") as tmp:
        # no thresholding: the fit's coefficients are its final point
        models = {m: fe_stage_model(os.path.join(tmp, m), m, d=D,
                                    sparsity_threshold=0.0)
                  for m in ("auto", "pallas_hybrid", "scatter")}
        model, schema = models["auto"]
        b = fe_problem("zipf", seed=3, d=D)
        torch.cuda.synchronize()
        build_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            aux = model.build_hybrid_aux_for(b)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)
        _check(aux is not None and aux.zs_win is not None,
               "wide_d: the split declined or lacks the windowed layouts")
        A = aux.hot_ids.shape[0]
        mc = int((aux.cold_val != 0).sum())
        _say("wide_d", workload="fe_wide_d", N=FE_N, D=D, K=FE_K,
             ids="zipf1.2", aux_build_cold_s=f"{build_s[0]:.3f}",
             aux_build_s=f"{build_s[1]:.3f}", A=A, mc=mc,
             cold_share=f"{mc / float((b.values != 0).sum()):.4f}",
             mc_pad=aux.cold_val.shape[0],
             grad_windows=(D + W - 1) // W, row_windows=aux.zs_nwin,
             grad_tiles=aux.gs_win.shape[0], row_tiles=aux.zs_win.shape[0])
        _check(A == 16384, f"wide_d: adaptive A {A}, want 16384")
        aux_ph = models["pallas_hybrid"][0].build_hybrid_aux_for(b)
        _check(aux_ph is not None and aux_ph.zs_win is None,
               "wide_d: pallas_hybrid's split")

        g = torch.Generator(device=DEV).manual_seed(1)
        x = 0.05 * torch.randn(D + 1, generator=g, device=DEV)
        lp, gp = _fe_objective_plain(b, D, x)
        want = {"auto": {"fe_hybrid_hot": 1, "windowed_scatter_add": 2},
                "pallas_hybrid": {"fe_hybrid_hot": 1,
                                  "windowed_scatter_add": 0},
                "scatter": {"fe_loss_grad_fused": 1, "fe_hybrid_hot": 0}}
        obj_ms = {}
        for mode, ax in (("auto", aux), ("pallas_hybrid", aux_ph),
                         ("scatter", None)):
            fun = models[mode][0]._objective_fun(b, ax)
            (lv, gv), counts = _counted(lambda: fun(x))
            l_rel = abs(float(lv - lp)) / abs(float(lp))
            g_rel = _rel(gv, gp)
            _check(all(counts[k] == v for k, v in want[mode].items()),
                   f"wide_d {mode}: launches {counts}")
            _check(l_rel <= FE_LOSS_RTOL and g_rel <= FE_GRAD_RTOL,
                   f"wide_d {mode}: loss rel {l_rel}, grad rel {g_rel}")
            obj_ms[mode] = _time_ms(lambda: fun(x), 10)
            _say("wide_d", grad_mode=mode, loss_rel=f"{l_rel:.2e}",
                 grad_rel=f"{g_rel:.2e}", objective_ms=f"{obj_ms[mode]:.3f}",
                 funcalls_per_s=f"{1000.0 / obj_ms[mode]:.1f}",
                 launches=counts)
        plain_ms = _time_ms(lambda: _fe_objective_plain(b, D, x), 3)
        auto_fun = models["auto"][0]._objective_fun(b, aux)
        busy, top = _top_kernels(lambda: auto_fun(x))
        _say("wide_d",
             fe_wide_d_funcalls_per_sec=f"{1000 / obj_ms['auto']:.1f}",
             scatter_funcalls_per_sec=f"{1000 / obj_ms['scatter']:.1f}",
             auto_vs_scatter=f"{obj_ms['scatter'] / obj_ms['auto']:.2f}",
             plain_ms=f"{plain_ms:.3f}", auto_device_busy_ms=f"{busy:.3f}",
             auto_top_device_ms=top, card=repr(card))

        # ---- the main path: one fit through auto ----
        data = PerRecordData(
            columns={"uid": np.arange(FE_N, dtype=np.int64),
                     "response": b.labels.cpu().numpy(),
                     "offset": b.offsets.cpu().numpy()},
            indices=b.indices.cpu().numpy(), values=b.values.cpu().numpy(),
            num_samples=FE_N)
        t0 = time.perf_counter()
        coef, launches = _counted(lambda: model.fit_data(data, schema))
        wall = time.perf_counter() - t0
        # ----
        lf = model.last_fit
        _say("wide_d", fit="auto", iterations=lf["iterations"],
             funcalls=lf["funcalls"], converged=lf["converged"],
             host_syncs=lf["host_syncs"], fit_s=f"{lf['seconds']:.3f}",
             wall_s=f"{wall:.3f}",
             funcalls_per_s=f"{lf['funcalls'] / lf['seconds']:.1f}",
             f=f"{lf['f']:.6f}", launches=launches)
        # At D = 1M on λ = 1 the objective is far worse conditioned than at
        # 10k (the hottest id carries ~10⁶ times the curvature of a rare
        # one): L-BFGS stops within neither its 100 iterations nor 1,000
        # (chip runs of this phase), and two unconverged float32 runs part
        # by more than FE_FIT_RTOL (their gradients' atomics add in other
        # orders). So the fit is held to running its iterations without a
        # line-search failure, to lowering the objective, and to the
        # objective it reports at its final point, recomputed through the
        # plain version; the plain version's own fit is printed beside it.
        _check((lf["converged"] or not lf["line_search_failed"])
               and np.isfinite(coef).all() and coef.shape == (D + 1,),
               "wide_d fit: line search failed or bad coefficients")
        x_fit = torch.as_tensor(coef, dtype=torch.float32, device=DEV)
        f_fit = float(_fe_objective_plain(b, D, x_fit)[0])
        f_0 = float(_fe_objective_plain(b, D, torch.zeros_like(x_fit))[0])
        fit_rel = abs(lf["f"] - f_fit) / abs(f_fit)
        _say("wide_d", fit="auto", f0=f"{f_0:.3f}",
             f_final_plain=f"{f_fit:.3f}",
             f_rel_at_final_x=f"{fit_rel:.2e}")
        _check(fit_rel <= FE_LOSS_RTOL and lf["f"] < f_0,
               f"wide_d fit: f {lf['f']} against the plain version's "
               f"{f_fit} at its final point (f(0) = {f_0})")
        _check(launches["fe_hybrid_hot"] == lf["funcalls"]
               and launches["windowed_scatter_add"] == 2 * lf["funcalls"]
               and launches["fe_loss_grad_fused"] == 0,
               f"wide_d fit: launches {launches} for {lf['funcalls']} "
               "funcalls")
        t0 = time.perf_counter()
        ref = lbfgs(lambda xx: _fe_objective_plain(b, D, xx),
                    torch.zeros(D + 1, device=DEV),
                    maxiter=model.model_params.num_of_lbfgs_iterations)
        ref_s = time.perf_counter() - t0
        f_rel = abs(lf["f"] - ref.f) / abs(ref.f)
        _say("wide_d", reference="plain version",
             iterations=ref.num_iterations, funcalls=ref.num_funcalls,
             converged=ref.converged, fit_s=f"{ref_s:.3f}",
             f=f"{ref.f:.6f}", f_rel=f"{f_rel:.2e}")
        _check(ref.converged or not ref.line_search_failed,
               "wide_d plain-version fit: line search failed")
        # λ = 10⁴ cuts the hottest id's curvature against a rare id's from
        # ~10⁶ to a few hundred: both fits converge (~20 iterations), so the
        # fit through auto is held to the plain-version fit's optimum
        lam = WIDE_D_CONVERGED_LAMBDA
        m_lam = fe_stage_model(os.path.join(tmp, "lambda"), "auto", d=D,
                               sparsity_threshold=0.0, l2_reg_weight=lam)[0]
        m_lam.fit_data(data, schema)
        lf = m_lam.last_fit
        ref = lbfgs(lambda xx: _fe_objective_plain(b, D, xx, lam),
                    torch.zeros(D + 1, device=DEV),
                    maxiter=m_lam.model_params.num_of_lbfgs_iterations)
        f_rel = abs(lf["f"] - ref.f) / abs(ref.f)
        _say("wide_d", fit="auto", l2_reg_weight=lam,
             iterations=lf["iterations"], funcalls=lf["funcalls"],
             converged=lf["converged"], f=f"{lf['f']:.6f}",
             plain_iterations=ref.num_iterations,
             plain_converged=ref.converged, plain_f=f"{ref.f:.6f}",
             f_rel=f"{f_rel:.2e}")
        _check(lf["converged"] and ref.converged and f_rel <= FE_FIT_RTOL,
               f"wide_d fit at λ = {lam}: converged {lf['converged']} and "
               f"{ref.converged}, f rel {f_rel}")
        del data, m_lam

        # ---- the kernels at this split's shapes ----
        a16 = _k12_args(aux, b, x, torch.float32)
        rows["fe_hybrid_hot"], r = _k12_row("wide_d", a16)
        aux65 = build_hybrid_aux(b.indices, b.values, D, hot_features=65536)
        _check(aux65 is not None, "wide_d: hot_features 65536 declined")
        # uniform compact ids over [0, A): no id is frequent, nothing is
        # dumped, so the strips cannot help and must not cost
        A16 = a16[-1]
        uni = torch.randint(0, A16, (FE_N, FE_K), device=DEV,
                            dtype=torch.int32,
                            generator=torch.Generator(device=DEV)
                            .manual_seed(5))
        cuts = {}
        for tag, args in (
                ("hot_features_65536",
                 _k12_args(aux65, b, x, torch.float32)),
                ("float64", _k12_args(aux, b, x, torch.float64)),
                ("uniform_compact_ids",
                 a16[:2] + (uni,) + a16[3:6] + (b.offsets, A16))):
            row, _ = _k12_row(tag, args)
            cuts[f"{tag}_ms"] = row["ms"]
            rows["fe_hybrid_hot"]["max_abs_err"] = max(
                rows["fe_hybrid_hot"]["max_abs_err"], row["max_abs_err"])
        rows["fe_hybrid_hot"]["forms"] = cuts
        del aux65, uni, a16
        w = x[:-1]
        ce = (aux.gs_val * r[aux.gs_row.long()]).float()
        wv = (w[aux.zs_idx.long()] * aux.zs_val).float()
        rows["windowed_scatter_add"] = k13 = _k13_row(
            "gradient", aux.gs_idxl, ce, aux.gs_win, (D + W - 1) // W,
            aux.gs_plan)
        zrow = _k13_row("rows", aux.zs_rowl, wv, aux.zs_win, aux.zs_nwin,
                        aux.zs_plan)
        k13["max_abs_err"] = max(k13["max_abs_err"], zrow["max_abs_err"],
                                 _k13_edge_row())
        k13["forms"] = {"gradient_device_ms": k13.pop("device_ms"),
                        "rows_ms": zrow["ms"],
                        "rows_device_ms": zrow["device_ms"],
                        "rows_bound_ms": zrow["bound_ms"],
                        "rows_library_ms": zrow["library_ms"]}
        del aux, aux_ph, b, ce, wv, r

        # uniform ids: no hot set, the builder declines, the fused kernel
        bu = fe_problem("uniform", seed=4, d=D)
        model_u = fe_stage_model(os.path.join(tmp, "uniform"), "auto", d=D)[0]
        _check(model_u.build_hybrid_aux_for(bu) is None,
               "wide_d uniform: the builder did not decline")
        fun = model_u._objective_fun(bu, None)
        (lv, gv), counts = _counted(lambda: fun(x))
        lp, gp = _fe_objective_plain(bu, D, x)
        l_rel, g_rel = abs(float(lv - lp)) / abs(float(lp)), _rel(gv, gp)
        _check(counts["fe_loss_grad_fused"] == 1
               and counts["fe_hybrid_hot"] == 0
               and l_rel <= FE_LOSS_RTOL and g_rel <= FE_GRAD_RTOL,
               f"wide_d uniform: launches {counts}, loss {l_rel}, "
               f"grad {g_rel}")
        u_ms = _time_ms(lambda: fun(x), 10)
        _say("wide_d", ids="uniform", aux="declined",
             loss_rel=f"{l_rel:.2e}", grad_rel=f"{g_rel:.2e}",
             objective_ms=f"{u_ms:.3f}",
             fe_wide_d_uniform_funcalls_per_sec=f"{1000 / u_ms:.1f}")
        del bu, model_u

        # criteo's width, K = 39 (past the vector path): the split through
        # auto and the objective against the plain version, then K12 at A =
        # 16,384 (the criteo cell's split) against its plain version; every
        # K12 launch of it must take the lane-group path
        from gdmix_tpu_torch.ops import fe_hybrid as fh
        bc = fe_problem("zipf", seed=6, d=D, k=CRITEO_K)
        auxc = model.build_hybrid_aux_for(bc)
        _check(auxc is not None, "wide_d criteo_K39: the split declined")
        fh.fe_hybrid_hot.path_launches = {"vector": 0, "lanes": 0}
        fun = model._objective_fun(bc, auxc)
        (lv, gv), counts = _counted(lambda: fun(x))
        lp, gp = _fe_objective_plain(bc, D, x)
        l_rel, g_rel = abs(float(lv - lp)) / abs(float(lp)), _rel(gv, gp)
        _check(counts["fe_hybrid_hot"] == 1
               and counts["windowed_scatter_add"] == 2
               and l_rel <= FE_LOSS_RTOL and g_rel <= FE_GRAD_RTOL,
               f"wide_d criteo_K39: launches {counts}, loss {l_rel}, "
               f"grad {g_rel}")
        c_ms = _time_ms(lambda: fun(x), 10)
        a_auto = auxc.hot_ids.shape[0]
        auxc = build_hybrid_aux(bc.indices, bc.values, D, hot_features=16384)
        row, _ = _k12_row("criteo_K39", _k12_args(auxc, bc, x,
                                                  torch.float32))
        paths = dict(fh.fe_hybrid_hot.path_launches)
        _say("wide_d", K=CRITEO_K, A_auto=a_auto, loss_rel=f"{l_rel:.2e}",
             grad_rel=f"{g_rel:.2e}", objective_ms=f"{c_ms:.3f}",
             k12_paths=paths)
        _check(paths["vector"] == 0 and paths["lanes"] >= 12,
               f"wide_d criteo_K39: K12 launches by path {paths}")
        rows["fe_hybrid_hot"]["forms"].update(
            criteo_K39_ms=row["ms"], criteo_K39_plain_ms=row["plain_ms"],
            criteo_K39_bound_ms=row["bound_ms"],
            criteo_K39_objective_ms=c_ms)
        del bc, auxc
    return rows, {k: launches[k] for k in ("fe_hybrid_hot",
                                           "windowed_scatter_add")}


def _re_fits_recorded(record, counters=()):
    """RandomEffectLRModel.fit_groups wrapped to append (model, cached,
    static uploads of the call, equal) to `record` for each call, where a
    call that found its cache filled (a later sweep) is refit on the same
    inputs without the cache and `equal` says whether the two tables are
    bit-equal (the launches of that refit are taken back off `counters`);
    or, with `record` None, to drop the device cache. Returns the
    original."""
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    orig = RandomEffectLRModel.fit_groups

    def fit_groups(self, groups, weights, schema, device_cache=None):
        if record is None:
            return orig(self, groups, weights, schema)
        before = self.static_upload_count
        warm = bool(device_cache)
        out = orig(self, groups, weights, schema, device_cache=device_cache)
        up = self.static_upload_count - before
        equal = None
        if warm:
            saved = [c.launches for c in counters]
            ref = orig(self, groups, weights, schema)
            for c, n in zip(counters, saved):
                c.launches = n
            equal = (list(ref.ids) == list(out.ids)
                     and np.array_equal(ref.coef_vals, out.coef_vals)
                     and np.array_equal(ref.icpt, out.icpt))
        record.append((id(self), device_cache is not None, up, equal))
        return out
    RandomEffectLRModel.fit_groups = fit_groups
    return orig


def phase_pipeline(card, tmp):
    """The in-memory pipeline through the workflow CLI, its RE fits through
    the sweep cache: sweep 2 uploads no static column, and each of its RE
    fits equals, bit for bit, a refit of the same inputs without the cache.
    Then runs with the cache dropped. Two runs of one config differ by up
    to a few 1e-6 of AUC (the run repeated shows it, as does a run with the
    global coordinate in float64): the FE kernel adds in an order its
    atomics choose, and the validation set's many tied scores turn the
    last bits into AUC. So the cached and the uncached run are held to
    1e-6 of AUC with the global coordinate held at its zero model
    (num_of_lbfgs_iterations 0), its only source of such bits. Returns the
    movieLens data root."""
    import torch
    import yaml
    from gdmix_tpu_torch.data import movielens
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.ops import newton_lanes as nl
    from gdmix_tpu_torch.workflow.main import main as workflow_main
    t0 = time.perf_counter()
    ml = movielens.prepare_gdmix_data(os.path.join(tmp, "data"),
                                      movielens.generate_synthetic())
    prep_s = time.perf_counter() - t0
    out = os.path.join(tmp, "out")
    cfgs = {}
    for tag in ("cached", "repeat", "uncached", "cached_f64",
                "uncached_f64", "cached_fe0", "uncached_fe0"):
        cfg = movielens_config(ml, out if tag == "cached"
                               else f"{out}_{tag}")
        if tag.endswith("f64"):
            cfg["fixed_effect_config"]["global"]["dtype"] = "float64"
        if tag.endswith("fe0"):
            cfg["fixed_effect_config"]["global"][
                "num_of_lbfgs_iterations"] = 0
        cfgs[tag] = os.path.join(tmp, f"movielens_{tag}.yaml")
        with open(cfgs[tag], "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)

    def run(tag):
        return workflow_main(["--config_path", cfgs[tag], "--mode",
                              "in_memory", "--num_sweeps", "2"])
    counters = _fe_counters() + (nl.newton_full, nl.newton_block)
    fits = []
    orig = _re_fits_recorded(fits, counters)
    try:
        for c in counters:
            c.launches = 0
        # ---- the main path ----
        t0 = time.perf_counter()
        metrics = run("cached")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        # ----
        RandomEffectLRModel.fit_groups = orig
        sweeps, equal = {}, []
        for m, cached, up, eq in fits:
            sweeps.setdefault(m, []).append(up if cached else None)
            equal += [] if eq is None else [eq]
        auc = {t: run(t) for t in ("repeat", "cached_f64", "cached_fe0")}
        _re_fits_recorded(None)
        t0 = time.perf_counter()
        auc["uncached"] = run("uncached")
        torch.cuda.synchronize()
        uncached_wall = time.perf_counter() - t0
        auc.update({t: run(t) for t in ("uncached_f64", "uncached_fe0")})
    finally:
        RandomEffectLRModel.fit_groups = orig
    uploads = list(sweeps.values())

    def gap(a, b):
        return max(abs(a[c] - b[c]) for c in COORDINATES)
    gaps = {"repeat": gap(metrics, auc["repeat"]),
            "uncached": gap(metrics, auc["uncached"]),
            "uncached_global_f64": gap(auc["cached_f64"],
                                       auc["uncached_f64"]),
            "uncached_global_zero": gap(auc["cached_fe0"],
                                        auc["uncached_fe0"])}
    _say("pipeline", re_static_uploads_by_sweep=uploads,
         sweep2_fits_equal_uncached=equal,
         uncached_wall_s=f"{uncached_wall:.3f}",
         max_auc_gap={k: f"{v:.2e}" for k, v in gaps.items()},
         card=repr(card))
    _check(len(uploads) == 2 and all(len(u) == 2 and u[0] and u[1] == 0
                                     for u in uploads),
           f"pipeline RE cache: static uploads by sweep {uploads}")
    _check(len(equal) == 2 and all(equal),
           f"pipeline RE cache: sweep-2 fits against uncached: {equal}")
    _check(gaps["uncached_global_zero"] <= 1e-6,
           f"pipeline with the RE cache against without: AUC gaps {gaps}")
    ladder = [metrics.get(c) for c in ("global", "per-user", "per-movie")]
    written = {c: os.path.isfile(os.path.join(out, c, "models",
                                              "part-00000.avro"))
               and os.path.isfile(os.path.join(out, c, "metric",
                                               "evalSummary.json"))
               for c in ("global", "per-user", "per-movie")}
    _say("pipeline", sweeps=2, auc={k: round(v, 6) for k, v in
                                    metrics.items()},
         wall_s=f"{wall:.3f}", data_prep_s=f"{prep_s:.3f}",
         launches=counts, card=repr(card))
    _check(None not in ladder and ladder[0] < ladder[1] < ladder[2],
           f"validation AUC does not climb global → per-user → per-movie: "
           f"{metrics}")
    _check(all(written.values()), f"coordinate outputs missing: {written}")
    _check(counts["fe_loss_grad_fused"] > 0 and counts["newton_full"] > 0,
           f"the pipeline skipped a kernel: {counts}")
    return ml


class _Records(logging.Handler):
    """The records a logger emits inside the `with` block."""

    def __init__(self, name):
        super().__init__()
        self.logger, self.records = logging.getLogger(name), []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def _ml100k_config(ml, tmp, name):
    """The movieLens workflow with per-user in 2 partitions (tests/
    test_e2e_pipeline.py:53-54), writing to <tmp>/<name>: the yaml's path."""
    cfg = movielens_config(ml, os.path.join(tmp, name))
    cfg["random_effect_config"]["per-user"]["num_partitions"] = 2
    path = os.path.join(tmp, f"{name}.yaml")
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def _re_tier_rows(out, phase, tag):
    """K1/K2 (`_lanes_row`, F32_TOL) at every lanes tier of each per-user
    and per-movie partition's plan under <out>, read from the run's
    partitioned records through iter_bucketize_flat, in the form
    lanes_form gives each tier, against their plain versions. Returns
    ({kernel: max |error|}, {kernel: tiers checked})."""
    import glob
    from gdmix_tpu_torch.io.input_pipeline import \
        load_per_entity_grouped_flat
    from gdmix_tpu_torch.io.metadata import DatasetMetadata
    from gdmix_tpu_torch.ops import newton_lanes as nl
    worst = {"newton_full": 0.0, "newton_block": 0.0}
    checked = {"newton_full": 0, "newton_block": 0}
    plans, tiers = {}, {}   # tiers: each launch shape once
    for coord, bag, entity in (("per-user", "per_user", "user_id"),
                               ("per-movie", "per_movie", "movie_id")):
        part = os.path.join(out, coord, "partition")
        md = DatasetMetadata.from_file(
            os.path.join(part, "metadata", "tensor_metadata.json"))
        dirs = sorted(glob.glob(os.path.join(part, "trainingData", "active",
                                             "partitionId=*")))
        _check(bool(dirs), f"{coord}: no partitioned training data")
        for pdir in dirs:
            fg = load_per_entity_grouped_flat(pdir, md, entity, bag)
            _check(fg is not None, f"{pdir}: no columnar records")
            plan = _plan_buckets(fg, md.num_features(bag))
            key = f"{coord}/{os.path.basename(pdir)}"
            plans[key] = [f"B{B}_n{n}_d{d}_{rung}" for B, n, d, rung in plan]
            for t in _lanes_tiers(plan):
                tiers.setdefault(t, coord)
    _say(phase, tier_plans=plans)
    for (B, n, d, form), coord in tiers.items():
        fn = nl.newton_full if form == "warp" else nl.newton_block
        r = _lanes_row(fn, B, n, d, f"{tag}_{coord}_tier")
        worst[fn.__name__] = max(worst[fn.__name__], r["max_abs_err"])
        checked[fn.__name__] += 1
    return worst, checked


def _ml100k_kernel_rows(ml, out):
    """The kernels at the shapes the single-node run gave them, against
    their plain versions: K1/K2 at every lanes tier of its RE partitions
    (`_re_tier_rows`); K5 (`_fe_fused_row`, FE_LOSS_RTOL/FE_GRAD_RTOL) on
    the global coordinate's training batch (D = 44) at a seeded θ. Returns
    {kernel: max |error|}."""
    import torch
    from gdmix_tpu_torch.io.input_pipeline import read_per_record
    from gdmix_tpu_torch.io.metadata import DatasetMetadata
    worst, _ = _re_tier_rows(out, "single_node", "ml100k")
    bag = os.path.join(ml, "global")
    md = DatasetMetadata.from_file(os.path.join(bag, "metadata",
                                                "tensor_metadata.json"))
    data = read_per_record(os.path.join(bag, "trainingData"), md, "global")
    d = md.num_features("global")
    dev = torch.device(DEV)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    x = f32(np.random.RandomState(d).randn(d + 1) * 0.1)
    _, worst["fe_loss_grad_fused"], _ = _fe_fused_row("ml100k_global", (
        x, torch.as_tensor(data.indices, dtype=torch.int32, device=dev),
        f32(data.values), f32(data.column("response")),
        f32(data.column("weight", 1.0)), f32(data.column("offset", 0.0)),
        d))
    return worst


def phase_single_node(card, tmp):
    """The file-based pipeline in this process through the CLI's default
    mode, at MovieLens-100K's counts; then the in-memory pipeline, one
    sweep, on the same data and config; and the kernels at the shapes
    the single-node run gave them (`_ml100k_kernel_rows`). Returns (data
    root, AUCs, {kernel: max |error|} of those checks)."""
    import torch
    from gdmix_tpu_torch.data import movielens
    from gdmix_tpu_torch.io import fs
    from gdmix_tpu_torch.ops import fe_loss_grad as fe, newton_lanes as nl
    from gdmix_tpu_torch.workflow.main import main as workflow_main
    phase_t0 = t0 = time.perf_counter()
    ml = movielens.prepare_gdmix_data(os.path.join(tmp, "ml100k"),
                                      movielens.generate_synthetic(**ML100K))
    prep_s = time.perf_counter() - t0
    cfg = _ml100k_config(ml, tmp, "single_node")
    out = os.path.join(tmp, "single_node")
    counters = (fe.fe_loss_grad_fused, nl.newton_full, nl.newton_block)
    for c in counters:
        c.launches = 0
    # ---- the main path ----
    with _Records("gdmix_tpu_torch.workflow.single_node") as log:
        t0 = time.perf_counter()
        metrics = workflow_main(["--config_path", cfg])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    # ----
    stages = {r.coordinate: {k: f"{v:.3f}" for k, v in
                             r.stage_seconds.items()}
              for r in log.records if hasattr(r, "stage_seconds")}
    _say("single_node", auc={k: round(v, 6) for k, v in metrics.items()},
         wall_s=f"{wall:.3f}", stage_s=stages, data_prep_s=f"{prep_s:.3f}",
         launches=counts, card=repr(card))
    ladder = [metrics.get(c) for c in COORDINATES]
    _check(None not in ladder and ladder[0] < ladder[1] < ladder[2],
           f"single_node: AUC does not climb global → per-user → "
           f"per-movie: {metrics}")
    _check(set(stages) == set(COORDINATES),
           f"single_node: stage times of {sorted(stages)}")
    contract = [os.path.join(out, p) for p in (
        "global/models/part-00000.avro", "per-user/partition/partitionList.txt",
        "per-movie/metric/evalSummary.json")]
    missing = [p for p in contract if not os.path.isfile(p)]
    missing += [f"{c}/{s}" for c in COORDINATES
                for s in ("train_scores", "validation_scores")
                if not fs.find_files(os.path.join(out, c, s), ".avro")]
    _check(not missing, f"single_node: the directory contract lacks "
                        f"{missing}")
    _check(counts["fe_loss_grad_fused"] > 0 and counts["newton_full"] > 0,
           f"single_node skipped a kernel: {counts}")
    errs = _ml100k_kernel_rows(ml, out)

    t0 = time.perf_counter()
    mem = workflow_main(["--config_path",
                         _ml100k_config(ml, tmp, "in_memory"),
                         "--mode", "in_memory"])
    torch.cuda.synchronize()
    mem_wall = time.perf_counter() - t0
    gap = {c: abs(mem[c] - metrics[c]) for c in COORDINATES}
    _say("single_node", against="in_memory, 1 sweep",
         auc={k: round(v, 6) for k, v in mem.items()},
         wall_s=f"{mem_wall:.3f}",
         max_auc_gap=f"{max(gap.values()):.2e}")
    _check(max(gap.values()) < MODES_AUC_ATOL,
           f"single_node against in_memory: AUC gaps {gap}")
    # the device's busy time in each mode: both runs again, warm, under
    # torch.profiler
    for mode in ("single_node", "in_memory"):
        cfg = _ml100k_config(ml, tmp, f"{mode}_profiled")
        prof_s, busy_ms = _profiled(lambda: workflow_main(
            ["--config_path", cfg, "--mode", mode]))
        _say("single_node", profiled=mode, wall_s=f"{prof_s:.3f}",
             device_busy_ms=f"{busy_ms:.3f}",
             idle=f"{1 - busy_ms / 1e3 / prof_s:.4f}")
    _say("single_node", phase_s=f"{time.perf_counter() - phase_t0:.3f}")
    return ml, metrics, errs


def phase_dag(card, tmp, ml, single):
    """The same pipeline as the job DAG: eight subprocesses on the card,
    each a `python -m gdmix_tpu_torch.…` that loads the kernels
    phase_build built. Each train job logs its own kernel launches (the
    trainer CLI's last line), read from the job's output."""
    from gdmix_tpu_torch.workflow.main import main as workflow_main
    cfg = _ml100k_config(ml, tmp, "dag")
    # the jobs import the package of this checkout, from wherever the
    # smoke was started
    keep = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, keep) if p)
    try:
        with _Records("gdmix_tpu_torch.workflow.distributed") as log:
            t0 = time.perf_counter()
            result = workflow_main(["--config_path", cfg, "--mode", "dag"])
            wall = time.perf_counter() - t0
    finally:
        if keep is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = keep
    done = [r for r in log.records if hasattr(r, "job")]
    jobs = {r.job: f"{r.seconds:.3f}" for r in done}
    launches = {}
    for r in done:
        if "kernel launches: " in r.output:
            line = r.output.rsplit("kernel launches: ", 1)[1].splitlines()[0]
            launches[r.job] = {k: v for k, v in json.loads(line).items()
                               if v}
    aucs = {}
    for c in COORDINATES:
        with open(os.path.join(tmp, "dag", c, "metric",
                               "evalSummary.json")) as f:
            aucs[c] = json.load(f)["auc"]
    gap = {c: abs(aucs[c] - single[c]) for c in COORDINATES}
    _say("dag", jobs=len(result["jobs"]), job_s=jobs, wall_s=f"{wall:.3f}",
         launches=launches, auc={k: round(v, 6) for k, v in aucs.items()},
         max_auc_gap=f"{max(gap.values()):.2e}", card=repr(card))
    _check(len(result["jobs"]) == 8 and len(jobs) == 8,
           f"dag: {len(result['jobs'])} jobs complete of 8")
    want = {"global-tf-train": "fe_loss_grad_fused",
            "per-user-tf-train": "newton_full",
            "per-movie-tf-train": "newton_full"}
    _check(all(launches.get(j, {}).get(k, 0) > 0 for j, k in want.items()),
           f"dag: a train job skipped its kernel: {launches}")
    _check(max(gap.values()) < MODES_AUC_ATOL,
           f"dag against single_node: AUC gaps {gap}")


def phase_fe_cli(ml, tmp):
    from gdmix_tpu_torch.io.input_pipeline import read_per_record
    from gdmix_tpu_torch.io.metadata import DatasetMetadata
    from gdmix_tpu_torch.io.model_avro import load_linear_models_from_avro
    from gdmix_tpu_torch.io.scores import read_scores
    from gdmix_tpu_torch.params import SchemaParams
    bag = os.path.join(ml, "global")
    feature_file = os.path.join(bag, "featureList", "global")
    md_file = os.path.join(bag, "metadata", "tensor_metadata.json")
    out = os.path.join(tmp, "fe_cli")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(out, *extra):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gdmix_tpu_torch.gdmix",
             "--action=train", "--stage=fixed_effect",
             "--model_type=logistic_regression",
             "--label_column_name=response", "--uid_column_name=uid",
             "--weight_column_name=weight",
             "--prediction_score_column_name=predictionScore",
             f"--training_score_dir={out}/train_scores",
             f"--validation_score_dir={out}/validation_scores",
             f"--metadata_file={md_file}",
             f"--training_data_dir={bag}/trainingData",
             f"--validation_data_dir={bag}/validationData",
             "--feature_bag=global", f"--feature_file={feature_file}",
             f"--output_model_dir={out}/models", "--l2_reg_weight=1.0",
             "--regularize_bias=false", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
        _check(proc.returncode == 0, f"FE CLI {extra} exit code "
                                     f"{proc.returncode}")
        (coef,) = load_linear_models_from_avro(
            os.path.join(out, "models", "part-00000.avro"), feature_file)
        return proc, wall, coef

    proc, wall, coef = cli(out)
    schema = SchemaParams(uid_column_name="uid", label_column_name="response",
                          prediction_score_column_name="predictionScore")
    md = DatasetMetadata.from_file(md_file)
    rows = {}
    for split, d in (("train", "trainingData"), ("validation",
                                                 "validationData")):
        scores = read_scores(os.path.join(out, f"{split}_scores"), schema)
        n = read_per_record(os.path.join(bag, d), md, "global").num_samples
        rows[split] = (len(scores["uid"]), n)
        _check(len(scores["uid"]) == n
               and bool(np.isfinite(scores["predictionScore"]).all()),
               f"FE CLI {split} scores: {len(scores['uid'])} rows of {n}")
    _say("cli", stage="fixed_effect", rc=proc.returncode,
         coefficients=len(coef), score_rows=rows, wall_s=f"{wall:.2f}")
    _check(len(coef) == md.num_features("global") + 1
           and bool(np.isfinite(coef).all()), "FE CLI model")
    # the same stage streamed, in a fresh process: its model's objective on
    # the training data within FE_FIT_RTOL of the eager run's
    n_train = rows["train"][1]
    chunk = max(8, n_train // 4)
    sproc, swall, scoef = cli(out + "_stream", f"--stream_chunk_rows={chunk}")
    streamed = "streamed ingestion" in sproc.stderr
    data = read_per_record(os.path.join(bag, "trainingData"), md, "global")
    f_eager, f_stream = (_fe_objective(c, data, md.num_features("global"))
                         for c in (coef, scoef))
    rel = abs(f_stream - f_eager) / abs(f_eager)
    _say("cli", stage="fixed_effect", stream_chunk_rows=chunk,
         rc=sproc.returncode, logged_streamed=streamed, f_rel=f"{rel:.2e}",
         max_abs_dcoef=f"{float(np.abs(scoef - coef).max()):.3e}",
         wall_s=f"{swall:.2f}")
    _check(streamed and rel <= FE_FIT_RTOL,
           f"streamed FE CLI: logged {streamed}, objective rel {rel}")


def _fe_objective(coef, data, d, lam=1.0):
    """The FE objective (Σ weighted logistic loss + λ/2‖w‖², intercept
    unregularized) of `coef` on `data`, in float64 through the plain
    version on the card."""
    import torch
    from gdmix_tpu_torch.ops.fe_loss_grad import fe_loss_grad_plain
    dev = torch.device(DEV)

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)
    v, _ = fe_loss_grad_plain(
        f64(coef), torch.as_tensor(data.indices, dtype=torch.int32,
                                   device=dev), f64(data.values),
        f64(data.column("response")), f64(data.column("weight", 1.0)),
        f64(data.column("offset", 0.0)), d)
    return float(v) + 0.5 * lam * float(np.sum(np.asarray(coef)[:-1] ** 2))


# ------------------------------------------------------------------ stream --

STREAM_CHUNK_ENTITIES = 16_384   # 7 chunks of the primary's 100,000
STREAM_CHUNK_ROWS = 1 << 20      # 5 chunks of FE_N, the last one short
STREAM_FE_FILES = 4
# scores of one model through two scorers: the same float32 sums
SCORE_RTOL = 1e-6


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _host_peak(fn):
    """(result, wall s, host peak bytes, device peak bytes) of fn(). The host
    peak is the process's resident set (/proc/self/statm), sampled every
    2 ms by a thread, at its highest over the call less its size at the
    start, after freed heap memory went back to the system (gc, then
    glibc's malloc_trim): every host allocation counts, PyTorch's and the
    native libraries' included. (tracemalloc, which traces each Python
    allocation, made the streamed FE decode 4-5× slower.) The device peak
    is torch.cuda.max_memory_allocated over the call."""
    import ctypes
    import gc
    import threading
    import torch
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = peak = _rss_bytes()
    done = threading.Event()

    def sample():
        nonlocal peak
        while not done.wait(0.002):
            peak = max(peak, _rss_bytes())
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        done.set()
        sampler.join()
    peak = max(peak, _rss_bytes())
    return out, wall, peak - start, torch.cuda.max_memory_allocated()


def _gib(nbytes):
    return f"{nbytes / 2**30:.3f}"


def _score_gap(file_a, file_b, schema):
    """max |Δ| of two score files' predictionScore, matched by uid, over
    max |score|; the files must hold the same uids."""
    from gdmix_tpu_torch.io.scores import read_scores
    a, b = read_scores(file_a, schema), read_scores(file_b, schema)
    oa, ob = np.argsort(a["uid"]), np.argsort(b["uid"])
    _check(np.array_equal(a["uid"][oa], b["uid"][ob]),
           f"score files {file_a} / {file_b}: other uids")
    sa, sb = a["predictionScore"][oa], b["predictionScore"][ob]
    return float(np.abs(sa - sb).max() / np.abs(sa).max()), len(sa)


def _stream_re(card, tmp):
    """The primary RE workload written as one grouped tfrecord partition,
    trained through RandomEffectLRModel.train eagerly and then in chunks of
    STREAM_CHUNK_ENTITIES; K1/K2 at every lanes tier of the first chunk's
    plan against their plain version; the streamed scorer against the
    eager one on the eager model. Returns {kernel: max |error|}."""
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.io.input_pipeline import (
        iter_per_entity_grouped_flat_chunks, write_grouped_flat)
    from gdmix_tpu_torch.ops import newton_lanes as nl
    fg = make_workload_flat(100_000, seed=0)
    data = os.path.join(tmp, "re_data")
    os.makedirs(data)
    t0 = time.perf_counter()
    write_grouped_flat(os.path.join(data, "part-00000.tfrecord"), fg,
                       "user_id", "string", "per_entity")
    write_s = time.perf_counter() - t0
    counters = (nl.newton_full, nl.newton_block)
    runs = {}
    for tag, over in (("eager", {}),
                      ("stream", dict(
                          stream_chunk_entities=STREAM_CHUNK_ENTITIES))):
        model, schema = stage_model(24, os.path.join(tmp, f"re_{tag}"),
                                    **over)
        for c in counters:
            c.launches = 0
        # ---- the main path: one train ----
        with _Records("gdmix_tpu_torch.models.random_effect_lr") as log:
            _, wall, host, dev = _host_peak(lambda: model.train(
                data, None, model.metadata_file, model.checkpoint_path,
                {constants.PARTITION_INDEX: 0}, schema))
        counts = {c.__name__: c.launches for c in counters}
        # ----
        table = model._load_weights(os.path.join(model.checkpoint_path,
                                                 "part-00000.avro"))
        lines = [r.getMessage() for r in log.records
                 if "streamed RE fit" in r.getMessage()]
        share = _converged_share(model)
        runs[tag] = dict(model=model, schema=schema, table=table,
                         lines=lines)
        _say("stream", effect="RE", run=tag, entities=len(fg),
             wall_s=f"{wall:.3f}", converged=f"{share:.6f}",
             host_peak_gib=_gib(host), device_peak_gib=_gib(dev),
             launches=counts, log=lines, card=repr(card))
        runs[tag].update(host=host, launches=counts)
        _check(share >= 0.999, f"streamed RE {tag}: converged share {share}")
        _check(counts["newton_full"] > 0, f"streamed RE {tag}: no K1 launch")
    e, st = runs["eager"]["table"], runs["stream"]["table"]
    _check(set(e) == set(st) and len(e) == len(fg),
           "streamed RE: entity sets differ")
    dmax = max(float(np.abs(e[k].theta - st[k].theta).max()) for k in e)
    n_chunks = -(-len(fg) // STREAM_CHUNK_ENTITIES)
    _say("stream", effect="RE", against="eager",
         max_abs_dtheta=f"{dmax:.3e}", write_s=f"{write_s:.3f}",
         host_peak_ratio=f"{runs['stream']['host'] / runs['eager']['host']:.3f}",
         card=repr(card))
    _check(dmax <= F32_TOL, f"streamed RE against eager: max|dθ| {dmax}")
    _check(not runs["eager"]["lines"] and len(runs["stream"]["lines"]) == 1
           and f"over {n_chunks} chunks" in runs["stream"]["lines"][0],
           f"streamed RE log: {runs['stream']['lines']}")
    _check(runs["stream"]["host"] < runs["eager"]["host"],
           "streamed RE host peak not below the eager one")
    # K1/K2 at the first chunk's lanes tiers
    model = runs["stream"]["model"]
    first = next(iter_per_entity_grouped_flat_chunks(
        data, model.metadata, "user_id", "per_entity",
        chunk_entities=STREAM_CHUNK_ENTITIES))
    worst = {"newton_full": 0.0, "newton_block": 0.0}
    for B, n, d, form in _lanes_tiers(_plan_buckets(first, 24)):
        fn = nl.newton_full if form == "warp" else nl.newton_block
        r = _lanes_row(fn, B, n, d, "stream_first_chunk_tier")
        worst[fn.__name__] = max(worst[fn.__name__], r["max_abs_err"])
    # the streamed scorer against the eager one, on the eager model
    outs = {}
    for tag in ("eager", "stream"):
        m, sch = runs[tag]["model"], runs[tag]["schema"]
        outs[tag] = os.path.join(tmp, f"re_scores_{tag}.avro")
        t0 = time.perf_counter()
        m._predict_file(data, outs[tag], sch, runs["eager"]["table"])
        outs[f"{tag}_s"] = time.perf_counter() - t0
    gap, rows = _score_gap(outs["eager"], outs["stream"],
                           runs["eager"]["schema"])
    _say("stream", effect="RE", scores="streamed against eager", rows=rows,
         rel_gap=f"{gap:.2e}", eager_s=f"{outs['eager_s']:.3f}",
         stream_s=f"{outs['stream_s']:.3f}", card=repr(card))
    _check(gap <= SCORE_RTOL, f"streamed RE scores: rel gap {gap}")
    return worst


def _write_fe_files(tmp):
    """The FE uniform batch (N = FE_N, D = FE_D, K = FE_K) from a numpy seed,
    written as STREAM_FE_FILES per-record tfrecord files by the native
    encoder; returns (directory, seconds to make, seconds to write)."""
    from gdmix_tpu_torch import native
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, FE_D, (FE_N, FE_K), dtype=np.int64)
    val = rng.standard_normal((FE_N, FE_K), dtype=np.float32)
    cols = {"uid": np.arange(FE_N, dtype=np.int64),
            "offset": (0.1 * rng.standard_normal(FE_N)).astype(np.float32),
            "response": (rng.random(FE_N) < 0.5).astype(np.float32)}
    make_s = time.perf_counter() - t0
    out = os.path.join(tmp, "fe_data")
    os.makedirs(out)
    t0 = time.perf_counter()
    nnz = np.full(FE_N // STREAM_FE_FILES + 1, FE_K, np.int32)
    for i, rows in enumerate(np.array_split(np.arange(FE_N),
                                            STREAM_FE_FILES)):
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        buf = native.encode_per_record(
            list(cols), [c[lo:hi] for c in cols.values()],
            "global_indices", "global_values", idx[lo:hi],
            val[lo:hi].astype(np.float64), nnz[:hi - lo], hi - lo)
        _check(buf is not None, "native per-record encoder unavailable")
        with open(os.path.join(out, f"part-{i:05d}.tfrecord"), "wb") as f:
            f.write(buf)
    return out, make_s, time.perf_counter() - t0


def _stream_fe(card, tmp):
    """The FE uniform batch at full size from STREAM_FE_FILES files,
    trained through FixedEffectLRModel.train eagerly and in chunks of
    STREAM_CHUNK_ROWS: the two device batches equal element for element,
    the fits within FE_FIT_RTOL, K5 on the streamed batch against its plain
    version, the streamed predict of one file against the eager one.
    Returns {kernel: max |error|}."""
    import torch
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.io.feature_list import write_feature_list
    from gdmix_tpu_torch.ops import fe_loss_grad as fe
    # the model avro names its coefficients through the feature list
    features = os.path.join(tmp, "fe_features.csv")
    write_feature_list([(f"f{i}", "") for i in range(FE_D)], features)
    model, schema = fe_stage_model(os.path.join(tmp, "fe_eager"), "auto",
                                   feature_file=features)
    data, make_s, write_s = _write_fe_files(tmp)
    _say("stream", effect="FE", N=FE_N, D=FE_D, K=FE_K,
         files=STREAM_FE_FILES, make_s=f"{make_s:.3f}",
         write_s=f"{write_s:.3f}", card=repr(card))
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    runs = {}
    for tag, over in (("eager", {}),
                      ("stream", dict(stream_chunk_rows=STREAM_CHUNK_ROWS))):
        if tag != "eager":
            model, schema = fe_stage_model(os.path.join(tmp, f"fe_{tag}"),
                                           "auto", feature_file=features,
                                           **over)
        fe.fe_loss_grad_fused.launches = 0
        # ---- the main path: one train ----
        _, wall, host, dev = _host_peak(lambda: model.train(
            data, None, model.metadata_file, model.checkpoint_path, ctx,
            schema))
        k5 = fe.fe_loss_grad_fused.launches
        # ----
        lf, ing = model.last_fit, model.last_ingest
        extra = {}
        if ing:
            extra = dict(chunks=ing["chunks"], k=ing["k"],
                         decode_s=[round(t, 3) for t in ing["decode_s"]],
                         upload_s=[round(t, 3) for t in ing["upload_s"]])
        _say("stream", effect="FE", run=tag, wall_s=f"{wall:.3f}",
             fit_s=f"{lf['seconds']:.3f}", iterations=lf["iterations"],
             funcalls=lf["funcalls"], converged=lf["converged"],
             f=f"{lf['f']:.6f}", host_peak_gib=_gib(host),
             device_peak_gib=_gib(dev), launches={"fe_loss_grad_fused": k5},
             card=repr(card), **extra)
        _check(lf["converged"] and k5 > 0,
               f"FE {tag}: not converged or no K5 launch ({k5})")
        runs[tag] = dict(model=model, schema=schema, host=host, f=lf["f"],
                         batch=model._train_batch_cache)
    (eb, euid, en), (sb, suid, sn) = (runs[t]["batch"]
                                      for t in ("eager", "stream"))
    same = (en == sn == FE_N and np.array_equal(euid, suid)
            and all(torch.equal(getattr(eb, k), getattr(sb, k))
                    for k in eb._fields))
    rel = abs(runs["stream"]["f"] - runs["eager"]["f"]) / abs(
        runs["eager"]["f"])
    coef = {t: runs[t]["model"].model_coefficients for t in runs}
    _say("stream", effect="FE", against="eager", batch_equal=same,
         f_rel=f"{rel:.2e}",
         max_abs_dcoef=f"{float(np.abs(coef['stream'] - coef['eager']).max()):.3e}",
         chunks=runs["stream"]["model"].last_ingest["chunks"],
         host_peak_ratio=f"{runs['stream']['host'] / runs['eager']['host']:.3f}",
         card=repr(card))
    _check(same, "streamed FE batch differs from the eager batch")
    _check(runs["stream"]["model"].last_ingest["chunks"]
           == -(-FE_N // STREAM_CHUNK_ROWS), "streamed FE chunk count")
    _check(rel <= FE_FIT_RTOL, f"streamed FE fit against eager: f rel {rel}")
    _check(runs["stream"]["host"] < runs["eager"]["host"],
           "streamed FE host peak not below the eager one")
    # at a seeded θ: at the fit's optimum max|g| is ~0 and a relative
    # gradient error says nothing
    x = torch.as_tensor(np.random.RandomState(FE_D).randn(FE_D + 1) * 0.01,
                        dtype=torch.float32, device=DEV)
    _, err, _ = _fe_fused_row("stream_batch", (
        x, sb.indices, sb.values, sb.labels, sb.weights, sb.offsets, FE_D))
    del eb, sb, runs["eager"]["batch"], runs["stream"]["batch"]
    for tag in runs:
        runs[tag]["model"]._train_batch_cache = None
    # streamed predict of one file against the eager predict, eager model
    one = os.path.join(data, "part-00001.tfrecord")
    outs = {}
    for tag, over in (("eager", {}),
                      ("stream", dict(stream_chunk_rows=STREAM_CHUNK_ROWS
                                      // 4))):
        m, sch = fe_stage_model(os.path.join(tmp, "fe_eager"), "auto",
                                feature_file=features, **over)
        outs[tag] = os.path.join(tmp, f"fe_predict_{tag}")
        t0 = time.perf_counter()
        m.predict(outs[tag], one, m.metadata_file, m.checkpoint_path,
                  {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1}, sch)
        outs[f"{tag}_s"] = time.perf_counter() - t0
    gap, rows = _score_gap(outs["eager"], outs["stream"], sch)
    _say("stream", effect="FE", scores="streamed predict against eager",
         rows=rows, rel_gap=f"{gap:.2e}", eager_s=f"{outs['eager_s']:.3f}",
         stream_s=f"{outs['stream_s']:.3f}", card=repr(card))
    _check(gap <= SCORE_RTOL, f"streamed FE predict: rel gap {gap}")
    return {"fe_loss_grad_fused": err}


def _theta0_kept(fn, n):
    """K1 or K2 restarted from its own result: every entity that passes the
    gradient test before its first step (0 iterations) comes back with θ0
    bit for bit, the condition of the downlink skip. Returns how many."""
    import torch
    dev = torch.device(DEV)
    kw = dict(lam=1.0, unreg_bias=True, maxiter=100, ftol=1e-12, pgtol=1e-5)
    X, y, w, off, cnt = (torch.from_numpy(a).to(dev)
                         for a in lr_problem(4096, n, 25, seed=n))
    th, _, _ = fn(torch.zeros(X.shape[0], 25, device=dev), X, y, w, off, cnt,
                  **kw)
    th2, _, it2 = fn(th, X, y, w, off, cnt, **kw)
    at_start = it2 == 0
    kept = int(at_start.sum())
    _check(kept > 0 and torch.equal(th2[at_start], th[at_start]),
           f"{fn.__name__}: θ0 not returned bit for bit at the gradient "
           f"test ({kept} entities)")
    return kept


def _stream_cache(card, tmp):
    """The RE sweep cache and the downlink skip on the primary workload: a
    cold fit_flat into a cache; a refit on offsets shifted by 0.25 with the
    cache (no static upload) and without it (bit-equal); a warm refit on
    unchanged data with the skip (one host read of the probe; skipped
    buckets' rows equal the prior's) and without it (F32_TOL)."""
    import dataclasses
    import torch
    from gdmix_tpu_torch.models import random_effect_lr as RE
    from gdmix_tpu_torch.ops import newton_lanes as nl
    kept = {fn.__name__: _theta0_kept(fn, n)
            for fn, n in ((nl.newton_full, 16), (nl.newton_block, 256))}
    fg = make_workload_flat(100_000, seed=0)
    model, schema = stage_model(24, os.path.join(tmp, "cache"))
    cache = {}
    cold = model.fit_flat(fg, {}, schema, device_cache=cache)
    uploads = model.static_upload_count
    shifted = dataclasses.replace(fg, columns=dict(
        fg.columns, offset=fg.columns["offset"] + 0.25))

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            k: round(v, 4) for k, v in model.last_fit_phases.items()}
    cached, cached_s, cached_ph = timed(lambda: model.fit_flat(
        shifted, cold, schema, device_cache=cache))
    cached_uploads = model.static_upload_count - uploads
    uncached, uncached_s, uncached_ph = timed(lambda: model.fit_flat(
        shifted, cold, schema))
    bit_equal = (list(cached.ids) == list(uncached.ids)
                 and np.array_equal(cached.coef_vals, uncached.coef_vals)
                 and np.array_equal(cached.icpt, uncached.icpt))
    # the warm refit: probe read counted, skipped buckets captured
    moved_flags = RE._moved_flags
    probe = _sync_counted(moved_flags)
    calls, skipped = [], []
    collect = model._collect_bucket_table

    def collect_spy(bucket, theta, variance):
        if isinstance(theta, np.ndarray):
            skipped.append(list(bucket.entity_ids))
        return collect(bucket, theta, variance)
    RE._moved_flags = lambda solved: calls.append(len(solved)) or probe(
        solved)
    model._collect_bucket_table = collect_spy
    try:
        warm, warm_s, warm_ph = timed(lambda: model.fit_flat(fg, cold,
                                                             schema))
        n_skipped = model.last_fit_skipped
        RE._moved_flags = lambda solved: [True] * len(solved)
        noskip, noskip_s, noskip_ph = timed(lambda: model.fit_flat(
            fg, cold, schema))
    finally:
        RE._moved_flags = moved_flags
        del model._collect_bucket_table
    n_buckets = calls[0] if calls else 0
    rows_equal = all(np.array_equal(warm[e].theta, cold[e].theta)
                     for ids in skipped for e in ids)
    # entities whose model the warm refit moved off the prior (the skip
    # needs every entity of a bucket unmoved)
    _check(list(warm.ids) == list(cold.ids), "RE warm refit: other ids")
    owner = np.repeat(np.arange(len(warm)), warm.lens)
    moved = (warm.icpt != cold.icpt) | (np.bincount(
        owner, weights=warm.coef_vals != cold.coef_vals,
        minlength=len(warm)) > 0)
    dmax = max(float(np.abs(warm.coef_vals - noskip.coef_vals).max()),
               float(np.abs(warm.icpt - noskip.icpt).max()))
    _say("stream", cache="RE primary", static_uploads_cold=uploads,
         static_uploads_cached_refit=cached_uploads, bit_equal=bit_equal,
         cached_s=f"{cached_s:.3f}", cached_phases=cached_ph,
         uncached_s=f"{uncached_s:.3f}", uncached_phases=uncached_ph,
         card=repr(card))
    _say("stream", skip="RE primary warm refit", probe_calls=len(calls),
         probe_host_reads=dict(probe.reads),
         skipped=f"{n_skipped} of {n_buckets}",
         skipped_entities=sum(map(len, skipped)), rows_equal=rows_equal,
         moved_entities=int(moved.sum()),
         max_abs_dtheta_vs_noskip=f"{dmax:.3e}", skip_s=f"{warm_s:.3f}",
         skip_phases=warm_ph, noskip_s=f"{noskip_s:.3f}",
         noskip_phases=noskip_ph, theta0_kept_at_gradient_test=kept,
         card=repr(card))
    _check(uploads == len(cache) > 0 and cached_uploads == 0,
           f"RE cache: {uploads} cold uploads, {cached_uploads} cached")
    _check(bit_equal, "RE cached refit differs from the uncached one")
    _check(len(calls) == 1 and sum(probe.reads.values()) == 1,
           f"RE moved probe: {len(calls)} calls, {dict(probe.reads)} reads")
    _check(n_skipped == len(skipped) and rows_equal,
           "RE skipped buckets: rows differ from the prior's")
    _check(dmax <= F32_TOL, f"RE skip against no skip: max|dθ| {dmax}")


def phase_stream(card):
    """Out-of-core ingestion and the RE sweep cache at full width
    (_stream_re, _stream_fe, _stream_cache). Returns {kernel: max |error|}
    of the kernel checks at the streamed path's shapes."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_stream_") as tmp:
        errs = _stream_re(card, tmp)
        errs.update(_stream_fe(card, tmp))
        _stream_cache(card, tmp)
    _say("stream", phase_s=f"{time.perf_counter() - t0:.3f}",
         card=repr(card))
    return errs


# ----------------------------------------------------------------- sharded --

SHARDED_MESHES = (2, 4)   # cuda:0 repeated: the P > 1 exchange on one card
SHARDED_WARM_ROUNDS = 6   # warm primary fits of each plane, in turns
# the sharded pipeline against the host one, per coordinate: the JAX
# package's bound between its two planes (tests/test_in_memory_pipeline.py:
# 53-54)
SHARDED_AUC_ATOL = 1e-4


def _repeated_mesh(p):
    import torch
    from gdmix_tpu_torch.parallel.mesh import Mesh
    return Mesh((torch.device(DEV),) * p)


@contextlib.contextmanager
def _mesh_of(mesh):
    """The RE model's mesh (get_mesh) is `mesh` inside the block."""
    from gdmix_tpu_torch.models import random_effect_lr as RE
    orig = RE.get_mesh
    RE.get_mesh = lambda device=None: mesh
    try:
        yield
    finally:
        RE.get_mesh = orig


def _re_run(fn):
    """(fn(), wall seconds, launches by RE kernel) with every RE count
    zeroed just before."""
    import torch
    for c in _re_counters():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            {c.__name__: c.launches for c in _re_counters()})


def _table_gap(a, b, ids=None):
    """max |Δθ| between two model tables over `ids` (every id of `a` when
    None); their ids and each entity's support must be the same."""
    from gdmix_tpu_torch.io.model_table import flat_positions
    _check(sorted(a.ids) == sorted(b.ids), "the planes trained other ids")
    ids = a.ids if ids is None else ids
    ra = np.fromiter((a.id2row[e] for e in ids), np.int64, len(ids))
    rb = np.fromiter((b.id2row[e] for e in ids), np.int64, len(ids))
    _check(np.array_equal(a.lens[ra], b.lens[rb]), "supports differ")
    pa = flat_positions(a.offs[ra], a.lens[ra])
    pb = flat_positions(b.offs[rb], b.lens[rb])
    _check(np.array_equal(a.coef_ids[pa], b.coef_ids[pb]),
           "support feature ids differ")
    return max(float(np.abs(a.coef_vals[pa] - b.coef_vals[pb]).max(
        initial=0.0)), float(np.abs(a.icpt[ra] - b.icpt[rb]).max(
            initial=0.0)))


def _lanes_want(model):
    """{kernel: launches} a sharded fit of `model` makes on the lanes path:
    one a tier of its form on each shard (every tier on the primal rung)."""
    from gdmix_tpu_torch.ops import newton_lanes as nl
    lay = model.last_fit_sharding
    want = {"newton_full": 0, "newton_block": 0}
    for _, n, dim in lay["tiers"]:
        if dim <= nl.MAX_DIM:
            k = ("newton_full" if nl.lanes_form(n, dim) == "warp"
                 else "newton_block")
            want[k] += lay["shards"]
    return want


def _captured_lanes(record):
    """newton.newton_lr_batch_lanes wrapped to append each call's kernel
    inputs, (θ0, X, y, w, off, counts) as the wrapper converts them, to
    `record`. Returns the original."""
    import torch
    from gdmix_tpu_torch.ops import newton
    orig = newton.newton_lr_batch_lanes

    def lanes(theta0, X, labels, weights, offsets, counts, **kw):
        f32 = torch.float32
        record.append((theta0.to(f32).contiguous(), X.to(f32).contiguous(),
                       labels.to(f32).contiguous(),
                       weights.to(f32).contiguous(),
                       offsets.to(f32).contiguous(),
                       torch.clamp_min(counts.to(f32), 1.0).contiguous()))
        return orig(theta0, X, labels, weights, offsets, counts, **kw)
    newton.newton_lr_batch_lanes = lanes
    return orig


def _sharded_primary(card, tmp, launches):
    """Parts 1 and 2 of phase_sharded: the primary on both planes (P = 1),
    then on meshes repeating the card. Returns (workload, model, schema)
    for the cache refit."""
    fg = make_workload_flat(100_000, seed=0)
    model, schema = stage_model(24, os.path.join(tmp, "primary"))
    planes = ("sharded", "host")
    res = {}
    for mode in planes:
        model.model_params.re_mode = mode
        # ---- the main path (sharded): a cold fit at P = 1 ----
        table, cold_s, got = _re_run(lambda: model.fit_flat(fg, {}, schema))
        # ----
        sharded = mode == "sharded"
        res[mode] = dict(
            table=table, cold_s=cold_s, launches=got,
            cold_phases={k: round(v, 4)
                         for k, v in model.last_fit_phases.items()},
            share=_converged_share(model),
            layout=dict(model.last_fit_sharding) if sharded else {},
            want=_lanes_want(model) if sharded else None, warm=[],
            phases=[])
    # warm fits in turns, S H then H S, on one card in one call
    for r in range(SHARDED_WARM_ROUNDS):
        for mode in (planes if r % 2 == 0 else planes[::-1]):
            model.model_params.re_mode = mode
            _, w, _ = _re_run(lambda: model.fit_flat(fg, {}, schema))
            res[mode]["warm"].append(w)
            res[mode]["phases"].append(dict(model.last_fit_phases))
    for mode in planes:
        r = res[mode]
        model.model_params.re_mode = mode
        prof_s, busy_ms = _profiled(lambda: model.fit_flat(fg, {}, schema))
        idle = (f"{1 - busy_ms / (1e3 * prof_s):.4f}" if busy_ms > 0
                else "not measured")
        r["warm_s"] = float(np.median(r["warm"]))
        _say("sharded", workload="primary", plane=mode, shards=1,
             entities=len(fg), converged=f"{r['share']:.6f}",
             cold_s=f"{r['cold_s']:.4f}", cold_phases=r["cold_phases"],
             warm_s_median=f"{r['warm_s']:.4f}",
             warm_s=[round(w, 4) for w in r["warm"]],
             warm_phases_median={k: round(float(np.median(
                 [ph[k] for ph in r["phases"]])), 4)
                 for k in r["phases"][0]},
             launches=r["launches"], tiers_B_n_dim=r["layout"].get("tiers"),
             capacity=r["layout"].get("capacity"),
             profiled_s=f"{prof_s:.4f}", device_busy_ms=f"{busy_ms:.2f}",
             idle_share=idle, card=repr(card))
        _check(r["share"] >= 0.999,
               f"primary {mode}: converged share {r['share']}")
    got, want = res["sharded"]["launches"], res["sharded"]["want"]
    launches.update(got)
    _check({k: got[k] for k in want} == want,
           f"primary sharded: lanes launches {got}, tiers {want}")
    gap = _table_gap(res["sharded"]["table"], res["host"]["table"])
    _say("sharded", workload="primary", compare="sharded vs host",
         max_abs_dtheta=f"{gap:.3e}",
         warm_ratio_sharded_over_host="{:.3f}".format(
             res["sharded"]["warm_s"] / res["host"]["warm_s"]),
         sharded_faster_in_pairs="{} of {}".format(
             sum(a < b for a, b in zip(res["sharded"]["warm"],
                                       res["host"]["warm"])),
             SHARDED_WARM_ROUNDS), card=repr(card))
    _check(gap <= F32_TOL, f"primary: sharded vs host max|dθ| {gap}")
    p1 = res["sharded"]["table"]
    model.model_params.re_mode = "sharded"
    for p in SHARDED_MESHES:
        with _mesh_of(_repeated_mesh(p)):
            table, wall, got = _re_run(lambda: model.fit_flat(fg, {},
                                                              schema))
            want = _lanes_want(model)
            layout = dict(model.last_fit_sharding)
            _, warm_s, _ = _re_run(lambda: model.fit_flat(fg, {}, schema))
        launches.update(got)
        gap = _table_gap(table, p1)
        _say("sharded", workload="primary", shards=p,
             mesh=f"{DEV} x{p} (one card: no launch crosses a device)",
             cold_s=f"{wall:.4f}", warm_s=f"{warm_s:.4f}",
             phases={k: round(v, 4)
                     for k, v in model.last_fit_phases.items()},
             capacity=layout["capacity"], tiers_B_n_dim=layout["tiers"],
             launches=got, max_abs_dtheta_vs_p1=f"{gap:.3e}",
             converged=f"{_converged_share(model):.6f}", card=repr(card))
        _check(gap <= F32_TOL, f"primary P={p} vs P=1: max|dθ| {gap}")
        _check({k: got[k] for k in want} == want,
               f"primary P={p}: lanes launches {got}, want {want}")
    return fg, model, schema


def _sharded_heavy_tail(card, tmp, launches, errs):
    """Part 3: the heavy tail through the sharded plane against the host
    plane; K1 and K2 at the sharded plane's own largest-B tier of each,
    on the arrays it packed, against their plain version."""
    from gdmix_tpu_torch.ops import newton, newton_lanes as nl
    fg = heavy_tail_workload()
    model, schema = stage_model(24, os.path.join(tmp, "heavy"),
                                re_mode="sharded")
    record = []
    orig = _captured_lanes(record)
    try:
        # ---- the main path: the sharded fit ----
        table, wall, got = _re_run(lambda: model.fit_flat(fg, {}, schema))
        # ----
    finally:
        newton.newton_lr_batch_lanes = orig
    launches.update(got)
    want = _lanes_want(model)
    share = _converged_share(model)
    layout = dict(model.last_fit_sharding)
    model.model_params.re_mode = "host"
    host, host_s, host_got = _re_run(lambda: model.fit_flat(fg, {},
                                                            schema))
    gap = _table_gap(table, host)
    _say("sharded", workload="heavy_tail", entities=len(fg),
         converged=f"{share:.6f}", sharded_s=f"{wall:.4f}",
         host_s=f"{host_s:.4f}", tiers_B_n_dim=layout["tiers"],
         capacity=layout["capacity"], launches=got, host_launches=host_got,
         max_abs_dtheta_vs_host=f"{gap:.3e}", card=repr(card))
    _check(share >= 0.999, f"heavy tail sharded: converged share {share}")
    _check(gap <= F32_TOL, f"heavy tail: sharded vs host max|dθ| {gap}")
    _check({k: got[k] for k in want} == want,
           f"heavy tail sharded: lanes launches {got}, want {want}")
    largest = {}
    for inputs in record:
        _, n, dim = inputs[1].shape
        fn = nl.newton_full if nl.lanes_form(n, dim) == "warp" \
            else nl.newton_block
        if inputs[1].shape[0] >= largest.get(fn, (0,))[0]:
            largest[fn] = (inputs[1].shape[0], inputs)
    _check(set(largest) == {nl.newton_full, nl.newton_block},
           f"heavy tail sharded: lanes forms {set(largest)}")
    for fn, (B, inputs) in largest.items():
        _, n, dim = inputs[1].shape
        r = _lanes_row(fn, B, n, dim, "sharded_heavy_tail_tier",
                       inputs=inputs)
        errs[fn.__name__] = max(errs.get(fn.__name__, 0.0),
                                r["max_abs_err"])


def _sharded_cuts(card, tmp, launches):
    """Part 4: the wide-support and support_120 cuts through both planes:
    the rungs each took, max|Δθ| over the well-posed entities (16+ records
    of both classes), ≤ F32_TOL; the RE kernels' launches of the sharded
    fits (K3/K4 where the ladder takes them)."""
    for tag, fg, d in (("wide_support",
                        make_workload_flat(4096, seed=2, d=512, max_nnz=16,
                                           count_lo=32, count_hi=64), 512),
                       ("support_120", support_120_workload(), 120)):
        model, schema = stage_model(d, os.path.join(tmp, tag),
                                    re_mode="sharded")
        # ---- the main path: the sharded fit ----
        table, wall, got = _re_run(lambda: model.fit_flat(fg, {}, schema))
        # ----
        launches.update(got)
        rungs, share = dict(model.last_fit_rungs), _converged_share(model)
        layout = dict(model.last_fit_sharding)
        model.model_params.re_mode = "host"
        host, host_s, host_got = _re_run(lambda: model.fit_flat(fg, {},
                                                                schema))
        ids = np.asarray(fg.entity_ids)[_well_posed_rows(fg)]
        gap = _table_gap(table, host, ids)
        _say("sharded", workload=tag, entities=len(fg),
             sharded_rungs=rungs, host_rungs=model.last_fit_rungs,
             converged=f"{share:.6f}",
             host_converged=f"{_converged_share(model):.6f}",
             sharded_s=f"{wall:.4f}", host_s=f"{host_s:.4f}",
             tiers_B_n_dim=layout["tiers"], launches=got,
             host_launches=host_got, compared=len(ids),
             max_abs_dtheta_vs_host=f"{gap:.3e}", card=repr(card))
        _check(share >= 0.999, f"{tag} sharded: converged share {share}")
        _check(gap <= F32_TOL, f"{tag}: sharded vs host max|dθ| {gap}")


def _sharded_cache(card, fg, model, schema):
    """Part 5: a refit of the primary on offsets + 0.3 through the sharded
    device cache against the same refit without it: bit for bit, no
    static upload."""
    import dataclasses
    model.model_params.re_mode = "sharded"
    cache = {}
    cold = model.fit_flat(fg, {}, schema, device_cache=cache)
    before = model.static_upload_count
    shifted = dataclasses.replace(fg, columns=dict(
        fg.columns, offset=fg.columns["offset"] + 0.3))
    cached, cached_s, _ = _re_run(lambda: model.fit_flat(
        shifted, cold, schema, device_cache=cache))
    cached_phases = {k: round(v, 4) for k, v in
                     model.last_fit_phases.items()}
    uploads = model.static_upload_count - before
    uncached, uncached_s, _ = _re_run(lambda: model.fit_flat(
        shifted, cold, schema))
    equal = (list(cached.ids) == list(uncached.ids)
             and np.array_equal(cached.coef_vals, uncached.coef_vals)
             and np.array_equal(cached.icpt, uncached.icpt))
    _say("sharded", cache="primary refit, offsets + 0.3",
         static_upload_count=before, static_uploads_cached_refit=uploads,
         bit_equal=equal, cached_s=f"{cached_s:.4f}",
         cached_phases=cached_phases, uncached_s=f"{uncached_s:.4f}",
         uncached_phases={k: round(v, 4) for k, v in
                          model.last_fit_phases.items()}, card=repr(card))
    _check(before == 1 and uploads == 0,
           f"sharded cache: {before} cold uploads, {uploads} cached")
    _check(equal, "sharded cached refit differs from the uncached one")


def _sharded_pipeline(card, tmp, ml, launches):
    """Part 6: the in-memory movieLens pipeline (phase 6's config) through
    `--re_mode sharded` against `--re_mode host`, AUC within
    SHARDED_AUC_ATOL per coordinate; then the trainer CLI's RE stage with
    --re_mode=sharded in a fresh process."""
    import yaml
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.workflow.main import main as workflow_main
    planes = []
    orig = RandomEffectLRModel.fit_records_sharded

    def spy(self, *a, **k):
        planes.append(self.model_params.partition_entity)
        return orig(self, *a, **k)
    runs = {}
    for mode in ("sharded", "host"):
        cfg_path = os.path.join(tmp, f"movielens_{mode}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(movielens_config(
                ml, os.path.join(tmp, f"out_{mode}")), f, sort_keys=False)
        RandomEffectLRModel.fit_records_sharded = spy
        try:
            # ---- the main path (sharded): the pipeline ----
            runs[mode] = _re_run(lambda: workflow_main(
                ["--config_path", cfg_path, "--mode", "in_memory",
                 "--num_sweeps", "2", "--re_mode", mode]))
            # ----
        finally:
            RandomEffectLRModel.fit_records_sharded = orig
        if mode == "sharded":
            launches.update(runs[mode][2])
    (sm, s_wall, s_got), (hm, h_wall, h_got) = runs["sharded"], runs["host"]
    gaps = {c: abs(sm[c] - hm[c]) for c in COORDINATES}
    _say("sharded", pipeline="in_memory --num_sweeps 2",
         auc_sharded={k: round(v, 6) for k, v in sm.items()},
         auc_host={k: round(v, 6) for k, v in hm.items()},
         auc_gap={k: f"{v:.2e}" for k, v in gaps.items()},
         sharded_fits=planes, wall_sharded_s=f"{s_wall:.3f}",
         wall_host_s=f"{h_wall:.3f}", launches=s_got, card=repr(card))
    _check(planes == ["user_id", "movie_id"] * 2,
           f"the pipeline's RE fits took another plane: {planes}")
    _check(max(gaps.values()) <= SHARDED_AUC_ATOL,
           f"sharded pipeline vs host: AUC gaps {gaps}")
    _check(s_got["newton_full"] > 0, f"sharded pipeline: {s_got}")
    cli_tmp = os.path.join(tmp, "cli_sharded")
    os.makedirs(cli_tmp)
    err = _cli_re_stage(cli_tmp, "sharded", ("--re_mode=sharded",))
    fits = [ln for ln in err.splitlines() if "sharded fit:" in ln]
    _check(len(fits) == 1, "the CLI's RE stage did not take the sharded "
                           "plane")
    kl = [ln for ln in err.splitlines() if "kernel launches:" in ln]
    cli_launches = json.loads(kl[-1].split("kernel launches:", 1)[1])
    _say("sharded", cli_fit=fits[0].split("sharded fit:", 1)[1].strip(),
         cli_launches=cli_launches)
    _check(cli_launches.get("newton_full", 0) > 0,
           f"the CLI's sharded stage never launched K1: {cli_launches}")


def phase_sharded(card, tmp, ml):
    """The entity-sharded RE plane (re_mode="sharded") on the card, parts
    1–6 (_sharded_primary, _sharded_heavy_tail, _sharded_cuts,
    _sharded_cache, _sharded_pipeline). Returns ({kernel: max |error|} of
    its K1/K2 rows, {kernel: launches} of its main-path runs)."""
    from collections import Counter
    t0 = time.perf_counter()
    launches, errs = Counter(), {}
    sub = os.path.join(tmp, "sharded")
    os.makedirs(sub)
    fg, model, schema = _sharded_primary(card, sub, launches)
    _sharded_heavy_tail(card, sub, launches, errs)
    _sharded_cuts(card, sub, launches)
    _sharded_cache(card, fg, model, schema)
    _sharded_pipeline(card, sub, ml, launches)
    _say("sharded", launches=dict(launches),
         phase_s=f"{time.perf_counter() - t0:.3f}", card=repr(card))
    _check(launches["newton_full"] > 0 and launches["newton_block"] > 0,
           f"the sharded phase skipped K1 or K2: {dict(launches)}")
    return errs, launches


# ------------------------------------------------------------ multiprocess --

MP_PROCS = 2              # processes sharing the one card over gloo
MP_TOWER_EPOCHS = 3
# The model-API FE cells: (name, ids, D, FixedLRParams overrides, θ held).
# Two processes against one: each process sums its own rows' loss and
# gradient, then one all-reduce adds them, so the fits are held to the FE
# limits: the loss within FE_LOSS_RTOL and θ within FE_GRAD_RTOL·max|θ|. A
# float32 fit stops where float32 no longer sees f fall (f ≈ 3.5e6 steps
# by 0.25, ops/lbfgs.py), which leaves θ loose along flat directions in
# any two runs, one process or two: there θ's gap is printed, and θ is
# held on a float64 twin of the uniform cell stopped by its gradient alone
# (ftol 0, ‖g‖∞ ≤ 1e-6: θ then sits within 1e-6 / λ_min(H) of the optimum)
MP_FE_CELLS = (
    ("uniform", "uniform", FE_D, {}, False),
    ("uniform_f64", "uniform", FE_D,
     dict(dtype="float64", lbfgs_tolerance=0.0, lbfgs_pgtol=1e-6,
          num_of_lbfgs_iterations=500), True),
    ("wide_d", "zipf", WIDE_D,
     dict(l2_reg_weight=WIDE_D_CONVERGED_LAMBDA), False),
)
# The pipelines' AUC within MODES_AUC_ATOL (the JAX package's bound,
# tests/test_multiprocess_pipeline.py:45). The tower cells: (dtype, AUC
# bound, max|Δscore| bound relative to max|score| or None). Each step's sums
# run in two halves, and on the card the embedding's and cuDNN's backward
# add with atomics, so a rounding-level gradient noise enters every step;
# Adam divides each coordinate by its own running RMS and turns noise-level
# coordinates into steps of up to the learning rate. In float32 the scores
# part by a few percent of max|score| over MP_TOWER_EPOCHS epochs (one
# process against itself as well) while the ranking agrees: the AUC is
# held, the score gap printed. In float64 the noise is 1e-16 and both are
# held at 1e-6. The JAX package's own test asks for a 0.98 correlation
# and 0.05 of AUC (tests/test_deep_tower.py:201).
MP_TOWER_CELLS = (("float32", 2e-3, None), ("float64", 1e-6, 1e-6))
MP_TIMEOUT_S = 600


def _records_of(b, rows=None):
    """A SparseBatch on the card as the PerRecordData a model loads, its
    uids the row numbers; `rows` selects rows."""
    from gdmix_tpu_torch.io.input_pipeline import PerRecordData
    sel = slice(None) if rows is None else rows
    n = int(b.labels.shape[0])
    uid = np.arange(n, dtype=np.int64)[sel]
    return PerRecordData(
        columns={"uid": uid, "response": b.labels.cpu().numpy()[sel],
                 "offset": b.offsets.cpu().numpy()[sel]},
        indices=b.indices.cpu().numpy()[sel],
        values=b.values.cpu().numpy()[sel], num_samples=len(uid))


def _theta_sha(coef) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(coef).tobytes()).hexdigest()


def _mp_env(rank, port):
    env = dict(os.environ)
    env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               NUM_PROCESSES=str(MP_PROCS), PROCESS_ID=str(rank),
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return env


def _mp_run(argv, what):
    """MP_PROCS processes of `argv` under the JAX package's environment
    contract on a free port; (outputs in rank order, wall seconds). A
    process that fails or outlives MP_TIMEOUT_S fails the smoke; every
    process is gone on return."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=_mp_env(r, port), cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MP_PROCS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:], flush=True)
        _check(p.returncode == 0, f"multiprocess {what}: process {r} exited "
                                  f"{p.returncode}")
    return outs, wall


def _log_json(out, marker):
    """The JSON after the last `marker` in a process's output."""
    line = out.rsplit(marker, 1)[1].splitlines()[0]
    return json.loads(line)


def _mp_problem(cell, ids, d, over):
    import torch
    dtype = torch.float64 if over.get("dtype") == "float64" else None
    return fe_problem(ids, seed=3 if cell == "wide_d" else 0, d=d,
                      dtype=dtype)


def _mp_child_fe(tmp, rank):
    """The child's FE fits through the model API on rows rank::MP_PROCS of
    the full-width batches (MP_FE_CELLS), the float32 uniform cell
    profiled (the device's busy share of this process's fit)."""
    import torch
    from gdmix_tpu_torch.gdmix import kernel_launches
    out = {}
    for cell, ids, d, over, _ in MP_FE_CELLS:
        b = _mp_problem(cell, ids, d, over)
        data = _records_of(b, np.arange(rank, FE_N, MP_PROCS))
        del b
        model, schema = fe_stage_model(os.path.join(tmp, f"{cell}{rank}"),
                                       "auto", d=d, sparsity_threshold=0.0,
                                       **over)
        _zero_launches()
        # ---- the main path: one fit on this process's rows ----
        if cell == "uniform":
            wall, busy_ms = _profiled(lambda: model.fit_data(data, schema))
        else:
            t0 = time.perf_counter()
            model.fit_data(data, schema)
            torch.cuda.synchronize()
            wall, busy_ms = time.perf_counter() - t0, None
        launches = {k: v for k, v in kernel_launches().items() if v}
        # ----
        lf = model.last_fit
        out[cell] = dict(
            rows=data.num_samples, f=lf["f"], funcalls=lf["funcalls"],
            iterations=lf["iterations"], converged=lf["converged"],
            fit_s=lf["seconds"], wall_s=wall, allreduce_s=lf["allreduce_s"],
            allreduce_calls=lf["allreduce_calls"],
            idle=None if busy_ms is None else 1 - busy_ms / 1e3 / wall,
            sha=_theta_sha(model.model_coefficients),
            coef=model.model_coefficients.tolist(), launches=launches)
        del data, model
    return out


def _mp_child_pipelines(a):
    """The in-memory movieLens-100K pipeline, 2 sweeps, on each RE plane."""
    import torch
    from gdmix_tpu_torch.gdmix import kernel_launches
    from gdmix_tpu_torch.workflow.config import WorkflowConfig
    from gdmix_tpu_torch.workflow.pipeline import InMemoryPipeline
    out = {}
    for plane in ("host", "sharded"):
        pipe = InMemoryPipeline(WorkflowConfig.from_file(a[plane]),
                                num_sweeps=2, re_mode=plane)
        _zero_launches()
        # ---- the main path ----
        t0 = time.perf_counter()
        metrics = pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernel_launches().items() if v}
        # ----
        out[plane] = dict(metrics=metrics, wall_s=wall,
                          exchanges=pipe.exchanges, launches=launches)
    return out


def _zero_launches():
    for c in _re_counters() + _hybrid_counters():
        c.launches = 0


def _mp_child_tower(a, ctx):
    """The deep tower (cnn, batch 512) trained data parallel, each
    MP_TOWER_CELLS dtype."""
    import torch
    import yaml
    from gdmix_tpu_torch.gdmix import kernel_launches
    with open(a["tower"]) as f:
        cfg = yaml.safe_load(f)
    out = {}
    for dtype, _, _ in MP_TOWER_CELLS:
        model, base = _detext_model(cfg, f"{a['tower_out']}_{dtype}",
                                    dtype=dtype)
        _zero_launches()
        # ---- the main path ----
        t0 = time.perf_counter()
        model.train(model.training_data_dir, model.validation_data_dir,
                    model.metadata_file, model.checkpoint_path, ctx, base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernel_launches().items() if v}
        # ----
        out[dtype] = dict(wall_s=wall, fit=model.last_fit,
                          launches=launches)
    return out


def _mp_child(args):
    """One process of the multiprocess phase's model-API group: joins the
    job of its environment (workflow/distributed.py), then runs the FE
    fits, the pipelines and the tower, and prints its results as one
    `MP_RESULT {json}` line."""
    global DEV
    import torch
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.workflow.distributed import \
        maybe_initialize_distributed
    a = json.loads(args[0])
    joined = maybe_initialize_distributed()
    DEV = joined["device"]
    rank = joined["process_id"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(torch.device(DEV))
    ctx = {constants.TASK_INDEX: rank,
           constants.NUM_WORKERS: joined["num_processes"],
           constants.IS_CHIEF: rank == 0}
    res = dict(joined, card=card, fe=_mp_child_fe(a["tmp"], rank),
               pipelines=_mp_child_pipelines(a),
               tower=_mp_child_tower(a, ctx))
    print("MP_RESULT " + json.dumps(res), flush=True)


def _mp_fe_reference(tmp):
    """The one-process fits of the FE cells, in this process."""
    ref = {}
    for cell, ids, d, over, _ in MP_FE_CELLS:
        b = _mp_problem(cell, ids, d, over)
        data = _records_of(b)
        del b
        model, schema = fe_stage_model(os.path.join(tmp, f"{cell}_one"),
                                       "auto", d=d, sparsity_threshold=0.0,
                                       **over)
        model.fit_data(data, schema)
        ref[cell] = dict(f=model.last_fit["f"],
                         funcalls=model.last_fit["funcalls"],
                         fit_s=model.last_fit["seconds"],
                         coef=model.model_coefficients)
        del data, model
    return ref


def _mp_fe_check(tag, ranks, ref_f, ref_coef, hold_theta):
    """Both ranks bit-equal; the loss (and with `hold_theta` θ) within the
    FE limits of the one-process fit. Returns (f rel, max|Δθ| / max|θ|)."""
    _check(len({r["sha"] for r in ranks}) == 1,
           f"multiprocess {tag}: θ differs between the ranks")
    coef = np.asarray(ranks[0]["coef"])
    f_rel = abs(ranks[0]["f"] - ref_f) / abs(ref_f)
    d_rel = float(np.abs(coef - ref_coef).max() / np.abs(ref_coef).max())
    _check(all(r["converged"] for r in ranks),
           f"multiprocess {tag}: a rank did not converge")
    _check(f_rel <= FE_LOSS_RTOL and (d_rel <= FE_GRAD_RTOL or not
                                      hold_theta),
           f"multiprocess {tag} against one process: f rel {f_rel:.2e}, "
           f"max|Δθ|/max|θ| {d_rel:.2e}")
    return f_rel, d_rel


def _mp_cli_fe(card, tmp, launches):
    """`python -m gdmix_tpu_torch.gdmix --stage fixed_effect` in two
    processes under the environment contract over the FE uniform cell as
    STREAM_FE_FILES tfrecord files (two a process), eagerly and in chunks
    of STREAM_CHUNK_ROWS, against one process's train of the same files:
    the ranks' fits equal, the loss within FE_LOSS_RTOL (float32: θ's gap
    is printed, see MP_FE_CELLS)."""
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.io.feature_list import write_feature_list
    from gdmix_tpu_torch.io.model_avro import load_linear_models_from_avro
    features = os.path.join(tmp, "fe_features.csv")
    write_feature_list([(f"f{i}", "") for i in range(FE_D)], features)
    data, make_s, write_s = _write_fe_files(tmp)
    model, schema = fe_stage_model(os.path.join(tmp, "cli_one"), "auto",
                                   feature_file=features,
                                   sparsity_threshold=0.0)
    model.train(data, None, model.metadata_file, model.checkpoint_path,
                {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                 constants.IS_CHIEF: True}, schema)
    ref_f, ref = model.last_fit["f"], model.model_coefficients
    del model
    for tag, extra in (("eager", []),
                       ("stream", [f"--stream_chunk_rows={STREAM_CHUNK_ROWS}"])):
        out_dir = os.path.join(tmp, f"cli_{tag}")
        for sub in ("models", "scores"):
            os.makedirs(os.path.join(out_dir, sub))
        argv = [sys.executable, "-m", "gdmix_tpu_torch.gdmix",
                "--action=train", "--stage=fixed_effect",
                "--model_type=logistic_regression",
                "--label_column_name=response", "--uid_column_name=uid",
                "--prediction_score_column_name=predictionScore",
                f"--metadata_file={os.path.join(tmp, 'cli_one', 'tensor_metadata.json')}",
                f"--training_data_dir={data}", "--feature_bag=global",
                f"--feature_file={features}",
                f"--output_model_dir={os.path.join(out_dir, 'models')}",
                f"--training_score_dir={os.path.join(out_dir, 'scores')}",
                "--l2_reg_weight=1.0", "--regularize_bias=False",
                "--sparsity_threshold=0.0"] + extra
        # ---- the main path: the trainer CLI in two processes ----
        outs, wall = _mp_run(argv, f"FE CLI {tag}")
        # ----
        fits = [_log_fit(o) for o in outs]
        for o in outs:
            for k, v in _log_json(o, "kernel launches: ").items():
                launches[k] += v
        (coef,) = load_linear_models_from_avro(
            os.path.join(out_dir, "models", "part-00000.avro"), features)
        f_rel = abs(fits[0]["f"] - ref_f) / abs(ref_f)
        d_rel = float(np.abs(coef - ref).max() / np.abs(ref).max())
        parts = sorted(os.listdir(os.path.join(out_dir, "scores")))
        _say("multiprocess", cli="gdmix --stage fixed_effect", run=tag,
             files=STREAM_FE_FILES, make_s=f"{make_s:.3f}",
             write_s=f"{write_s:.3f}", wall_s=f"{wall:.3f}",
             rank_fits=fits, f_rel=f"{f_rel:.2e}",
             max_dcoef_rel=f"{d_rel:.2e}", score_parts=parts,
             backend=[_log_backend(o) for o in outs], card=repr(card))
        _check(fits[0]["f"] == fits[1]["f"]
               and fits[0]["funcalls"] == fits[1]["funcalls"],
               f"FE CLI {tag}: the ranks' fits differ: {fits}")
        _check(f_rel <= FE_LOSS_RTOL,
               f"FE CLI {tag} against one process: f rel {f_rel:.2e}")
        _check(parts == ["part-00000.avro", "part-00001.avro"],
               f"FE CLI {tag}: score parts {parts}")


def _log_fit(out):
    """The trainer's fit line (models/fixed_effect_lr.py `f_min: ...`)."""
    line = out.rsplit("f_min: ", 1)[1].splitlines()[0]
    f, rest = line.split(", iters: ")
    iters, rest = rest.split(", funcalls: ")
    funcalls = rest.split(",")[0]
    return dict(f=float(f), iterations=int(iters), funcalls=int(funcalls))


def _log_backend(out):
    return out.rsplit("backend ", 1)[1].split()[0]


def phase_multiprocess(card, tmp, ml, single):
    """Multi-process training (ROADMAP A.6b) with MP_PROCS processes
    sharing the one card over a gloo process group (NCCL refuses two ranks
    on one card), each joined through the JAX package's environment
    contract: (a) one group through the model API: the FE uniform cell
    (fit on rows rank::2, profiled) and the wide-D cell at λ = 10⁴ through
    auto (K12 + 2×K13 on each process's own split), the in-memory
    movieLens-100K pipeline, 2 sweeps, on the host and the sharded RE plane
    (the model-file exchange), and the deep tower (cnn, batch 512,
    MP_TOWER_EPOCHS epochs, MP_TOWER_CELLS), each against one process's
    run here; (b) the
    trainer CLI over the FE cell's 4 files, eagerly and streamed; (c)
    `workflow.main --mode distributed` against the single-node run. Returns
    {kernel: launches} of the children's main-path runs."""
    import torch
    import yaml
    from collections import Counter
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.data import movielens
    from gdmix_tpu_torch.io.scores import read_scores
    from gdmix_tpu_torch.ops.metrics import auc as auc_metric
    from gdmix_tpu_torch.workflow.pipeline import InMemoryPipeline
    from gdmix_tpu_torch.workflow.config import WorkflowConfig
    phase_t0 = time.perf_counter()
    launches = Counter()
    sub = os.path.join(tmp, "multiprocess")
    os.makedirs(sub)
    # ---- one process: the references ----
    t0 = time.perf_counter()
    fe_ref = _mp_fe_reference(sub)
    cfgs = {plane: _ml100k_config(ml, sub, f"mp_{plane}")
            for plane in ("host", "sharded")}
    one = {plane: InMemoryPipeline(WorkflowConfig.from_file(
        _ml100k_config(ml, sub, f"one_{plane}")), num_sweeps=2,
        re_mode=plane).run() for plane in ("host", "sharded")}
    dml = movielens.prepare_gdmix_data(os.path.join(sub, "detext100k"),
                                       movielens.generate_synthetic(
                                           **ML100K), with_detext=True)
    tower_cfg = _detext_config(dml, os.path.join(sub, "tower_cfg"),
                               MP_TOWER_EPOCHS)
    tower_path = os.path.join(sub, "tower.yaml")
    with open(tower_path, "w") as f:
        yaml.safe_dump(tower_cfg, f, sort_keys=False)
    tower_ref = {}
    for dtype, _, _ in MP_TOWER_CELLS:
        model, base = _detext_model(
            tower_cfg, os.path.join(sub, f"tower_one_{dtype}"), dtype=dtype)
        model.train(model.training_data_dir, model.validation_data_dir,
                    model.metadata_file, model.checkpoint_path,
                    {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                     constants.IS_CHIEF: True}, base)
        tower_ref[dtype] = model.last_fit
        del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _say("multiprocess", references_s=f"{time.perf_counter() - t0:.3f}",
         fe_one={c: dict(f=f"{r['f']:.6f}", funcalls=r["funcalls"],
                         fit_s=f"{r['fit_s']:.3f}")
                 for c, r in fe_ref.items()},
         in_memory_one=one, card=repr(card))

    # ---- (a) the model API in MP_PROCS processes ----
    args = dict(tmp=sub, host=cfgs["host"], sharded=cfgs["sharded"],
                tower=tower_path, tower_out=os.path.join(sub, "tower_mp"))
    outs, wall = _mp_run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--mp-child", json.dumps(args)], "model API")
    ranks = [_log_json(o, "MP_RESULT ") for o in outs]
    _say("multiprocess", group="model API", wall_s=f"{wall:.3f}",
         world_size=[r["num_processes"] for r in ranks],
         backend=[r["backend"] for r in ranks],
         rank_card=[f"{r['process_id']}:{r['device']}:{r['card']}"
                    for r in ranks])
    _check([r["process_id"] for r in ranks] == list(range(MP_PROCS))
           and {r["backend"] for r in ranks} == {"gloo"}
           and {r["num_processes"] for r in ranks} == {MP_PROCS},
           f"multiprocess: the group is not {MP_PROCS} gloo ranks")
    for cell, _, d, over, hold_theta in MP_FE_CELLS:
        fits = [r["fe"][cell] for r in ranks]
        f_rel, d_rel = _mp_fe_check(cell, fits, fe_ref[cell]["f"],
                                    np.asarray(fe_ref[cell]["coef"]),
                                    hold_theta)
        for fit in fits:
            for k, v in fit["launches"].items():
                launches[k] += v
        _say("multiprocess", fe=cell, N=FE_N, D=d, K=FE_K,
             dtype=over.get("dtype", "float32"),
             rows=[f["rows"] for f in fits],
             funcalls=[f["funcalls"] for f in fits],
             one_process_funcalls=fe_ref[cell]["funcalls"],
             fit_s=[f"{f['fit_s']:.3f}" for f in fits],
             wall_s=[f"{f['wall_s']:.3f}" for f in fits],
             one_process_fit_s=f"{fe_ref[cell]['fit_s']:.3f}",
             allreduce_s_per_funcall=[
                 f"{f['allreduce_s'] / max(f['allreduce_calls'], 1):.6f}"
                 for f in fits],
             allreduce_share=[f"{f['allreduce_s'] / f['fit_s']:.3f}"
                              for f in fits],
             device_idle=[None if f["idle"] is None else f"{f['idle']:.4f}"
                          for f in fits],
             f=f"{fits[0]['f']:.6f}", f_rel=f"{f_rel:.2e}",
             max_dcoef_rel=f"{d_rel:.2e}", theta_held=hold_theta,
             launches=[f["launches"] for f in fits], card=repr(card))
        want = (("fe_hybrid_hot", "windowed_scatter_add") if d == WIDE_D
                else ("fe_loss_grad_fused",))
        _check(all(f["launches"].get(k, 0) >= f["funcalls"]
                   for f in fits for k in want),
               f"multiprocess {cell}: a kernel of the path skipped a "
               f"funcall: {[f['launches'] for f in fits]}")
    for plane in ("host", "sharded"):
        runs = [r["pipelines"][plane] for r in ranks]
        got = runs[0]["metrics"]
        gap = {c: abs(got[c] - one[plane][c]) for c in COORDINATES}
        for run in runs:
            for k, v in run["launches"].items():
                launches[k] += v
        ex = runs[0]["exchanges"]
        _say("multiprocess", pipeline=f"in_memory --re_mode {plane}",
             sweeps=2, auc={k: round(v, 6) for k, v in got.items()},
             auc_gap={k: f"{v:.2e}" for k, v in gap.items()},
             wall_s=[f"{r['wall_s']:.3f}" for r in runs],
             exchange_files=[e["files"] for e in ex],
             exchange_s=[f"{e['seconds']:.4f}" for e in ex],
             launches=[r["launches"] for r in runs], card=repr(card))
        _check(runs[0]["metrics"] == runs[1]["metrics"],
               f"multiprocess pipeline {plane}: the ranks' AUCs differ")
        _check(max(gap.values()) <= MODES_AUC_ATOL,
               f"multiprocess pipeline {plane} against one process: {gap}")
        _check(len(ex) == 4 and all(e["files"] == MP_PROCS for e in ex),
               f"multiprocess pipeline {plane}: exchanges {ex}")
        _check(all(r["launches"].get("newton_full", 0) > 0
                   and r["launches"].get("fe_loss_grad_fused", 0) > 0
                   for r in runs),
               f"multiprocess pipeline {plane}: K1 or K5 never launched")
    # the tower: the two processes' part files against one process's scores
    for dtype, auc_atol, score_rtol in MP_TOWER_CELLS:
        one_s, mp_s = (read_scores(os.path.join(
            sub, f"tower_{who}_{dtype}", "validation_scores"), base)
            for who in ("one", "mp"))
        o1, o2 = (np.argsort(s["uid"], kind="stable") for s in (one_s, mp_s))
        _check(np.array_equal(one_s["uid"][o1], mp_s["uid"][o2]),
               f"multiprocess tower {dtype}: the part files do not hold "
               "every row once")
        s1, s2 = one_s["predictionScore"][o1], mp_s["predictionScore"][o2]
        y = one_s["response"][o1]
        auc1, auc2 = float(auc_metric(s1, y)), float(auc_metric(s2, y))
        dscore = float(np.abs(s1 - s2).max() / np.abs(s1).max())
        towers = [r["tower"][dtype] for r in ranks]
        for t in towers:
            for k, v in t["launches"].items():
                launches[k] += v
        _say("multiprocess", tower="cnn", dtype=dtype, batch=512,
             epochs=MP_TOWER_EPOCHS,
             wall_s=[f"{t['wall_s']:.3f}" for t in towers],
             fit_s=[f"{t['fit']['seconds']:.3f}" for t in towers],
             one_process_fit_s=f"{tower_ref[dtype]['seconds']:.3f}",
             best_epoch=[t["fit"]["best_epoch"] for t in towers],
             one_process_best_epoch=tower_ref[dtype]["best_epoch"],
             auc=f"{auc2:.6f}", one_process_auc=f"{auc1:.6f}",
             auc_gap=f"{abs(auc1 - auc2):.2e}",
             max_dscore_rel=f"{dscore:.2e}",
             corr=f"{np.corrcoef(s1, s2)[0, 1]:.8f}", card=repr(card))
        _check(abs(auc1 - auc2) <= auc_atol
               and (score_rtol is None or dscore <= score_rtol),
               f"multiprocess tower {dtype} against one process: AUC gap "
               f"{abs(auc1 - auc2):.2e}, max|Δscore| {dscore:.2e}")

    # ---- (b) the trainer CLI ----
    _mp_cli_fe(card, sub, launches)

    # ---- (c) --mode distributed ----
    cfg = _ml100k_config(ml, sub, "distributed")
    outs, wall = _mp_run([sys.executable, "-m", "gdmix_tpu_torch.workflow."
                          "main", "--config_path", cfg, "--mode",
                          "distributed"], "--mode distributed")
    metrics = [_log_json(o, "workflow metrics: ") for o in outs]
    for o in outs:
        for k, v in _log_json(o, "kernel launches: ").items():
            launches[k] += v
    gap = {c: abs(metrics[0][c] - single[c]) for c in COORDINATES}
    _say("multiprocess", mode="distributed", wall_s=f"{wall:.3f}",
         auc={k: round(v, 6) for k, v in metrics[0].items()},
         auc_gap_single_node={k: f"{v:.2e}" for k, v in gap.items()},
         backend=[_log_backend(o) for o in outs], card=repr(card))
    _check(metrics[0] == metrics[1],
           "--mode distributed: the ranks report other AUCs")
    _check(max(gap.values()) <= MODES_AUC_ATOL,
           f"--mode distributed against single_node: {gap}")
    _say("multiprocess", launches=dict(launches),
         phase_s=f"{time.perf_counter() - phase_t0:.3f}", card=repr(card))
    for k in ("newton_full", "newton_block", "fe_loss_grad_fused",
              "fe_hybrid_hot", "windowed_scatter_add"):
        _check(launches[k] > 0, f"multiprocess: {k} never launched")
    return launches


# ------------------------------------------------------------------ detext --

# the JAX bench's deep-tower cell (bench.py:434-487): B rows of L tokens
# from a vocabulary of V, a wide bag of K ids in D, cnn windows 2 and 3,
# 64 filters, 64 units, 128 hidden, Adam at 1e-3
DETEXT_B, DETEXT_L, DETEXT_V, DETEXT_D, DETEXT_K = 4096, 16, 30_000, 10_000, 8
# one step on the card (float32, TF32 off) against the CPU's float64 step
# from the same parameters: float32 sums in other orders, so the loss
# ≤ 1e-5 relative and each gradient's max|Δ| ≤ 1e-4·max|g|
DETEXT_LOSS_RTOL, DETEXT_GRAD_RTOL = 1e-5, 1e-4
DETEXT_STEPS = 20         # warm steps timed one by one; the median
DETEXT_EPOCHS = 10        # DeepTowerParams' default
DETEXT_PROFILED_EPOCHS = 2
# a cold predict from the checkpoint against the warm validation scores:
# one model, one device, the same chunks; the score files keep float32
DETEXT_PREDICT_ATOL = 1e-5


def _detext_step_row(ftr_ext, layers, cudnn=True):
    """One Adam step of the bench's deep-tower cell through the port's
    tower_loss and adam, from parameters drawn on the CPU: the card's loss
    and gradients against the CPU's float64 step, then the warm step's
    median time by CUDA events, and a profiled step's device time by
    kernel. cudnn=False runs the card's part with cuDNN off (PyTorch's own
    LSTM kernels in place of cuDNN's)."""
    import torch
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        return _detext_step(ftr_ext, layers)
    finally:
        torch.backends.cudnn.enabled = prev


def _detext_step(ftr_ext, layers):
    import copy
    import torch
    from gdmix_tpu_torch.models import deep_tower as dt
    tower = dt._TextWideTower(
        vocab_size=DETEXT_V, num_wide=DETEXT_D, num_units=64,
        windows=(2, 3), num_filters=64, num_hidden=128, ftr_ext=ftr_ext,
        num_heads=4, num_layers=layers, max_len=DETEXT_L)
    tower.load_state_dict(dt.init_state(tower,
                                        torch.Generator().manual_seed(1)))
    rng = np.random.RandomState(0)
    B, L = DETEXT_B, DETEXT_L
    batch = dict(tokens=rng.randint(0, DETEXT_V, (B, 1, L)),
                 mask=(rng.rand(B, 1, L) < 0.9).astype(np.float32),
                 indices=rng.randint(0, DETEXT_D, (B, DETEXT_K)),
                 values=rng.randn(B, DETEXT_K).astype(np.float32),
                 labels=(rng.rand(B) < 0.5).astype(np.float32),
                 weights=np.ones(B, np.float32),
                 offsets=np.zeros(B, np.float32),
                 groups=np.zeros(B, np.int64))
    towers, losses, grads = {}, {}, {}
    for where, dev, dtype in (("card", DEV, torch.float32),
                              ("cpu", "cpu", torch.float64),
                              ("cpu32", "cpu", torch.float32)):
        t = copy.deepcopy(tower).to(device=dev, dtype=dtype)
        rows = {k: torch.as_tensor(v, device=dev, dtype=torch.int64
                                   if v.dtype.kind == "i" else dtype)
                for k, v in batch.items()}
        loss = dt.tower_loss(t, rows, False, 0.0)
        loss.backward()
        losses[where] = float(loss.detach())
        grads[where] = {n: p.grad.detach().double().cpu()
                        for n, p in t.named_parameters()
                        if p.grad is not None}
        towers[where] = (t, rows)
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    # each gradient against its own largest entry; where that vanishes
    # (the attention's key bias: softmax is shift-invariant in each query's
    # row, so its gradient is 0 and float32 leaves only rounding), against
    # the largest entry of any gradient
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())

    def grad_rel(where):
        worst = (0.0, "")
        for n, g in grads["cpu"].items():
            scale = float(g.abs().max())
            scale = scale if scale > 1e-9 * gmax else gmax
            worst = max(worst, (float((grads[where][n] - g).abs().max())
                                / scale, n))
        return worst
    t, rows = towers["card"]
    opt = dt.adam(t, 1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        dt.tower_loss(t, rows, False, 0.0).backward()
        opt.step()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(DETEXT_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    busy_ms, top = _top_kernels(step, reps=5, top=6)
    (card_rel, worst), (cpu32_rel, _) = grad_rel("card"), grad_rel("cpu32")
    return dict(loss_rel=loss_rel, grad_rel=card_rel, grad_worst=worst,
                grad_rel_cpu32=cpu32_rel, step_ms=step_ms,
                step_ms_range=(min(times), max(times)),
                rows_per_sec=B / (step_ms / 1e3), busy_ms=busy_ms, top=top)


def _detext_config(ml, out_dir, epochs):
    """The movieLens workflow with the deep tower as its global coordinate
    (DeepTowerParams' defaults: units 64, windows 1,2,3, 50 filters,
    hidden 100, batch 512, lr 0.002), as the JAX package's
    tests/test_e2e_detext_pipeline.py wires it."""
    cfg = movielens_config(ml, out_dir)
    detext = os.path.join(ml, "detext")
    gdmix_config = dict(
        cfg["fixed_effect_config"]["global"]["gdmix_config"],
        model_type="detext")
    cfg["fixed_effect_config"] = {"global": {
        "training_data_dir": os.path.join(detext, "trainingData"),
        "validation_data_dir": os.path.join(detext, "validationData"),
        "metadata_file": os.path.join(detext, "metadata",
                                      "tensor_metadata.json"),
        "vocab_file": os.path.join(detext, "vocab.txt"),
        "feature_bag": "wide_ftrs_sp", "num_epochs": epochs,
        "gdmix_config": gdmix_config}}
    return cfg


def _detext_model(cfg, out_dir, **over):
    """A DeepTowerModel of the config's global coordinate on the card."""
    from gdmix_tpu_torch.models.deep_tower import (DeepTowerModel,
                                                   DeepTowerParams)
    from gdmix_tpu_torch.params import Params, from_dict
    conf = dict(cfg["fixed_effect_config"]["global"])
    base = from_dict(Params, {
        **conf.pop("gdmix_config"), "stage": "fixed_effect",
        "training_score_dir": os.path.join(out_dir, "train_scores"),
        "validation_score_dir": os.path.join(out_dir, "validation_scores")})
    params = from_dict(DeepTowerParams, {
        **conf, "output_model_dir": os.path.join(out_dir, "models"), **over})
    return DeepTowerModel(params, base, device=DEV), base


# the ModernBERT cell's lengths (benchmark/traffic/
# detext-modernbert-base.fe-fit-long.json): a document's tokens log-normal
# around VARLEN_MEDIAN (σ VARLEN_SIGMA), clipped, then [CLS] and [SEP]
VARLEN_MEDIAN, VARLEN_SIGMA, VARLEN_CLIP = 1024, 0.8, (62, 8190)
VARLEN_HEADS, VARLEN_WINDOW = 12, 64


def _varlen_row(tag, lens, window, reps=5):
    """csrc/varlen_attention.cu at packed documents of `lens` (12 heads of
    64): forward and backward against the plain versions in float64 on the
    card (relative to each output's largest entry), the backward twice and
    bit-equal, and each direction's ms by CUDA events beside its bound
    (the benchmark's count of a call's work, `attention_call`) and the
    plain float32 versions' ms."""
    import torch
    from benchmark.costs.modernbert import attention_call
    from gdmix_tpu_torch.ops import varlen_attention as va
    H, d = VARLEN_HEADS, va.HEAD_DIM
    T, longest = int(sum(lens)), int(max(lens))
    gen = torch.Generator(device="cuda").manual_seed(len(lens) + window)
    q, k, v, do = (torch.randn(T, H, d, device="cuda", generator=gen)
                   for _ in range(4))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32, device="cuda")
    o, lse = va.varlen_attention_forward(q, k, v, offsets, longest, window)
    grads = va.varlen_attention_backward(q, k, v, o, lse, do, offsets,
                                         longest, window)
    again = va.varlen_attention_backward(q, k, v, o, lse, do, offsets,
                                         longest, window)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(grads, again))
    d64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = va.varlen_attention_forward_plain(*d64[:3], offsets, window)
    want = va.varlen_attention_backward_plain(*d64[:3], o.double(),
                                              lse.double(), d64[3], offsets,
                                              window)
    errs = {name: float((got.double() - ref).abs().max() / ref.abs().max())
            for name, got, ref in (("o", o, o64), ("lse", lse, lse64),
                                   ("dq", grads[0], want[0]),
                                   ("dk", grads[1], want[1]),
                                   ("dv", grads[2], want[2]))}
    del o64, lse64, want, d64
    fwd_ms = _time_ms(lambda: va.varlen_attention_forward(
        q, k, v, offsets, longest, window), reps)
    bwd_ms = _time_ms(lambda: va.varlen_attention_backward(
        q, k, v, o, lse, do, offsets, longest, window), reps)
    plain_ms = _time_ms(lambda: va.varlen_attention_backward_plain(
        q, k, v, *va.varlen_attention_forward_plain(q, k, v, offsets,
                                                    window),
        do, offsets, window), 1)
    flops, nbytes = attention_call(lens, H, d, window)
    fwd_bound, by = _bound(nbytes, flops)
    bwd_bound, _ = _bound(*attention_call(lens, H, d, window,
                                          backward=True)[::-1])
    row = dict(max_abs_err=max(errs.values()), ms=fwd_ms + bwd_ms,
               plain_ms=plain_ms, bound_ms=fwd_bound + bwd_bound,
               bound_by=by, library_ms=None)
    _say("varlen_attention", case=tag, T=T, docs=len(lens), longest=longest,
         window=window, errs={k: f"{v:.2e}" for k, v in errs.items()},
         deterministic=same, forward_ms=f"{fwd_ms:.3f}",
         forward_bound_ms=f"{fwd_bound:.3f}",
         forward_share=f"{100 * fwd_bound / fwd_ms:.1f}%",
         backward_ms=f"{bwd_ms:.3f}", backward_bound_ms=f"{bwd_bound:.3f}",
         backward_share=f"{100 * bwd_bound / bwd_ms:.1f}%",
         plain_ms=f"{plain_ms:.2f}", bound_by=by)
    _check(same, f"varlen_attention {tag}: two backward passes differ")
    _check(max(errs.values()) <= 1e-4,
           f"varlen_attention {tag}: {errs} against the float64 plain "
           "version")
    return row


def phase_varlen_attention(card):
    """The ModernBERT encoder's attention kernel (csrc/varlen_attention.cu)
    on a pack of documents at the tiles' and the window's edges (1, 63,
    64, 65, 129, 130, 300 rows) and at the ModernBERT cell's shapes (a
    batch of 16 documents drawn as its traffic draws them, seed 0), whole
    documents and the local layers' window of 64. Returns {"varlen_attention":
    the cell's global row, the worst error of every case}; its launches are
    phase_modernbert's."""
    rng = np.random.default_rng(0)
    lens = np.clip(np.rint(np.exp(rng.normal(np.log(VARLEN_MEDIAN),
                                             VARLEN_SIGMA, 16))),
                   *VARLEN_CLIP).astype(np.int64) + 2
    edges = [1, 63, 64, 65, 129, 130, 300]
    rows = {}
    for tag, ls, window in (("edges_full", edges, -1),
                            ("edges_window", edges, VARLEN_WINDOW),
                            ("cell_full", lens, -1),
                            ("cell_window", lens, VARLEN_WINDOW)):
        rows[tag] = _varlen_row(tag, ls.tolist() if hasattr(ls, "tolist")
                                else ls, window)
    row = dict(rows["cell_full"],
               max_abs_err=max(r["max_abs_err"] for r in rows.values()))
    _say("varlen_attention", card=repr(card), lengths=lens.tolist())
    return {"varlen_attention": row}


# ModernBERT-base's tower on the main path: its widths from the cell's
# configuration file, documents of these many positions (two of the 8,192
# the model takes), MODERNBERT_BATCH a step
MODERNBERT_CONFIG = os.path.join(ROOT, "benchmark", "configs",
                                 "detext-modernbert-base.json")
MODERNBERT_TRAIN = (8192, 64, 1500, 130, 3000, 65, 8192, 700)
MODERNBERT_VALID = (8192, 300, 64, 2000)
MODERNBERT_BATCH = 4
MODERNBERT_WIDE = 44


def _modernbert_rows(c, lens, seed):
    """Per-row tensors on the card of documents of `lens` positions: [CLS],
    ids below the special ones, [SEP], then [PAD] to max_len; 3 wide
    entries a row, labels half 1."""
    import torch
    rng = np.random.default_rng(seed)
    n, length = len(lens), c["max_len"]
    lens = np.asarray(lens)
    pos = np.arange(length)[None, :]
    first_special = min(c["special_ids"].values())
    tokens = np.where(pos < lens[:, None],
                      rng.integers(0, first_special, (n, length)),
                      c["pad_token_id"])
    tokens[:, 0] = c["cls_token_id"]
    tokens[np.arange(n), lens - 1] = c["sep_token_id"]
    cols = dict(tokens=tokens[:, None],
                mask=(pos < lens[:, None]).astype(np.float32)[:, None],
                indices=rng.integers(0, MODERNBERT_WIDE, (n, 3)),
                values=rng.uniform(0.5, 1.0, (n, 3)).astype(np.float32),
                labels=(np.arange(n) % 2).astype(np.float32),
                weights=np.ones(n, np.float32),
                offsets=np.zeros(n, np.float32),
                groups=np.zeros(n, np.int64))
    return {k: torch.as_tensor(v, device=DEV) for k, v in cols.items()}


def phase_modernbert(card, tmp):
    """ModernBERT-base's tower (`--ftr_ext=bert --bert_config_file=` its
    config.json, every width as published) through DeepTowerModel's
    _fit_rows on the card: one epoch of MODERNBERT_BATCH-document steps
    over documents of up to 8,192 positions, then the validation's
    forward. The varlen kernel's launches, zeroed just before, must be the
    encoder's: one forward a layer a forward pass (the steps' and the
    validation's) and one backward a layer a step; the fit's losses and
    scores finite. Returns {"varlen_attention": its launches}."""
    import torch
    from gdmix_tpu_torch.models.deep_tower import (DeepTowerModel,
                                                   DeepTowerParams,
                                                   _ModernBertEncoder)
    from gdmix_tpu_torch.ops import varlen_attention as va
    from gdmix_tpu_torch.params import Params
    with open(MODERNBERT_CONFIG) as f:
        c = json.load(f)
    config = os.path.join(tmp, "config.json")
    with open(config, "w") as f:
        json.dump({k: v for k, v in c.items()
                   if k not in ("name", "source", "reduced", "assumed")}, f)
    vocab = os.path.join(tmp, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(f"[unused{i}]" for i in range(c["vocab_size"]))
                + "\n")
    md_file, _ = _write_metadata(os.path.join(tmp, "md"), MODERNBERT_WIDE)
    params = DeepTowerParams(
        metadata_file=md_file, output_model_dir=tmp,
        feature_bag="per_entity", vocab_file=vocab, bert_config_file=config,
        ftr_ext="bert", max_len=c["max_len"], num_hidden=c["num_hidden"],
        task_type="classification", learning_rate=c["learning_rate"],
        batch_size=MODERNBERT_BATCH, num_epochs=1, dtype="float32", seed=0)
    base = Params(action="train", stage="fixed_effect", model_type="detext",
                  label_column_name="response", uid_column_name="uid",
                  weight_column_name=None,
                  prediction_score_column_name="predictionScore")
    model = DeepTowerModel(params, base, device=DEV)
    _check(isinstance(model.module.bert, _ModernBertEncoder),
           f"modernbert: built {type(model.module.bert).__name__}")
    train = _modernbert_rows(c, MODERNBERT_TRAIN, 1)
    valid = _modernbert_rows(c, MODERNBERT_VALID, 2)
    state = model._initial_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    va.varlen_attention_forward.launches = 0
    va.varlen_attention_backward.launches = 0
    # ---- the main path ----
    t0 = time.perf_counter()
    scores = model._fit_rows(train, valid, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = va.varlen_attention_forward.launches
    bwd = va.varlen_attention_backward.launches
    # ----
    lf = model.last_fit
    layers = c["num_hidden_layers"]
    passes = lf["steps"] + 1            # the steps' and the validation's
    loss = lf["epochs"][0]["loss"]
    _say("modernbert", layers=layers, steps=lf["steps"],
         forward_launches=fwd, backward_launches=bwd,
         attention_calls_full=lf["attention_calls_full"],
         attention_calls_window=lf["attention_calls_window"],
         longest_document=lf["longest_document"],
         encoded_positions=lf["encoded_positions"],
         padded_positions=lf["padded_positions"],
         host_syncs=lf["host_syncs"], loss=f"{loss:.6f}",
         val_auc=f"{lf['epochs'][0]['val_auc']:.4f}", wall_s=f"{wall:.3f}",
         peak_gib=_gib(torch.cuda.max_memory_allocated()),
         card=repr(card))
    _check(lf["steps"] == len(MODERNBERT_TRAIN) // MODERNBERT_BATCH,
           f"modernbert: {lf['steps']} steps")
    _check(fwd == layers * passes and bwd == layers * lf["steps"],
           f"modernbert: {fwd} forward and {bwd} backward launches of the "
           f"varlen kernel over {passes} forward passes and {lf['steps']} "
           f"steps of {layers} layers")
    _check(fwd == lf["attention_calls_full"] + lf["attention_calls_window"],
           f"modernbert: {fwd} launches against the encoder's {lf}")
    _check(lf["longest_document"] == max(MODERNBERT_TRAIN + MODERNBERT_VALID)
           and lf["encoded_positions"]
           == sum(MODERNBERT_TRAIN) + sum(MODERNBERT_VALID),
           f"modernbert: the documents' positions: {lf}")
    _check(np.isfinite(loss) and bool(torch.isfinite(scores).all()),
           f"modernbert: loss {loss}, scores {scores}")
    return {"varlen_attention": fwd + bwd}


def phase_detext(card, tmp):
    """The deep fixed effect (DeText) on the card. (a) The bench's
    deep-tower cell at full width: one step against the CPU's float64
    step, and the warm step rate of the cnn, lstm and transformer
    encoders. (b) The detext pipeline (deep tower → per-user → per-movie)
    through the CLI's default mode on synthetic data at MovieLens-100K's
    counts: AUC climbing, each coordinate's stage seconds, the tower's
    fit, a cold predict from its checkpoint against the warm scores, the
    kernel launches, K1/K2 at every lanes tier of the run's RE partitions
    against their plain versions; then the tower's train again, for
    DETEXT_PROFILED_EPOCHS epochs, under torch.profiler (device busy,
    idle). Returns ({kernel: max |error|}, {kernel: launches})."""
    import torch
    import yaml
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.data import movielens
    from gdmix_tpu_torch.gdmix import kernel_launches
    from gdmix_tpu_torch.io.scores import read_scores
    from gdmix_tpu_torch.workflow.main import main as workflow_main
    from torch.profiler import ProfilerActivity, profile
    phase_t0 = time.perf_counter()
    # the step's loss is held for every encoder, its gradients for the
    # bench's cell (cnn). The lstm and transformer gradients are printed
    # beside the CPU's float32 ones: at this width ReLU and the masked
    # max-pool switch on float32 rounding, so float32 itself sits up to
    # ~5e-3 from float64 there; and cuDNN's float32 LSTM (the port's LSTM
    # on the card) computes its forward ~1e-4 from float64, PyTorch's own
    # LSTM kernels ~3e-7 (the cudnn=False row)
    for ext, layers, cudnn in (("cnn", 1, True), ("lstm", 2, True),
                               ("lstm", 2, False), ("transformer", 2, True)):
        r = _detext_step_row(ext, layers, cudnn)
        key = "detext_rows_per_sec" + ("" if ext == "cnn" else f"_{ext}")
        if not cudnn:
            key += "_no_cudnn"
        _say("detext", ftr_ext=ext, layers=layers, B=DETEXT_B, L=DETEXT_L,
             cudnn=cudnn,
             **{key: f"{r['rows_per_sec']:.1f}"},
             step_ms=f"{r['step_ms']:.4f}",
             step_ms_range="{:.4f}-{:.4f}".format(*r["step_ms_range"]),
             device_busy_ms=f"{r['busy_ms']:.4f}",
             loss_rel=f"{r['loss_rel']:.2e}",
             grad_rel=f"{r['grad_rel']:.2e}", grad_worst=r["grad_worst"],
             grad_rel_cpu32=f"{r['grad_rel_cpu32']:.2e}",
             top_kernels_ms=r["top"],
             card=repr(card))
        _check(r["loss_rel"] <= DETEXT_LOSS_RTOL
               and (r["grad_rel"] <= DETEXT_GRAD_RTOL or ext != "cnn"),
               f"detext {ext}: the card's step against the CPU's float64 "
               f"one: loss {r['loss_rel']:.2e}, gradient "
               f"{r['grad_rel']:.2e}")

    t0 = time.perf_counter()
    ml = movielens.prepare_gdmix_data(os.path.join(tmp, "detext100k"),
                                      movielens.generate_synthetic(**ML100K),
                                      with_detext=True)
    prep_s = time.perf_counter() - t0
    out = os.path.join(tmp, "detext")
    cfg = _detext_config(ml, out, DETEXT_EPOCHS)
    path = os.path.join(tmp, "detext.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    for c in _re_counters() + _hybrid_counters():
        c.launches = 0
    # ---- the main path ----
    with _Records("gdmix_tpu_torch.workflow.single_node") as log, \
            _Records("gdmix_tpu_torch.models.deep_tower") as tower_log:
        t0 = time.perf_counter()
        metrics = workflow_main(["--config_path", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_launches()
    # ----
    stages = {r.coordinate: {k: f"{v:.3f}" for k, v in
                             r.stage_seconds.items()}
              for r in log.records if hasattr(r, "stage_seconds")}
    fits = [r.deep_tower_fit for r in tower_log.records
            if hasattr(r, "deep_tower_fit")]
    _check(len(fits) == 1, f"detext: {len(fits)} tower fits logged")
    fit = fits[0]
    _say("detext", auc={k: round(v, 6) for k, v in metrics.items()},
         wall_s=f"{wall:.3f}", stage_s=stages, data_prep_s=f"{prep_s:.3f}",
         tower_fit_s=f"{fit['seconds']:.3f}", epochs=len(fit["epochs"]),
         steps_per_epoch=fit["steps_per_epoch"],
         best_epoch=fit["best_epoch"],
         val_auc=[round(e["val_auc"], 5) for e in fit["epochs"]],
         launches={k: v for k, v in launches.items() if v},
         card=repr(card))
    ladder = [metrics.get(c) for c in COORDINATES]
    _check(None not in ladder and ladder[0] > 0.55
           and ladder[0] < ladder[1] < ladder[2],
           f"detext: AUC does not climb global (> 0.55) → per-user → "
           f"per-movie: {metrics}")
    _check(set(stages) == set(COORDINATES),
           f"detext: stage times of {sorted(stages)}")
    _check(launches["newton_full"] > 0,
           f"detext: the RE coordinates skipped K1: {launches}")

    # a cold predict from the checkpoint against the warm scores
    model, base = _detext_model(cfg, os.path.join(out, "global"))
    pred = os.path.join(tmp, "detext_pred")
    t0 = time.perf_counter()
    model.predict(pred, model.validation_data_dir, model.metadata_file,
                  model.checkpoint_path,
                  {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                   constants.IS_CHIEF: True}, base)
    predict_s = time.perf_counter() - t0
    warm = read_scores(os.path.join(out, "global", "validation_scores"),
                       base)
    cold = read_scores(pred, base)
    gap = float(np.max(np.abs(cold["predictionScore"]
                              - warm["predictionScore"])))
    _say("detext", cold_predict_s=f"{predict_s:.3f}",
         rows=len(cold["uid"]), max_abs_gap=f"{gap:.2e}")
    _check(np.array_equal(cold["uid"], warm["uid"])
           and gap <= DETEXT_PREDICT_ATOL,
           f"detext: cold predict against the warm scores: {gap:.2e}")

    errs, checked = _re_tier_rows(out, "detext", "detext")
    _check(all(launches[k] > 0 for k, n in checked.items() if n),
           f"detext: a kernel of the run's tiers did not launch: "
           f"{launches}, tiers {checked}")

    # the tower's train under torch.profiler: the device's idle share over
    # the whole train() (loading and scoring included) and over its fit
    model, _ = _detext_model(cfg, os.path.join(tmp, "detext_profiled"),
                             num_epochs=DETEXT_PROFILED_EPOCHS)
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train(model.training_data_dir, model.validation_data_dir,
                    model.metadata_file, model.checkpoint_path, ctx,
                    model.base_params)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in ev) / 1e6
    ev.sort(key=lambda e: -e.self_device_time_total)
    fit_s = model.last_fit["seconds"]
    _say("detext", profiled_epochs=DETEXT_PROFILED_EPOCHS,
         train_s=f"{prof_s:.3f}", fit_s=f"{fit_s:.3f}",
         device_busy_s=f"{busy_s:.4f}", idle=f"{1 - busy_s / prof_s:.4f}",
         idle_fit=f"{1 - busy_s / fit_s:.4f}",
         top_kernels_s={e.key[:60]: round(e.self_device_time_total / 1e6, 4)
                        for e in ev[:8]})
    _say("detext", phase_s=f"{time.perf_counter() - phase_t0:.3f}")
    return errs, launches


# ------------------------------------------------------ bench, prewarm --

BENCH_TIMEOUT_S = 600
# the RE lines of the bench: the primary, heavy tail, wide support, the
# stage's two and the sharded heavy tail
BENCH_RE_LINES = 6
PREWARM_TIMEOUT_S = 600


def _port_env(**extra):
    """This environment with the checkout on PYTHONPATH, the compile-cache
    variable dropped, then `extra` set."""
    env = {k: v for k, v in os.environ.items()
           if k != "GDMIX_TPU_COMPILE_CACHE"}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def _run(argv, what, timeout, **env):
    """(stdout, stderr, wall seconds) of argv in a fresh process from the
    checkout; a non-zero exit or a timeout fails the smoke, and the process
    is gone on return."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(argv, cwd=ROOT, env=_port_env(**env),
                              capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise SystemExit(f"chip_smoke: FAILED: {what} outlived {timeout}s: "
                         f"{(e.stderr or b'')[-3000:]!r}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], flush=True)
    _check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    return proc.stdout, proc.stderr, wall


def phase_bench(card):
    """`python -m gdmix_tpu_torch.bench` at its full defaults in a fresh
    process: its one JSON line (every key of the JAX bench's but
    fe_speedup_vs_round1, every rate > 0), no expired budget, converged ≥
    0.999 on every RE line; returns its kernel launches (its bench[kernels]
    line: a fresh process, its counters from 0)."""
    import re
    import torch
    from gdmix_tpu_torch import bench
    out, err, wall = _run([sys.executable, "-m", "gdmix_tpu_torch.bench"],
                          "bench", BENCH_TIMEOUT_S)
    for ln in err.splitlines():
        if ln.startswith("bench"):
            print(f"  {ln}")
    _check("BUDGET EXPIRED" not in err, "bench: the budget expired")
    line = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    _check(set(line) == {"metric", "value", "unit", "vs_baseline",
                         "submetrics", "device"},
           f"bench: line keys {sorted(line)}")
    _check(line["metric"] == bench.METRIC and line["value"] > 0,
           f"bench: primary {line['value']}")
    sub = line["submetrics"]
    _check(set(sub) == set(bench.SUBMETRICS),
           f"bench: submetrics {sorted(set(sub) ^ set(bench.SUBMETRICS))}")
    decomp = sub["re_stage_decomposition"]
    rates = {k: v for k, v in sub.items() if k != "re_stage_decomposition"}
    rates.update({f"decomposition.{k}": decomp[k] for k in (
        "wall_s", "warm_fit_s", "bytes_up", "bytes_down",
        "serial_link_s_est")})
    low = {k: v for k, v in rates.items() if not v > 0}
    _check(not low, f"bench: not positive: {low}")
    conv = [float(c) for c in re.findall(r"converged ([0-9.]+)", err)]
    _check(len(conv) >= BENCH_RE_LINES and min(conv) >= 0.999,
           f"bench: converged {conv}")
    _check(line["device"] != "cpu"
           and line["device"]["kind"] == torch.cuda.get_device_name(0),
           f"bench: device {line['device']}")
    launches = _log_json(err, "bench[kernels]: ")
    smi = err.rsplit("bench[device]: ", 1)[1].splitlines()[0]
    _say("bench", wall_s=f"{wall:.1f}", converged=conv, launches=launches,
         bench_device=repr(smi), card=repr(card))
    return launches


def _fit_child(args):
    """A fresh process of the prewarm phase: the primary workload's first
    fit_flat on the card (its nvcc builds, where the compile cache lacks
    them, inside the wall), then a second under util/timing's phase and
    device_profile (a torch.profiler trace); with "all", every library of
    the port loaded after (tools/prewarm.compile_libraries). One `RESULT
    {json}` line."""
    import torch
    from gdmix_tpu_torch.gdmix import kernel_launches
    from gdmix_tpu_torch.ops import _cuda
    from gdmix_tpu_torch.tools.prewarm import compile_libraries
    from gdmix_tpu_torch.util.timing import (device_profile,
                                             nominal_dispatch_latency_s,
                                             phase)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    fg = make_workload_flat(100_000, seed=0)
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_fit_") as tmp:
        model, schema = stage_model(24, tmp, device=DEV)
        t0 = time.perf_counter()
        model.fit_flat(fg, {}, schema)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        fit_builds = dict(_cuda.build_seconds)
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        with phase("second fit"), device_profile(trace_dir):
            model.fit_flat(fg, {}, schema)
            torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        kernel_events = 0
        for f in traces:
            with open(f) as fh:
                kernel_events += fh.read().count('"cat": "kernel"')
        converged = model.last_fit_converged
    res = dict(first_fit_s=first_s, second_fit_s=second_s,
               fit_build_seconds=fit_builds, build_dir=_cuda.BUILD_DIR,
               converged=converged, traces=len(traces),
               trace_kernel_events=kernel_events,
               dispatch_class_s=nominal_dispatch_latency_s(DEV))
    if args == ["all"]:
        res.update(compile_libraries(DEV))
    res["launches"] = kernel_launches()
    print("RESULT " + json.dumps(res), flush=True)


def phase_prewarm(card):
    """tools/prewarm at its defaults (tiers 8–1,024, the sharded plane
    twice through a device cache) with GDMIX_TPU_COMPILE_CACHE an empty
    directory: it builds every CUDA library there; then a fresh process
    fits the primary over that directory and must build nothing (0.0 s for
    every CUDA and native library), beside a cold process over another
    empty directory, whose first fit includes its nvcc. Returns the
    launches of the three processes."""
    from gdmix_tpu_torch.ops import _cuda
    names = set(_cuda.library_names())
    launches = {}

    def add(ls):
        for k, v in ls.items():
            launches[k] = launches.get(k, 0) + v
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_cache_") as cache, \
            tempfile.TemporaryDirectory(prefix="gdx_smoke_cold_") as cold:
        _, err, wall = _run([sys.executable, "-m",
                             "gdmix_tpu_torch.tools.prewarm"], "prewarm",
                            PREWARM_TIMEOUT_S, GDMIX_TPU_COMPILE_CACHE=cache)
        rep = json.loads("{" + err.rsplit("prewarm: {", 1)[1]
                         .splitlines()[0])
        add(rep["launches"])
        _check(rep["build_dir"] == cache and set(rep["cuda"]) == names
               and all(v > 0 for v in rep["cuda"].values()),
               f"prewarm: built {rep['cuda']} into {rep['build_dir']}")
        _check(rep["converged"][0] == rep["converged"][1] == rep["models"],
               f"prewarm: converged {rep['converged']} of {rep['models']}")
        _say("prewarm", wall_s=f"{wall:.1f}", models=rep["models"],
             plane=rep["plane"], build_s=f"{rep['build_s']:.2f}",
             nvcc={k: round(v, 2) for k, v in rep["cuda"].items()},
             native=rep["native"], fit_s=f"{rep['fit_s']:.3f}",
             launches=rep["launches"], card=repr(card))
        runs = {}
        for tag, where, args in (("prewarmed", cache, ["all"]),
                                 ("cold", cold, [])):
            out, _, wall = _run([sys.executable, os.path.join(
                ROOT, "chip_smoke.py"), "--fit-child"] + args,
                f"fit child ({tag})", PREWARM_TIMEOUT_S,
                GDMIX_TPU_COMPILE_CACHE=where)
            runs[tag] = r = _log_json(out, "RESULT ")
            add(r["launches"])
            _check(r["converged"][0] == r["converged"][1],
                   f"fit child ({tag}): converged {r['converged']}")
            _say("prewarm", process=tag, wall_s=f"{wall:.1f}",
                 first_fit_s=f"{r['first_fit_s']:.3f}",
                 second_fit_s=f"{r['second_fit_s']:.3f}",
                 fit_nvcc={k: round(v, 2)
                           for k, v in r["fit_build_seconds"].items()},
                 cuda=r.get("cuda"), native=r.get("native"),
                 traces=r["traces"],
                 trace_kernel_events=r["trace_kernel_events"],
                 dispatch_class_s=r["dispatch_class_s"], card=repr(card))
        warm, cold_r = runs["prewarmed"], runs["cold"]
        _check(set(warm["cuda"]) == names
               and all(v == 0.0 for v in warm["cuda"].values())
               and all(v == 0.0 for v in warm["fit_build_seconds"].values())
               and all(v == 0.0 for v in warm["native"].values()),
               f"prewarmed process compiled: {warm['cuda']} "
               f"{warm['fit_build_seconds']} {warm['native']}")
        _check(cold_r["fit_build_seconds"].get("newton_lanes", 0) > 0,
               f"cold process built {cold_r['fit_build_seconds']}")
        _check(warm["traces"] >= 1 and warm["trace_kernel_events"] > 0,
               "device_profile wrote no trace with kernel events")
    return launches


KERNELS = (
    ("newton_full", "gdmix_tpu_torch/csrc/newton_lanes.cu",
     "gdmix_tpu/ops/pallas/newton_lanes.py:175"),
    ("newton_block", "gdmix_tpu_torch/csrc/newton_lanes.cu",
     "gdmix_tpu/ops/pallas/newton_lanes.py:137"),
    ("spd_solve_batched", "gdmix_tpu_torch/csrc/ldlt_solve.cu",
     "gdmix_tpu/ops/pallas/linsolve.py:27"),
    ("spd_solve_batched_mrhs", "gdmix_tpu_torch/csrc/ldlt_solve.cu",
     "gdmix_tpu/ops/pallas/linsolve.py:103"),
    ("fe_loss_grad_fused", "gdmix_tpu_torch/csrc/fe_loss_grad.cu",
     "gdmix_tpu/ops/pallas/fe_grad.py:48; gdmix_tpu/ops/pallas/"
     "fe_block.py:85; gdmix_tpu/ops/pallas/fe_gather.py:50"),
    ("fe_gather_entries", "gdmix_tpu_torch/csrc/fe_loss_grad.cu",
     "gdmix_tpu/ops/pallas/fe_flat.py:81; gdmix_tpu/ops/pallas/"
     "fe_flat.py:96"),
    ("fe_scatter_entries", "gdmix_tpu_torch/csrc/fe_loss_grad.cu",
     "gdmix_tpu/ops/pallas/fe_flat.py:109; gdmix_tpu/ops/pallas/"
     "fe_flat.py:134"),
    ("fe_hybrid_hot", "gdmix_tpu_torch/csrc/fe_hybrid.cu",
     "gdmix_tpu/ops/pallas/fe_hybrid.py:53"),
    ("windowed_scatter_add", "gdmix_tpu_torch/csrc/windowed_scatter.cu",
     "gdmix_tpu/ops/pallas/windowed_scatter.py:40"),
    ("re_supports", "gdmix_tpu_torch/csrc/re_pack.cu",
     "none: the JAX package packs on the host (gdmix_tpu/data/bucketing.py "
     "iter_bucketize_flat)"),
    ("re_pack_tier", "gdmix_tpu_torch/csrc/re_pack.cu",
     "none: the JAX package packs on the host (gdmix_tpu/data/bucketing.py "
     "iter_bucketize_flat)"),
    ("varlen_attention", "gdmix_tpu_torch/csrc/varlen_attention.cu",
     "none: the JAX package has no ModernBERT encoder"),
)


def main():
    sys.path.insert(0, ROOT)
    import gdmix_tpu_torch  # noqa: F401  (outside a checkout: fail first)
    if sys.argv[1:2] == ["--mp-child"]:
        # a process of the multiprocess phase, started by phase_multiprocess
        _mp_child(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--fit-child"]:
        # a process of the prewarm phase, started by phase_prewarm
        _fit_child(sys.argv[2:])
        return
    card = phase_device()
    import torch
    phase_build()
    res = phase_kernels()
    res.update(phase_fe_kernels())
    launches = phase_fit(card)
    pack_rows, pack_launches = phase_re_pack(card)
    res.update(pack_rows)
    launches.update(pack_launches)
    errs, tp_launches = phase_two_phase(card)
    for name, err in errs.items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    for name, n in tp_launches.items():
        launches[name] += n
    launches["spd_solve_batched_mrhs"] = phase_wide(card)[
        "spd_solve_batched_mrhs"]
    launches.update(phase_fe_fit(card))
    wide_rows, wide_launches = phase_wide_d(card)
    res.update(wide_rows)
    launches.update(wide_launches)
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_ml_") as tmp:
        ml = phase_pipeline(card, tmp)
        ml100k, single, errs = phase_single_node(card, tmp)
        for name, err in errs.items():
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        phase_dag(card, tmp, ml100k, single)
        phase_cli()
        phase_fe_cli(ml, tmp)
        errs, sharded_launches = phase_sharded(card, tmp, ml)
        mp_launches = phase_multiprocess(card, tmp, ml100k, single)
    for name, err in errs.items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    for name, n in list(sharded_launches.items()) + list(
            mp_launches.items()):
        launches[name] += n
    for name, err in phase_stream(card).items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    res.update(phase_varlen_attention(card))
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_modernbert_") as tmp:
        launches.update(phase_modernbert(card, tmp))
    with tempfile.TemporaryDirectory(prefix="gdx_smoke_detext_") as tmp:
        errs, _ = phase_detext(card, tmp)
    for name, err in errs.items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    for name, n in list(phase_bench(card).items()) + list(
            phase_prewarm(card).items()):
        launches[name] += n
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=launches[name], **{k: res[name][k] for k in keys},
                 **({"forms": res[name]["forms"]} if "forms" in res[name]
                    else {}))
            for name, src, rep in KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
