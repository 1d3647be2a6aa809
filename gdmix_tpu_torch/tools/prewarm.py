"""Prewarm: build the port's compiled libraries BEFORE the first production
fit, and fit the RE plane's shape ladder once.

Port of gdmix_tpu/tools/prewarm.py. There the first dispatch on a fresh
machine compiles the sharded plane's whole tier ladder, and the tool fills
XLA's persistent compilation cache with it. Here the compiled code is the
hand-written CUDA libraries of csrc/ (one a source, shape-independent) and
the native C++ host libraries: the tool builds every one of them on the
card — the CUDA ones into GDMIX_TPU_COMPILE_CACHE when it is set
(ops/_cuda.py BUILD_DIR), the native ones into the checkout's build tree —
so that a later process that shares the directory compiles nothing, then
fits the ladder as the JAX tool does: the sharded plane twice through a
device_cache, or the host plane once with --host_plane.

Usage:
  python -m gdmix_tpu_torch.tools.prewarm --tiers 8,16,32,64,128 \\
      --entities_per_tier 1024 --support 24 --entry_width 8 \\
      [--num_features 10000] [--l2_reg_weight 1.0] [--regularize_bias false]
      [--num_of_lbfgs_iterations 100] [--batch_solver auto]
      [--newton_phase1_iters 0] [--variance_mode none|simple|full]
      [--dtype float32] [--host_plane] [--device cpu]

With --newton_phase1_iters > 0 the ladder's Newton tiers of more than 64
entities fit by two-phase Newton (the model's gate), its two launches a
tier on a card.

On the CPU (--device cpu) no CUDA library is built: the kernels' plain
versions run there. The tool logs each library's build seconds (0.0 where
it was built already) and the fit's wall, and ends with one line
`prewarm: {json}` holding them, the solver rungs of the last fit and each
kernel's launches.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

from gdmix_tpu_torch.device import pop_device_flag, resolve_device

logger = logging.getLogger("gdmix_tpu_torch.prewarm")

# the native host libraries: (name, loader, library, source) in
# gdmix_tpu_torch/native
_NATIVE = (("io", "_load", "_SO", "_SRC"),
           ("avro", "_load_avro", "_AVRO_SO", "_AVRO_SRC"),
           ("bucketize", "_load_bkt", "_BKT_SO", "_BKT_SRC"))


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def build_args(argv=None):
    ap = argparse.ArgumentParser(
        "gdmix_tpu_torch.tools.prewarm",
        description="build the compiled libraries and fit the RE tier "
                    "ladder once")
    ap.add_argument("--tiers", default="8,16,32,64,128,256,512,1024",
                    help="comma-separated per-entity sample caps (pow-2)")
    ap.add_argument("--entities_per_tier", default="1024",
                    help="entity count per tier (one value, or one per tier)")
    ap.add_argument("--support", type=int, default=24,
                    help="distinct features per entity (sets the tier u_cap)")
    ap.add_argument("--entry_width", type=int, default=8,
                    help="padded sparse entries per record (K)")
    ap.add_argument("--num_features", type=int, default=10_000)
    ap.add_argument("--l2_reg_weight", type=float, default=1.0)
    ap.add_argument("--regularize_bias", type=_bool, default=False)
    ap.add_argument("--num_of_lbfgs_iterations", type=int, default=100)
    ap.add_argument("--lbfgs_tolerance", type=float, default=1e-12)
    ap.add_argument("--lbfgs_pgtol", type=float, default=1e-5)
    ap.add_argument("--num_of_lbfgs_curvature_pairs", type=int, default=10)
    ap.add_argument("--batch_solver", default="auto")
    ap.add_argument("--newton_phase1_iters", type=int, default=None,
                    help="override REParams default")
    ap.add_argument("--variance_mode", default="none",
                    choices=["none", "simple", "full"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--host_plane", action="store_true",
                    help="prewarm the host plane (fit_groups: the host's "
                         "plan, each tier packed on the device) instead "
                         "of the sharded plane")
    return ap.parse_args(argv)


def synthesize(tiers, entities_per_tier, support, k, num_features, seed=0):
    """Per-tier synthetic records: entities_per_tier[i] entities with exactly
    tiers[i] samples each and `support` distinct features — reproduces the
    production plane's (b_cap, n_cap, u_cap) shape triple per tier."""
    from gdmix_tpu_torch.io.input_pipeline import PerRecordData
    rng = np.random.RandomState(seed)
    ents, counts = [], []
    eid = 0
    for cap, e_t in zip(tiers, entities_per_tier):
        for _ in range(e_t):
            ents.append(eid)
            counts.append(cap)
            eid += 1
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    entity_col = np.repeat(np.asarray(ents, np.int64), counts)
    # per-entity support: `support` distinct ids; entries cycle through it
    sup = rng.randint(0, num_features, size=(eid, support))
    rec_ent = entity_col
    indices = sup[rec_ent][:, :k] if support >= k else np.pad(
        sup[rec_ent], ((0, 0), (0, k - support)), mode="wrap")
    indices = np.ascontiguousarray(indices[:, :k]).astype(np.int64)
    values = rng.randn(n, k)
    return PerRecordData(
        columns={"entity": entity_col,
                 "uid": np.arange(n, dtype=np.int64),
                 "response": rng.randint(0, 2, n).astype(np.float64)},
        indices=indices, values=values,
        nnz=np.full(n, min(k, support), np.int64), num_samples=n)


def _native_build_seconds() -> dict:
    """{native library: seconds its loader spent building it}: 0.0 where
    it was built from its current source already; None where the
    toolchain could not build it (the pure-Python paths run)."""
    from gdmix_tpu_torch import native
    out = {}
    for name, load, so, src in _NATIVE:
        so, src = getattr(native, so), getattr(native, src)
        built = os.path.exists(so) \
            and os.path.getmtime(so) >= os.path.getmtime(src)
        t0 = time.perf_counter()
        ok = getattr(native, load)() is not None
        out[name] = (None if not ok
                     else 0.0 if built else time.perf_counter() - t0)
    return out


def compile_libraries(device) -> dict:
    """Build what the port compiles, where it is missing: on a card every
    CUDA library of csrc/ (one nvcc a source, all started together), and
    the native host libraries. Returns {"build_dir", "cuda": {library:
    seconds}, "native": {library: seconds}}, 0.0 for a library found
    built."""
    from gdmix_tpu_torch.ops import _cuda
    cuda = {}
    if resolve_device(device).type == "cuda":
        _cuda.load_all(_cuda.library_names())
        cuda = {n: _cuda.build_seconds[n] for n in _cuda.library_names()}
    return dict(build_dir=_cuda.BUILD_DIR, cuda=cuda,
                native=_native_build_seconds())


def _model(a, root, device):
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.params import Params, REParams, from_dict
    md_file = os.path.join(root, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "bag", "dtype": "float",
             "shape": [a.num_features], "isSparse": True},
            {"name": "uid", "dtype": "long", "shape": [],
             "isSparse": False},
            {"name": "entity", "dtype": "long", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "int",
                        "shape": [], "isSparse": False}]}, f)
    over = {}
    if a.newton_phase1_iters is not None:
        over["newton_phase1_iters"] = a.newton_phase1_iters
    mp = from_dict(REParams, dict(
        metadata_file=md_file,
        output_model_dir=os.path.join(root, "m"),
        feature_bag="bag", partition_entity="entity",
        l2_reg_weight=a.l2_reg_weight,
        regularize_bias=a.regularize_bias,
        num_of_lbfgs_iterations=a.num_of_lbfgs_iterations,
        lbfgs_tolerance=a.lbfgs_tolerance,
        lbfgs_pgtol=a.lbfgs_pgtol,
        num_of_lbfgs_curvature_pairs=a.num_of_lbfgs_curvature_pairs,
        batch_solver=a.batch_solver, dtype=a.dtype,
        random_effect_variance_mode=(None if a.variance_mode == "none"
                                     else a.variance_mode),
        **over))
    base = from_dict(Params, dict(
        action="train", stage="random_effect",
        model_type="logistic_regression", label_column_name="response",
        uid_column_name="uid",
        prediction_score_column_name="predictionScore"))
    return RandomEffectLRModel(mp, base, device=device), base


def run(argv=None):
    """(the models of the ladder's fit, the report logged as `prewarm:
    {json}`). argv as the command line's, --device included."""
    argv, device = pop_device_flag(sys.argv[1:] if argv is None else argv)
    a = build_args(argv)
    tiers = [int(t) for t in a.tiers.split(",")]
    ept = [int(e) for e in a.entities_per_tier.split(",")]
    if len(ept) == 1:
        ept = ept * len(tiers)
    if len(ept) != len(tiers):
        raise SystemExit("--entities_per_tier: one value or one per tier")
    device = resolve_device(device)
    t0 = time.perf_counter()
    built = compile_libraries(device)
    build_s = time.perf_counter() - t0
    logger.info("prewarm: device=%s build_dir=%s cuda build_seconds=%s "
                "native build_seconds=%s (%.3fs)", device,
                built["build_dir"], built["cuda"] or "none on the CPU",
                built["native"], build_s)
    with tempfile.TemporaryDirectory() as root:
        model, base = _model(a, root, device)
        data = synthesize(tiers, ept, a.support, a.entry_width,
                          a.num_features)
        t0 = time.perf_counter()
        if a.host_plane:
            from gdmix_tpu_torch.data.partitioner import (PartitionerConfig,
                                                          assign_group_ids,
                                                          group_flat)
            pcfg = PartitionerConfig(partition_entity="entity",
                                     num_partitions=1,
                                     uid_column_name="uid")
            gids = assign_group_ids(data.columns["entity"],
                                    data.columns["uid"], None, None)
            fg = group_flat(data, pcfg, gids, active_only=True)
            out = model.fit_groups(fg, {}, base)
        else:
            # two passes through a device_cache, as the JAX tool: pass 1
            # the full route/pack/solve ladder, pass 2 the offsets-only
            # reuse path of the multi-sweep pipeline
            dev_cache = {}
            out = model.fit_records_sharded(data, base,
                                            device_cache=dev_cache)
            out = model.fit_records_sharded(data, base,
                                            model_weights=dict(out),
                                            device_cache=dev_cache)
        fit_s = time.perf_counter() - t0
    from gdmix_tpu_torch.gdmix import kernel_launches
    report = dict(built, build_s=build_s, fit_s=fit_s, models=len(out),
                  plane=model.last_fit_plane, tiers=tiers,
                  rungs=model.last_fit_rungs,
                  converged=model.last_fit_converged,
                  launches=kernel_launches())
    logger.info("prewarm: %d models over tiers %s in %.3fs on the %s plane",
                len(out), tiers, fit_s, model.last_fit_plane)
    logger.info("prewarm: %s", json.dumps(report))
    return out, report


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
