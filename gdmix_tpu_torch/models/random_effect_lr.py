"""Random-effect LR: thousands of per-entity models as batched device solves.

Port of gdmix_tpu/models/random_effect_lr.py (the host plane). Entities are
tiered by sample count (the plan of data/bucketing.py) and each tier is
packed on the model's device (ops/re_pack.py); each tier's per-entity
problems are solved at once by the rung of the solver ladder its shape
selects (`_select_solver`, as in the JAX package):

  * primal damped Newton (dim ≤ newton_max_dim; ops/newton.py, whose
    float32 path runs the kernels of ops/newton_lanes.py for dim ≤ 64 and
    the batched solve kernel K3 above it), or, where newton_phase1_iters
    asks for it, two-phase Newton with straggler compaction (the JAX
    package's gate: no variance, more iterations than phase 1's, B > 64;
    on the lanes path the compaction stays on the card);
  * sample-space (Woodbury) dual Newton (samples-per-entity < dim; its n×n
    solve is the multi-RHS kernel K4 for n ≤ 128);
  * L-BFGS on densified per-entity matrices, lockstep over the bucket
    (ops/lbfgs.py:lbfgs_batched);
  * L-BFGS on the sparse per-entity objective (ops/logistic.py).

Every rung returns (θ, variance, converged), with the SIMPLE or FULL
coefficient variance when random_effect_variance_mode asks for it; the
solutions become a columnar ModelTable that is exported as photon-ml model
avro, variances included.

Behavior kept from the JAX package: warm start with prior-model/feature
reconciliation, sparsify-to-support and threshold, validation, active and
passive scoring where entities without a model pass offsets through,
intercept-only models, string or numeric entity ids, out-of-core training
and scoring in entity-complete chunks (stream_chunk_entities), the
multi-sweep device cache of the sweep-static tier tensors and the
warm-sweep downlink skip.

Two planes feed the solver ladder (REParams.re_mode): the host plane
plans the tiers on the host and packs them on the model's device
(fit_groups); the entity-sharded plane routes records to the mesh shard
that owns their entity and groups and packs them on that shard's device
(fit_records_sharded, parallel/entity_sharding.py). "auto" takes the
sharded plane on a mesh of more than one device, as the JAX package does.
The sharded plane solves each shard's slice of a tier on its own device;
two-phase Newton, whose phase-2 cut spans the whole tier in the JAX
package, takes the tier's shards at once, orders and cuts their lanes
together, and then solves each shard's own lanes of that cut.
"""
from __future__ import annotations

import logging
import os
from functools import partial
from typing import Dict, Mapping

import numpy as np
import torch

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.data.bucketing import bucketize
from gdmix_tpu_torch.device import pad_to_multiple, resolve_device
from gdmix_tpu_torch.io import fs, model_avro, scores as scores_io
from gdmix_tpu_torch.io.input_pipeline import load_per_entity_grouped
from gdmix_tpu_torch.io.metadata import DatasetMetadata
from gdmix_tpu_torch.io.model_avro import SparseModel
from gdmix_tpu_torch.io.model_table import (ModelTable, flat_positions,
                                            intersect_prior_support)
from gdmix_tpu_torch.models.api import Model
from gdmix_tpu_torch.ops.lbfgs import lbfgs_batched
from gdmix_tpu_torch.ops.logistic import (SparseBatch, _l2_mask,
                                          entity_logits,
                                          per_entity_value_and_grad,
                                          stable_bce)
from gdmix_tpu_torch.ops.newton import (densify_bucket, dual_variance,
                                        newton_lr_batch, newton_two_phase)
from gdmix_tpu_torch.ops.segment import ENTITY_SENTINEL
from gdmix_tpu_torch.parallel.entity_sharding import (pack_tier,
                                                      route_records,
                                                      shard_rows)
from gdmix_tpu_torch.parallel.mesh import get_mesh, local_mesh, on_device
from gdmix_tpu_torch.parallel.process_group import process_index_and_count
from gdmix_tpu_torch.params import Params, REParams, from_argv
from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy
from gdmix_tpu_torch.util.timing import span

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the tier tensors a sweep does not change (the device cache keeps them);
# the solvers also read the offsets and θ0
_STATIC_COLS = ("indices", "values", "labels", "weights", "sample_count")


_EPSILON = 1.0e-12


def _variance_dense(theta, X, offsets, weights, *, lam, unreg_bias,
                    variance_mode):
    """Per-entity variance from densified X [B, n, dim] (the dense L-BFGS
    rung's, gdmix_tpu/models/random_effect_lr.py:356-371; the FULL form of
    every rung). The reference's Hessian is UN-normalized (no 1/n)."""
    p = torch.sigmoid(torch.einsum("bnd,bd->bn", X, theta) + offsets)
    d = weights * p * (1 - p)                                   # [B, n]
    if variance_mode == constants.SIMPLE:
        hd = torch.einsum("bnd,bn->bd", X * X, d) + lam
        if unreg_bias:
            hd[:, 0] -= lam
        return 1.0 / (hd + _EPSILON)
    dim = X.shape[2]
    H = torch.einsum("bnd,bne->bde", X, X * d[:, :, None]) \
        + (lam + _EPSILON) * torch.eye(dim, dtype=X.dtype, device=X.device)
    if unreg_bias:
        H[:, 0, 0] -= lam
    return torch.diagonal(torch.linalg.inv(H), dim1=1, dim2=2)


def _variance_batch(theta, a, u_cap, *, has_intercept, regularize_bias, lam,
                    variance_mode, X=None):
    """Per-entity variance of the primal and sparse L-BFGS rungs
    (gdmix_tpu/models/random_effect_lr.py:58-86, reference
    binary_logistic_regression.py:144-189). SIMPLE works on the sparse
    records (a feature repeated within a record adds its squares, as the
    JAX package's sparse Hessian diagonal does); FULL inverts the densified
    Hessian (X, densified here when the caller has none)."""
    unreg_bias = has_intercept and not regularize_bias
    if variance_mode != constants.SIMPLE:
        if X is None:
            X = densify_bucket(a["indices"], a["values"], u_cap,
                               has_intercept)
        return _variance_dense(theta, X, a["offsets"], a["weights"], lam=lam,
                               unreg_bias=unreg_bias,
                               variance_mode=variance_mode)
    batch = SparseBatch(a["indices"], a["values"], a["offsets"], a["labels"],
                        a["weights"])
    p = torch.sigmoid(entity_logits(theta, batch,
                                    has_intercept=has_intercept))
    d = a["weights"] * p * (1 - p)                              # [B, n]
    B = theta.shape[0]
    hd = torch.zeros(B, u_cap, dtype=theta.dtype, device=theta.device)
    hd.scatter_add_(1, a["indices"].reshape(B, -1),
                    (a["values"] ** 2 * d[..., None]).reshape(B, -1))
    if has_intercept:
        hd = torch.cat([torch.sum(d, dim=1)[:, None], hd], dim=1)
    hd = hd + lam
    if unreg_bias:
        hd[:, 0] -= lam
    return 1.0 / (hd + _EPSILON)


def _newton_solver(u_cap, has_intercept, regularize_bias, lam, maxiter, ftol,
                   pgtol, m, variance_mode):
    """The primal Newton rung: bucket arrays → (θ [B, dim], variance
    [B, dim] or None, converged [B])."""
    unreg_bias = has_intercept and not regularize_bias

    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        mask = _l2_mask(X.shape[2], has_intercept, regularize_bias, False,
                        X.dtype, X.device)
        res = newton_lr_batch(
            a["theta0"], X, a["labels"], a["weights"], a["offsets"],
            a["sample_count"], l2_reg_weight=lam, l2_mask=mask,
            maxiter=maxiter, ftol=ftol, pgtol=pgtol,
            static_unreg_bias=unreg_bias)
        var = _variance_batch(
            res.theta, a, u_cap, has_intercept=has_intercept,
            regularize_bias=regularize_bias, lam=lam,
            variance_mode=variance_mode, X=X) if variance_mode else None
        return res.theta, var, res.converged
    return solve


def _newton_two_phase_solver(u_cap, has_intercept, regularize_bias, lam,
                             maxiter, ftol, pgtol, m, variance_mode,
                             phase1_iters):
    """Two-phase Newton with straggler compaction
    (gdmix_tpu/models/random_effect_lr.py:235-294; ops/newton.py
    newton_two_phase): `phase1_iters` iterations on the whole tier, then
    the smallest ladder prefix holding the tier's stragglers, stragglers
    first, for `maxiter` from phase 1's θ. `solve(a)` takes one bucket;
    `solve.tier(arrays)` the shards of one tier of the entity-sharded
    plane at once, cut across all of them as the JAX solver cuts its
    sharded array, and returns one result a shard. No variance: the gate
    admits it only with variance_mode None."""
    unreg_bias = has_intercept and not regularize_bias

    def tier(arrays):
        shards = [(a["theta0"],
                   densify_bucket(a["indices"], a["values"], u_cap,
                                  has_intercept),
                   a["labels"], a["weights"], a["offsets"],
                   a["sample_count"]) for a in arrays]
        X = shards[0][1]
        mask = _l2_mask(X.shape[2], has_intercept, regularize_bias, False,
                        X.dtype, X.device)
        return [(res.theta, None, res.converged)
                for res in newton_two_phase(
                    shards, l2_reg_weight=lam, l2_mask=mask,
                    phase1_iters=phase1_iters, maxiter=maxiter, ftol=ftol,
                    pgtol=pgtol, static_unreg_bias=unreg_bias)]

    def solve(a):
        return tier([a])[0]
    solve.tier = tier
    return solve


def _newton_dual_solver(u_cap, has_intercept, regularize_bias, lam, maxiter,
                        ftol, pgtol, m, variance_mode):
    """Sample-space (Woodbury) Newton, the wide-support rung: Newton-rate
    convergence at O(n²·dim) per iteration through the n×n kernel system,
    no [B, dim, dim] Hessian. Selected when samples-per-entity < dim."""
    unreg_bias = has_intercept and not regularize_bias

    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        mask = _l2_mask(X.shape[2], has_intercept, regularize_bias, False,
                        X.dtype, X.device)
        res = newton_lr_batch(
            a["theta0"], X, a["labels"], a["weights"], a["offsets"],
            a["sample_count"], l2_reg_weight=lam, l2_mask=mask,
            maxiter=maxiter, ftol=ftol, pgtol=pgtol, dual=True)
        var = dual_variance(
            res.theta, X, a["labels"], a["weights"], a["offsets"],
            l2_reg_weight=lam, l2_mask=mask,
            full=(variance_mode == constants.FULL),
            epsilon=_EPSILON) if variance_mode else None
        return res.theta, var, res.converged
    return solve


def _lbfgs_dense_solver(u_cap, has_intercept, regularize_bias, lam, maxiter,
                        ftol, pgtol, m, variance_mode):
    """L-BFGS over DENSIFIED per-entity matrices: every funcall is two
    batched [B, n, dim] products, the rung for wide buckets whose samples
    outnumber their features."""
    unreg_bias = has_intercept and not regularize_bias

    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        mask = _l2_mask(X.shape[2], has_intercept, regularize_bias, False,
                        X.dtype, X.device)
        off, lab, wt = a["offsets"], a["labels"], a["weights"]
        inv_n = 1.0 / torch.clamp_min(a["sample_count"], 1.0)

        def fun(th):
            z = torch.einsum("bnd,bd->bn", X, th) + off
            v = (torch.sum(wt * stable_bce(z, lab), dim=1)
                 + 0.5 * lam * torch.sum(mask * th * th, dim=1)) * inv_n
            r = wt * (torch.sigmoid(z) - lab)
            g = (torch.einsum("bnd,bn->bd", X, r) + lam * mask * th) \
                * inv_n[:, None]
            return v, g

        res = lbfgs_batched(fun, a["theta0"], m=m, ftol=ftol, pgtol=pgtol,
                            maxiter=maxiter)
        var = _variance_dense(
            res.x, X, off, wt, lam=lam, unreg_bias=unreg_bias,
            variance_mode=variance_mode) if variance_mode else None
        return res.x, var, res.converged
    return solve


def _lbfgs_solver(u_cap, has_intercept, regularize_bias, lam, maxiter, ftol,
                  pgtol, m, variance_mode):
    """L-BFGS on the sparse per-entity objective, the last rung: no
    densified matrix (FULL variance excepted)."""
    def solve(a):
        batch = SparseBatch(a["indices"], a["values"], a["offsets"],
                            a["labels"], a["weights"])

        def fun(th):
            return per_entity_value_and_grad(
                th, batch, u_cap, has_intercept=has_intercept,
                regularize_bias=regularize_bias, l2_reg_weight=lam,
                sample_count=a["sample_count"])

        res = lbfgs_batched(fun, a["theta0"], m=m, ftol=ftol, pgtol=pgtol,
                            maxiter=maxiter)
        var = _variance_batch(
            res.x, a, u_cap, has_intercept=has_intercept,
            regularize_bias=regularize_bias, lam=lam,
            variance_mode=variance_mode) if variance_mode else None
        return res.x, var, res.converged
    return solve


def _nbytes(tensors) -> int:
    """The bytes of `tensors` in their own types: what a copy of each
    moves."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _bucket_moved(theta: torch.Tensor, theta0: torch.Tensor) -> torch.Tensor:
    """One device bool per bucket: did the solve move any coefficient off
    its warm start? False: every entity stopped at θ0 and the host rebuilds
    the bucket's models from its own θ0, with no [B, dim] copy back (the
    warm-sweep downlink skip, gdmix_tpu/models/random_effect_lr.py:200-207).
    The float32 kernels solve from θ0 in float32, so a float64 model always
    counts as moved."""
    return torch.any(theta != theta0.to(theta.dtype))


def _moved_flags(solved) -> list:
    """The moved probe of every bucket of a fit, [(θ, θ0)] → [bool], read
    back in one host sync."""
    if not solved:
        return []
    return torch.stack([_bucket_moved(th, th0)
                        for th, th0 in solved]).tolist()


class _PackedTier:
    """A tier of a fit, as the solve, the fetch and the collection read
    it: its members' ids and sample counts, its sample cap n_cap and B,
    its u_cap, and once read back its distinct-id counts (u_count as the
    solver pads them, at least 1; u_raw as found) and `support`, the ids
    in slot order (a dummy 0 for an entity with none); theta0, the host
    warm start of a fit with a prior; the sweep-cache entry it fills, if
    any."""

    def __init__(self, entity_ids, sample_count, n_cap, b):
        self.entity_ids, self.sample_count = entity_ids, sample_count
        self.n_cap, self.b = n_cap, b
        self.u_cap = self.u_count = self.u_raw = self.support = None
        self.theta0 = self.cache_entry = None


def _cached_tier(cache, i, tier):
    """The sweep-cache entry of tier i if it holds this tier: the
    same sample cap, B, entity ids and sample counts, and its supports
    read back."""
    ent = cache.get(("flat", i))
    if (ent is not None and ent["support"] is not None
            and (ent["n_cap"], ent["b"]) == (tier.n_cap, tier.b)
            and np.array_equal(ent["sample_count"], tier.sample_count)
            and np.array_equal(ent["entity_ids"], tier.entity_ids)):
        return ent
    return None


def _record_scorer(mkey, mvals, icpt, ent_idx, qkey, values, offsets):
    """Sparse per-record scoring against the CSR model table: each record
    entry's (entity, feature-rank) key is located in the table's sorted
    keys by one binary search; misses (a feature outside the entity's
    support, or an entity without a model) contribute 0, so unmodeled
    entities score logits = offsets (reference job_consumers.py:144-152).
    Returns (per-coordinate logits, total logits)."""
    pos = torch.clamp_max(torch.searchsorted(mkey, qkey), mkey.shape[0] - 1)
    coef = torch.where(mkey[pos] == qkey, mvals[pos],
                       torch.zeros((), dtype=mvals.dtype,
                                   device=mvals.device))
    z_pc = torch.sum(coef * values, dim=1) + icpt[ent_idx]
    return z_pc, z_pc + offsets


class RandomEffectLRModel(Model):
    """Batched per-entity logistic regression."""

    def __init__(self, model_params: REParams, base_params: Params,
                 device=None):
        self.model_params = model_params
        self.base_params = base_params
        self.checkpoint_path = model_params.output_model_dir
        self.metadata_file = model_params.metadata_file
        self.feature_bag_name = model_params.feature_bag
        self.has_intercept = model_params.has_intercept
        self.feature_file = (None if self.feature_bag_name is None
                             else model_params.feature_file)
        if model_params.training_data_dir is not None:
            self.training_data_dir = os.path.join(
                model_params.training_data_dir, constants.ACTIVE)
            self.passive_training_data_dir = os.path.join(
                model_params.training_data_dir, constants.PASSIVE)
        else:
            self.training_data_dir = None
            self.passive_training_data_dir = None
        self.validation_data_dir = model_params.validation_data_dir
        self.metadata = DatasetMetadata.from_file(self.metadata_file)
        self.num_features = self.metadata.num_features(self.feature_bag_name)
        self.dtype = _DTYPES[model_params.dtype]
        self.device = resolve_device(device)
        self.variance_mode = model_params.random_effect_variance_mode
        # (converged, solved) real entities of the last fit, and its
        # buckets per solver rung
        self.last_fit_converged = (0, 0)
        self.last_fit_rungs: Dict[str, int] = {}
        # tiers of the last fit whose models were rebuilt from θ0 (the
        # downlink skip), and how many times a tier's static tensors were
        # packed into a cache (the multi-sweep cache keeps this at one per
        # tier)
        self.last_fit_skipped = 0
        self.static_upload_count = 0
        # the plane of the last fit ("host" or "sharded") and, on the
        # sharded plane, its layout: shards, routing capacity, and each
        # tier as (P·b_cap, n_cap, dim)
        self.last_fit_plane = None
        self.last_fit_sharding = {}
        # the bytes one fit copied host → device and device → host, on
        # either plane, reset at each fit (the JAX package's counters,
        # gdmix_tpu/models/random_effect_lr.py:658). These are the port's
        # own arrays as they cross, uncompacted and in the model's dtype,
        # not the JAX package's compacted relay wire, so the two packages'
        # numbers differ. On the CPU device nothing is copied, and the
        # same tensors are counted.
        self.last_fit_bytes_up = 0
        self.last_fit_bytes_down = 0

    # ------------------------------------------------------------------ train --

    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        logger.info("Kicking off random effect LR training on %s",
                    self.device)
        partition_index = execution_context[constants.PARTITION_INDEX]
        avro_filename = f"part-{partition_index:05d}.avro"
        model_file = os.path.join(self.model_params.output_model_dir,
                                  avro_filename)

        model_weights = self._load_weights(model_file, catch_exception=True)
        from gdmix_tpu_torch.io.input_pipeline import \
            load_per_entity_grouped_flat
        stream = self.model_params.stream_chunk_entities
        streamed = None
        if stream > 0 and self.model_params.data_format == constants.TFRECORD:
            streamed = self._fit_streamed(training_data_dir, model_weights,
                                          schema_params, stream)
        if streamed is not None:
            model_weights = streamed
        else:
            if stream > 0:
                logger.warning(
                    "stream_chunk_entities: streaming needs the native "
                    "tfrecord grouped decoder — loading eagerly instead")
            groups = load_per_entity_grouped_flat(
                training_data_dir, self.metadata,
                self.model_params.partition_entity, self.feature_bag_name,
                data_format=self.model_params.data_format)
            if groups is None:  # non-tfrecord / native-less / ragged presence
                groups = load_per_entity_grouped(
                    training_data_dir, self.metadata,
                    self.model_params.partition_entity, self.feature_bag_name,
                    data_format=self.model_params.data_format)
                model_weights = self.fit_groups(groups, model_weights,
                                                schema_params)
            else:
                model_weights = self.fit_flat(groups, model_weights,
                                              schema_params)
        self._save_model(model_file, model_weights)

        # Scoring
        predict = partial(self._predict_file, schema_params=schema_params,
                          model_weights=model_weights)
        if validation_data_dir:
            o = execution_context.get(constants.VALIDATION_OUTPUT_FILE)
            o and predict(input_path=validation_data_dir, output_file=o)
        if not self.model_params.disable_random_effect_scoring_after_training:
            o = execution_context.get(constants.ACTIVE_TRAINING_OUTPUT_FILE)
            o and predict(input_path=training_data_dir, output_file=o)
            i = execution_context.get(constants.PASSIVE_TRAINING_DATA_DIR)
            o = execution_context.get(constants.PASSIVE_TRAINING_OUTPUT_FILE)
            i and o and predict(input_path=i, output_file=o)

    def _fit_streamed(self, training_data_dir, model_weights, schema_params,
                      chunk_entities: int):
        """Out-of-core RE training (gdmix_tpu/models/random_effect_lr.py:
        521-584): the partition streams as entity-complete FlatGroups chunks
        (io/input_pipeline.py iter_per_entity_grouped_flat_chunks), each
        trained through fit_flat, so host memory holds one chunk plus the
        output model table.

        Each chunk warm-starts from the prior rows of its own entities.
        Chunks hold disjoint entities except the partitioner's capped-entity
        overflow groups (repeated group ids), which keep the eager path's
        last-wins semantics through deduped_last; prior-only entities carry
        forward. Returns the merged mapping, or None when the native grouped
        decoder cannot take the dataset (the caller then loads eagerly)."""
        from gdmix_tpu_torch.io.input_pipeline import \
            iter_per_entity_grouped_flat_chunks
        prior = ModelTable.from_models(model_weights, self.has_intercept)
        if len(model_weights) and prior is None:
            return None  # mixed-variance dict prior: eager path handles it
        tables = []
        n_chunks = n_conv = n_real = 0
        rungs: Dict[str, int] = {}
        for fg in iter_per_entity_grouped_flat_chunks(
                training_data_dir, self.metadata,
                self.model_params.partition_entity, self.feature_bag_name,
                chunk_entities=chunk_entities):
            if fg is None:
                return None
            if len(fg) == 0:
                continue
            n_chunks += 1
            if prior is not None and len(prior):
                id2row = prior.id2row
                rows = np.fromiter((id2row.get(e, -1)
                                    for e in fg.entity_ids), np.int64,
                                   len(fg.entity_ids))
                pchunk = prior.select_rows(rows[rows >= 0])
            else:
                pchunk = ModelTable.empty(
                    self.has_intercept,
                    with_variance=self.variance_mode is not None)
            out = self.fit_flat(fg, pchunk, schema_params)
            table = (out if isinstance(out, ModelTable)
                     else ModelTable.from_models(out, self.has_intercept))
            if table is None:  # incompatible prior/new layout: go eager
                return None
            tables.append(table)
            n_conv += self.last_fit_converged[0]
            n_real += self.last_fit_converged[1]
            for rung, k in self.last_fit_rungs.items():
                rungs[rung] = rungs.get(rung, 0) + k
        self.last_fit_converged = (n_conv, n_real)
        self.last_fit_rungs = rungs
        if not tables:
            return (prior if prior is not None and len(prior)
                    else dict(model_weights))
        with_var = tables[0].with_variance
        new = ModelTable.concat(tables, has_intercept=self.has_intercept,
                                with_variance=with_var).deduped_last()
        merged = prior.merged_with(new) if prior is not None and len(prior) \
            else new
        logger.info("streamed RE fit: %d models over %d chunks "
                    "(chunk_entities=%d)", len(merged), n_chunks,
                    chunk_entities)
        return merged

    # ---------------------------------------------------------- bucket solving --

    def _flat_records_view(self, fg):
        """A FlatGroups partition as per-record columns, zero-copy: the
        input form fit_records_sharded takes. No per-record entity column:
        fit_flat hands the grouping over as `entity_groups`."""
        from gdmix_tpu_torch.io.input_pipeline import PerRecordData
        return PerRecordData(columns=dict(fg.columns), indices=fg.indices,
                             values=fg.values, nnz=fg.rec_nnz,
                             num_samples=int(np.asarray(fg.counts).sum()))

    def fit_flat(self, fg, model_weights: Mapping[str, SparseModel],
                 schema_params,
                 device_cache=None) -> Mapping[str, SparseModel]:
        """Train a columnar FlatGroups partition through the configured
        random-effect plane (REParams.re_mode, as in
        gdmix_tpu/models/random_effect_lr.py:598-641):

          sharded — route records to the mesh shard that owns their entity
                    and group and pack them ON DEVICE (fit_records_sharded);
                    "auto" takes it when the feature bag is rectangular AND
                    the mesh (parallel/mesh.get_mesh: every visible card)
                    has more than one device.
          host    — the plan on the host, each tier packed on the
                    model's device (fit_groups); "auto" on one device.

        The FlatGroups is grouped already: its entity ids are factorized at
        E scale (the sharded fit's `factorize` phase), and each entity's
        record run is handed over with them. Across processes each process
        solves its own partition on its LOCAL mesh (parallel/mesh.
        local_mesh); the level across processes stays the partition
        round-robin of the driver."""
        from gdmix_tpu_torch.data.partitioner import factorize_entities
        mesh = (get_mesh(device=self.device)
                if process_index_and_count()[1] == 1
                else local_mesh(device=self.device))
        mode = self.model_params.re_mode
        use_sharded = (mode == "sharded"
                       or (mode == "auto" and fg.indices is not None
                           and mesh.size > 1))
        if not use_sharded:
            return self.fit_groups(fg, model_weights, schema_params,
                                   device_cache=device_cache)
        with span("re.factorize") as factorize:
            counts = np.asarray(fg.counts, np.int64)
            uniq, ginv = factorize_entities(np.asarray(fg.entity_ids,
                                                       object))
            inv = np.repeat(ginv, counts)
            ecounts = np.bincount(ginv, weights=counts,
                                  minlength=len(uniq)).astype(np.int64)
            # each entity's records are one run of fg, at its group's
            # start, in fg's order (not factorize's sorted order); an
            # entity repeated in fg (a capped entity's overflow groups) has
            # no one run
            rec_starts = None
            if len(uniq) == len(fg):
                rec_starts = np.zeros(len(uniq), np.int64)
                rec_starts[ginv] = np.cumsum(counts) - counts
        out = self.fit_records_sharded(
            self._flat_records_view(fg), schema_params,
            model_weights=model_weights, mesh=mesh,
            entity_groups=(uniq, inv, ecounts, rec_starts),
            device_cache=device_cache)
        self.last_fit_phases = dict(factorize=factorize.seconds,
                                    **self.last_fit_phases)
        return out

    def fit_groups(self, groups, model_weights: Mapping[str, SparseModel],
                   schema_params,
                   device_cache=None) -> Mapping[str, SparseModel]:
        """In-memory batched training of all entities in `groups` (a
        List[EntityGroup] or columnar FlatGroups); returns the prior ∪ new
        model mapping (prior-only entities carry forward, reference
        :155-163) as a columnar ModelTable (a plain dict only when the prior
        mixes variance presence).

        Every input form takes one route (_marshal_packed): ops/re_pack.py
        FlatPack packs it on the model's device. `device_cache`: a dict the
        caller keeps across coordinate-descent sweeps over the same records.

        last_fit_phases holds the seconds of the fit's three spans:
        `re.marshal_dispatch` (the plan, pass 1 and each tier's pack,
        `re.bucketize`; the flat columns' upload and a prior's θ0,
        `re.upload`; each solve's launch, `re.launch`),
        `re.solve_fetch_collect` (`re.fetch` in _fetch, `re.collect`) and
        `re.merge`."""
        logger.info("Training %d entities", len(groups))
        self.last_fit_plane = "host"
        self.last_fit_bytes_up = self.last_fit_bytes_down = 0
        # every tier's solve is queued before any result is fetched; each
        # is (tier, (θ, variance, converged), the device θ0, which stays
        # for the downlink skip's probe)
        pending = []
        rungs: Dict[str, int] = {}
        with span("re.marshal_dispatch") as marshal:
            pack = self._marshal_packed(groups, model_weights, schema_params,
                                        device_cache, pending, rungs)
        with span("re.solve_fetch_collect") as solve_fetch_collect:
            self._packed_supports(pack, [t for t, _, _ in pending])
            # warm-sweep downlink skip (gdmix_tpu/models/random_effect_lr.py:
            # 685-701): a tier whose solve moved no coefficient (every
            # entity stopped at its warm start) takes its models from the
            # host θ0
            if self.variance_mode is None and len(model_weights):
                moved = _moved_flags([(solved[0], th0)
                                      for _, solved, th0 in pending])
                self.last_fit_bytes_down += len(pending)  # one bool a tier
            else:
                moved = [True] * len(pending)
            self.last_fit_skipped = moved.count(False)
            n_conv = n_real = 0
            tables = []
            for (tier, (theta, variance, converged), _), mv in zip(pending,
                                                                  moved):
                b_real = len(tier.entity_ids)
                n_conv += int(self._fetch(converged[:b_real].sum()))
                n_real += b_real
                theta = self._fetch(theta[:b_real]) if mv else tier.theta0
                variance = (None if variance is None
                            else self._fetch(variance[:b_real]))
                with span("re.collect"):
                    tables.append(self._collect_bucket_table(tier, theta,
                                                             variance))
            self.last_fit_converged = (n_conv, n_real)
            self.last_fit_rungs = rungs
            new = ModelTable.concat(tables, has_intercept=self.has_intercept,
                                    with_variance=self.variance_mode
                                    is not None)
        with span("re.merge") as merge:
            # a capped entity's overflow groups each solve a model; keep the
            # last
            new = new.deduped_last()
            prior = ModelTable.from_models(model_weights, self.has_intercept)
            if prior is None:  # mixed variance presence in the prior dict
                merged = dict(model_weights)
                merged.update(new)
            else:
                merged = prior.merged_with(new)
        self.last_fit_phases = dict(
            marshal_dispatch=marshal.seconds,
            solve_fetch_collect=solve_fetch_collect.seconds,
            merge=merge.seconds)
        logger.info("%d models in total after training/refreshing. | %s",
                    len(merged),
                    " ".join(f"{nm}={dt:.3f}s"
                             for nm, dt in self.last_fit_phases.items()))
        return merged

    def _launch(self, tier, arrays, pending, rungs) -> None:
        """Queue the solve of one tier on its rung."""
        rung, solve = self._select_solver(tier.u_cap,
                                          arrays["indices"].shape[0],
                                          tier.n_cap)
        rungs[rung] = rungs.get(rung, 0) + 1
        with span("re.launch"):
            solved = solve(arrays)
        pending.append((tier, solved, arrays["theta0"]))

    def _marshal_packed(self, groups, model_weights, schema_params, cache,
                        pending, rungs):
        """The fit's marshal on the model's device (ops/re_pack.py
        FlatPack): the input as a FlatGroups, the plan on the host, one
        upload of its flat columns, pass 1 and the caps read back, every
        tier's pack, then the solves. A tier's warm start is the prior
        reconciled on the host from the supports (then read back first),
        else zeros made on the device.

        `cache` (the single-device branch of gdmix_tpu/models/
        random_effect_lr.py:746-852): each tier's _STATIC_COLS and supports
        under ("flat", tier). A tier hits when its sample cap, B, entity
        ids and sample counts match; then only its offsets are packed (from
        the offsets column alone when every tier hits). The caller owns the
        invariant that only the offsets changed (workflow/pipeline.py).
        Each tier packed into the cache adds one to static_upload_count.
        Returns the FlatPack (None for no entity), whose supports
        _packed_supports reads back after the solves."""
        from gdmix_tpu_torch.ops import re_pack
        p = self.model_params
        with span("re.bucketize"):
            if not len(groups):
                return None
            pack = re_pack.FlatPack(
                groups, label_column=schema_params.label_column_name,
                weight_column=schema_params.weight_column_name,
                offset_column=p.offset_column_name, device=self.device,
                dtype=self.dtype)
            eids = np.asarray(pack.fg.entity_ids, object)
            tiers = [_PackedTier(eids[t.members], pack.counts[t.members],
                                 t.n_cap, t.b) for t in pack.tiers]
            hits = [None if cache is None else _cached_tier(cache, i, t)
                    for i, t in enumerate(tiers)]
        with span("re.upload"):
            self._uploaded(pack.upload(static=not all(hits)))
        if not all(hits):
            with span("re.bucketize"):
                pack.supports()
        warm = len(model_weights) > 0
        off = 1 if self.has_intercept else 0
        inputs = []
        for i, (t, hit) in enumerate(zip(tiers, hits)):
            with span("re.bucketize"):
                arrays = pack.tier(i, static=hit is None)
                if hit:
                    t.u_cap, t.u_count, t.u_raw, t.support = (
                        hit[k] for k in ("u_cap", "u_count", "u_raw",
                                         "support"))
                    arrays.update(hit["static"])
                else:
                    t.u_cap = pack.u[i]
                if not hit and cache is not None:
                    self.static_upload_count += 1
                    t.cache_entry = cache[("flat", i)] = dict(
                        n_cap=t.n_cap, b=t.b, entity_ids=t.entity_ids,
                        sample_count=t.sample_count, u_cap=t.u_cap,
                        static={k: arrays[k] for k in _STATIC_COLS},
                        u_count=None, u_raw=None, support=None)
                if not warm:
                    arrays["theta0"] = torch.zeros(
                        t.b, t.u_cap + off, dtype=self.dtype,
                        device=self.device)
            inputs.append(arrays)
        # every tier is packed before any solve allocates its own tensors
        pack.release()
        if warm:
            # the warm start is reconciled on the host from the supports
            # that pass 2 wrote
            self._packed_supports(pack, tiers)
            theta0 = re_pack.prior_theta0(
                [t.entity_ids for t in tiers],
                [(t.u_raw, t.support) for t in tiers],
                [t.u_cap for t in tiers], [t.b for t in tiers],
                model_weights, self.has_intercept)
            for t, arrays, th0 in zip(tiers, inputs, theta0):
                t.theta0 = th0
                with span("re.upload"):
                    up = newton_inputs_from_numpy({"theta0": th0},
                                                  self.device, self.dtype)
                    self._uploaded(up.values())
                    arrays.update(up)
        for t, arrays in zip(tiers, inputs):
            self._launch(t, arrays, pending, rungs)
        return pack

    def _packed_supports(self, pack, tiers) -> None:
        """Each tier's supports on the host, where it has none yet: one read
        of the pack's compact buffer (ops/re_pack.py FlatPack); a tier that
        fills a cache entry leaves them there."""
        todo = [i for i, t in enumerate(tiers) if t.support is None]
        if not todo:
            return
        ids = self._fetch(pack.support_ids).numpy()
        for i in todo:
            t = tiers[i]
            t.u_raw, t.support = pack.host_supports(ids, i)
            t.u_count = np.maximum(t.u_raw, 1).astype(np.int32)
            if t.cache_entry is not None:
                t.cache_entry.update(u_count=t.u_count, support=t.support,
                                     u_raw=t.u_raw)

    def _uploaded(self, tensors):
        """`tensors`, their bytes added to last_fit_bytes_up."""
        self.last_fit_bytes_up += _nbytes(tensors)
        return tensors

    def _fetch(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on the host, its bytes added to last_fit_bytes_down: the
        model's one device→host path, each call a `re.fetch` span."""
        self.last_fit_bytes_down += _nbytes([t])
        with span("re.fetch"):
            return t.to("cpu")

    def _select_solver(self, u_cap: int, B: int, n_cap: int):
        """The solver ladder of the JAX package
        (gdmix_tpu/models/random_effect_lr.py:862-899): Newton (dim ≤
        newton_max_dim; two-phase where newton_phase1_iters > 0, no
        variance is asked for, the iterations exceed phase 1's and B > 64)
        → sample-space dual Newton (n < dim, kernel fits) → densified
        L-BFGS → sparse L-BFGS. Returns (rung name, solve)."""
        p = self.model_params
        dim = u_cap + (1 if self.has_intercept else 0)
        use_newton = (p.batch_solver == "newton"
                      or (p.batch_solver == "auto"
                          and dim <= p.newton_max_dim))
        # explicit newton_dual is honored whenever the kernel fits; auto
        # additionally requires n_cap < dim (where sample space is cheaper)
        use_dual = (not use_newton
                    and (p.batch_solver == "newton_dual"
                         or (p.batch_solver == "auto" and n_cap < dim))
                    and B * n_cap * n_cap <= p.dual_newton_max_elems
                    and B * n_cap * dim <= p.dense_lbfgs_max_elems)
        if p.batch_solver == "newton_dual" and not use_dual \
                and not use_newton:
            logger.warning(
                "batch_solver=newton_dual: bucket B=%d n=%d dim=%d exceeds "
                "dual_newton_max_elems/dense_lbfgs_max_elems — falling back "
                "to L-BFGS", B, n_cap, dim)
        use_dense = (not use_newton and not use_dual
                     and B * n_cap * dim <= p.dense_lbfgs_max_elems)
        key = (u_cap, self.has_intercept, p.regularize_bias,
               float(p.l2_reg_weight), p.num_of_lbfgs_iterations,
               float(p.lbfgs_tolerance), float(p.lbfgs_pgtol),
               p.num_of_lbfgs_curvature_pairs, self.variance_mode)
        if (use_newton and p.newton_phase1_iters > 0
                and self.variance_mode is None
                and p.num_of_lbfgs_iterations > p.newton_phase1_iters
                and B > 64):
            return "newton_two_phase", _newton_two_phase_solver(
                *key, p.newton_phase1_iters)
        rung, factory = (("newton", _newton_solver) if use_newton
                         else ("newton_dual", _newton_dual_solver) if use_dual
                         else ("lbfgs_dense", _lbfgs_dense_solver)
                         if use_dense else ("lbfgs", _lbfgs_solver))
        return rung, factory(*key)

    def _collect_bucket_table(self, tier: _PackedTier, theta,
                              variance) -> ModelTable:
        """The tier's [B, dim] solution (and variances) as ModelTable
        columns (one masked gather, no per-entity python). `theta`: the
        device solution, or the host θ0 of a tier the solve did not move
        (float64, as the JAX package rebuilds it; no copy back)."""
        b_real = len(tier.entity_ids)
        thetas = (np.asarray(theta[:b_real], np.float64)
                  if isinstance(theta, np.ndarray)
                  else theta[:b_real].to("cpu", torch.float64).numpy())
        off = 1 if self.has_intercept else 0
        tau = self.model_params.sparsity_threshold
        thetas = np.where(np.abs(thetas) <= tau, 0.0, thetas)
        u_count = tier.u_count[:b_real].astype(np.int64)
        u_cap = tier.u_cap
        mask = np.arange(u_cap)[None, :] < u_count[:, None]
        offs = np.zeros(b_real + 1, np.int64)
        np.cumsum(u_count, out=offs[1:])
        var = (None if variance is None
               else variance[:b_real].to("cpu", torch.float64).numpy())
        return ModelTable(
            ids=np.asarray(tier.entity_ids, object), offs=offs,
            coef_ids=tier.support,
            coef_vals=thetas[:, off:off + u_cap][mask],
            icpt=thetas[:, 0].copy() if off else None,
            coef_vars=None if var is None else var[:, off:off + u_cap][mask],
            icpt_vars=var[:, 0].copy() if var is not None and off else None)

    # ------------------------------------------------- entity-sharded fit --

    @staticmethod
    def _entity_supports(inv: np.ndarray, indices, values, nnz,
                         num_entities: int, num_features: int):
        """Per-entity sorted unique feature support from per-record padded-COO
        data, fully vectorized (mirrors bucketize's compact support). Returns
        flat (sup_keys, sup_feat, sup_offs[E+1]) where sup_keys = e*D + feat
        is sorted ascending (the np.unique output, reused for the warm-start
        key intersection)."""
        if indices is None:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(num_entities + 1, np.int64))
        k = indices.shape[1]
        if nnz is not None:
            entry_ok = np.arange(k)[None, :] < nnz[:, None]
        else:
            entry_ok = values != 0
        flat_ent = np.repeat(inv, k)[entry_ok.reshape(-1)]
        flat_feat = indices.reshape(-1)[entry_ok.reshape(-1)].astype(np.int64)
        keys = np.unique(flat_ent.astype(np.int64) * num_features + flat_feat)
        sup_ent = keys // num_features
        sup_feat = keys % num_features
        sup_offs = np.searchsorted(sup_ent, np.arange(num_entities + 1))
        return keys, sup_feat, sup_offs

    def _local_supports(self, data, inv, counts, rec_starts, indices,
                        values):
        """(local [N, K] int32 per-entry ids in the entity's compact
        support, sup_keys, sup_feat, sup_offs [E+1], u_counts [E]): the
        reference's enable_local_indexing (job_consumers.py:209-232). With
        each entity's record run known (`rec_starts`), the multicore C++
        per-entity dedup; otherwise one N-scale unique + searchsorted."""
        from gdmix_tpu_torch import native
        E, D = len(counts), self.num_features
        nat = None
        if rec_starts is not None and data.indices is not None:
            nat = native.entry_local(indices, values, data.nnz, counts,
                                     rec_starts,
                                     use_value_mask=data.nnz is None)
        if nat is not None:
            local, sup_feat, u_counts, sup_offs = nat
            sup_keys = (np.repeat(np.arange(E, dtype=np.int64), u_counts) * D
                        + sup_feat)
            return local, sup_keys, sup_feat, sup_offs, u_counts
        sup_keys, sup_feat, sup_offs = self._entity_supports(
            inv, data.indices, data.values, data.nnz, E, D)
        local = np.zeros(indices.shape, np.int32)
        if data.indices is not None and sup_keys.size:
            k = indices.shape[1]
            if data.nnz is not None:
                entry_ok = np.arange(k)[None, :] \
                    < np.asarray(data.nnz)[:, None]
            else:
                entry_ok = values != 0
            flat_pos = np.flatnonzero(entry_ok.ravel())
            ent_e = inv[flat_pos // k].astype(np.int64)
            fid_e = indices.ravel()[flat_pos].astype(np.int64)
            pos = np.searchsorted(sup_keys, ent_e * D + fid_e)
            li = local.reshape(-1)
            li[flat_pos] = (pos - sup_offs[ent_e]).astype(np.int32)
        return local, sup_keys, sup_feat, sup_offs, np.diff(sup_offs)

    def _warm_start_local(self, model_weights, prior_table, uniq, sup_keys,
                          sup_feat, sup_offs):
        """The prior reconciled onto each entity's compact support
        (reference job_consumers.py:260-288): (warm_icpt as (entity,
        value) or None, warm_coef as (entity, local position, value) or
        None). One key intersection for a table prior; the per-entity path
        for a dict prior that mixes variance presence."""
        off = 1 if self.has_intercept else 0
        E, D = len(uniq), self.num_features
        warm_icpt = warm_coef = None
        if len(model_weights) and prior_table is not None \
                and E * D < (1 << 62):
            id2row = prior_table.id2row
            prow = np.fromiter((id2row.get(u, -1) for u in uniq), np.int64, E)
            ents = np.flatnonzero(prow >= 0)
            if ents.size:
                if off and prior_table.icpt is not None:
                    warm_icpt = (ents, prior_table.icpt[prow[ents]])
                p_ent, _, p_val, pos, hit = intersect_prior_support(
                    prior_table, ents, prow[ents], sup_keys, D)
                warm_coef = (p_ent[hit],
                             pos[hit] - sup_offs[p_ent[hit]], p_val[hit])
        elif len(model_weights):
            wi_e, wi_v, w_e, w_l, w_v = [], [], [], [], []
            for e in range(E):
                prior = model_weights.get(uniq[e])
                if prior is None:
                    continue
                if off:
                    wi_e.append(e)
                    wi_v.append(prior.theta[0])
                sup = sup_feat[sup_offs[e]:sup_offs[e + 1]]
                if len(prior.unique_global_indices) and len(sup):
                    p_idx = np.asarray(prior.unique_global_indices)
                    order = np.argsort(p_idx, kind="stable")
                    p_sorted = p_idx[order]
                    p_theta = np.asarray(prior.theta[off:])[order]
                    pos = np.clip(np.searchsorted(p_sorted, sup), 0,
                                  len(p_sorted) - 1)
                    hit = p_sorted[pos] == sup
                    w_e.append(np.full(int(hit.sum()), e, np.int64))
                    w_l.append(np.flatnonzero(hit).astype(np.int64))
                    w_v.append(p_theta[pos[hit]])
            if wi_e:
                warm_icpt = (np.asarray(wi_e, np.int64), np.asarray(wi_v))
            if w_e:
                warm_coef = (np.concatenate(w_e), np.concatenate(w_l),
                             np.concatenate(w_v))
        return warm_icpt, warm_coef

    def fit_records_sharded(self, data, schema_params,
                            model_weights: Mapping[str, SparseModel] = None,
                            mesh=None, entity_groups=None,
                            device_cache=None) -> Mapping[str, SparseModel]:
        """Train straight from per-record data (a PerRecordData) on the
        entity-sharded plane (gdmix_tpu/models/random_effect_lr.py:991-1366):
        records are routed to the mesh shard owning their entity
        (parallel/entity_sharding ≡ the Spark shuffle-by-entity,
        DataPartitioner.scala:235-276), grouped and packed into per-TIER
        solver blocks on that shard's device, and each shard solves its own
        entities with the solver ladder of the host plane. Returns the
        prior ∪ new models, as fit_groups does.

        Tiering + local indexing: entities fall into power-of-two
        sample-count tiers (the host plane's ladder), and every record's
        feature ids are remapped on the host to the entity's compact
        [0, U) support before routing, so each tier's solve dimension is
        its largest support, not the global feature count.

        Slot assignment is host-predicted (build_entity_blocks packs each
        shard's entities in ascending entity order), so every tier's route,
        pack and solve is queued before any result is read back. A tier's
        solve runs once per shard, on that shard's [b_cap] slice and
        device; every entity is solved alone, so this equals one solve of
        the P·b_cap batch.

        `entity_groups`: (uniq, inv, counts, rec_starts) from a caller that
        has the records grouped already (fit_flat); rec_starts (or None)
        gives each entity's record run. `device_cache`: a dict the caller
        keeps across coordinate-descent sweeps over the same records
        (workflow/pipeline.py): from sweep 2 on only the offsets are routed
        again; the routed entity/tier tags and each tier's packed static
        columns stay on the devices."""
        from gdmix_tpu_torch.data.bucketing import _next_pow2, _sample_caps
        from gdmix_tpu_torch.data.partitioner import factorize_entities
        with span("re.host_prep") as host_prep:
            self.last_fit_plane = "sharded"
            self.last_fit_skipped = 0
            self.last_fit_bytes_up = self.last_fit_bytes_down = 0
            up = self._uploaded
            model_weights = model_weights if model_weights is not None else {}
            mesh = mesh if mesh is not None else get_mesh(device=self.device)
            P = mesh.size
            p = self.model_params
            n = data.num_samples
            dt = self.dtype
            off = 1 if self.has_intercept else 0

            if entity_groups is not None:
                uniq, inv, counts, rec_starts = entity_groups
            else:
                uniq, inv = factorize_entities(
                    data.columns[p.partition_entity])
                counts = np.bincount(inv, minlength=len(uniq))
                rec_starts = None
            E = len(uniq)
            prior_table = ModelTable.from_models(model_weights,
                                                 self.has_intercept)
            if E == 0:
                self.last_fit_phases = {}
                return (prior_table if prior_table is not None
                        else dict(model_weights))

            # the sweep cache (fit_groups' device_cache contract): a hit
            # needs the same records count, entities, shards, counts and
            # entry width; the caller owns the invariant that only offsets
            # change
            k_now = data.indices.shape[1] if data.indices is not None else 0
            chit = None
            if device_cache is not None:
                ent_c = device_cache.get("sharded")
                if (ent_c is not None and ent_c["n"] == n and ent_c["E"] == E
                        and ent_c["num_shards"] == P and ent_c["k"] == k_now
                        and np.array_equal(ent_c["counts"], counts)
                        and np.array_equal(ent_c["uniq"], uniq)):
                    chit = ent_c
            # round-robin ownership over the sorted entity ids (any balanced
            # deterministic assignment works)
            owner_of_entity = (np.arange(E) % P).astype(np.int32)
            offsets = (data.columns[p.offset_column_name].astype(np.float64)
                       if p.offset_column_name in data.columns
                       else np.zeros(n))
            if chit is None:
                labels = (data.columns[schema_params.label_column_name]
                          .astype(np.float64)
                          if schema_params.label_column_name in data.columns
                          else np.zeros(n))
                weights = (data.columns[schema_params.weight_column_name]
                           .astype(np.float64)
                           if schema_params.weight_column_name
                           and schema_params.weight_column_name
                           in data.columns
                           else np.ones(n))
                if data.indices is not None:
                    indices, values = data.indices, data.values
                else:
                    indices = np.zeros((n, 1), np.int32)
                    values = np.zeros((n, 1))
                local_indices, sup_keys, sup_feat, sup_offs, u_counts = \
                    self._local_supports(data, inv, counts, rec_starts,
                                         indices, values)
                u_eff = np.maximum(u_counts, 1)
                caps = np.asarray(_sample_caps(np.asarray(counts), 8))
                tier_of_entity = np.searchsorted(
                    caps, counts, side="left").astype(np.int32)
            else:
                (sup_keys, sup_feat, sup_offs, u_counts, tier_of_entity,
                 slot_of_entity, tiers, owner_pad, capacity, extra) = (
                    chit["sup_keys"], chit["sup_feat"], chit["sup_offs"],
                    chit["u_counts"], chit["tier_of_entity"],
                    chit["slot_of_entity"], chit["tiers"], chit["owner_pad"],
                    chit["capacity"], chit["extra"])
        with span("re.route") as route:
            if chit is None:
                # pad the record axis to split evenly; padding rows carry
                # weight 0 and the entity sentinel (they never enter a block)
                n_pad = pad_to_multiple(max(n, 1), P * 8)
                rows_per_shard = n_pad // P
                extra = n_pad - n

                def padr(a, fill=0.0):
                    if not extra:
                        return a
                    block = np.full((extra,) + a.shape[1:], fill, a.dtype)
                    return np.concatenate([a, block], axis=0)

                ent_rows = padr(inv.astype(np.int32), int(ENTITY_SENTINEL))
                owner_pad = padr(owner_of_entity[inv], 0)
                if extra:  # padding rows round-robin (with the sentinel)
                    owner_pad[n:] = np.arange(extra) % P
                tier_rows = padr(tier_of_entity[inv], 0)

                # exact capacity: the most records a source shard sends
                # anywhere
                src = np.arange(n_pad) // rows_per_shard
                pair = np.bincount(src * P + owner_pad, minlength=P * P)
                capacity = pad_to_multiple(max(int(pair.max()), 1), 8)
                per_shard_rows = P * capacity

                # ONE exchange of every payload column, entity/tier tags
                # included
                routed = route_records(
                    mesh,
                    dict(indices=up(shard_rows(mesh, padr(local_indices))),
                         values=up(shard_rows(mesh, padr(values), dt)),
                         offsets=up(shard_rows(mesh, padr(offsets), dt)),
                         labels=up(shard_rows(mesh, padr(labels), dt)),
                         weights=up(shard_rows(mesh, padr(weights), dt)),
                         _ent=up(shard_rows(mesh, ent_rows)),
                         _tier=up(shard_rows(mesh, tier_rows))),
                    up(shard_rows(mesh, owner_pad)), capacity=capacity)
                r_ent = routed.arrays["_ent"]
                r_tier = routed.arrays["_tier"]
            else:
                off_pad = (np.concatenate([offsets, np.zeros(extra)])
                           if extra else offsets)
                routed = route_records(
                    mesh, dict(offsets=up(shard_rows(mesh, off_pad, dt))),
                    up(shard_rows(mesh, owner_pad)), capacity=capacity)
                r_ent, r_tier = chit["r_ent"], chit["r_tier"]
        with span("re.plan_warm") as plan_warm:
            if chit is None:
                # host-predicted slots: build_entity_blocks packs each
                # shard's tier members in ascending entity order, so slot =
                # owner·b_cap + rank within the owner
                tiers = []
                # within its own tier
                slot_of_entity = np.full(E, -1, np.int64)
                for t in range(len(caps)):
                    members = np.flatnonzero(tier_of_entity == t)
                    if members.size == 0:
                        continue
                    own_m = owner_of_entity[members]
                    per_shard = np.bincount(own_m, minlength=P)
                    b_cap_t = min(max(8, _next_pow2(int(per_shard.max()))),
                                  per_shard_rows)
                    u_cap_t = pad_to_multiple(
                        max(int(u_eff[members].max()), 1), 8)
                    # members already ↑
                    order = np.argsort(own_m, kind="stable")
                    sorted_members = members[order]
                    shard_of = own_m[order]
                    shard_starts = np.searchsorted(shard_of, np.arange(P))
                    rank = np.arange(members.size) - shard_starts[shard_of]
                    slots = shard_of.astype(np.int64) * b_cap_t + rank
                    slot_of_entity[sorted_members] = slots
                    tiers.append(dict(t=t, n_cap=int(caps[t]), b_cap=b_cap_t,
                                      u_cap=u_cap_t, members=sorted_members,
                                      slots=slots))
            tier_static = {} if device_cache is not None and chit is None \
                else None

            warm_icpt, warm_coef = self._warm_start_local(
                model_weights, prior_table, uniq, sup_keys, sup_feat, sup_offs)
        with span("re.dispatch") as dispatch:
            # every tier's pack + solve is queued before anything is read back
            pending = []
            rungs: Dict[str, int] = {}
            for ti in tiers:
                dim_t = ti["u_cap"] + off
                theta0 = np.zeros((P * ti["b_cap"], dim_t))
                if warm_icpt is not None:
                    we, wv = warm_icpt
                    sel = tier_of_entity[we] == ti["t"]
                    theta0[slot_of_entity[we[sel]], 0] = wv[sel]
                if warm_coef is not None:
                    ce, cl, cv = warm_coef
                    sel = tier_of_entity[ce] == ti["t"]
                    theta0[slot_of_entity[ce[sel]], off + cl[sel]] = cv[sel]
                sample_count = np.zeros(P * ti["b_cap"])
                sample_count[ti["slots"]] = counts[ti["members"]]
                blocks, _, _, pack_dropped = pack_tier(
                    mesh, routed, r_ent, r_tier, ti["t"], b_cap=ti["b_cap"],
                    n_cap=ti["n_cap"])
                if chit is not None:
                    # sweep 2+: only offsets were routed; the static packed
                    # columns are the cached device tensors
                    blocks = dict(chit["tier_static"][ti["t"]],
                                  offsets=blocks["offsets"])
                elif tier_static is not None:
                    tier_static[ti["t"]] = {
                        k: blocks[k]
                        for k in ("indices", "values", "labels", "weights")}
                rung, solve = self._select_solver(
                    ti["u_cap"], P * ti["b_cap"], ti["n_cap"])
                rungs[rung] = rungs.get(rung, 0) + 1
                theta0_s = up(shard_rows(mesh, theta0, dt))
                count_s = up(shard_rows(mesh, sample_count, dt))
                arrays = []
                for s in range(P):
                    a = {k: v[s] for k, v in blocks.items()}
                    a["indices"] = a["indices"].long()
                    a["sample_count"], a["theta0"] = count_s[s], theta0_s[s]
                    arrays.append(a)
                if rung == "newton_two_phase":
                    # the tier's shards at once: the cut spans all of them
                    solved = solve.tier(arrays)
                else:
                    solved = []
                    for a, dev in zip(arrays, mesh.devices):
                        with on_device(dev):
                            solved.append(solve(a))
                pending.append((ti, solved, pack_dropped))
            if tier_static is not None:
                self.static_upload_count += 1
                device_cache["sharded"] = dict(
                    n=n, E=E, k=k_now, num_shards=P,
                    counts=np.array(counts, copy=True),
                    uniq=np.array(uniq, copy=True),
                    sup_keys=sup_keys, sup_feat=sup_feat, sup_offs=sup_offs,
                    u_counts=u_counts, tier_of_entity=tier_of_entity,
                    slot_of_entity=slot_of_entity, tiers=tiers,
                    owner_pad=owner_pad, capacity=capacity, extra=extra,
                    r_ent=r_ent, r_tier=r_tier, tier_static=tier_static)
        with span("re.fetch_collect") as fetch_collect:
            # columnar collection: each tier's support coefficients gathered
            # straight into ModelTable columns (no per-entity python)
            with_var = self.variance_mode is not None
            host = lambda ts: torch.cat([self._fetch(t).double()
                                         for t in ts]).numpy()
            dropped = sum(int(self._fetch(o.sum())) for o in routed.overflow)
            tables = []
            n_conv = 0
            for ti, solved, pack_dropped in pending:
                thetas = host([s[0] for s in solved])
                variances = host([s[1] for s in solved]) if with_var else None
                conv = torch.cat([self._fetch(s[2]) for s in solved]).numpy()
                dropped += sum(int(self._fetch(d.sum()))
                               for d in pack_dropped)
                thetas = np.where(np.abs(thetas) <= p.sparsity_threshold, 0.0,
                                  thetas)
                ents_t, slots_t = ti["members"], ti["slots"]
                n_conv += int(conv[slots_t].sum())
                lens = u_counts[ents_t]
                src = flat_positions(sup_offs[ents_t], lens)
                inner = np.arange(int(lens.sum())) \
                    - np.repeat(np.cumsum(lens) - lens, lens)
                rows = np.repeat(slots_t, lens)
                offs_out = np.zeros(len(ents_t) + 1, np.int64)
                np.cumsum(lens, out=offs_out[1:])
                tables.append(ModelTable(
                    ids=uniq[ents_t].astype(object), offs=offs_out,
                    coef_ids=sup_feat[src],
                    coef_vals=thetas[rows, off + inner],
                    icpt=thetas[slots_t, 0].copy() if off else None,
                    coef_vars=(variances[rows, off + inner] if with_var
                               else None),
                    icpt_vars=(variances[slots_t, 0].copy()
                               if with_var and off else None)))
            assert dropped == 0, (
                f"entity routing dropped {dropped} records "
                f"(capacity={capacity}, "
                f"tiers={[(ti['b_cap'], ti['n_cap']) for ti in tiers]}) — "
                f"capacities are planned exactly, this is a bug")
            self.last_fit_converged = (n_conv, E)
            self.last_fit_rungs = rungs
            new = ModelTable.concat(tables, has_intercept=self.has_intercept,
                                    with_variance=with_var)
            if prior_table is not None:
                merged = prior_table.merged_with(new)
            else:  # mixed variance presence in the prior dict
                merged = dict(model_weights)
                merged.update(new)
        self.last_fit_phases = dict(
            host_prep=host_prep.seconds, route=route.seconds,
            plan_warm=plan_warm.seconds, dispatch=dispatch.seconds,
            fetch_collect=fetch_collect.seconds)
        self.last_fit_sharding = dict(
            shards=P, capacity=capacity,
            tiers=[(P * ti["b_cap"], ti["n_cap"], ti["u_cap"] + off)
                   for ti in tiers])
        logger.info("sharded fit: %d entities over %d shards in %d tiers "
                    "(capacity=%d); %d models total | %s", E, P, len(tiers),
                    capacity, len(merged),
                    " ".join(f"{nm}={dt_:.3f}s"
                             for nm, dt_ in self.last_fit_phases.items()))
        return merged

    # ---------------------------------------------------------------- scoring --

    def score_groups(self, groups, model_weights: Dict[str, SparseModel],
                     schema_params) -> Dict[str, np.ndarray]:
        """In-memory scoring of grouped data (List[EntityGroup]). Returns
        {uid, total, per_coordinate, labels?, weights?} flat arrays.
        bucketize with the models as warm start puts θ on the data's own
        support, so X·θ is exact and entities without a model score
        logits = offsets (reference job_consumers.py:144-152)."""
        buckets = bucketize(groups, schema_params,
                            self.model_params.offset_column_name,
                            has_intercept=self.has_intercept,
                            prior_models=model_weights)
        uids, totals, per_coords, labels, weights = [], [], [], [], []
        has_label = schema_params.label_column_name is not None and any(
            schema_params.label_column_name in g.columns for g in groups)
        has_weight = schema_params.weight_column_name is not None and any(
            schema_params.weight_column_name in g.columns for g in groups)
        for bucket in buckets:
            a = newton_inputs_from_numpy(
                {k: getattr(bucket, k)
                 for k in _STATIC_COLS + ("offsets", "theta0")},
                self.device, self.dtype)
            X = densify_bucket(a["indices"], a["values"], bucket.u_cap,
                               self.has_intercept)
            z_pc = torch.einsum("bnd,bd->bn", X, a["theta0"])
            z = (z_pc + a["offsets"]).to("cpu", torch.float64).numpy()
            z_pc = z_pc.to("cpu", torch.float64).numpy()
            b_real = len(bucket.entity_ids)
            n = bucket.sample_count[:b_real].astype(np.int64)
            mask = np.arange(bucket.n_cap)[None, :] < n[:, None]
            uids.append(bucket.uids[:b_real][mask])
            totals.append(z[:b_real][mask])
            per_coords.append(z_pc[:b_real][mask])
            labels.append(bucket.labels[:b_real][mask])
            weights.append(bucket.weights[:b_real][mask])
        out = {"uid": np.concatenate(uids), "total": np.concatenate(totals),
               "per_coordinate": np.concatenate(per_coords)}
        if has_label:
            out["labels"] = np.concatenate(labels)
        if has_weight:
            out["weights"] = np.concatenate(weights)
        return out

    def _model_table(self, model_weights: Dict[str, SparseModel]):
        """Sparse CSR scoring table (ModelTable.scoring_csr) + id→row map;
        row E is the implicit zero model (entities without a model score as
        logits = offsets)."""
        if isinstance(model_weights, ModelTable):
            mkey, mvals, icpt, uniq = model_weights.scoring_csr()
            return mkey, mvals, icpt, uniq, model_weights.id2row
        E = len(model_weights)
        off = 1 if self.has_intercept else 0
        icpt = np.zeros(E + 1)
        id2row: Dict[str, int] = {}
        rows_l, fids_l, vals_l = [], [], []
        for row, (mid, sm) in enumerate(model_weights.items()):
            id2row[mid] = row
            if off:
                icpt[row] = sm.theta[0]
            k = len(sm.unique_global_indices)
            if k:
                rows_l.append(np.full(k, row, np.int64))
                fids_l.append(np.asarray(sm.unique_global_indices, np.int64))
                vals_l.append(np.asarray(sm.theta[off:], np.float64))
        if rows_l:
            rows = np.concatenate(rows_l)
            fids = np.concatenate(fids_l)
            vals = np.concatenate(vals_l)
        else:
            rows = fids = np.zeros(0, np.int64)
            vals = np.zeros(0, np.float64)
        uniq = np.unique(fids)
        key = rows * np.int64(len(uniq) + 1) + np.searchsorted(uniq, fids)
        order = np.argsort(key, kind="stable")
        return key[order], vals[order], icpt, uniq, id2row

    def _score_columns(self, table, ent_idx, n, columns, indices, values,
                       schema_params):
        p = self.model_params
        mkey, mvals, icpt, uniq, _ = table
        offsets = (columns[p.offset_column_name].astype(np.float64)
                   if p.offset_column_name in columns else np.zeros(n))
        if indices is None:
            indices = np.zeros((n, 1), np.int32)
            values = np.zeros((n, 1))
        # rank-compact the record feature ids against the table's support
        # union; misses take rank U — the hole in each entity's key span, so
        # they can never match a model key (coefficient 0)
        U = len(uniq)
        flat = np.asarray(indices, np.int64).ravel()
        rank = np.searchsorted(uniq, flat)
        hit = rank < U
        if U:  # U == 0 (all-intercept-only table): nothing can match
            hit &= uniq[np.minimum(rank, U - 1)] == flat
        qkey = (np.asarray(ent_idx, np.int64)[:, None] * np.int64(U + 1)
                + np.where(hit, rank, U).reshape(np.shape(indices)))
        if not len(mkey):  # no coefficients anywhere: sentinel never matches
            mkey, mvals = np.full(1, -1, np.int64), np.zeros(1)
        dev, dt = self.device, self.dtype
        z_pc, z = _record_scorer(
            torch.as_tensor(np.asarray(mkey, np.int64), device=dev),
            torch.as_tensor(mvals, dtype=dt, device=dev),
            torch.as_tensor(icpt, dtype=dt, device=dev),
            torch.as_tensor(np.asarray(ent_idx, np.int64), device=dev),
            torch.as_tensor(qkey, device=dev),
            torch.as_tensor(values, dtype=dt, device=dev),
            torch.as_tensor(offsets, dtype=dt, device=dev))
        out = {"uid": columns[schema_params.uid_column_name].astype(np.int64),
               "total": z.to("cpu", torch.float64).numpy(),
               "per_coordinate": z_pc.to("cpu", torch.float64).numpy()}
        if schema_params.label_column_name in columns:
            out["labels"] = columns[schema_params.label_column_name] \
                .astype(np.float64)
        if schema_params.weight_column_name and \
                schema_params.weight_column_name in columns:
            out["weights"] = columns[schema_params.weight_column_name] \
                .astype(np.float64)
        return out

    def score_records(self, data, model_weights: Dict[str, SparseModel],
                      schema_params) -> Dict[str, np.ndarray]:
        """Per-record scoring of a PerRecordData against the sparse CSR
        model table — one binary-search join over all records, no grouping
        (the in-memory pipeline's path). Entities without a model hit the
        implicit zero row → logits = offsets (reference
        job_consumers.py:144-152). Two spans: `re.score.factorize` (the
        entity column's ids) and `re.score.join` (the table, the id→row
        lookup and the scoring)."""
        from gdmix_tpu_torch.data.partitioner import factorize_entities
        with span("re.score.factorize"):
            uniq_str, inv = factorize_entities(
                data.columns[self.model_params.partition_entity])
        with span("re.score.join"):
            table = self._model_table(model_weights)
            E = len(model_weights)
            id2row = table[4]
            rows = np.fromiter((id2row.get(e, E) for e in uniq_str),
                               dtype=np.int64, count=len(uniq_str))
            return self._score_columns(table, rows[inv], data.num_samples,
                                       data.columns, data.indices,
                                       data.values, schema_params)

    def score_flat(self, fg, model_weights: Dict[str, SparseModel],
                   schema_params, _table=None) -> Dict[str, np.ndarray]:
        """Per-record scoring of a columnar FlatGroups against the sparse
        CSR model table: one id→row lookup per entity, then one
        binary-search join over every record entry. `_table`: a prebuilt
        _model_table, so chunked callers (the streamed inference loop) build
        the join arrays once, not per chunk."""
        table = _table if _table is not None \
            else self._model_table(model_weights)
        E = len(model_weights)
        id2row = table[4]
        rows = np.fromiter((id2row.get(str(e), E) for e in fg.entity_ids),
                           dtype=np.int64, count=len(fg))
        ent_idx = np.repeat(rows, fg.counts)
        n = int(np.asarray(fg.counts).sum())
        return self._score_columns(table, ent_idx, n, fg.columns, fg.indices,
                                   fg.values, schema_params)

    def _predict_file(self, input_path: str, output_file: str, schema_params,
                      model_weights: Dict[str, SparseModel]) -> None:
        logger.info("Start inference for %s.", input_path)
        from gdmix_tpu_torch.io.input_pipeline import \
            load_per_entity_grouped_flat
        stream = self.model_params.stream_chunk_entities
        if stream > 0 and self.model_params.data_format == constants.TFRECORD:
            if self._predict_streamed(input_path, output_file, schema_params,
                                      model_weights, stream):
                return
        fg = load_per_entity_grouped_flat(
            input_path, self.metadata, self.model_params.partition_entity,
            self.feature_bag_name, data_format=self.model_params.data_format)
        if fg is not None:
            if not len(fg):
                logger.info("No entities found in %s, skipping.", input_path)
                return
            arrays = self.score_flat(fg, model_weights, schema_params)
        else:
            groups = load_per_entity_grouped(
                input_path, self.metadata, self.model_params.partition_entity,
                self.feature_bag_name,
                data_format=self.model_params.data_format)
            if not groups:
                logger.info("No entities found in %s, skipping.", input_path)
                return
            arrays = self.score_groups(groups, model_weights, schema_params)
        scores_io.write_scores(
            output_file, schema_params, arrays["uid"], arrays["total"],
            scores_per_coordinate=arrays["per_coordinate"],
            labels=arrays.get("labels"), weights=arrays.get("weights"))
        logger.info("Inference complete: %s.", input_path)

    def _predict_streamed(self, input_path: str, output_file: str,
                          schema_params, model_weights, chunk_entities: int
                          ) -> bool:
        """Out-of-core inference (gdmix_tpu/models/random_effect_lr.py:
        1532-1575): entity-complete chunks scored against one CSR join
        table, so host memory holds one chunk of data plus the O(N) scores.
        False when the native decoder cannot take the dataset (the caller
        then scores eagerly)."""
        from gdmix_tpu_torch.io.input_pipeline import \
            iter_per_entity_grouped_flat_chunks
        outs = []
        table = None
        for chunk in iter_per_entity_grouped_flat_chunks(
                input_path, self.metadata, self.model_params.partition_entity,
                self.feature_bag_name, chunk_entities=chunk_entities):
            if chunk is None:
                return False
            if len(chunk):
                if table is None:  # the CSR join arrays, built once
                    table = self._model_table(model_weights)
                outs.append(self.score_flat(chunk, model_weights,
                                            schema_params, _table=table))
        if not outs:
            logger.info("No entities found in %s, skipping.", input_path)
            return True
        arrays = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        scores_io.write_scores(
            output_file, schema_params, arrays["uid"], arrays["total"],
            scores_per_coordinate=arrays["per_coordinate"],
            labels=arrays.get("labels"), weights=arrays.get("weights"))
        logger.info("Inference complete (streamed): %s.", input_path)
        return True

    # --------------------------------------------------------------- save/load --

    def _save_model(self, output_file: str,
                    model_coefficients: Dict[str, SparseModel]) -> None:
        if isinstance(model_coefficients, ModelTable):
            n = model_avro.export_model_table_to_avro(
                model_coefficients, self.feature_file, output_file,
                sparsity_threshold=self.model_params.sparsity_threshold)
            logger.info("Saved %d random-effect models to %s", n, output_file)
            return
        model_ids = list(model_coefficients.keys())
        biases = [] if self.has_intercept else None
        if self.feature_file is None:
            list_of_weight_indices = list_of_weight_values = None
            assert self.num_features == 1
        else:
            list_of_weight_indices = []
            list_of_weight_values = []
        for entity_id, sm in model_coefficients.items():
            idx = 0
            if self.has_intercept:
                biases.append(sm.theta[0])
                idx = 1
            if list_of_weight_indices is not None:
                list_of_weight_values.append(sm.theta[idx:])
                list_of_weight_indices.append(sm.unique_global_indices)
        fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        model_avro.export_linear_model_to_avro(
            model_ids, list_of_weight_indices, list_of_weight_values, biases,
            self.feature_file, output_file,
            sparsity_threshold=self.model_params.sparsity_threshold)
        logger.info("Saved %d random-effect models to %s", len(model_ids),
                    output_file)

    def _load_weights(self, model_file: str, catch_exception: bool = False
                      ) -> Dict[str, SparseModel]:
        if not fs.exists(model_file):
            if catch_exception:
                return {}
            raise FileNotFoundError(f"Model file {model_file} does not exist")
        return model_avro.load_sparse_models_from_avro(
            model_file, self.feature_file, has_intercept=self.has_intercept,
            as_table=True)

    # ---------------------------------------------------------------- predict --

    def predict(self, output_dir, input_data_path, metadata_file,
                checkpoint_path, execution_context, schema_params):
        partition_index = execution_context[constants.PARTITION_INDEX]
        avro_filename = f"part-{partition_index:05d}.avro"
        model_weights = self._load_weights(
            os.path.join(checkpoint_path, avro_filename))
        self._predict_file(input_data_path,
                           os.path.join(output_dir, avro_filename),
                           schema_params, model_weights)

    @staticmethod
    def from_argv(argv, base_params: Params,
                  device=None) -> "RandomEffectLRModel":
        return RandomEffectLRModel(from_argv(REParams, argv), base_params,
                                   device)
