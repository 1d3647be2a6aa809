"""Random-effect LR: thousands of per-entity models as batched device solves.

Port of gdmix_tpu/models/random_effect_lr.py (the host plane). Entities are
bucketed by sample count (data/bucketing.py), each bucket's per-entity
problems are solved at once by the rung of the solver ladder its shape
selects (`_select_solver`, as in the JAX package):

  * primal damped Newton (dim ≤ newton_max_dim; ops/newton.py, whose
    float32 path runs the kernels of ops/newton_lanes.py for dim ≤ 64 and
    the batched solve kernel K3 above it);
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
multi-sweep device cache of the sweep-static bucket columns and the
warm-sweep downlink skip.

Not ported (each raises NotImplementedError naming its ROADMAP item or the
do-not-port list): two-phase Newton and re_mode="sharded".
"""
from __future__ import annotations

import logging
import os
import time
from functools import partial
from typing import Dict, Mapping

import numpy as np
import torch

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.data.bucketing import EntityBucket, bucketize
from gdmix_tpu_torch.device import resolve_device
from gdmix_tpu_torch.io import fs, model_avro, scores as scores_io
from gdmix_tpu_torch.io.input_pipeline import load_per_entity_grouped
from gdmix_tpu_torch.io.metadata import DatasetMetadata
from gdmix_tpu_torch.io.model_avro import SparseModel
from gdmix_tpu_torch.io.model_table import ModelTable
from gdmix_tpu_torch.models.api import Model
from gdmix_tpu_torch.ops.lbfgs import lbfgs_batched
from gdmix_tpu_torch.ops.logistic import (SparseBatch, _l2_mask,
                                          entity_logits,
                                          per_entity_value_and_grad,
                                          stable_bce)
from gdmix_tpu_torch.ops.newton import (densify_bucket, dual_variance,
                                        newton_lr_batch)
from gdmix_tpu_torch.params import Params, REParams, from_argv
from gdmix_tpu_torch.util.convert import newton_inputs_from_numpy

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the bucket columns a sweep does not change (the device cache keeps them)
# and the two it does
_STATIC_COLS = ("indices", "values", "labels", "weights", "sample_count")
_DYNAMIC_COLS = ("offsets", "theta0")


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
        # buckets of the last fit whose models were rebuilt from θ0 (the
        # downlink skip), and how many times static bucket columns crossed
        # to the device into a cache (the multi-sweep cache keeps this at
        # one per bucket)
        self.last_fit_skipped = 0
        self.static_upload_count = 0

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

    def fit_flat(self, fg, model_weights: Mapping[str, SparseModel],
                 schema_params,
                 device_cache=None) -> Mapping[str, SparseModel]:
        """Train a columnar FlatGroups partition through the configured
        random-effect plane (REParams.re_mode). The port has the host plane
        (numpy grouping + bucketize, fit_groups); "auto" takes it, as the
        JAX package's auto does on one device."""
        if self.model_params.re_mode == "sharded":
            raise NotImplementedError(
                "ROADMAP A.6: re_mode='sharded' (multi-GPU entity routing)")
        return self.fit_groups(fg, model_weights, schema_params,
                               device_cache=device_cache)

    def fit_groups(self, groups, model_weights: Mapping[str, SparseModel],
                   schema_params,
                   device_cache=None) -> Mapping[str, SparseModel]:
        """In-memory batched training of all entities in `groups` (a
        List[EntityGroup] or columnar FlatGroups); returns the prior ∪ new
        model mapping (prior-only entities carry forward, reference
        :155-163) as a columnar ModelTable (a plain dict only when the prior
        mixes variance presence).

        `device_cache`: a dict the caller keeps across coordinate-descent
        sweeps over the same records (_bucket_device_arrays)."""
        from gdmix_tpu_torch.data.bucketing import (FlatGroups,
                                                    iter_bucketize_flat)
        logger.info("Training %d entities", len(groups))
        tt = [("start", time.time())]  # per-phase wall marks
        bucketize_fn = (iter_bucketize_flat if isinstance(groups, FlatGroups)
                        else bucketize)
        buckets = bucketize_fn(groups, schema_params,
                               self.model_params.offset_column_name,
                               has_intercept=self.has_intercept,
                               prior_models=model_weights)
        # every bucket's solve is queued before any result is fetched; the
        # bucketizer is a generator, so tier t+1 marshals on the host while
        # tier t solves (the float32 kernels run asynchronously; the
        # per-iteration forms synchronize once per iteration)
        pending = []
        rungs: Dict[str, int] = {}
        for i, bucket in enumerate(buckets):
            arrays = self._bucket_device_arrays(bucket, cache=device_cache,
                                                cache_key=i)
            rung, solve = self._select_solver(bucket.u_cap,
                                              bucket.indices.shape[0],
                                              bucket.n_cap)
            rungs[rung] = rungs.get(rung, 0) + 1
            # the device θ0 stays for the downlink skip's probe
            pending.append((bucket, solve(arrays), arrays["theta0"]))
        tt.append(("marshal_dispatch", time.time()))
        # warm-sweep downlink skip (gdmix_tpu/models/random_effect_lr.py:
        # 685-701): a bucket whose solve moved no coefficient (every entity
        # stopped at its warm start) takes its models from the host θ0
        if self.variance_mode is None and len(model_weights):
            moved = _moved_flags([(solved[0], th0)
                                  for _, solved, th0 in pending])
        else:
            moved = [True] * len(pending)
        self.last_fit_skipped = moved.count(False)
        n_conv = n_real = 0
        tables = []
        for (bucket, (theta, variance, converged), _), mv in zip(pending,
                                                                 moved):
            b_real = len(bucket.entity_ids)
            n_conv += int(converged[:b_real].sum())
            n_real += b_real
            tables.append(self._collect_bucket_table(
                bucket, theta if mv else bucket.theta0, variance))
        self.last_fit_converged = (n_conv, n_real)
        self.last_fit_rungs = rungs
        new = ModelTable.concat(tables, has_intercept=self.has_intercept,
                                with_variance=self.variance_mode is not None)
        tt.append(("solve_fetch_collect", time.time()))
        # a capped entity's overflow groups each solve a model; keep the last
        new = new.deduped_last()
        prior = ModelTable.from_models(model_weights, self.has_intercept)
        if prior is None:  # mixed variance presence in the prior dict
            merged = dict(model_weights)
            merged.update(new)
        else:
            merged = prior.merged_with(new)
        tt.append(("merge", time.time()))
        self.last_fit_phases = {nm: tb - ta for (_, ta), (nm, tb)
                                in zip(tt, tt[1:])}
        logger.info("%d models in total after training/refreshing. | %s",
                    len(merged),
                    " ".join(f"{nm}={dt:.3f}s"
                             for nm, dt in self.last_fit_phases.items()))
        return merged

    def _bucket_device_arrays(self, bucket: EntityBucket, cache=None,
                              cache_key=None):
        """The bucket's solver inputs as tensors on the model's device.

        `cache`/`cache_key`: multi-sweep device-tensor reuse (the single-
        device branch of gdmix_tpu/models/random_effect_lr.py:746-852). The
        pipeline's sweeps retrain identical records, only the offsets and
        the warm start change, so the sweep-static columns (_STATIC_COLS)
        stay on the device as the solver's tensors and only `offsets` and
        `theta0` cross from sweep 2 on. A hit requires the entry under
        `cache_key` (the bucket's index in the plan) to have the bucket's
        shape, entity ids and sample counts; the caller owns the stronger
        invariant that indices, values, labels and weights are unchanged
        (workflow/pipeline.py changes only the offset column). Each upload
        into a cache adds one to static_upload_count."""
        cols = _STATIC_COLS + _DYNAMIC_COLS
        if cache is not None:
            ent = cache.get(cache_key)
            if (ent is not None and ent["shape"] == bucket.indices.shape
                    and ent["entity_ids"] == list(bucket.entity_ids)
                    and np.array_equal(ent["sample_count"],
                                       bucket.sample_count)):
                arrays = dict(ent["static"])
                arrays.update(newton_inputs_from_numpy(
                    {k: getattr(bucket, k) for k in _DYNAMIC_COLS},
                    self.device, self.dtype))
                return arrays
        arrays = newton_inputs_from_numpy(
            {k: getattr(bucket, k) for k in cols}, self.device, self.dtype)
        if cache is not None:
            self.static_upload_count += 1
            cache[cache_key] = dict(
                shape=bucket.indices.shape,
                entity_ids=list(bucket.entity_ids),
                sample_count=np.array(bucket.sample_count, copy=True),
                static={k: arrays[k] for k in _STATIC_COLS})
        return arrays

    def _select_solver(self, u_cap: int, B: int, n_cap: int):
        """The solver ladder of the JAX package
        (gdmix_tpu/models/random_effect_lr.py:862-899): Newton (dim ≤
        newton_max_dim) → sample-space dual Newton (n < dim, kernel fits) →
        densified L-BFGS → sparse L-BFGS. Returns (rung name, solve)."""
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
        if (use_newton and p.newton_phase1_iters > 0
                and self.variance_mode is None
                and p.num_of_lbfgs_iterations > p.newton_phase1_iters
                and B > 64):
            raise NotImplementedError(
                "two-phase Newton (newton_phase1_iters > 0) is on ROADMAP's "
                "do-not-port list")
        rung, factory = (("newton", _newton_solver) if use_newton
                         else ("newton_dual", _newton_dual_solver) if use_dual
                         else ("lbfgs_dense", _lbfgs_dense_solver)
                         if use_dense else ("lbfgs", _lbfgs_solver))
        return rung, factory(
            u_cap, self.has_intercept, p.regularize_bias,
            float(p.l2_reg_weight), p.num_of_lbfgs_iterations,
            float(p.lbfgs_tolerance), float(p.lbfgs_pgtol),
            p.num_of_lbfgs_curvature_pairs, self.variance_mode)

    def _collect_bucket_table(self, bucket: EntityBucket, theta,
                              variance) -> ModelTable:
        """The bucket's [B, dim] solution (and variances) as ModelTable
        columns (one masked gather, no per-entity python). `theta`: the
        device solution, or the host θ0 of a bucket the solve did not move
        (float64, as the JAX package rebuilds it; no copy back)."""
        b_real = len(bucket.entity_ids)
        thetas = (np.asarray(theta[:b_real], np.float64)
                  if isinstance(theta, np.ndarray)
                  else theta[:b_real].to("cpu", torch.float64).numpy())
        off = 1 if self.has_intercept else 0
        tau = self.model_params.sparsity_threshold
        thetas = np.where(np.abs(thetas) <= tau, 0.0, thetas)
        u_count = bucket.u_count[:b_real].astype(np.int64)
        u_cap = bucket.u_cap
        mask = np.arange(u_cap)[None, :] < u_count[:, None]
        offs = np.zeros(b_real + 1, np.int64)
        np.cumsum(u_count, out=offs[1:])
        var = (None if variance is None
               else variance[:b_real].to("cpu", torch.float64).numpy())
        return ModelTable(
            ids=np.asarray(bucket.entity_ids, object), offs=offs,
            coef_ids=bucket.unique_global_indices[:b_real][mask],
            coef_vals=thetas[:, off:off + u_cap][mask],
            icpt=thetas[:, 0].copy() if off else None,
            coef_vars=None if var is None else var[:, off:off + u_cap][mask],
            icpt_vars=var[:, 0].copy() if var is not None and off else None)

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
            a = self._bucket_device_arrays(bucket)
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
        job_consumers.py:144-152)."""
        from gdmix_tpu_torch.data.partitioner import factorize_entities
        uniq_str, inv = factorize_entities(
            data.columns[self.model_params.partition_entity])
        table = self._model_table(model_weights)
        E = len(model_weights)
        id2row = table[4]
        rows = np.fromiter((id2row.get(e, E) for e in uniq_str),
                           dtype=np.int64, count=len(uniq_str))
        return self._score_columns(table, rows[inv], data.num_samples,
                                   data.columns, data.indices, data.values,
                                   schema_params)

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
