"""Fixed-effect LR / linear-regression trainer: full-batch L-BFGS, data
parallel across processes.

Port of gdmix_tpu/models/fixed_effect_lr.py (the TPU re-design of the
reference FixedEffectLRModelLBFGS, linkedin/gdmix:gdmix-trainer/src/gdmix/
models/custom/fixed_effect_lr_lbfgs_model.py). The whole dataset sits on the
device as padded-COO tensors; every L-BFGS funcall (ops/lbfgs.py, a host loop
over device tensors) evaluates the data term through the hand-written FE
kernels of ops/fe_loss_grad.py and adds the λ-term once.

Semantics preserved: loss = Σ weighted BCE (or squared error) + λ·½‖w‖²
with bias exclusion; coefficient layout [w..., b]; warm start from avro;
coefficient thresholding; scoring of train + validation with
predictionScore / predictionScorePerCoordinate; SIMPLE/FULL training
variance; photon-ml avro export.

grad_mode: the JAX package's modes are strategies for one sum on a TPU.
After `effective_grad_mode` resolves the mode, `hybrid` and `pallas_hybrid`
run the wide-D hot/cold split (ops/logistic.py HybridAux) when its builder
accepts the batch: the hot side through the fe_hybrid_hot kernel and, under
`hybrid` on a card, both cold scatters through the windowed-scatter kernel
(`pallas_hybrid` keeps the cold side in PyTorch and the hot side in float32,
as JAX's). `pallas_flat` runs the flat entry gather/scatter pair; every
other mode, and a hybrid mode whose builder declined (no hot set, e.g.
uniform ids), runs the fused kernel.

stream_chunk_rows > 0 trains and scores a tfrecord shard out of core: it
moves to the device chunk by chunk as it decodes (_device_batch_streamed),
so host memory holds one chunk.

Across processes (a process group joined by workflow/distributed.py; the
JAX package's `_device_batch` / `_device_batch_streamed` multi-host halves,
gdmix_tpu/models/fixed_effect_lr.py:256-440): each process loads only its
own rows — its file shard (io/shard.py, TASK_INDEX of NUM_WORKERS), or its
sample shard where there are fewer files than processes — onto its own
card. Every funcall runs the data term on the local rows and then ONE
all-reduce of one packed tensor [loss, gradient]; the λ-term is added
after it. The reduced sums are bit-equal on every rank, so the replicated
L-BFGS host loop (ops/lbfgs.py) takes the same steps everywhere. The
SIMPLE/FULL variance all-reduces its Hessian diagonal / Hessian. Each
process scores its own rows into part-{task_index:05d}.avro; the chief
alone saves the model.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.device import pad_to_multiple, resolve_device
from gdmix_tpu_torch.io import fs, model_avro, scores as scores_io
from gdmix_tpu_torch.io.input_pipeline import PerRecordData, load_per_record
from gdmix_tpu_torch.io.metadata import DatasetMetadata
from gdmix_tpu_torch.models.api import Model
from gdmix_tpu_torch.ops.fe_loss_grad import (fe_loss_grad_flat,
                                              fe_loss_grad_fused)
from gdmix_tpu_torch.ops.lbfgs import lbfgs
from gdmix_tpu_torch.ops.logistic import (
    HybridAux, SparseBatch, build_hybrid_aux, extend_hybrid_aux_windowed,
    fixed_effect_value_and_grad_hybrid,
    fixed_effect_value_and_grad_hybrid_pallas, hessian_diag, hessian_full,
    l2_value_and_grad, predict_logits)
from gdmix_tpu_torch.parallel.process_group import (all_reduce_sum,
                                                    process_index_and_count)
from gdmix_tpu_torch.params import FixedLRParams, Params, from_argv
from gdmix_tpu_torch.util.convert import fe_coefficients_from_numpy
from gdmix_tpu_torch.util.model_utils import threshold_coefficients
from gdmix_tpu_torch.util.timing import span

logger = logging.getLogger(__name__)

_EPSILON = 1.0e-12
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def effective_grad_mode(grad_mode: str, has_intercept: bool,
                        num_features: int, block_min_features: int,
                        onehot_max_features: int,
                        block_max_features: int = 700_000) -> str:
    """Resolve grad_mode to the CONCRETE strategy _objective_fun runs.

    "auto" picks the two-level one-hot `block` path inside
    (block_min_features, block_max_features]: in the JAX package block's
    cost grows with D while the scatter-add path's does not, so past their
    crossover on that package's device (block_max_features, copied so that
    both packages route alike; not measured on the card) auto takes
    `hybrid`: the hot/cold split that runs the frequent-feature
    majority through block's compact MXU path and only the cold tail through
    per-entry gather/scatter (ops/logistic.py HybridAux; the builder itself
    falls back to plain scatter when the data has no hot set — uniform ids —
    so auto is never worse than scatter; VERDICT r4 task 1). The reference's
    sparse graph is D-independent the same way
    (fixed_effect_lr_lbfgs_model.py:214-392). At/below
    onehot_max_features the single-level `onehot` densification wins.
    The sorted-COO `segment` mode is explicit-only. The Pallas kernels are
    strictly OPT-IN and, except pallas_hybrid
    (which handles b=0 natively), they require the fused intercept-last
    layout: without an intercept they resolve to the scatter path (the same
    fallthrough _objective_fun always applied)."""
    if grad_mode == "auto":
        if block_min_features < num_features <= block_max_features:
            return "block"
        if num_features <= onehot_max_features:
            return "onehot"
        return "hybrid"
    if grad_mode.startswith("pallas") and grad_mode != "pallas_hybrid" \
            and not has_intercept:
        # the fused kernels need the intercept-last layout; pallas_hybrid
        # handles b=0 natively (its rsum output is simply unused)
        return "scatter"
    return grad_mode


class FixedEffectLRModel(Model):
    """Full-batch LR/linear-regression with host-driven L-BFGS on one
    device a process."""

    def __init__(self, model_params: FixedLRParams, base_params: Params,
                 device=None):
        self.model_params = model_params
        self.base_params = base_params
        self.model_type = base_params.model_type
        self.metadata_file = model_params.metadata_file
        self.checkpoint_path = model_params.output_model_dir
        self.training_data_dir = model_params.training_data_dir
        self.validation_data_dir = model_params.validation_data_dir
        self.feature_bag_name = model_params.feature_bag
        self.feature_file = (model_params.feature_file
                             if self.feature_bag_name else None)
        self.offset_column_name = model_params.offset_column_name
        self.has_intercept = model_params.has_intercept
        self.is_regularize_bias = model_params.regularize_bias
        self.l2_reg_weight = model_params.l2_reg_weight
        self.sparsity_threshold = model_params.sparsity_threshold
        self.variance_mode = model_params.fixed_effect_variance_mode
        if self.model_type == constants.LOGISTIC_REGRESSION:
            self.disable_scoring_after_training = \
                model_params.disable_fixed_effect_scoring_after_training
        else:
            # plain linear regression: no post-train scoring (reference
            # :106-110)
            self.disable_scoring_after_training = True
        if self.variance_mode is not None:
            assert self.model_type == constants.LOGISTIC_REGRESSION

        self.metadata = DatasetMetadata.from_file(self.metadata_file)
        self.num_features = self.metadata.num_features(self.feature_bag_name)
        self.dtype = _DTYPES[model_params.dtype]
        self.device = resolve_device(device)
        self.model_coefficients: Optional[np.ndarray] = None
        self.variances: Optional[np.ndarray] = None
        # how many times the static columns crossed to the device (the
        # multi-sweep cache keeps this at 1)
        self.static_upload_count = 0
        # the last fit's L-BFGS counts and wall seconds, and across
        # processes the all-reduces it made and their seconds
        self.last_fit: Dict[str, float] = {}
        self._allreduce = [0, 0.0]
        # the last streamed ingestion: chunks, rows, bag width, and the
        # seconds each chunk took to decode and to reach the device
        self.last_ingest: Dict[str, object] = {}

    # ------------------------------------------------------------------ data --

    @property
    def _dim(self) -> int:
        return self.num_features + 1 if self.has_intercept else \
            self.num_features

    def _host_arrays(self, data: PerRecordData, schema_params):
        """(indices, values, offsets, labels, weights, uid) host arrays for a
        PerRecordData."""
        n = data.num_samples
        md = self.metadata
        uid = data.column(schema_params.uid_column_name).astype(np.int64)
        if md.has_label(schema_params.label_column_name):
            labels = data.column(
                schema_params.label_column_name).astype(np.float64)
        else:
            labels = np.zeros(n)
        if md.has_feature(schema_params.weight_column_name):
            weights = data.column(
                schema_params.weight_column_name).astype(np.float64)
        else:
            weights = np.ones(n)
        if self.offset_column_name in data.columns:
            # present either in the dataset schema or injected by the
            # in-memory pipeline's score ledger
            offsets = data.column(self.offset_column_name).astype(np.float64)
        else:
            offsets = np.zeros(n)
        if self.feature_bag_name:
            indices, values = data.indices, data.values
        else:
            # intercept-only: one dummy zero-valued feature (reference
            # :171-185)
            indices = np.zeros((n, 8), dtype=np.int32)
            values = np.zeros((n, 8), dtype=np.float64)
        return indices, values, offsets, labels, weights, uid

    def _device_batch(self, data: PerRecordData, schema_params,
                      cache=None) -> Tuple[SparseBatch, np.ndarray, int]:
        """A SparseBatch on the model's device + uids, from host columns (no
        row padding: the kernels mask their own edge). A feature id outside
        [0, num_features) raises (the kernels would read and write out of
        bounds).

        `cache`: multi-sweep device-tensor reuse. The in-memory pipeline's
        sweeps retrain / rescore IDENTICAL records — only the offset column
        (score residuals) changes — so from sweep 2 on the four static
        columns stay on the device and only offsets cross. A hit requires
        matching shapes AND equal uids; the caller owns the stronger
        invariant that indices/values/labels/weights are unchanged
        (workflow/pipeline.py mutates only the offset column). A miss also
        drops the cached hybrid split, which was built from the old
        columns."""
        n = data.num_samples
        indices, values, offsets, labels, weights, uid = \
            self._host_arrays(data, schema_params)

        if cache is not None:
            ent = cache.get("batch")
            if (ent is not None and ent["n"] == n
                    and ent["shape"] == indices.shape
                    and np.array_equal(ent["uid"], uid)):
                batch = SparseBatch(
                    indices=ent["indices"], values=ent["values"],
                    offsets=self._put(offsets, self.dtype),
                    labels=ent["labels"], weights=ent["weights"])
                return batch, uid, n

        batch = self._upload(indices, values, offsets, labels, weights)
        if cache is not None:
            self.static_upload_count += 1
            cache.pop("hybrid_aux", None)
            cache["batch"] = dict(
                n=n, shape=indices.shape, uid=np.array(uid, copy=True),
                indices=batch.indices, values=batch.values,
                labels=batch.labels, weights=batch.weights)
        return batch, uid, n

    def _put(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _upload(self, indices, values, offsets, labels, weights
                ) -> SparseBatch:
        """Host columns → a SparseBatch on the model's device. A feature id
        outside [0, num_features) raises (the kernels would read and write
        out of bounds)."""
        dt = self.dtype
        batch = SparseBatch(
            indices=self._put(indices, torch.int32),
            values=self._put(values, dt), offsets=self._put(offsets, dt),
            labels=self._put(labels, dt), weights=self._put(weights, dt))
        bad = (batch.indices < 0) | (batch.indices >= self.num_features)
        if bool(bad.any()):
            raise ValueError(
                f"{int(bad.sum())} feature ids outside [0, "
                f"{self.num_features}) (feature bag "
                f"{self.feature_bag_name!r})")
        return batch

    def _device_batch_streamed(self, chunks, schema_params
                               ) -> Tuple[SparseBatch, np.ndarray, int]:
        """The device SparseBatch + uids from a bounded-memory chunk stream
        (io/input_pipeline.py iter_per_record_chunks; the single-process
        half of gdmix_tpu/models/fixed_effect_lr.py:303-440): each chunk
        goes to the device as soon as it decodes, through _host_arrays and
        _upload's range check, so host memory holds one chunk while the
        whole shard ends up on the device. At stream end the bag width is
        padded to the widest chunk's (at least 8, as the JAX package's;
        id 0, value 0: inert) and the chunks are concatenated one column at
        a time. Only the last chunk may be short of a multiple of 8 rows
        (the chunker yields exact-size chunks).

        Across processes each process streams its own file shard. The JAX
        package agrees one padded row count and one bag width over the
        processes at stream end (process_allgather) only because
        make_array_from_process_local_data needs equal shards; a process
        group that sums local results needs neither, so each process keeps
        its own rows and width, and a process whose shard is empty holds an
        empty batch."""
        cols = {name: [] for name in SparseBatch._fields}
        uids, decode_s, upload_s = [], [], []
        n, k_max, saw_short = 0, 8, False
        stream = iter(chunks)
        while True:
            t0 = time.perf_counter()
            chunk = next(stream, None)
            if chunk is None:
                break
            t1 = time.perf_counter()
            assert not saw_short, "short chunk before the last one"
            saw_short = chunk.num_samples % 8 != 0
            indices, values, offsets, labels, weights, uid = \
                self._host_arrays(chunk, schema_params)
            k_max = max(k_max, indices.shape[1])
            part = self._upload(indices, values, offsets, labels, weights)
            for name in SparseBatch._fields:
                cols[name].append(getattr(part, name))
            del part, chunk, indices, values
            uids.append(uid)
            n += len(uid)
            decode_s.append(t1 - t0)
            upload_s.append(time.perf_counter() - t1)
        if not uids:
            if process_index_and_count()[1] == 1:
                raise ValueError("empty chunk stream")
            empty = np.zeros((0, k_max))
            part = self._upload(empty.astype(np.int32), empty, *[
                np.zeros(0)] * 3)
            for name in SparseBatch._fields:
                cols[name].append(getattr(part, name))
            uids.append(np.zeros(0, np.int64))

        def cat(name):
            parts = cols.pop(name)
            if parts[0].dim() == 2:
                parts = [p if p.shape[1] == k_max else
                         torch.nn.functional.pad(p, (0, k_max - p.shape[1]))
                         for p in parts]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        batch = SparseBatch(*[cat(name) for name in SparseBatch._fields])
        self.last_ingest = dict(chunks=len(uids), rows=n, k=k_max,
                                decode_s=decode_s, upload_s=upload_s)
        return batch, np.concatenate(uids), n

    # ------------------------------------------------------------- objective --

    def _grad_mode(self) -> str:
        p = self.model_params
        return effective_grad_mode(p.grad_mode, self.has_intercept,
                                   self.num_features, p.block_min_features,
                                   p.onehot_max_features,
                                   p.block_max_features)

    def _objective_fun(self, batch: SparseBatch,
                       hybrid_aux: Optional[HybridAux] = None):
        """(value, grad) of the objective: the data term through the FE
        kernels, across processes summed by one all-reduce of [value,
        grad] (_reduce), then the λ-term once. `hybrid_aux`: the hot/cold
        split (build_hybrid_aux_for); without one, the hybrid modes take
        the fused kernel, as JAX's fall through to scatter. A process with
        no rows contributes zeros."""
        mode = self._grad_mode()
        linear = self.model_type == constants.LINEAR_REGRESSION
        b = batch
        if mode in ("hybrid", "pallas_hybrid") and hybrid_aux is not None:
            hybrid = (fixed_effect_value_and_grad_hybrid_pallas
                      if mode == "pallas_hybrid"
                      else fixed_effect_value_and_grad_hybrid)

            def data_term(x):
                return hybrid(x, b, hybrid_aux, self.num_features,
                              has_intercept=self.has_intercept,
                              model_type=self.model_type)
        elif mode == "pallas_flat":
            def data_term(x):
                return fe_loss_grad_flat(
                    x, b.indices, b.values, b.labels, b.weights, b.offsets,
                    self.num_features, linear=linear)
        else:
            def data_term(x):
                return fe_loss_grad_fused(
                    x, b.indices, b.values, b.labels, b.weights, b.offsets,
                    self.num_features, has_intercept=self.has_intercept,
                    linear=linear)

        if b.labels.shape[0] == 0:
            def data_term(x):
                return x.new_zeros(()), torch.zeros_like(x)

        def fun(x):
            v, g = self._reduce(*data_term(x))
            lv, lg = l2_value_and_grad(
                x, self.l2_reg_weight, has_intercept=self.has_intercept,
                regularize_bias=self.is_regularize_bias,
                intercept_at_end=True)
            return v + lv, g + lg
        return fun

    def _reduce(self, v: torch.Tensor, g: torch.Tensor):
        """Σ over the processes of the data term (v, g): one all-reduce of
        the packed [v, g...], timed (after the data term is done) into
        last_fit's allreduce_s; (v, g) as they are in one process."""
        if process_index_and_count()[1] == 1:
            return v, g
        packed = torch.cat([v.reshape(1).to(g.dtype), g])
        if packed.is_cuda:
            torch.cuda.synchronize(packed.device)
        t0 = time.perf_counter()
        packed = all_reduce_sum(packed)
        self._allreduce[0] += 1
        self._allreduce[1] += time.perf_counter() - t0
        return packed[0].to(v.dtype), packed[1:]

    # ------------------------------------------------------------------ train --

    def fit_data(self, train_data: PerRecordData, schema_params,
                 warm_start: Optional[np.ndarray] = None,
                 device_cache=None) -> np.ndarray:
        """In-memory fit: solve on the device, threshold, set
        model_coefficients. device_cache: see _device_batch; it also keeps
        the hybrid split across sweeps (build_hybrid_aux_for)."""
        batch, train_uid, n_train = self._device_batch(
            train_data, schema_params, cache=device_cache)
        return self._fit_batch(batch, train_uid, n_train, warm_start,
                               device_cache=device_cache)

    def build_hybrid_aux_for(self, batch: SparseBatch, device_cache=None
                             ) -> Optional[HybridAux]:
        """The hot/cold split for the wide-D fit (ops/logistic.py
        HybridAux; port of gdmix_tpu/models/fixed_effect_lr.py:688-739).
        None when grad_mode does not resolve to a hybrid mode or the data
        declines (no hot set). Cached in `device_cache` across sweeps: the
        split depends only on indices/values, which the multi-sweep pipeline
        keeps identical (only offsets change).

        The windowed cold layouts are attached for `hybrid` when
        `hybrid_windowed_cold` is "on", or "auto" on a card (where the
        windowed-scatter kernel runs; JAX's "auto" asks for a single TPU);
        `pallas_hybrid` never reads them. Their row span is the chunk-padded
        row count of JAX's objective, so the layouts equal JAX's."""
        p = self.model_params
        mode = self._grad_mode()
        if mode not in ("hybrid", "pallas_hybrid") \
                or batch.labels.shape[0] == 0:
            return None
        if device_cache is not None and "hybrid_aux" in device_cache:
            return device_cache["hybrid_aux"]
        aux = build_hybrid_aux(batch.indices, batch.values,
                               self.num_features,
                               hot_features=p.hot_features,
                               cold_max_frac=p.hybrid_cold_max_frac)
        # Across processes each process builds its split from its own rows:
        # the split changes how the gradient is summed, not its value, so
        # no hot set needs agreeing. The JAX package turns the windowed
        # cold side off on a mesh of more than one device
        # (gdmix_tpu/models/fixed_effect_lr.py:722-727), a limit of its
        # kernel under GSPMD, not of the math; here every process runs the
        # kernel on its own card and keeps it.
        use_windowed = (mode == "hybrid"
                        and (p.hybrid_windowed_cold == "on"
                             or (p.hybrid_windowed_cold == "auto"
                                 and self.device.type == "cuda")))
        if aux is not None and use_windowed:
            n = batch.labels.shape[0]
            hy_chunk = p.train_chunk_size or max(256,
                                                 min(n, p.block_chunk_size))
            aux = extend_hybrid_aux_windowed(aux, self.num_features,
                                             pad_to_multiple(n, hy_chunk))
        if device_cache is not None:
            device_cache["hybrid_aux"] = aux
        return aux

    def _fit_batch(self, batch: SparseBatch, train_uid: np.ndarray,
                   n_train: int,
                   warm_start: Optional[np.ndarray] = None,
                   device_cache=None) -> np.ndarray:
        if warm_start is not None and len(warm_start) == self._dim:
            x0 = fe_coefficients_from_numpy(warm_start, self.device,
                                            self.dtype)
        else:
            x0 = torch.zeros(self._dim, dtype=self.dtype, device=self.device)
        p = self.model_params
        aux = self.build_hybrid_aux_for(batch, device_cache)
        self._allreduce = [0, 0.0]
        # the solve and its answer's copy to the host; inside, ops/lbfgs.py's
        # spans (`lbfgs`, `lbfgs.objective`, `lbfgs.fetch`)
        with span("lbfgs.fe_fit") as fit:
            res = lbfgs(self._objective_fun(batch, aux), x0,
                        m=p.num_of_lbfgs_curvature_pairs,
                        ftol=p.lbfgs_tolerance, pgtol=p.lbfgs_pgtol,
                        maxiter=p.num_of_lbfgs_iterations)
            coeffs = res.x.to("cpu", torch.float64).numpy()
        seconds = fit.seconds
        self.last_fit = dict(
            f=res.f, iterations=res.num_iterations,
            funcalls=res.num_funcalls, converged=res.converged,
            line_search_failed=res.line_search_failed,
            host_syncs=res.host_syncs, seconds=seconds,
            allreduce_calls=self._allreduce[0],
            allreduce_s=self._allreduce[1])
        logger.info("f_min: %s, iters: %s, funcalls: %s, converged: %s, "
                    "host syncs: %s, %.3f s", res.f, res.num_iterations,
                    res.num_funcalls, res.converged, res.host_syncs, seconds)
        self.model_coefficients = threshold_coefficients(
            coeffs, self.sparsity_threshold)
        self._train_batch_cache = (batch, train_uid, n_train)
        return self.model_coefficients

    def score_data(self, data: PerRecordData, schema_params,
                   device_cache=None) -> Dict[str, np.ndarray]:
        """In-memory scoring: {uid, total, per_coordinate, labels?,
        weights?}. device_cache: see _device_batch."""
        batch, uid, n = self._device_batch(data, schema_params,
                                           cache=device_cache)
        return self._score_arrays(batch, uid, n, schema_params)

    def _stream_rows(self) -> int:
        """The chunk size of out-of-core ingestion, or 0 to load eagerly:
        streaming takes tfrecord input without custom_input_fn (the JAX
        package's condition), in chunks padded to a multiple of 8 rows."""
        p = self.model_params
        if p.stream_chunk_rows <= 0:
            return 0
        if p.data_format == constants.TFRECORD and not p.custom_input_fn:
            return pad_to_multiple(p.stream_chunk_rows, 8)
        logger.warning(
            "stream_chunk_rows: streaming needs tfrecord input without "
            "custom_input_fn — loading eagerly instead")
        return 0

    def _chunks(self, input_path: str, chunk_rows: int, num_shards: int = 1,
                shard_index: int = 0):
        from gdmix_tpu_torch.io.input_pipeline import iter_per_record_chunks
        return iter_per_record_chunks(input_path, self.metadata,
                                      self.feature_bag_name,
                                      num_shards=num_shards,
                                      shard_index=shard_index,
                                      chunk_rows=chunk_rows)

    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        logger.info("Kicking off fixed effect LR L-BFGS training on %s",
                    self.device)
        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        is_chief = execution_context.get(constants.IS_CHIEF, True)

        if self.model_params.copy_to_local:
            training_data_dir = self._copy_shard_to_local(
                training_data_dir, num_workers, task_index)
            num_shards, shard_index = 1, 0
        else:
            num_shards, shard_index = num_workers, task_index
        # Warm start from a prior avro model if shapes match (reference
        # :606-623).
        prev = self._load_model(catch_exception=True)
        if prev is not None and len(prev) == self._dim:
            logger.info("Found a previous model, loaded as the initial point")
        chunk_rows = self._stream_rows()
        if chunk_rows:
            batch, train_uid, n_train = self._device_batch_streamed(
                self._chunks(training_data_dir, chunk_rows, num_shards,
                             shard_index), schema_params)
            logger.info("streamed ingestion: %d records on %s in %d chunks "
                        "of %d rows", n_train, self.device,
                        self.last_ingest["chunks"], chunk_rows)
            self._fit_batch(batch, train_uid, n_train, warm_start=prev)
        else:
            train_data = load_per_record(
                training_data_dir, self.metadata, self.feature_bag_name,
                num_shards=num_shards, shard_index=shard_index,
                data_format=self.model_params.data_format,
                feature_file=self.feature_file,
                custom_input_fn=self.model_params.custom_input_fn)
            self.fit_data(train_data, schema_params, warm_start=prev)
        batch, train_uid, n_train = self._train_batch_cache

        want_variance = self.variance_mode is not None
        if not self.disable_scoring_after_training or want_variance:
            self._score_and_write(batch, train_uid, n_train, schema_params,
                                  self.base_params.training_score_dir,
                                  task_index, compute_variance=want_variance)
        if validation_data_dir:
            val_data = load_per_record(
                validation_data_dir, self.metadata, self.feature_bag_name,
                num_shards=num_workers, shard_index=task_index,
                data_format=self.model_params.data_format,
                feature_file=self.feature_file,
                custom_input_fn=self.model_params.custom_input_fn)
            vbatch, val_uid, n_val = self._device_batch(val_data,
                                                        schema_params)
            self._score_and_write(vbatch, val_uid, n_val, schema_params,
                                  self.base_params.validation_score_dir,
                                  task_index)

        if is_chief:
            self._save_model()

    def _copy_shard_to_local(self, data_dir: str, num_workers: int,
                             task_index: int) -> str:
        """Copy this worker's file shard to a local cache dir (reference
        copy_to_local, fixed_effect_lr_lbfgs_model.py:519-531)."""
        from gdmix_tpu_torch.io.shard import shard_input_files
        files, sample_level = shard_input_files(data_dir, num_workers,
                                                task_index)
        assert not sample_level, ("copy_to_local needs at least one file "
                                  "per worker")
        local_dir = f"local_training_input_dir_{task_index}"
        os.makedirs(local_dir, exist_ok=True)
        for f in files:   # fs.copy = the remote download half of the contract
            fs.copy(f, os.path.join(local_dir, os.path.basename(f)))
        logger.info("Copied %d files to %s", len(files), local_dir)
        return local_dir

    # ------------------------------------------------------------------ score --

    def _coefficients_tensor(self) -> torch.Tensor:
        return fe_coefficients_from_numpy(self.model_coefficients,
                                          self.device, self.dtype)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.to("cpu", torch.float64).numpy()

    def _score_arrays(self, batch: SparseBatch, uid: np.ndarray, n: int,
                      schema_params) -> Dict[str, np.ndarray]:
        z_pc = predict_logits(
            self._coefficients_tensor(),
            batch._replace(offsets=torch.zeros_like(batch.offsets)),
            has_intercept=self.has_intercept, intercept_at_end=True)
        out = {"uid": uid, "total": self._to_host(z_pc + batch.offsets),
               "per_coordinate": self._to_host(z_pc)}
        if self.metadata.has_label(schema_params.label_column_name):
            out["labels"] = self._to_host(batch.labels)
        if self.metadata.has_feature(schema_params.weight_column_name):
            out["weights"] = self._to_host(batch.weights)
        return out

    def _score_and_write(self, batch: SparseBatch, uid: np.ndarray, n: int,
                         schema_params, output_dir: Optional[str],
                         task_index: int,
                         compute_variance: bool = False) -> None:
        arrays = self._score_arrays(batch, uid, n, schema_params)
        if compute_variance:
            self._compute_variance(batch, self._coefficients_tensor())
        if output_dir:
            out = os.path.join(output_dir, f"part-{task_index:05d}.avro")
            scores_io.write_scores(
                out, schema_params, arrays["uid"], arrays["total"],
                scores_per_coordinate=arrays["per_coordinate"],
                labels=arrays.get("labels"), weights=arrays.get("weights"))
            logger.info("Wrote %d scores to %s", n, out)

    def _compute_variance(self, batch: SparseBatch, x: torch.Tensor) -> None:
        """SIMPLE: 1/(diag H + ε); FULL: diag((H + (λ+ε)I)⁻¹) with the
        intercept's λ removed when unregularized (reference :442-463).
        Across processes the data Hessian (diagonal) is all-reduced before
        λ is added (reference :302-306)."""
        lam = self.l2_reg_weight
        kw = dict(has_intercept=self.has_intercept, intercept_at_end=True)
        if self.variance_mode == constants.SIMPLE:
            H = all_reduce_sum(hessian_diag(
                x, batch, self.num_features, **kw)).to(
                "cpu", torch.float64).numpy().copy()
            H += lam
            if self.has_intercept and not self.is_regularize_bias:
                H[-1] -= lam
            self.variances = 1.0 / (H + _EPSILON)
        elif self.variance_mode == constants.FULL:
            H = all_reduce_sum(hessian_full(
                x, batch, self.num_features, **kw)).to(
                "cpu", torch.float64).numpy().copy()
            H += np.diag([lam + _EPSILON] * H.shape[0])
            if self.has_intercept and not self.is_regularize_bias:
                H[-1][-1] -= lam
            self.variances = np.diagonal(np.linalg.inv(H))

    # --------------------------------------------------------------- save/load --

    def _save_model(self) -> None:
        compute_variance = self.variances is not None
        if self.has_intercept:
            bias = ((self.model_coefficients[-1], self.variances[-1])
                    if compute_variance else self.model_coefficients[-1])
        else:
            bias = None
        expanded_bias = None if bias is None else [bias]
        if self.feature_bag_name is None:
            list_of_weight_indices = list_of_weight_values = None
        else:
            if self.has_intercept:
                weights = self.model_coefficients[:-1]
                variances = self.variances[:-1] if compute_variance else None
            else:
                weights = self.model_coefficients
                variances = self.variances if compute_variance else None
            indices = np.arange(weights.shape[0])
            list_of_weight_values = [weights] if variances is None \
                else [(weights, variances)]
            list_of_weight_indices = [indices]
        output_file = os.path.join(self.checkpoint_path, "part-00000.avro")
        model_class = (constants.LOGISTIC_MODEL_CLASS
                       if self.model_type == constants.LOGISTIC_REGRESSION
                       else constants.LINEAR_MODEL_CLASS)
        model_avro.export_linear_model_to_avro(
            model_ids=["global model"],
            list_of_weight_indices=list_of_weight_indices,
            list_of_weight_values=list_of_weight_values,
            biases=expanded_bias, feature_file=self.feature_file,
            output_file=output_file, model_class=model_class,
            sparsity_threshold=self.sparsity_threshold)
        logger.info("Saved fixed-effect model to %s", output_file)

    def _load_model(self, catch_exception: bool = False
                    ) -> Optional[np.ndarray]:
        path = self.checkpoint_path
        if not path or not fs.isdir(path):
            if catch_exception:
                return None
            raise FileNotFoundError(f"checkpoint path {path} doesn't exist")
        files = [os.path.join(path, f) for f in fs.listdir(path)
                 if f.endswith(".avro")]
        if len(files) != 1:
            if catch_exception:
                return None
            raise ValueError(f"expected exactly one model file in {path}, "
                             f"found {len(files)}")
        model = model_avro.load_linear_models_from_avro(
            files[0], self.feature_file)[0]
        if self.feature_bag_name is None and model is not None:
            (model,) = model_avro.add_dummy_weight((model,))
        return model

    # ---------------------------------------------------------------- predict --

    def predict(self, output_dir, input_data_path, metadata_file,
                checkpoint_path, execution_context, schema_params):
        logger.info("Kicking off fixed effect LR predict")
        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        self.model_coefficients = np.asarray(self._load_model(),
                                             dtype=np.float64)
        chunk_rows = self._stream_rows()
        if chunk_rows:
            # out-of-core inference: host memory holds one chunk of data
            # plus the O(N) scores (gdmix_tpu/models/fixed_effect_lr.py:
            # 983-1020)
            outs = []
            for chunk in self._chunks(input_data_path, chunk_rows,
                                      num_workers, task_index):
                b, uid, n = self._device_batch(chunk, schema_params)
                outs.append(self._score_arrays(b, uid, n, schema_params))
            if not outs:
                logger.info("No records in %s, skipping.", input_data_path)
                return
            arrays = {k: np.concatenate([o[k] for o in outs])
                      for k in outs[0]}
            out = os.path.join(output_dir, f"part-{task_index:05d}.avro")
            scores_io.write_scores(
                out, schema_params, arrays["uid"], arrays["total"],
                scores_per_coordinate=arrays["per_coordinate"],
                labels=arrays.get("labels"), weights=arrays.get("weights"))
            logger.info("Wrote %d streamed scores to %s",
                        len(arrays["uid"]), out)
            return
        data = load_per_record(
            input_data_path, self.metadata, self.feature_bag_name,
            num_shards=num_workers, shard_index=task_index,
            data_format=self.model_params.data_format,
            feature_file=self.feature_file,
            custom_input_fn=self.model_params.custom_input_fn)
        batch, uid, n = self._device_batch(data, schema_params)
        self._score_and_write(batch, uid, n, schema_params, output_dir,
                              task_index)

    @staticmethod
    def from_argv(argv, base_params: Params,
                  device=None) -> "FixedEffectLRModel":
        return FixedEffectLRModel(from_argv(FixedLRParams, argv),
                                  base_params, device)
