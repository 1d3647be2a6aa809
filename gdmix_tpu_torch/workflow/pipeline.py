"""In-memory coordinate-descent pipeline: NO file I/O between coordinates.

Port of gdmix_tpu/workflow/pipeline.py. Where GDMix writes
scores/partitions/offsets to HDFS between every stage, here the uid-keyed
score ledger lives in memory, the offset update (OffsetUpdater semantics) is
a vectorized join, entity grouping is an in-process sort, and each
coordinate's solver consumes the previous coordinate's scores directly.
Supports multiple coordinate-descent sweeps: from sweep 2 on, offset =
accumulated − own-previous-score (linkedin/gdmix:gdmix-data/src/main/scala/
com/linkedin/gdmix/data/OffsetUpdater.scala:105-129).

Final artifacts (photon-ml avro models, evalSummary.json) are still written,
so the output stays drop-in compatible with the file-based workflow.

Random effects train on either plane of RandomEffectLRModel: the host
plane (grouped on the host, tiered by the host's plan and packed on the
device by ops/re_pack.py) or the entity-sharded plane (records
routed to the mesh shard owning their entity, grouped and packed on the
device: fit_records_sharded).

Across processes (a process group joined by workflow/distributed.py;
gdmix_tpu/workflow/pipeline.py:121-140, :196-300) every process holds the
full data in memory. The fixed effect fits on this process's rows
(rank::nproc) with the all-reduce of models/fixed_effect_lr.py and scores
every row. Random-effect entities are owned round-robin by the processes
(the host plane over the grouped entity list, the sharded plane over the
factorized ids, routed over the process's local mesh); each process fits
its own and the partial models are merged through the model-file exchange:
one avro a process under <models>/.exchange-sweep<n>, a barrier, then
everyone reads everyone's. The chief alone writes the final artifacts.
"""
from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.data.evaluator import EVAL_SUMMARY_JSON
from gdmix_tpu_torch.data.bucketing import select_entities
from gdmix_tpu_torch.data.partitioner import PartitionerConfig, \
    assign_group_ids, factorize_entities, group_flat
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.io.input_pipeline import (PerRecordData,
                                               read_per_record, slice_rows)
from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
from gdmix_tpu_torch.ops.metrics import auc as auc_metric
from gdmix_tpu_torch.parallel.mesh import get_mesh, local_mesh
from gdmix_tpu_torch.parallel.process_group import (barrier,
                                                    process_index_and_count)
from gdmix_tpu_torch.params import FixedLRParams, Params, REParams, from_dict
from gdmix_tpu_torch.workflow.config import METRIC, MODELS, WorkflowConfig

logger = logging.getLogger(__name__)


@dataclass
class _Ledger:
    """uid-keyed accumulated scores + per-coordinate contributions."""
    uids: np.ndarray                      # sorted
    total: np.ndarray                     # accumulated score per uid
    per_coordinate: Dict[str, np.ndarray] = field(default_factory=dict)

    @classmethod
    def empty(cls, uids: np.ndarray) -> "_Ledger":
        order = np.argsort(uids)
        return cls(uids=uids[order], total=np.zeros(len(uids)))

    def apply_coordinate(self, name: str, uids: np.ndarray,
                         per_coordinate: np.ndarray) -> None:
        """total += new_contribution − previous contribution of this
        coordinate."""
        pos = np.searchsorted(self.uids, uids)
        assert np.array_equal(self.uids[pos], uids)
        full = np.zeros_like(self.total)
        full[pos] = per_coordinate
        prev = self.per_coordinate.get(name)
        self.total = self.total + full - (prev if prev is not None
                                          else np.zeros_like(self.total))
        self.per_coordinate[name] = full


class InMemoryPipeline:
    """Runs the fixed effect + random effects with the score ledger in
    memory, in one process or in each process of a group.

    re_mode selects the random-effect training plane: "host" groups
    entities on the host, packs their tiers on the device and solves each
    tier (fit_groups);
    "sharded" routes each record to the mesh shard owning its entity and
    groups and packs on the device (fit_records_sharded); "auto" takes
    "sharded" on a mesh of more than one device (parallel/mesh.get_mesh:
    every visible card; across processes the process's local_mesh) when
    the feature bag is rectangular, and "host" otherwise, as the JAX
    package's auto does. The fixed effect runs on the process's card
    either way. `exchanges` records each model-file exchange: coordinate,
    sweep, files read, seconds."""

    def __init__(self, config: WorkflowConfig, num_sweeps: int = 1,
                 re_mode: str = "auto", device=None):
        if re_mode not in ("host", "sharded", "auto"):
            raise ValueError(f"re_mode {re_mode!r}: host, sharded or auto")
        self.config = config
        self.re_mode = re_mode
        self.num_sweeps = num_sweeps
        self.device = device
        self.metrics: Dict[str, float] = {}
        self.exchanges = []

    def _exchange_re_models(self, model_dir: str, sweep: int, name: str,
                            partial, model) -> Dict:
        """Multi-process model merge (gdmix_tpu/workflow/pipeline.py:
        121-140): each process owns a disjoint entity subset (round-robin ≡
        random_effect_driver.py:60-68 partition assignment), writes its
        partial avro, waits at a barrier for every process's, and reads
        them all — the reference's partition-model-files contract, with the
        filesystem as the exchange fabric."""
        rank = process_index_and_count()[0]
        t0 = time.perf_counter()
        ex_dir = os.path.join(model_dir, f".exchange-sweep{sweep}")
        fs.makedirs(ex_dir, exist_ok=True)
        model._save_model(os.path.join(ex_dir, f"part-{rank:05d}.avro"),
                          partial)
        barrier()
        merged: Dict = {}
        files = sorted(f for f in fs.listdir(ex_dir) if f.endswith(".avro"))
        for f in files:
            merged.update(model._load_weights(os.path.join(ex_dir, f)))
        seconds = time.perf_counter() - t0
        self.exchanges.append(dict(coordinate=name, sweep=sweep,
                                   files=len(files), seconds=seconds))
        logger.info("model exchange %s sweep %d: %d files, %d models, "
                    "%.3f s", name, sweep, len(files), len(merged), seconds)
        return merged

    def run(self) -> Dict[str, float]:
        rank, nproc = process_index_and_count()
        cfg = self.config
        (fe_name, fe_raw), = cfg.fixed_effect_config.items()
        fe_config = dict(fe_raw)
        fe_gdmix = dict(fe_config.pop("gdmix_config"))
        fe_params = from_dict(Params, {**fe_gdmix,
                                       "stage": constants.FIXED_EFFECT})

        fe_model_params = from_dict(FixedLRParams, {
            **fe_config,
            "output_model_dir": os.path.join(cfg.output_dir, fe_name,
                                             MODELS)})
        fe_model = FixedEffectLRModel(fe_model_params, fe_params,
                                      device=self.device)

        # Load every coordinate's data once.
        fe_train = read_per_record(fe_config["training_data_dir"],
                                   fe_model.metadata,
                                   fe_model.feature_bag_name)
        fe_valid = read_per_record(fe_config["validation_data_dir"],
                                   fe_model.metadata,
                                   fe_model.feature_bag_name) \
            if fe_config.get("validation_data_dir") else None

        uid_col = fe_params.uid_column_name
        train_ledger = _Ledger.empty(
            fe_train.columns[uid_col].astype(np.int64))
        valid_ledger = (_Ledger.empty(
            fe_valid.columns[uid_col].astype(np.int64))
            if fe_valid is not None else None)

        re_items = []
        for name, re_raw in cfg.random_effect_config.items():
            re_config = dict(re_raw)
            re_gdmix = dict(re_config.pop("gdmix_config"))
            re_config.pop("num_partitions", None)
            min_samples = re_config.pop("min_samples", None)
            max_samples = re_config.pop("max_samples", None)
            if re_gdmix.get("model_type", constants.LOGISTIC_REGRESSION) \
                    != constants.LOGISTIC_REGRESSION:
                # reference restriction (model_factory.py:46-47): random
                # effects are logistic-only
                raise ValueError(f"random effect {name}: only "
                                 f"{constants.LOGISTIC_REGRESSION} is "
                                 f"supported")
            re_params = from_dict(Params, {**re_gdmix,
                                           "stage": constants.RANDOM_EFFECT})
            re_model_params = from_dict(REParams, {
                **re_config,
                "output_model_dir": os.path.join(cfg.output_dir, name,
                                                 MODELS)})
            model = RandomEffectLRModel(re_model_params, re_params,
                                        device=self.device)
            train = read_per_record(re_config["training_data_dir"],
                                    model.metadata, model.feature_bag_name)
            valid = read_per_record(re_config["validation_data_dir"],
                                    model.metadata, model.feature_bag_name) \
                if re_config.get("validation_data_dir") else None
            re_items.append(dict(name=name, model=model, params=re_params,
                                 train=train, valid=valid,
                                 min_samples=min_samples,
                                 max_samples=max_samples, weights={}))

        # multi-sweep device reuse: only the offset column changes between
        # sweeps (see FixedEffectLRModel._device_batch). In one process the
        # fit and the training-set scoring share ONE cache and one device
        # copy of the static columns; across processes the fit sees this
        # process's rows only, so the two get a cache each
        fe_caches = {"fit": {}, "valid": {}}
        fe_caches["score_train"] = fe_caches["fit"] if nproc == 1 else {}
        for sweep in range(self.num_sweeps):
            logger.info("=== coordinate-descent sweep %d ===", sweep + 1)
            # ---- fixed effect ----
            self._set_offsets(fe_train, train_ledger, fe_name,
                              fe_model_params.offset_column_name, uid_col)
            warm = fe_model.model_coefficients if sweep else None
            fe_fit_view = fe_train if nproc == 1 else slice_rows(
                fe_train, np.arange(rank, fe_train.num_samples, nproc))
            fe_model.fit_data(fe_fit_view, fe_params, warm_start=warm,
                              device_cache=fe_caches["fit"])
            tr_scores = fe_model.score_data(
                fe_train, fe_params, device_cache=fe_caches["score_train"])
            train_ledger.apply_coordinate(fe_name, tr_scores["uid"],
                                          tr_scores["per_coordinate"])
            if fe_valid is not None:
                self._set_offsets(fe_valid, valid_ledger, fe_name,
                                  fe_model_params.offset_column_name,
                                  uid_col)
                va = fe_model.score_data(fe_valid, fe_params,
                                         device_cache=fe_caches["valid"])
                valid_ledger.apply_coordinate(fe_name, va["uid"],
                                              va["per_coordinate"])
                self.metrics[fe_name] = float(auc_metric(
                    valid_ledger.total, self._labels(fe_valid, fe_params)))

            # ---- random effects ----
            for item in re_items:
                model: RandomEffectLRModel = item["model"]
                params: Params = item["params"]
                mp: REParams = model.model_params
                name = item["name"]

                self._set_offsets(item["train"], train_ledger, name,
                                  mp.offset_column_name,
                                  params.uid_column_name)
                pcfg = PartitionerConfig(
                    partition_entity=mp.partition_entity, num_partitions=1,
                    min_samples=item["min_samples"],
                    max_samples=item["max_samples"],
                    uid_column_name=params.uid_column_name,
                    offset_column_name=mp.offset_column_name)
                # the records are the same in every sweep (only the offset
                # column changes), so from sweep 2 on only the offsets are
                # packed and θ0 crosses to the device (RandomEffectLRModel.
                # _marshal_packed; on the sharded plane only the offsets
                # are routed again)
                cache = item.setdefault("dev_cache", {})
                if self._use_sharded_re(item["train"]):
                    records = self._active_records(item["train"], pcfg)
                    mesh = None
                    if nproc > 1:
                        # round-robin entity OWNERSHIP across processes,
                        # routing within the process's local mesh
                        uniq, inv = factorize_entities(
                            records.columns[mp.partition_entity])
                        owned = (np.arange(len(uniq)) % nproc) == rank
                        records = slice_rows(records,
                                             np.flatnonzero(owned[inv]))
                        mine, mesh = uniq[owned], local_mesh(
                            device=self.device)
                    fitted = model.fit_records_sharded(
                        records, params, model_weights=item["weights"],
                        mesh=mesh, device_cache=cache)
                else:
                    groups = self._group_active(item["train"], pcfg)
                    if nproc > 1:
                        # round-robin ownership over the (identical) full
                        # entity list
                        groups = select_entities(
                            groups, np.arange(rank, len(groups), nproc))
                        mine = groups.entity_ids
                    fitted = model.fit_groups(groups, item["weights"],
                                              params, device_cache=cache)
                if nproc > 1:
                    fitted = dict(item["weights"], **self._exchange_re_models(
                        os.path.join(cfg.output_dir, name, MODELS), sweep,
                        name, {eid: fitted[eid] for eid in mine}, model))
                item["weights"] = fitted

                # score ALL training rows (active + passive) for the ledger:
                # one sparse record join, no re-grouping
                sc = model.score_records(item["train"], item["weights"],
                                         params)
                train_ledger.apply_coordinate(name, sc["uid"],
                                              sc["per_coordinate"])

                if item["valid"] is not None:
                    self._set_offsets(item["valid"], valid_ledger, name,
                                      mp.offset_column_name,
                                      params.uid_column_name)
                    vs = model.score_records(item["valid"], item["weights"],
                                             params)
                    valid_ledger.apply_coordinate(name, vs["uid"],
                                                  vs["per_coordinate"])
                    self.metrics[name] = float(auc_metric(
                        valid_ledger.total,
                        self._labels(item["valid"], params)))

        # ---- persist final artifacts (the chief only across processes) ----
        if rank == 0:
            fs.makedirs(os.path.join(cfg.output_dir, fe_name, MODELS),
                        exist_ok=True)
            fe_model._save_model()
            self._write_metric(fe_name)
            for item in re_items:
                model_dir = os.path.join(cfg.output_dir, item["name"],
                                         MODELS)
                fs.makedirs(model_dir, exist_ok=True)
                item["model"]._save_model(
                    os.path.join(model_dir, "part-00000.avro"),
                    item["weights"])
                self._write_metric(item["name"])
        return dict(self.metrics)

    # ------------------------------------------------------------------ utils --

    @staticmethod
    def _labels(data: PerRecordData, params: Params) -> np.ndarray:
        return data.columns[params.label_column_name].astype(np.float64)

    @staticmethod
    def _set_offsets(data: PerRecordData, ledger: Optional[_Ledger],
                     coordinate_name: str, offset_column: str,
                     uid_column: str = "uid") -> None:
        """offset = accumulated − own contribution (OffsetUpdater
        semantics; the own-term is zero on the first sweep)."""
        if ledger is None:
            return
        uids = data.columns[uid_column].astype(np.int64)
        pos = np.searchsorted(ledger.uids, uids)
        total = ledger.total[pos]
        own = ledger.per_coordinate.get(coordinate_name)
        if own is not None:
            total = total - own[pos]
        data.columns[offset_column] = total.astype(np.float32)

    def _use_sharded_re(self, data: PerRecordData) -> bool:
        """The plane of a random-effect coordinate (gdmix_tpu/workflow/
        pipeline.py:105-118): "auto" takes the sharded plane when the bag
        is rectangular (an intercept-only coordinate, indices None, keeps
        the host grouping) AND the mesh has more than one device: get_mesh
        in one process, the process's local_mesh across processes."""
        if self.re_mode == "auto":
            mesh = (get_mesh(device=self.device)
                    if process_index_and_count()[1] == 1
                    else local_mesh(device=self.device))
            return data.indices is not None and mesh.size > 1
        return self.re_mode == "sharded"

    @staticmethod
    def _active_records(data: PerRecordData, pcfg: PartitionerConfig
                        ) -> PerRecordData:
        """The active records (group id 0 — DataPartitioner's min/max
        bounding, getGroupId :332-379), per record, for the sharded
        plane."""
        if not (pcfg.min_samples or pcfg.max_samples):
            return data
        uids = data.columns[pcfg.uid_column_name].astype(np.int64)
        gids = assign_group_ids(
            np.asarray(data.columns[pcfg.partition_entity]), uids,
            pcfg.min_samples, pcfg.max_samples)
        return slice_rows(data, np.flatnonzero(gids == 0))

    @staticmethod
    def _group_active(data: PerRecordData, pcfg: PartitionerConfig):
        """The active records grouped by entity, columnar (DataPartitioner's
        min/max bounding, getGroupId :332-379)."""
        uids = data.columns[pcfg.uid_column_name].astype(np.int64)
        if pcfg.min_samples or pcfg.max_samples:
            gids = assign_group_ids(
                np.asarray(data.columns[pcfg.partition_entity]), uids,
                pcfg.min_samples, pcfg.max_samples)
        else:
            gids = np.zeros(len(uids), dtype=np.int64)
        return group_flat(data, pcfg, gids, active_only=True)

    def _write_metric(self, name: str) -> None:
        if name not in self.metrics:
            return
        d = os.path.join(self.config.output_dir, name, METRIC)
        fs.makedirs(d, exist_ok=True)
        with fs.open(os.path.join(d, EVAL_SUMMARY_JSON), "w") as f:
            json.dump({"auc": self.metrics[name]}, f)


def run_gdmix_in_memory(config_path_or_obj, num_sweeps: int = 1,
                        re_mode: Optional[str] = None,
                        device=None) -> Dict[str, float]:
    """re_mode precedence: explicit argument > the config's top-level
    `re_mode` key > "auto" (the sharded plane on a mesh of more than one
    device, the host plane on one)."""
    config = (config_path_or_obj
              if isinstance(config_path_or_obj, WorkflowConfig)
              else WorkflowConfig.from_file(config_path_or_obj))
    if re_mode is None:
        re_mode = config.extras.get("re_mode", "auto")
    return InMemoryPipeline(config, num_sweeps=num_sweeps, re_mode=re_mode,
                            device=device).run()
