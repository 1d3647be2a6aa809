"""Data partitioner: per-record data → per-entity grouped, bounded, partitioned.

Replaces the Spark DataPartitioner job (linkedin/gdmix:gdmix-data/src/main/scala/
com/linkedin/gdmix/data/DataPartitioner.scala):

  1. join previous-stage scores and update offsets (:402-422 → data/offset.py)
  2. per-entity sample counts → group ids (:332-379): below `min_samples` → group −1
     (passive); above `max_samples` → per-entity cap via uid mod ceil(count/max)+1
     groups, group 0 active, others passive
  3. group records by entity — one SequenceExample row per (entity, group)
  4. partitionId = |java_string_hash(entity_id)| % num_partitions (:235-236,
     PartitionUtils.scala:31-37 — exact Java String.hashCode for layout parity)
  5. write active/ + passive/ trees partitioned by partitionId, partitionList.txt
     of non-empty partitions (:113-120), regenerated metadata

The Spark groupBy shuffle becomes a stable argsort + slice per entity (vectorized
host-side; the in-HBM pipeline keeps everything columnar and skips the files).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from gdmix_tpu_torch.data.offset import update_offset
from gdmix_tpu_torch.io.input_pipeline import (EntityGroup, PerRecordData,
                                         read_per_record,
                                         write_per_entity_grouped)
from gdmix_tpu_torch.io.metadata import DatasetMetadata, TensorInfo
from gdmix_tpu_torch.io.scores import read_scores
from gdmix_tpu_torch.io import fs


def java_string_hash(s: str) -> int:
    """Java String.hashCode (32-bit, signed)."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def partition_id_of(entity_id: str, num_partitions: int) -> int:
    h = java_string_hash(str(entity_id))
    # Math.abs(Integer.MIN_VALUE) stays negative in Java; mimic abs() directly —
    # entity hashes hitting exactly -2^31 are vanishingly rare and the reference
    # would throw the same partition either way.
    return abs(h) % num_partitions


@dataclass
class PartitionerConfig:
    partition_entity: str
    num_partitions: int = 1
    min_samples: Optional[int] = None   # lowerBound: entities below → passive
    max_samples: Optional[int] = None   # upperBound: per-entity sample cap
    save_passive_data: bool = True
    offset_column_name: str = "offset"
    uid_column_name: str = "uid"
    prediction_score_column_name: str = "predictionScore"
    prediction_score_per_coordinate_column_name: str = "predictionScorePerCoordinate"


def factorize_entities(entity_col) -> Tuple[np.ndarray, np.ndarray]:
    """(unique entity ids as a str object array, inverse per record). One
    C-speed unique on the RAW column plus an E-scale string conversion —
    replaces the N-scale per-record decode/str the reference pays when it
    stringifies entity ids record by record."""
    col = np.asarray(entity_col)
    uniq_vals, inv = np.unique(col, return_inverse=True)
    uniq_str = np.asarray([e.decode() if isinstance(e, bytes) else str(e)
                           for e in uniq_vals], dtype=object)
    return uniq_str, inv


def assign_group_ids(entity_ids: np.ndarray, uids: np.ndarray,
                     min_samples: Optional[int],
                     max_samples: Optional[int]) -> np.ndarray:
    """Group id per record (reference getGroupId :332-379): 0 = active,
    −1 = below lower bound, >0 = overflow groups from the upper-bound cap."""
    n = len(entity_ids)
    if min_samples is None and max_samples is None:
        return np.zeros(n, dtype=np.int64)
    _, inverse, counts = np.unique(entity_ids, return_inverse=True,
                                   return_counts=True)
    per_record_count = counts[inverse]
    if max_samples is not None:
        group_count = (per_record_count // max_samples + 1).astype(np.int64)
    else:
        group_count = np.ones(n, dtype=np.int64)
    group = np.mod(uids, group_count)
    if min_samples is not None:
        group = np.where(per_record_count < min_samples, -1, group)
    return group


def group_by_entity(data: PerRecordData, config: PartitionerConfig,
                    metadata: DatasetMetadata,
                    group_ids: np.ndarray) -> List[Tuple[str, int, EntityGroup]]:
    """Stable-sort records by (entity, group) and slice one EntityGroup per pair.
    Returns (entity_id, group_id, group) tuples; per-record columns keep their
    original relative order within each entity (matching collect_list)."""
    entity_col = data.columns[config.partition_entity]
    entity_str = np.asarray([e.decode() if isinstance(e, bytes) else str(e)
                             for e in entity_col], dtype=object)
    # composite key sort: by entity then group, stable to preserve record order
    order = np.lexsort((group_ids, entity_str))
    sorted_entity = entity_str[order]
    sorted_group = group_ids[order]

    # boundaries where (entity, group) changes
    change = np.ones(len(order), dtype=bool)
    if len(order) > 1:
        change[1:] = (sorted_entity[1:] != sorted_entity[:-1]) | \
                     (sorted_group[1:] != sorted_group[:-1])
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], len(order))

    per_record_cols = {name: arr for name, arr in data.columns.items()
                       if name != config.partition_entity}
    out: List[Tuple[str, int, EntityGroup]] = []
    for s, e in zip(starts, ends):
        idx = order[s:e]
        eid = sorted_entity[s]
        gid = int(sorted_group[s])
        cols = {name: arr[idx] for name, arr in per_record_cols.items()}
        g = EntityGroup(entity_id=eid, columns=cols)
        if data.indices is not None:
            # bulk fancy-index the entity's padded block — no per-record loop
            g.padded_indices = data.indices[idx]
            g.padded_values = data.values[idx]
            g.rec_nnz = (data.nnz[idx] if data.nnz is not None
                         else np.full(len(idx), data.indices.shape[1], np.int32))
        out.append((eid, gid, g))
    return out


def group_flat(data: PerRecordData, config: PartitionerConfig,
               group_ids: np.ndarray, active_only: bool = False):
    """group_by_entity without the per-entity objects: the (entity, group)
    pairing of group_flat_pairs, then either the active pairs only
    (DataPartitioner's active tree — each entity has at most one group-0
    pair) or an entity's pairs merged (scoring view)."""
    from gdmix_tpu_torch.data.bucketing import FlatGroups, select_entities
    fg, pair_gids = group_flat_pairs(data, config, group_ids)
    if active_only:
        return select_entities(fg, np.flatnonzero(pair_gids == 0))
    if len(fg) == 0:
        return fg
    eids = np.asarray(fg.entity_ids, object)
    change = np.ones(len(eids), bool)
    change[1:] = eids[1:] != eids[:-1]
    starts = np.flatnonzero(change)
    return FlatGroups(
        entity_ids=eids[starts],
        counts=np.add.reduceat(fg.counts, starts).astype(np.int64),
        columns=fg.columns, indices=fg.indices, values=fg.values,
        rec_nnz=fg.rec_nnz)


def group_flat_pairs(data: PerRecordData, config: PartitionerConfig,
                     group_ids: np.ndarray):
    """Columnar grouping by (entity, group) PAIR — the partitioner's unit
    (one SequenceExample row per pair, DataPartitioner.scala:296-317).
    Returns (FlatGroups, pair_gids [P]); entity_ids repeat across a capped
    entity's overflow groups exactly like group_by_entity's tuples."""
    from gdmix_tpu_torch.data.bucketing import FlatGroups
    uniq_str, codes = factorize_entities(data.columns[config.partition_entity])
    str_order = np.argsort(uniq_str, kind="stable")
    rank = np.empty(len(uniq_str), np.int64)
    rank[str_order] = np.arange(len(uniq_str))
    order = np.lexsort((group_ids, rank[codes]))
    sorted_codes = codes[order]
    sorted_group = np.asarray(group_ids)[order]
    change = np.ones(len(order), bool)
    if len(order) > 1:
        change[1:] = (sorted_codes[1:] != sorted_codes[:-1]) | \
                     (sorted_group[1:] != sorted_group[:-1])
    starts = np.flatnonzero(change)
    counts = np.diff(np.append(starts, len(order)))
    columns = {name: arr[order] for name, arr in data.columns.items()
               if name != config.partition_entity}
    fg = FlatGroups(
        entity_ids=uniq_str[sorted_codes[starts]],
        counts=counts.astype(np.int64),
        columns=columns,
        indices=None if data.indices is None else data.indices[order],
        values=None if data.values is None else data.values[order],
        rec_nnz=(data.nnz[order] if data.nnz is not None
                 else (np.full(len(order), data.indices.shape[1], np.int32)
                       if data.indices is not None else None)))
    return fg, sorted_group[starts]


def partition_dataset_flat(data: PerRecordData,
                           metadata: DatasetMetadata,
                           config: PartitionerConfig,
                           feature_bag: Optional[str],
                           scores: Optional[Dict[str, np.ndarray]] = None,
                           per_coordinate_scores=None,
                           split_active_passive: bool = True):
    """partition_dataset on the columnar path: {pid: {"active": FlatGroups,
    "passive": FlatGroups}} with the same (entity, group) rows and ordering
    as the object version."""
    from gdmix_tpu_torch.data.bucketing import select_entities
    uids = data.columns[config.uid_column_name].astype(np.int64)
    if scores is not None:
        pc_uids = pc_vals = None
        if per_coordinate_scores is not None:
            pc_uids = per_coordinate_scores[config.uid_column_name]
            pc_vals = per_coordinate_scores[
                config.prediction_score_per_coordinate_column_name]
        data.columns[config.offset_column_name] = update_offset(
            uids, scores[config.uid_column_name],
            scores[config.prediction_score_column_name], pc_uids, pc_vals)

    entity_col = np.asarray(data.columns[config.partition_entity])
    if split_active_passive:
        # assign_group_ids only uses entity IDENTITY (np.unique), so the raw
        # column works — no per-record python str() on the hot path
        group_ids = assign_group_ids(entity_col, uids, config.min_samples,
                                     config.max_samples)
    else:
        group_ids = np.zeros(len(uids), dtype=np.int64)
    fg, pair_gids = group_flat_pairs(data, config, group_ids)
    # one hash per unique id (they repeat across overflow groups)
    uniq_ids, inv = np.unique(np.asarray(fg.entity_ids, object),
                              return_inverse=True)
    pid_of_uniq = np.fromiter(
        (partition_id_of(e, config.num_partitions) for e in uniq_ids),
        np.int64, len(uniq_ids))
    pids = pid_of_uniq[inv]
    out = {}
    for pid in np.unique(pids):
        slot = {"active": None, "passive": None}
        base = pids == pid
        act = np.flatnonzero(base & ((pair_gids == 0)
                                     if split_active_passive else base))
        if act.size:
            slot["active"] = select_entities(fg, act)
        if split_active_passive:
            pas = np.flatnonzero(base & (pair_gids != 0))
            if pas.size:
                slot["passive"] = select_entities(fg, pas)
        out[int(pid)] = slot
    return out


def _grouped_metadata(metadata: DatasetMetadata, config: PartitionerConfig,
                      has_offset: bool) -> DatasetMetadata:
    """Output metadata for the grouped dataset (MetadataGenerator equivalent):
    same tensors, plus the offset column when scores were joined."""
    feats = list(metadata.features)
    names = {t.name for t in feats}
    if has_offset and config.offset_column_name not in names:
        feats.append(TensorInfo(name=config.offset_column_name, dtype="float",
                                shape=[], is_sparse=False))
    return DatasetMetadata(features=feats, labels=list(metadata.labels),
                           number_of_training_samples=
                           metadata.number_of_training_samples)


def partition_dataset(data: PerRecordData,
                      metadata: DatasetMetadata,
                      config: PartitionerConfig,
                      feature_bag: Optional[str],
                      scores: Optional[Dict[str, np.ndarray]] = None,
                      per_coordinate_scores: Optional[Dict[str, np.ndarray]] = None,
                      split_active_passive: bool = True,
                      ) -> Dict[int, Dict[str, List[EntityGroup]]]:
    """In-memory partitioner core. Returns {partition_id: {"active": [...],
    "passive": [...]}}. When split_active_passive is False everything lands in
    "active" (validation semantics, reference :267-276)."""
    uids = data.columns[config.uid_column_name].astype(np.int64)
    if scores is not None:
        pc_uids = pc_vals = None
        if per_coordinate_scores is not None:
            pc_uids = per_coordinate_scores[config.uid_column_name]
            pc_vals = per_coordinate_scores[
                config.prediction_score_per_coordinate_column_name]
        offsets = update_offset(
            uids, scores[config.uid_column_name],
            scores[config.prediction_score_column_name], pc_uids, pc_vals)
        data.columns[config.offset_column_name] = offsets

    entity_col = data.columns[config.partition_entity]
    entity_str = np.asarray([e.decode() if isinstance(e, bytes) else str(e)
                             for e in entity_col], dtype=object)
    if split_active_passive:
        group_ids = assign_group_ids(entity_str, uids, config.min_samples,
                                     config.max_samples)
    else:
        group_ids = np.zeros(len(uids), dtype=np.int64)

    grouped = group_by_entity(data, config, metadata, group_ids)
    out: Dict[int, Dict[str, List[EntityGroup]]] = {}
    for eid, gid, g in grouped:
        pid = partition_id_of(eid, config.num_partitions)
        slot = out.setdefault(pid, {"active": [], "passive": []})
        if not split_active_passive or gid == 0:
            slot["active"].append(g)
        else:
            slot["passive"].append(g)
    return out


def run_partitioner(training_data_dir: Optional[str],
                    validation_data_dir: Optional[str],
                    metadata_file: str,
                    output_metadata_file: str,
                    partitioned_training_data_dir: Optional[str],
                    partitioned_validation_data_dir: Optional[str],
                    output_partition_list_file: Optional[str],
                    config: PartitionerConfig,
                    feature_bag: Optional[str],
                    schema_params=None,
                    training_score_dir: Optional[str] = None,
                    training_score_per_coordinate_dir: Optional[str] = None,
                    validation_score_dir: Optional[str] = None,
                    validation_score_per_coordinate_dir: Optional[str] = None
                    ) -> None:
    """File-based partitioner honoring the reference directory contract."""
    metadata = DatasetMetadata.from_file(metadata_file)
    entity_dtype = metadata.feature(config.partition_entity).dtype

    class _SchemaShim:
        uid_column_name = config.uid_column_name
        prediction_score_column_name = config.prediction_score_column_name
        prediction_score_per_coordinate_column_name = \
            config.prediction_score_per_coordinate_column_name
        label_column_name = None
        weight_column_name = None

    shim = schema_params or _SchemaShim()

    def load_scores(path):
        return read_scores(path, shim) if path else None

    def process(data_dir, score_dir, pc_score_dir, out_dir, split):
        from gdmix_tpu_torch.io.input_pipeline import write_grouped_flat
        data = read_per_record(data_dir, metadata, feature_bag)
        partitions = partition_dataset_flat(
            data, metadata, config, feature_bag,
            scores=load_scores(score_dir),
            per_coordinate_scores=load_scores(pc_score_dir),
            split_active_passive=split)
        for pid, groups in partitions.items():
            for kind in ("active", "passive"):
                if kind == "passive" and (not split or not config.save_passive_data):
                    continue
                if groups[kind] is None or not len(groups[kind]):
                    continue
                if split:
                    d = os.path.join(out_dir, kind, f"partitionId={pid}")
                else:
                    d = os.path.join(out_dir, f"partitionId={pid}")
                fs.makedirs(d, exist_ok=True)
                write_grouped_flat(
                    os.path.join(d, "part-00000.tfrecord"), groups[kind],
                    config.partition_entity, entity_dtype, feature_bag)
        return sorted(partitions.keys())

    partition_ids: List[int] = []
    joined_offset = training_score_dir is not None or validation_score_dir is not None
    if training_data_dir:
        partition_ids = process(training_data_dir, training_score_dir,
                                training_score_per_coordinate_dir,
                                partitioned_training_data_dir, split=True)
        if output_partition_list_file:
            with fs.open(output_partition_list_file, "w") as f:
                f.write(",".join(str(p) for p in partition_ids))
    if validation_data_dir:
        process(validation_data_dir, validation_score_dir,
                validation_score_per_coordinate_dir,
                partitioned_validation_data_dir, split=False)

    out_md = _grouped_metadata(metadata, config, has_offset=joined_offset)
    fs.makedirs(os.path.dirname(output_metadata_file) or ".", exist_ok=True)
    out_md.save(output_metadata_file)
