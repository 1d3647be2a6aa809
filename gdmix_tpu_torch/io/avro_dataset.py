"""Avro dataset input: per-record and entity-grouped training data from .avro.

The reference accepts data_format=avro throughout the Spark layer
(IoUtils.scala:123-193) and converts NameTermValue feature bags to indexed
tensors via EffectConfig/ColumnConfig (configs/EffectConfig.scala:33-73,
ConversionUtils.scala:23-91). Equivalents here:

  * per-record avro: each record carries dense scalar fields plus a sparse bag
    as either `<bag>_indices`/`<bag>_values` arrays or an NTV array field
    `<bag>` of {name, term, value} records (translated through the (name,term)
    feature map — the avro2tf-style conversion)
  * entity-grouped avro: the DataPartitioner's collect_list output — scalar
    entity id, array per-record columns, array-of-array bag fields
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from gdmix_tpu_torch.io import avro
from gdmix_tpu_torch.io.feature_list import get_feature_map
from gdmix_tpu_torch.io.input_pipeline import (EntityGroup, PerRecordData,
                                         _pad_ragged)
from gdmix_tpu_torch.io.metadata import DatasetMetadata
from gdmix_tpu_torch.io.shard import shard_input_files
from gdmix_tpu_torch.io import fs

INDICES_SUFFIX = "_indices"
VALUES_SUFFIX = "_values"


def _avro_files(input_path, num_shards: int, shard_index: int):
    files, sample_level = shard_input_files(input_path, num_shards, shard_index)
    return ([f for f in files if f.endswith(".avro")] or files), sample_level


def _extract_bag(rec: dict, feature_bag: str, feature_map: Optional[dict]):
    """(indices, values) from either indexed arrays or an NTV list."""
    idx_key, val_key = feature_bag + INDICES_SUFFIX, feature_bag + VALUES_SUFFIX
    if idx_key in rec:
        return (np.asarray(rec[idx_key], np.int64),
                np.asarray(rec.get(val_key, []), np.float64))
    ntvs = rec.get(feature_bag)
    if ntvs is None:
        return np.zeros(0, np.int64), np.zeros(0)
    assert feature_map is not None, (
        f"feature bag {feature_bag!r} is NameTermValue-encoded; a feature file "
        f"is required for index conversion")
    idx, val = [], []
    for ntv in ntvs:
        gi = feature_map.get((ntv["name"], ntv["term"]))
        if gi is not None:
            idx.append(gi)
            val.append(np.float64(ntv["value"]))
    order = np.argsort(idx) if idx else []
    return (np.asarray(idx, np.int64)[order] if len(idx) else
            np.zeros(0, np.int64),
            np.asarray(val, np.float64)[order] if len(val) else np.zeros(0))


def read_per_record_avro(input_path, metadata: DatasetMetadata,
                         feature_bag: Optional[str] = None,
                         num_shards: int = 1, shard_index: int = 0,
                         feature_file: Optional[str] = None,
                         align: int = 8) -> PerRecordData:
    files, sample_level = _avro_files(input_path, num_shards, shard_index)
    feature_map = get_feature_map(feature_file) if feature_file else None
    tensors = metadata.tensors()
    dense_names = [n for n, t in tensors.items() if not t.is_sparse]

    cols: Dict[str, list] = {n: [] for n in dense_names}
    ragged_idx, ragged_val = [], []
    n_records = 0
    for f in files:
        for rec in avro.read_records(f):
            for name in dense_names:
                v = rec.get(name, 0)
                cols[name].append(v if v is not None else 0)
            if feature_bag:
                i, v = _extract_bag(rec, feature_bag, feature_map)
                ragged_idx.append(i)
                ragged_val.append(v)
            n_records += 1

    columns = {name: np.asarray(cols[name], tensors[name].np_dtype)
               for name in dense_names}
    indices = values = nnz = None
    if feature_bag:
        indices, values = _pad_ragged(ragged_idx, ragged_val, align)
        nnz = np.asarray([len(r) for r in ragged_idx], np.int32)
    out = PerRecordData(columns=columns, indices=indices, values=values,
                        nnz=nnz, num_samples=n_records)
    if sample_level:
        from gdmix_tpu_torch.io.input_pipeline import shard_samples
        out = shard_samples(out, num_shards, shard_index)
    return out


def read_per_entity_grouped_avro(input_path, metadata: DatasetMetadata,
                                 entity_name: str,
                                 feature_bag: Optional[str] = None,
                                 num_shards: int = 1, shard_index: int = 0
                                 ) -> List[EntityGroup]:
    files, sample_level = _avro_files(input_path, num_shards, shard_index)
    tensors = metadata.tensors()
    idx_key = feature_bag + INDICES_SUFFIX if feature_bag else None
    val_key = feature_bag + VALUES_SUFFIX if feature_bag else None
    groups: List[EntityGroup] = []
    for f in files:
        for rec in avro.read_records(f):
            eid = rec[entity_name]
            eid = eid.decode() if isinstance(eid, bytes) else str(eid)
            columns = {}
            for name, arr in rec.items():
                if name in (entity_name, idx_key, val_key):
                    continue
                if isinstance(arr, list):
                    info = tensors.get(name)
                    dtype = info.np_dtype if info is not None else np.float64
                    columns[name] = np.asarray(arr, dtype)
            g = EntityGroup(entity_id=eid, columns=columns)
            if feature_bag:
                g.ragged_indices = [np.asarray(r, np.int64)
                                    for r in rec.get(idx_key, [])]
                g.ragged_values = [np.asarray(r, np.float64)
                                   for r in rec.get(val_key, [])]
            groups.append(g)
    if sample_level and num_shards > 1:
        groups = groups[shard_index::num_shards]
    return groups


def write_per_record_avro(output_file: str, metadata: DatasetMetadata,
                          columns: Dict[str, np.ndarray],
                          feature_bag: Optional[str] = None,
                          ragged_indices=None, ragged_values=None) -> int:
    """Write per-record avro data (tests / format interop)."""
    n = len(next(iter(columns.values())))
    tensors = metadata.tensors()
    _AVRO_TYPE = {"int": "int", "long": "long", "float": "float",
                  "double": "double", "string": "string", "bytes": "bytes"}
    fields = [{"name": name, "type": _AVRO_TYPE[tensors[name].dtype]}
              for name in columns if name in tensors]
    if feature_bag:
        fields.append({"name": feature_bag + INDICES_SUFFIX,
                       "type": {"type": "array", "items": "long"}})
        fields.append({"name": feature_bag + VALUES_SUFFIX,
                       "type": {"type": "array", "items": "double"}})
    schema = {"type": "record", "name": "TrainingExample", "fields": fields}

    def gen():
        for i in range(n):
            rec = {}
            for name, arr in columns.items():
                if name not in tensors:
                    continue
                v = arr[i]
                rec[name] = (int(v) if tensors[name].dtype in ("int", "long")
                             else float(v))
            if feature_bag:
                rec[feature_bag + INDICES_SUFFIX] = \
                    [int(x) for x in ragged_indices[i]]
                rec[feature_bag + VALUES_SUFFIX] = \
                    [float(x) for x in ragged_values[i]]
            yield rec

    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    return avro.write_records(output_file, schema, gen())
