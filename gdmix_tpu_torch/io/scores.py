"""Inference/score-file Avro IO.

Schema mirrors the reference's inference output
(linkedin/gdmix:gdmix-trainer/src/gdmix/util/io_utils.py:367-375):
uid (long), predictionScore (float), label (nullable float), optional weight,
predictionScorePerCoordinate (float).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from gdmix_tpu_torch.io import avro
from gdmix_tpu_torch.io import fs


def inference_output_schema(schema_params, has_label: bool, has_weight: bool,
                            has_logits_per_coordinate: bool = True) -> dict:
    fields = [
        {"name": schema_params.uid_column_name, "type": "long"},
        {"name": schema_params.prediction_score_column_name, "type": "float"},
    ]
    if has_label:
        fields.append({"name": schema_params.label_column_name,
                       "type": ["null", "float"], "default": None})
    if has_weight:
        fields.append({"name": schema_params.weight_column_name, "type": "float"})
    if has_logits_per_coordinate:
        fields.append({"name": schema_params.prediction_score_per_coordinate_column_name,
                       "type": "float"})
    return {"name": "validation_result", "type": "record", "fields": fields}


def write_scores(output_file: str, schema_params, uids, scores,
                 scores_per_coordinate=None, labels=None, weights=None) -> int:
    """Write one score avro file from parallel arrays."""
    schema = inference_output_schema(
        schema_params,
        has_label=labels is not None,
        has_weight=weights is not None,
        has_logits_per_coordinate=scores_per_coordinate is not None)

    uids = np.asarray(uids)
    scores = np.asarray(scores)

    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    # Columnar fast path: the inference schema is flat primitives, so the
    # native encoder emits block payloads ~40x faster than the per-record
    # Python datum writer (the reference pays the same per-record cost in
    # fastavro, io_utils.py:299-334).
    try:
        from gdmix_tpu_torch import native
        columns = {schema_params.uid_column_name: uids,
                   schema_params.prediction_score_column_name: scores}
        if labels is not None:
            columns[schema_params.label_column_name] = np.asarray(labels)
        if weights is not None:
            columns[schema_params.weight_column_name] = np.asarray(weights)
        if scores_per_coordinate is not None:
            columns[schema_params.prediction_score_per_coordinate_column_name] = \
                np.asarray(scores_per_coordinate)
        blocks = native.encode_avro_column_blocks(schema, columns)
    except Exception:
        blocks = None
    if blocks is not None:
        return avro.write_encoded_blocks(output_file, schema, blocks)

    def gen() -> Iterator[dict]:
        for i in range(len(uids)):
            rec = {
                schema_params.uid_column_name: int(uids[i]),
                schema_params.prediction_score_column_name: float(scores[i]),
            }
            if labels is not None:
                rec[schema_params.label_column_name] = float(labels[i])
            if weights is not None:
                rec[schema_params.weight_column_name] = float(weights[i])
            if scores_per_coordinate is not None:
                rec[schema_params.prediction_score_per_coordinate_column_name] = \
                    float(scores_per_coordinate[i])
            yield rec

    return avro.write_records(output_file, schema, gen())


def _score_files(path: str) -> List[str]:
    """All .avro files under path, recursively (score dirs may contain
    partitionId=N subdirectories, which Spark reads recursively too)."""
    if fs.isdir(path):
        return fs.find_files(path, ".avro")
    return [path]


def read_scores(path: str, schema_params) -> Dict[str, np.ndarray]:
    """Read a score dir/file into {column: array} keyed by schema column names.
    Missing columns are absent from the dict. A C++ flat-record decoder
    (gdmix_tpu_torch.native) handles the hot path; the pure-Python reader is the
    fallback for exotic schemas."""
    files = _score_files(path)
    native_parts = []
    for f in files:
        try:
            from gdmix_tpu_torch import native
            # the native decoder mmaps a REAL local path; remote schemes go
            # through the copy-through-local seam (same contract as
            # model_avro._parse_native)
            with fs.local_input(f) as local:
                cols = native.read_avro_columns(local)
        except Exception:
            cols = None
        if cols is None:
            native_parts = None
            break
        native_parts.append(cols)
    if native_parts is not None and native_parts:
        merged: Dict[str, np.ndarray] = {}
        for name in native_parts[0]:
            merged[name] = np.concatenate([p[name] for p in native_parts])
        wanted = [schema_params.uid_column_name,
                  schema_params.prediction_score_column_name,
                  schema_params.label_column_name,
                  schema_params.weight_column_name,
                  schema_params.prediction_score_per_coordinate_column_name]
        return {k: v for k, v in merged.items() if k in wanted}

    uids: List[int] = []
    scores: List[float] = []
    per_coord: List[float] = []
    labels: List[float] = []
    weights: List[float] = []
    has_label = has_weight = has_pc = False
    for f in files:
        for rec in avro.read_records(f):
            uids.append(rec[schema_params.uid_column_name])
            scores.append(rec[schema_params.prediction_score_column_name])
            if schema_params.label_column_name in rec:
                v = rec[schema_params.label_column_name]
                labels.append(np.nan if v is None else v)
                has_label = True
            if schema_params.weight_column_name and schema_params.weight_column_name in rec:
                weights.append(rec[schema_params.weight_column_name])
                has_weight = True
            if schema_params.prediction_score_per_coordinate_column_name in rec:
                per_coord.append(rec[schema_params.prediction_score_per_coordinate_column_name])
                has_pc = True
    out = {
        schema_params.uid_column_name: np.asarray(uids, dtype=np.int64),
        schema_params.prediction_score_column_name: np.asarray(scores, dtype=np.float64),
    }
    if has_label:
        out[schema_params.label_column_name] = np.asarray(labels, dtype=np.float64)
    if has_weight:
        out[schema_params.weight_column_name] = np.asarray(weights, dtype=np.float64)
    if has_pc:
        out[schema_params.prediction_score_per_coordinate_column_name] = \
            np.asarray(per_coord, dtype=np.float64)
    return out
