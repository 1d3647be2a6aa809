"""Offset (score-residual) updater — the coordinate-descent arithmetic.

Replaces the Spark OffsetUpdater (linkedin/gdmix:gdmix-data/src/main/scala/com/
linkedin/gdmix/data/OffsetUpdater.scala:105-129):

    offset = predictionScore(previous coordinate, this sweep)
           − predictionScorePerCoordinate(this coordinate, previous sweep)   [optional]

joined on uid. The Spark shuffle-join becomes a vectorized searchsorted gather; on
device the same op is a sort + take (see pipeline usage). Matching the reference,
the joined score is cast to float32 before subtraction (OffsetUpdater.scala:115).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
from gdmix_tpu_torch.io import fs

logger = logging.getLogger(__name__)


def _align_by_uid(target_uids: np.ndarray, uids: np.ndarray,
                  values: np.ndarray) -> np.ndarray:
    """values[uids] gathered onto target_uids (inner-join semantics: missing uids
    raise, as the reference's inner join would silently drop them — we'd rather
    fail loudly)."""
    order = np.argsort(uids, kind="stable")
    sorted_uids = uids[order]
    pos = np.searchsorted(sorted_uids, target_uids)
    pos = np.clip(pos, 0, len(sorted_uids) - 1)
    if not np.array_equal(sorted_uids[pos], target_uids):
        missing = target_uids[sorted_uids[pos] != target_uids]
        raise ValueError(f"scores missing for {len(missing)} uids "
                         f"(e.g. {missing[:5]})")
    return values[order][pos]


def update_offset(target_uids: np.ndarray,
                  score_uids: np.ndarray,
                  prediction_scores: np.ndarray,
                  per_coordinate_uids: Optional[np.ndarray] = None,
                  per_coordinate_scores: Optional[np.ndarray] = None) -> np.ndarray:
    """offset per target uid = score − (per-coordinate score from last sweep)."""
    offsets = _align_by_uid(target_uids, np.asarray(score_uids, np.int64),
                            np.asarray(prediction_scores, np.float32)
                            .astype(np.float64))
    if per_coordinate_uids is not None and per_coordinate_scores is not None:
        pc = _align_by_uid(target_uids, np.asarray(per_coordinate_uids, np.int64),
                           np.asarray(per_coordinate_scores, np.float64))
        offsets = offsets - pc
    return offsets


@dataclass
class _ScoreSchema:
    uid_column_name: str
    prediction_score_column_name: str
    prediction_score_per_coordinate_column_name: str
    label_column_name: Optional[str] = None
    weight_column_name: Optional[str] = None


def run_offset_updater(data_dir: str,
                       score_dir: str,
                       output_data_dir: str,
                       metadata_file: str,
                       output_metadata_file: Optional[str] = None,
                       per_coordinate_score_dir: Optional[str] = None,
                       data_format: str = "tfrecord",
                       feature_bag: Optional[str] = None,
                       offset_column_name: str = "offset",
                       uid_column_name: str = "uid",
                       prediction_score_column_name: str = "predictionScore",
                       prediction_score_per_coordinate_column_name: str =
                       "predictionScorePerCoordinate") -> int:
    """The standalone OffsetUpdater job (reference OffsetUpdater.scala:30-91):
    join a score dir into a dataset on uid, write the dataset back with
    `offset = predictionScore − perCoordinateScore(optional)`, and emit the
    metadata augmented with the offset column (the reference infers schema
    from the DataFrame; the TPU build needs the declared metadata to read
    TFRecords, hence the explicit metadata_file in/out)."""
    from gdmix_tpu_torch.io.input_pipeline import load_per_record, write_per_record
    from gdmix_tpu_torch.io.metadata import DatasetMetadata
    from gdmix_tpu_torch.io.scores import read_scores

    sp = _ScoreSchema(
        uid_column_name=uid_column_name,
        prediction_score_column_name=prediction_score_column_name,
        prediction_score_per_coordinate_column_name=
        prediction_score_per_coordinate_column_name)
    metadata = DatasetMetadata.from_file(metadata_file)
    data = load_per_record(data_dir, metadata, feature_bag,
                           data_format=data_format)
    scores = read_scores(score_dir, sp)
    pc_uids = pc_scores = None
    if per_coordinate_score_dir:
        pc = read_scores(per_coordinate_score_dir, sp)
        pc_uids = pc[uid_column_name]
        pc_scores = pc[prediction_score_per_coordinate_column_name]
    uids = data.columns[uid_column_name].astype(np.int64)
    offsets = update_offset(uids, scores[uid_column_name],
                            scores[prediction_score_column_name],
                            pc_uids, pc_scores)
    data.columns[offset_column_name] = offsets.astype(np.float32)

    # augmented metadata (the offset column must be declared to be readable)
    from gdmix_tpu_torch.data.metadata_gen import add_columns_to_metadata
    out_md = output_metadata_file or os.path.join(output_data_dir,
                                                  "tensor_metadata.json")
    out_metadata = add_columns_to_metadata(
        {offset_column_name: ("float", False)}, metadata_file, out_md,
        data_format)

    ragged_i = ragged_v = None
    if feature_bag and data.indices is not None:
        ragged_i = [data.indices[i, :data.nnz[i]]
                    for i in range(data.num_samples)]
        ragged_v = [data.values[i, :data.nnz[i]]
                    for i in range(data.num_samples)]
    fs.makedirs(output_data_dir, exist_ok=True)
    if data_format == "avro":
        from gdmix_tpu_torch.io.avro_dataset import write_per_record_avro
        n = write_per_record_avro(
            os.path.join(output_data_dir, "part-00000.avro"), out_metadata,
            data.columns, feature_bag, ragged_i, ragged_v)
    else:
        n = write_per_record(
            os.path.join(output_data_dir, "part-00000.tfrecord"), out_metadata,
            data.columns, feature_bag, ragged_i, ragged_v)
    logger.info("offset updater: wrote %d records to %s", n, output_data_dir)
    return n
