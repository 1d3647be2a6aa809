"""LR model splitter: one crossed global model → per-entity models.

Replaces the Spark LrModelSplitter (linkedin/gdmix:gdmix-data/src/main/scala/com/
linkedin/gdmix/model/LrModelSplitter.scala:51-101): features named
"<modelId>_gdmixcross_<feature>" are exploded, split on the cross marker and
regrouped by modelId into photon-ml BayesianLinearModelAvro records.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List

from gdmix_tpu_torch.constants import LOGISTIC_MODEL_CLASS
from gdmix_tpu_torch.io import avro
from gdmix_tpu_torch.io.model_avro import BAYESIAN_LINEAR_MODEL_SCHEMA
from gdmix_tpu_torch.io import fs

CROSS = "_gdmixcross_"


def _split_ntv_list(ntvs: List[dict]) -> Dict[str, List[dict]]:
    out: "OrderedDict[str, List[dict]]" = OrderedDict()
    for ntv in ntvs:
        model_id, name = ntv["name"].split(CROSS)
        out.setdefault(model_id, []).append(
            {"name": name, "term": ntv["term"], "value": ntv["value"]})
    return out


def split_model_file(model_input_path: str, model_output_dir: str,
                     num_output_files: int = 1) -> int:
    """Split every model record found under model_input_path. Returns the number
    of per-entity models written."""
    files = ([os.path.join(model_input_path, f)
              for f in sorted(fs.listdir(model_input_path)) if f.endswith(".avro")]
             if fs.isdir(model_input_path) else [model_input_path])
    means: "OrderedDict[str, List[dict]]" = OrderedDict()
    variances: "OrderedDict[str, List[dict]]" = OrderedDict()
    has_variances = False
    for f in files:
        for record in avro.read_records(f):
            for mid, ntvs in _split_ntv_list(record["means"]).items():
                means.setdefault(mid, []).extend(ntvs)
            if record.get("variances"):
                has_variances = True
                for mid, ntvs in _split_ntv_list(record["variances"]).items():
                    variances.setdefault(mid, []).extend(ntvs)

    records = []
    for mid, ntvs in means.items():
        records.append({
            "modelId": mid,
            "modelClass": LOGISTIC_MODEL_CLASS,
            "means": ntvs,
            "variances": variances.get(mid) if has_variances else None,
            "lossFunction": "",
        })

    fs.makedirs(model_output_dir, exist_ok=True)
    per_file = max(1, (len(records) + num_output_files - 1) // num_output_files)
    written = 0
    for i in range(0, max(len(records), 1), per_file):
        chunk = records[i:i + per_file]
        if not chunk:
            break
        avro.write_records(
            os.path.join(model_output_dir, f"part-{i // per_file:05d}.avro"),
            BAYESIAN_LINEAR_MODEL_SCHEMA, chunk)
        written += len(chunk)
    return written
