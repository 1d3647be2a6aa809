"""Metric evaluator: score files → evalSummary.json.

Replaces the Spark Evaluator job (linkedin/gdmix:gdmix-data/src/main/scala/com/
linkedin/gdmix/evaluation/Evaluator.scala:29-79). The metric itself runs on device
(ops/metrics.py).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from gdmix_tpu_torch.io.scores import read_scores
from gdmix_tpu_torch.ops import metrics
from gdmix_tpu_torch.io import fs

EVAL_SUMMARY_JSON = "evalSummary.json"


def calculate_metric(scores: np.ndarray, labels: np.ndarray,
                     metric_name: str) -> float:
    if metric_name == "auc":
        return float(metrics.auc(scores, labels))
    if metric_name == "mse":
        return float(metrics.mse(scores, labels))
    raise ValueError(f"Do not support metric {metric_name}, currently only "
                     f"support 'auc' and 'mse'.")


def run_evaluator(metrics_input_dir: str, output_metric_dir: str,
                  label_column_name: str, prediction_column_name: str,
                  metric_name: str, schema_params=None) -> Dict[str, float]:
    from types import SimpleNamespace
    shim = schema_params or SimpleNamespace(
        uid_column_name="uid",
        prediction_score_column_name=prediction_column_name,
        prediction_score_per_coordinate_column_name="predictionScorePerCoordinate",
        label_column_name=label_column_name,
        weight_column_name=None)
    data = read_scores(metrics_input_dir, shim)
    metric = calculate_metric(data[prediction_column_name],
                              data[label_column_name], metric_name)
    result = {metric_name: metric}
    fs.makedirs(output_metric_dir, exist_ok=True)
    with fs.open(os.path.join(output_metric_dir, EVAL_SUMMARY_JSON), "w") as f:
        json.dump(result, f)
    return result
