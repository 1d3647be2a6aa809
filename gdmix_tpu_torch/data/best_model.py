"""Best-model selector for hyperparameter sweeps.

Replaces the Spark BestModelSelector (linkedin/gdmix:gdmix-data/src/main/scala/
com/linkedin/gdmix/data/BestModelSelector.scala:32-129): pick the best model by
AUC (max) or RMSE (min) over metric dirs, write evals.json, optionally copy the
winning model + metrics.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Optional, Sequence

from gdmix_tpu_torch.data.evaluator import EVAL_SUMMARY_JSON
from gdmix_tpu_torch.io import fs


def decode_hparams(hparams_b64: str) -> dict:
    return json.loads(base64.b64decode(hparams_b64).decode("utf-8"))


def select_best_model(input_metrics_paths: Sequence[str],
                      eval_metric: str,
                      output_best_model_path: str,
                      hyperparameters: Optional[str] = None,
                      input_model_paths: Optional[Sequence[str]] = None,
                      output_best_metrics_path: Optional[str] = None,
                      copy_best_output: bool = False) -> int:
    """Returns the best model index; writes evals.json under the output path."""
    if eval_metric == "auc":
        direction = 1
    elif eval_metric == "rmse":
        direction = -1
    else:
        raise ValueError(f"Evaluation metric {eval_metric} is not defined")

    hparam_map = decode_hparams(hyperparameters) if hyperparameters else {}
    best_metric, best_id = None, -1
    for model_id, path in enumerate(input_metrics_paths):
        with fs.open(os.path.join(path, EVAL_SUMMARY_JSON)) as f:
            summary = json.load(f)
        metric = summary[eval_metric]
        if best_metric is None or metric * direction > best_metric * direction:
            best_metric, best_id = metric, model_id

    fs.makedirs(output_best_model_path, exist_ok=True)
    configs = {"best model index": best_id,
               "model params": json.dumps(hparam_map.get(str(best_id), {}))}
    with fs.open(os.path.join(output_best_model_path, "evals.json"), "w") as f:
        json.dump(configs, f)

    if copy_best_output:
        assert input_model_paths is not None and \
            len(input_model_paths) == len(input_metrics_paths)
        # through the filesystem seam, so that a remote winner reaches a
        # remote destination
        if output_best_metrics_path:
            fs.copy_tree(input_metrics_paths[best_id], output_best_metrics_path)
        fs.copy_tree(input_model_paths[best_id], output_best_model_path)
    return best_id
