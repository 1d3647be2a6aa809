"""Hyperparameter sweep runner: grid of pipeline runs → best-model selection.

Port of gdmix_tpu/workflow/sweep.py. The reference supports sweeps through
BestModelSelector over per-run metric dirs (BestModelSelector.scala:32-129,
base64 hparam maps). This runner closes the loop: run the pipeline per
parameter combination and pick the winner.
"""
from __future__ import annotations

import base64
import copy
import itertools
import json
import logging
import os
from typing import Dict, List, Sequence, Tuple

from gdmix_tpu_torch.data.best_model import select_best_model
from gdmix_tpu_torch.workflow.config import METRIC, MODELS, WorkflowConfig

logger = logging.getLogger(__name__)


def expand_grid(param_grid: Dict[str, Sequence]) -> List[Dict]:
    """{"a": [1,2], "b": [x]} → [{a:1,b:x}, {a:2,b:x}]"""
    keys = list(param_grid)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(param_grid[k] for k in keys))]


def _apply_overrides(config: WorkflowConfig, overrides: Dict) -> WorkflowConfig:
    """Override keys apply to every coordinate config (e.g. l2_reg_weight)."""
    cfg = copy.deepcopy(config)
    for section in (cfg.fixed_effect_config, cfg.random_effect_config):
        for coord in section.values():
            for k, v in overrides.items():
                coord[k] = v
    return cfg


def run_sweep(config: WorkflowConfig, param_grid: Dict[str, Sequence],
              metric_coordinate: str, output_dir: str,
              mode: str = "in_memory", device=None) -> Tuple[int, List[Dict]]:
    """Run one pipeline per grid point, `mode` "in_memory" or
    "single_node", on `device` (resolve_device's default: the first card);
    select the best by the named coordinate's validation AUC. Returns
    (best index, grid)."""
    if mode == "in_memory":
        from gdmix_tpu_torch.workflow.pipeline import \
            run_gdmix_in_memory as run
    elif mode == "single_node":
        from gdmix_tpu_torch.workflow.single_node import \
            run_gdmix_single_node as run
    else:
        raise ValueError(f"mode {mode!r}: in_memory or single_node")
    grid = expand_grid(param_grid)
    metric_paths = []
    model_paths = []
    for i, overrides in enumerate(grid):
        run_dir = os.path.join(output_dir, f"run_{i}")
        cfg = _apply_overrides(config, overrides)
        cfg.output_dir = run_dir
        logger.info("sweep run %d/%d: %s", i + 1, len(grid), overrides)
        run(cfg, device=device)
        metric_paths.append(os.path.join(run_dir, metric_coordinate, METRIC))
        model_paths.append(os.path.join(run_dir, metric_coordinate, MODELS))

    hparams = base64.b64encode(json.dumps(
        {str(i): g for i, g in enumerate(grid)}).encode()).decode()
    best = select_best_model(
        metric_paths, "auc", os.path.join(output_dir, "best"),
        hyperparameters=hparams, input_model_paths=model_paths,
        output_best_metrics_path=os.path.join(output_dir, "best_metrics"),
        copy_best_output=True)
    logger.info("sweep best run: %d (%s)", best, grid[best])
    return best, grid
