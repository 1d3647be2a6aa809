"""Workflow YAML config loading.

Accepts the reference's GDMix config dialect verbatim (gdmix-workflow/test/
resources/lr-movieLens.yaml): output_dir + fixed_effect_config {name: {...,
gdmix_config: {...}}} + random_effect_config {name: {..., num_partitions,
gdmix_config}} with YAML anchors. spark_config/tfjob_config blocks are accepted
and ignored (single-process TPU runs don't need them).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict

import yaml
from gdmix_tpu_torch.io import fs

MODELS = "models"
METRIC = "metric"
TRAINING_SCORES = "train_scores"
VALIDATION_SCORES = "validation_scores"
PARTITION = "partition"


@dataclass
class WorkflowConfig:
    output_dir: str
    fixed_effect_config: Dict[str, dict] = field(default_factory=dict)
    random_effect_config: Dict[str, dict] = field(default_factory=dict)
    extras: dict = field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str) -> "WorkflowConfig":
        with fs.open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    @classmethod
    def from_dict(cls, obj: dict) -> "WorkflowConfig":
        obj = copy.deepcopy(obj)
        out = cls(output_dir=obj.pop("output_dir"),
                  fixed_effect_config=obj.pop("fixed_effect_config", {}),
                  random_effect_config=obj.pop("random_effect_config", {}))
        out.extras = obj
        return out
