"""Single-node workflow runner: the full coordinate-descent pipeline, in-process.

Port of gdmix_tpu/workflow/single_node.py (reference gdmix-workflow/src/
gdmixworkflow/single_node_workflow.py + fixed/random_effect_workflow_
generator.py), with the subprocess `python -m gdmix.gdmix` / `spark-submit`
jobs replaced by direct function calls into this package:

  fixed effect:   train(+score) → evaluate (AUC on validation scores); an
                  LR model, or the deep (detext) tower
  per RE coord:   partition (score join + offset update + group by entity)
                  → batched train(+score) → evaluate

The score-residual handoff between coordinates stays the reference's directory
contract: <coordinate>/{models,metric,train_scores,validation_scores,partition}.
Every directory operation goes through the filesystem seam (io/fs), so a
remote `output_dir` is cleared and written where it lies. Both models run
on one device a process: the process's card, or the CPU when it is asked
for. Each coordinate logs its partition, train and evaluate seconds (the
record's `stage_seconds`).

In every process of a group (`--mode distributed`) the train stages run in
every process (the fixed effect's file or sample shards, the random
effect's partitions round-robin), while the set-up of each coordinate's
tree and the data jobs (partitioner, evaluator) run on the chief alone,
each followed by a barrier; the other processes read the chief's
evalSummary.json. The JAX package runs those in every process, and they
race on one tree (ROADMAP C.14).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.data.evaluator import run_evaluator
from gdmix_tpu_torch.data.partitioner import PartitionerConfig, \
    run_partitioner
from gdmix_tpu_torch.device import resolve_device
from gdmix_tpu_torch.drivers.driver import FixedEffectDriver, \
    RandomEffectDriver
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.models.deep_tower import DeepTowerModel, \
    DeepTowerParams
from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
from gdmix_tpu_torch.parallel.process_group import (barrier,
                                                    process_index_and_count)
from gdmix_tpu_torch.params import FixedLRParams, Params, REParams, from_dict
from gdmix_tpu_torch.workflow.config import (METRIC, MODELS, PARTITION,
                                             TRAINING_SCORES,
                                             VALIDATION_SCORES,
                                             WorkflowConfig)

logger = logging.getLogger(__name__)


def _create_subdirs(parent_dir: str) -> None:
    fs.remove_tree(parent_dir)
    fs.makedirs(parent_dir)
    for sub in (MODELS, METRIC, TRAINING_SCORES, VALIDATION_SCORES):
        fs.makedirs(os.path.join(parent_dir, sub))


def _metric_name(model_type: str) -> str:
    return "mse" if model_type == constants.LINEAR_REGRESSION else "auc"


def _completed_metric(output_dir: str, metric: str):
    """The coordinate's recorded metric if it already ran to completion
    (evalSummary.json written last), else None. Powers --resume: a crashed
    pipeline restarts from the first unfinished coordinate, since each
    coordinate's outputs (scores for the next stage's offset join) exist iff
    its evaluation was reached (reference has no resume; its wrapper rewipes
    every directory, single_node_workflow.py:21-48)."""
    path = os.path.join(output_dir, METRIC, "evalSummary.json")
    try:
        with fs.open(path) as f:
            return json.load(f)[metric]
    except (OSError, ValueError, KeyError):
        return None


def _on_chief(fn) -> None:
    """Run `fn` on the chief alone, then wait for every process (C.14);
    just `fn` in one process."""
    if process_index_and_count()[0] == 0:
        fn()
    barrier()


def _evaluate(output_dir: str, params: Params, metric: str) -> float:
    """The evaluator job on the chief; every process returns the value the
    chief wrote to evalSummary.json."""
    barrier()   # every process's validation scores are written
    _on_chief(lambda: run_evaluator(
        os.path.join(output_dir, VALIDATION_SCORES),
        os.path.join(output_dir, METRIC), params.label_column_name,
        params.prediction_score_column_name, metric,
        schema_params=params))
    value = _completed_metric(output_dir, metric)
    if value is None:
        raise RuntimeError(f"no {metric} in {output_dir}/{METRIC}")
    return value


def _log_stages(kind: str, name: str, metric: str, value: float,
                seconds: Dict[str, float]) -> None:
    logger.info("%s %s: %s = %s (%s)", kind, name, metric, value,
                ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()),
                extra={"coordinate": name, "stage_seconds": seconds})


def run_fixed_effect(config: WorkflowConfig, resume: bool = False,
                     device=None) -> Dict[str, float]:
    (name, fe_config), = config.fixed_effect_config.items()
    fe_config = dict(fe_config)
    gdmix_config = dict(fe_config.pop("gdmix_config"))
    output_dir = os.path.join(config.output_dir, name)
    model_type = gdmix_config.get("model_type",
                                  constants.LOGISTIC_REGRESSION)
    if model_type not in (constants.LOGISTIC_REGRESSION, constants.DETEXT):
        # same restriction as the reference workflow generator
        # (fixed_effect_workflow_generator.py:75-85); plain linear regression
        # runs through the trainer CLI, not the scored+evaluated workflow
        raise ValueError(f"unsupported model_type: {model_type}")
    metric = _metric_name(model_type)
    if resume:
        done = _completed_metric(output_dir, metric)
        if done is not None:
            logger.info("resume: fixed effect %s already complete (%s = %s)",
                        name, metric, done)
            return {name: done}
    _on_chief(lambda: _create_subdirs(output_dir))

    t0 = time.perf_counter()
    base_params = from_dict(Params, {
        **gdmix_config,
        "stage": constants.FIXED_EFFECT,
        "training_score_dir": os.path.join(output_dir, TRAINING_SCORES),
        "validation_score_dir": os.path.join(output_dir, VALIDATION_SCORES),
    })
    if model_type == constants.DETEXT:
        model_params = from_dict(DeepTowerParams, {
            **fe_config, "output_model_dir": os.path.join(output_dir, MODELS)})
        model = DeepTowerModel(model_params, base_params, device=device)
    else:
        model_params = from_dict(FixedLRParams, {
            **fe_config, "output_model_dir": os.path.join(output_dir, MODELS)})
        model = FixedEffectLRModel(model_params, base_params, device=device)
    FixedEffectDriver(base_params, model).run_training(base_params)
    t1 = time.perf_counter()
    value = _evaluate(output_dir, base_params, metric)
    _log_stages("fixed effect", name, metric, value,
                {"train": t1 - t0, "evaluate": time.perf_counter() - t1})
    return {name: value}


def run_random_effects(config: WorkflowConfig, prev_model_name: str,
                       resume: bool = False,
                       device=None) -> Dict[str, float]:
    metrics: Dict[str, float] = {}
    root = config.output_dir
    for name, re_config in config.random_effect_config.items():
        re_config = dict(re_config)
        gdmix_config = dict(re_config.pop("gdmix_config"))
        if gdmix_config.get("model_type", constants.LOGISTIC_REGRESSION) \
                != constants.LOGISTIC_REGRESSION:
            # reference restriction (model_factory.py:46-47): random effects
            # are logistic-only — checked BEFORE the partition job runs
            raise ValueError(f"random effect {name}: only "
                             f"{constants.LOGISTIC_REGRESSION} is supported")
        num_partitions = int(re_config.pop("num_partitions", 1))
        output_dir = os.path.join(root, name)
        metric = _metric_name(constants.LOGISTIC_REGRESSION)
        if resume:
            done = _completed_metric(output_dir, metric)
            if done is not None:
                logger.info("resume: random effect %s already complete "
                            "(%s = %s)", name, metric, done)
                metrics[name] = done
                prev_model_name = name
                continue

        def set_up():
            _create_subdirs(output_dir)
            for score_name in (TRAINING_SCORES, VALIDATION_SCORES):
                for idx in range(num_partitions):
                    fs.makedirs(os.path.join(output_dir, score_name,
                                             f"partitionId={idx}"),
                                exist_ok=True)
        _on_chief(set_up)

        # ---- partition job (DataPartitioner equivalent) ----
        t0 = time.perf_counter()
        part_dir = os.path.join(output_dir, PARTITION)
        training_data_dir = os.path.join(part_dir, "trainingData")
        validation_data_dir = os.path.join(part_dir, "validationData")
        metadata_file = os.path.join(part_dir, "metadata",
                                     "tensor_metadata.json")
        partition_list_file = os.path.join(part_dir, "partitionList.txt")
        prev_dir = os.path.join(root, prev_model_name)
        cfg = PartitionerConfig(
            partition_entity=re_config["partition_entity"],
            num_partitions=num_partitions,
            min_samples=re_config.pop("min_samples", None),
            max_samples=re_config.pop("max_samples", None),
            uid_column_name=gdmix_config.get("uid_column_name", "uid"),
            prediction_score_column_name=gdmix_config.get(
                "prediction_score_column_name", "predictionScore"),
        )
        _on_chief(lambda: run_partitioner(
            training_data_dir=re_config["training_data_dir"],
            validation_data_dir=re_config.get("validation_data_dir"),
            metadata_file=re_config["metadata_file"],
            output_metadata_file=metadata_file,
            partitioned_training_data_dir=training_data_dir,
            partitioned_validation_data_dir=validation_data_dir,
            output_partition_list_file=partition_list_file,
            config=cfg, feature_bag=re_config.get("feature_bag"),
            training_score_dir=os.path.join(prev_dir, TRAINING_SCORES),
            validation_score_dir=os.path.join(prev_dir, VALIDATION_SCORES)))

        # ---- train job ----
        t1 = time.perf_counter()
        base_params = from_dict(Params, {
            **gdmix_config,
            "stage": constants.RANDOM_EFFECT,
            "partition_list_file": partition_list_file,
            "training_score_dir": os.path.join(output_dir, TRAINING_SCORES),
            "validation_score_dir": os.path.join(output_dir,
                                                 VALIDATION_SCORES),
        })
        model_params = from_dict(REParams, {
            **re_config,
            "training_data_dir": training_data_dir,
            "validation_data_dir": validation_data_dir,
            "metadata_file": metadata_file,
            "output_model_dir": os.path.join(output_dir, MODELS),
        })
        model = RandomEffectLRModel(model_params, base_params, device=device)
        RandomEffectDriver(base_params, model).run_training(base_params)

        # ---- evaluate ----
        t2 = time.perf_counter()
        value = _evaluate(output_dir, base_params, metric)
        _log_stages("random effect", name, metric, value,
                    {"partition": t1 - t0, "train": t2 - t1,
                     "evaluate": time.perf_counter() - t2})
        metrics[name] = value
        prev_model_name = name
    return metrics


def run_gdmix_single_node(config_path_or_obj, resume: bool = False,
                          device=None) -> Dict[str, float]:
    """Run the full pipeline. Returns {coordinate_name: validation metric}.
    resume=True skips coordinates whose evalSummary.json already exists
    (restart a crashed run from the first unfinished coordinate). `device`
    as in resolve_device: by default the first card, an error without one;
    checked before anything is written."""
    config = (config_path_or_obj
              if isinstance(config_path_or_obj, WorkflowConfig)
              else WorkflowConfig.from_file(config_path_or_obj))
    if not config.fixed_effect_config:
        raise ValueError("Need to define fixed_effect_config")
    device = resolve_device(device)
    metrics = run_fixed_effect(config, resume=resume, device=device)
    fe_name = next(iter(config.fixed_effect_config))
    if config.random_effect_config:
        metrics.update(run_random_effects(config, prev_model_name=fe_name,
                                          resume=resume, device=device))
    return metrics
