"""Drivers: partition loop + training/inference orchestration.

Port of gdmix_tpu/drivers/driver.py (reference drivers/driver.py:12-216,
fixed_effect_driver.py, random_effect_driver.py). A fixed-effect "worker"
is a process; random-effect partitions are assigned round-robin to
processes. The process index and count are the torch.distributed rank and
world size when a process group is initialised, else 0 and 1.
"""
from __future__ import annotations

import abc
import logging
import os
from typing import List, Optional

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.parallel.process_group import process_index_and_count
from gdmix_tpu_torch.params import Params

logger = logging.getLogger(__name__)


def _is_empty_directory(path: str) -> bool:
    if not fs.isdir(path):
        raise ValueError(f"Directory expected, but {path} is not a directory")
    return len(fs.listdir(path)) == 0


class Driver(abc.ABC):
    """Partition loop + output-path anchoring."""

    def __init__(self, base_params: Params, model, effect_name: str):
        self.base_params = base_params
        self.model = model
        self.effect_name = effect_name
        self.execution_context = self._setup_cluster()

    def _setup_cluster(self) -> dict:
        index, count = process_index_and_count()
        return {
            constants.TASK_INDEX: index,
            constants.NUM_WORKERS: count,
            constants.IS_CHIEF: index == 0,
        }

    @abc.abstractmethod
    def _get_partition_list(self) -> List[int]:
        ...

    @abc.abstractmethod
    def _anchor_directory(self, directory_path: str,
                          partition_index: int) -> str:
        ...

    def run_training(self, schema_params, export_model: bool = False,
                     output_model_dir: Optional[str] = None) -> None:
        logger.info("Commencing %s training", self.effect_name)
        for partition_index in self._get_partition_list():
            logger.info("Partition index: %s", partition_index)
            checkpoint_path = self._anchor_directory(
                self.model.checkpoint_path, partition_index)
            training_data_dir = self._anchor_directory(
                self.model.training_data_dir, partition_index)
            validation_data_dir = (
                self._anchor_directory(self.model.validation_data_dir,
                                       partition_index)
                if self.model.validation_data_dir else None)
            if _is_empty_directory(training_data_dir):
                logger.info("%s is empty, no dataset to train on.",
                            training_data_dir)
                continue
            self.execution_context[constants.PARTITION_INDEX] = \
                partition_index
            self.model.train(
                training_data_dir=training_data_dir,
                validation_data_dir=validation_data_dir,
                metadata_file=self.model.metadata_file,
                checkpoint_path=checkpoint_path,
                execution_context=self._prepare_training_context(
                    partition_index),
                schema_params=schema_params)
            if export_model and self.execution_context[constants.IS_CHIEF]:
                self.model.export(output_model_dir=output_model_dir)

    def run_inference(self, schema_params) -> None:
        logger.info("Commencing %s inference", self.effect_name)
        for partition_index in self._get_partition_list():
            self.execution_context[constants.PARTITION_INDEX] = \
                partition_index
            pairs = ((self.model.training_data_dir,
                      self.base_params.training_score_dir),
                     (self.model.validation_data_dir,
                      self.base_params.validation_score_dir))
            for input_path, output_path in pairs:
                if input_path and output_path:
                    data_path = self._anchor_directory(input_path,
                                                       partition_index)
                    output_dir = self._anchor_directory(output_path,
                                                        partition_index)
                    if _is_empty_directory(input_path):
                        continue
                    self.model.predict(
                        output_dir=output_dir, input_data_path=data_path,
                        metadata_file=self.model.metadata_file,
                        checkpoint_path=self.model.checkpoint_path,
                        execution_context=self.execution_context,
                        schema_params=schema_params)
        logger.info("Inference complete")

    def _prepare_training_context(self, partition_index: int) -> dict:
        """RE training gets anchored score-output files (reference
        driver.py:191-214)."""
        if self.base_params.stage != constants.RANDOM_EFFECT:
            return self.execution_context
        task_index = self.execution_context[constants.TASK_INDEX]
        ctx = dict(self.execution_context)
        training_score_dir = self._anchor_directory(
            self.base_params.training_score_dir, partition_index)
        ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE] = os.path.join(
            training_score_dir, f"part-{task_index:05d}-active.avro")
        ctx[constants.PASSIVE_TRAINING_OUTPUT_FILE] = os.path.join(
            training_score_dir, f"part-{task_index:05d}-passive.avro")
        ctx[constants.VALIDATION_OUTPUT_FILE] = (os.path.join(
            self._anchor_directory(self.base_params.validation_score_dir,
                                   partition_index),
            f"part-{task_index:05d}.avro")
            if self.base_params.validation_score_dir else None)
        passive_dir = self._anchor_directory(
            self.model.passive_training_data_dir, partition_index)
        if fs.isdir(passive_dir) and fs.listdir(passive_dir):
            ctx[constants.PASSIVE_TRAINING_DATA_DIR] = passive_dir
        return ctx


class FixedEffectDriver(Driver):
    """Fixed effect: one logical partition; workers = processes."""

    def __init__(self, base_params: Params, model):
        super().__init__(base_params, model, effect_name="fixed effect")

    def _get_partition_list(self) -> List[int]:
        return [self.execution_context[constants.TASK_INDEX]]

    def _anchor_directory(self, directory_path: str,
                          partition_index: int) -> str:
        return directory_path


class RandomEffectDriver(Driver):
    """Random effect: round-robin partition assignment, partitionId=N
    anchoring."""

    _PARTITION_FOLDER_PREFIX = "partitionId="

    def __init__(self, base_params: Params, model):
        super().__init__(base_params, model, effect_name="random effect")

    def _get_partition_list(self) -> List[int]:
        partition_file = self.base_params.partition_list_file
        assert partition_file, \
            "partition_list_file is required for random effect"
        with fs.open(partition_file) as f:
            all_partitions = [int(x) for x in f.read().strip().split(",")
                              if x != ""]
        task_index = self.execution_context[constants.TASK_INDEX]
        num_workers = self.execution_context[constants.NUM_WORKERS]
        return all_partitions[task_index::num_workers]

    def _anchor_directory(self, directory_path: str,
                          partition_index: int) -> str:
        return os.path.join(
            directory_path,
            f"{self._PARTITION_FOLDER_PREFIX}{partition_index}")
