"""Model ABC — the L4→L3 contract (reference gdmix/models/api.py:4-84)."""
from __future__ import annotations

import abc


class Model(abc.ABC):
    """train / predict / export contract shared by all coordinate models."""

    @abc.abstractmethod
    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        raise NotImplementedError

    @abc.abstractmethod
    def predict(self, output_dir, input_data_path, metadata_file, checkpoint_path,
                execution_context, schema_params):
        raise NotImplementedError

    def export(self, output_model_dir):
        """Linear models are exported as part of training; deep models override."""
