"""String constants shared across the framework.

Mirrors the vocabulary of the reference trainer
(linkedin/gdmix:gdmix-trainer/src/gdmix/util/constants.py) so that configs,
directory layouts and column names stay interchangeable.
"""

# Actions
ACTION_TRAIN = "train"
ACTION_INFERENCE = "inference"

# Stages
FIXED_EFFECT = "fixed_effect"
RANDOM_EFFECT = "random_effect"

# Model types
LOGISTIC_REGRESSION = "logistic_regression"
LINEAR_REGRESSION = "linear_regression"
DETEXT = "detext"

# Variance computation modes
SIMPLE = "simple"
FULL = "full"

# Dataset constants
TFRECORD = "tfrecord"
TFRECORD_GLOB_PATTERN = "*.tfrecord"
ACTIVE = "active"
PASSIVE = "passive"

# Execution-context keys
PARTITION_INDEX = "partition_index"
TASK_INDEX = "task_index"
NUM_WORKERS = "num_workers"
IS_CHIEF = "is_chief"
ACTIVE_TRAINING_OUTPUT_FILE = "active_training_output_file"
PASSIVE_TRAINING_OUTPUT_FILE = "passive_training_output_file"
PASSIVE_TRAINING_DATA_DIR = "passive_training_data_dir"
VALIDATION_OUTPUT_FILE = "validation_output_file"

# Model export
INTERCEPT = "(INTERCEPT)"
LOGISTIC_MODEL_CLASS = "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel"
LINEAR_MODEL_CLASS = "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel"
