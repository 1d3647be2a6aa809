"""Driver/model factories (reference gdmix/factory/*.py)."""
from __future__ import annotations

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.drivers.driver import (Driver, FixedEffectDriver,
                                            RandomEffectDriver)
from gdmix_tpu_torch.models.deep_tower import DeepTowerModel
from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
from gdmix_tpu_torch.params import Params


def get_model(params: Params, argv, device=None):
    stage, model_type = params.stage, params.model_type
    if model_type in (constants.LOGISTIC_REGRESSION,
                      constants.LINEAR_REGRESSION):
        if stage == constants.FIXED_EFFECT:
            return FixedEffectLRModel.from_argv(argv, params, device)
        if model_type == constants.LINEAR_REGRESSION:
            # same restriction as the reference (model_factory.py:46-47):
            # the RE solver stack is logistic-only
            raise ValueError("Does not support random effect model for "
                             "plain linear regression")
        return RandomEffectLRModel.from_argv(argv, params, device)
    if model_type == constants.DETEXT:
        if stage != constants.FIXED_EFFECT:
            raise ValueError("deep (detext) models are fixed-effect only")
        return DeepTowerModel.from_argv(argv, params, device)
    raise ValueError(f"unsupported model_type {model_type}")


def get_driver(params: Params, argv, device=None) -> Driver:
    model = get_model(params, argv, device)
    if params.stage == constants.FIXED_EFFECT:
        return FixedEffectDriver(params, model)
    return RandomEffectDriver(params, model)
