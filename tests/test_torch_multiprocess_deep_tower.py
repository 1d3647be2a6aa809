"""The deep (DeText) tower across processes, on the CPU in float64
(gdmix_tpu/models/deep_tower.py:288-530 in the port):

- two REAL processes over a gloo process group train data parallel (the
  same permutation, a contiguous half of each global batch each, the
  gradients averaged by one all-reduce a step) and must reproduce the
  one-process fit: bit-equal replicas, and the validation scores within
  a tolerance of one process. The sums of a step run in two halves, so
  the gradients part at rounding level only: 3e-17 on a step of the
  ranking loss here. Pointwise loss: scores within 1e-8·max|score|, AUC
  within 1e-8. The ranking loss's pair sums leave coordinates whose
  gradient is itself rounding noise, and Adam, which divides each
  coordinate by its own running RMS, moves those by up to the learning
  rate a step whichever way the noise points: its runs part by 4e-10 of
  the loss after one epoch, so it is held to 1e-2·max|score| and 2e-3 of
  AUC (the JAX package's own test asks for a 0.98 correlation and 0.05
  of AUC, tests/test_deep_tower.py:201). Both losses: the pointwise one,
  and the ranking one whose pairs span the two processes' halves. BERT's
  encoder under the pointwise loss, each process packing the encoded
  positions of its own half of a batch, is held as the pointwise cnn.
- NUM_WORKERS = 2 with no process group: independent replicas, each
  scoring its interleaved share; the union is every row once, equal to
  the one-worker scores (tests/test_deep_tower.py:167)."""
import json
import os

import numpy as np
import pytest
import torch

from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.ops.metrics import auc as auc_metric
from gdmix_tpu_torch import constants
from gdmix_tpu_torch.params import Params
from tests.test_torch_deep_tower import (_base, _kwargs, _port_model,
                                         detext_data)  # noqa: F401
from tests.torch_multiproc_runner import launch

RANKING = {"task_type": "ranking", "query_column": "user_id",
           "l2_reg_weight": 1e-4}
# a small BERT (its config file is written by the test)
BERT = {"ftr_ext": "bert", "max_len": 12, "learning_rate": 1e-3}
BERT_CONFIG = dict(vocab_size=400, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=16)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _ctx(task=0, workers=1):
    return {constants.TASK_INDEX: task, constants.NUM_WORKERS: workers,
            constants.IS_CHIEF: task == 0}


def _scores(out_root, schema):
    s = read_scores(os.path.join(out_root, "validation_scores"), schema)
    order = np.argsort(s["uid"], kind="stable")
    return s["uid"][order], s["predictionScore"][order], s["response"][order]


@pytest.mark.parametrize("over,score_rtol,auc_atol", [
    ({}, 1e-8, 1e-8), (RANKING, 1e-2, 2e-3), (BERT, 1e-8, 1e-8)],
    ids=["classification", "ranking", "bert-classification"])
def test_two_process_training_matches_one(detext_data, tmp_path, over,
                                          score_rtol, auc_atol):
    kw = dict(num_epochs=3, dtype="float64", **over)
    if over is BERT:
        kw["bert_config_file"] = str(tmp_path / "bert_config.json")
        with open(kw["bert_config_file"], "w") as f:
            json.dump(BERT_CONFIG, f)
    one_root, mp_root = str(tmp_path / "one"), str(tmp_path / "mp")
    one = _port_model(detext_data, one_root, **kw)
    one.train(one.training_data_dir, one.validation_data_dir,
              one.metadata_file, one.checkpoint_path, _ctx(),
              one.base_params)
    base = dict(action="train", stage="fixed_effect", model_type="detext",
                label_column_name="response", uid_column_name="uid",
                weight_column_name="weight",
                prediction_score_column_name="predictionScore",
                training_score_dir=os.path.join(mp_root, "train_scores"),
                validation_score_dir=os.path.join(mp_root,
                                                  "validation_scores"))
    res = launch("tower", dict(model=_kwargs(detext_data, mp_root, **kw),
                               base=base))
    assert res[0]["sha"] == res[1]["sha"]           # identical replicas
    assert res[0]["fit"]["best_epoch"] == one.last_fit["best_epoch"]
    schema = _base(Params, mp_root)
    uid1, s1, y1 = _scores(one_root, schema)
    uid2, s2, y2 = _scores(mp_root, schema)
    np.testing.assert_array_equal(uid1, uid2)        # every row once
    gap = np.abs(s1 - s2).max()
    assert gap <= score_rtol * np.abs(s1).max(), gap
    assert abs(float(auc_metric(s1, y1)) - float(auc_metric(s2, y2))) \
        <= auc_atol
    # one checkpoint, written by the chief, loads and scores what the two
    # processes wrote
    cold = _port_model(detext_data, mp_root, **kw)
    cold._load_checkpoint()
    arrays = cold._rows(cold.validation_data_dir, schema)
    total = (cold._score_all(cold._on_device(arrays)).numpy()
             + arrays["offsets"])[np.argsort(arrays["uid"], kind="stable")]
    np.testing.assert_allclose(total, s2, rtol=1e-6, atol=1e-6)


def test_independent_replicas_score_their_share(detext_data, tmp_path):
    one_root = str(tmp_path / "one")
    model = _port_model(detext_data, one_root)
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, _ctx(),
                model.base_params)
    schema = _base(Params, one_root)
    uid1, s1, _ = _scores(one_root, schema)
    two = str(tmp_path / "two")
    for task in (0, 1):
        replica = _port_model(detext_data, one_root)
        replica.predict(os.path.join(two, "validation_scores"),
                        replica.validation_data_dir, replica.metadata_file,
                        replica.checkpoint_path, _ctx(task, 2), schema)
        part = read_scores(os.path.join(two, "validation_scores",
                                        f"part-{task:05d}.avro"), schema)
        assert len(part["uid"]) == (len(uid1) + 1 - task) // 2
    uid2, s2, _ = _scores(two, schema)
    np.testing.assert_array_equal(uid1, uid2)
    np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-6)
