"""The deep tower's BERT encoder (`--ftr_ext=bert --bert_config_file=...`)
against the benchmark's plain reference (benchmark/reference/bert_tower.py:
plain PyTorch, written from BERT's equations), at a small BERT (hidden 64,
2 layers, 4 heads, intermediate 256) over L 16 and B 8, on seeded random
weights; the framing of the documents; the refusals; and the normal path
(the trainer's command line) on the CPU.

Tolerances, float64 throughout (the reference computes the same sums in
other orders: an explicit softmax against scaled_dot_product_attention,
its own LayerNorm and GELU, row blocks for the gradient): _FWD_RTOL on the
logits and the loss (relative); _GRAD_RTOL on every gradient, relative to
the larger of its leaf's largest entry and the median leaf's (an attention
key's bias has a gradient of rounding alone: the softmax cancels it);
_ADAM_ATOL on the parameters after three Adam steps of lr 1e-3 (the
updates are lr·m/(√v + eps), ~1e-3 an entry, and carry the gradients'
rounding)."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference.bert_tower import BertTower
from gdmix_tpu_torch.data import movielens
from gdmix_tpu_torch.gdmix import run as torch_cli
from gdmix_tpu_torch.io.scores import read_scores
from gdmix_tpu_torch.models import deep_tower as tdt
from gdmix_tpu_torch.params import Params

_FWD_RTOL = 1e-12
_GRAD_RTOL = 1e-10
_ADAM_ATOL = 1e-11
BERT = dict(vocab_size=120, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256, hidden_act="gelu",
            max_position_embeddings=32, type_vocab_size=2,
            initializer_range=0.02, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
_B, _L, _K, _D = 8, 16, 3, 11


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _tower(seed=0):
    """A float64 BERT tower on seeded random weights: BERT's initialiser,
    then every bias, LayerNorm and the wide weights moved off their
    start so that each takes part."""
    tower = tdt._TextWideTower(
        vocab_size=BERT["vocab_size"], num_wide=_D, num_units=8,
        windows=(1,), num_filters=4, num_hidden=6, ftr_ext="bert",
        max_len=_L, bert=tdt.BertConfig(**BERT))
    gen = torch.Generator().manual_seed(seed)
    state = tdt.init_state(tower, gen)
    for k, v in state.items():
        if not k.endswith(".weight") or "norm" in k or k == "wide_w":
            v += 0.1 * torch.randn(v.shape, generator=gen)
    tower.load_state_dict(state)
    return tower.double()


# the batches' first rows (the others are documents of 1 to L − 2 tokens)
_FIRST_ROWS = {
    "docs": None,
    "a-doc-with-no-tokens": np.zeros(_L, bool),
    # [CLS][SEP] alone: the fewest positions a framed document has
    "a-row-of-cls-sep-only": np.arange(_L) < 2,
    # position 0 is no key: the pooler's position is encoded and attends,
    # and no query attends to it
    "a-left-padded-row": np.arange(_L) >= 5,
}


def _batch(seed=0, case="docs"):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, _L - 1, _B)
    if case == "every-row-at-full-length":
        lens[:] = _L - 2
    tokens = rng.randint(5, BERT["vocab_size"], (_B, 1, _L))
    mask = (np.arange(_L)[None, None, :] < lens[:, None, None] + 2)
    if _FIRST_ROWS.get(case) is not None:
        mask[0, 0] = _FIRST_ROWS[case]
    tokens = np.where(mask, tokens, 0)
    return {"tokens": torch.as_tensor(tokens),
            "mask": torch.as_tensor(mask, dtype=torch.float64),
            "indices": torch.as_tensor(rng.randint(0, _D, (_B, _K))),
            "values": torch.as_tensor(rng.randn(_B, _K)),
            "labels": torch.as_tensor((rng.rand(_B) < 0.3) * 1.0),
            "weights": torch.as_tensor(rng.rand(_B) + 0.5),
            "offsets": torch.as_tensor(0.1 * rng.randn(_B)),
            "groups": torch.zeros(_B, dtype=torch.int64)}


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("case", list(_FIRST_ROWS)
                         + ["every-row-at-full-length"])
def test_forward_loss_and_gradients_match_the_reference(case):
    """The logits, the loss and the gradient of every parameter, computed
    over the encoded positions only, against the reference's over every
    position: documents; a doc whose mask is all zeros attends to every
    position alike (finite, as the reference's); a row of [CLS][SEP]
    only; a left-padded row, whose position 0 the pooler reads though no
    query attends to it; no padding at all (every position encoded)."""
    tower, batch = _tower(), _batch(case=case)
    ref = BertTower(BERT)
    P = ref.params(tower.state_dict())
    z = tower(batch["tokens"], batch["mask"], batch["indices"],
              batch["values"])
    want = ref.scores(P, batch)
    assert torch.isfinite(z).all()
    assert _max_rel(z.detach(), want) < _FWD_RTOL
    loss = tdt.tower_loss(tower, batch, False, 0.0)
    loss.backward()
    ref_loss, grads = ref.gradient(P, batch, torch.arange(_B), block=3)
    assert abs(float(loss.detach()) - ref_loss) < _FWD_RTOL * abs(ref_loss)
    med = float(np.median([float(g.abs().max()) for g in grads.values()]))
    for name, p in tower.named_parameters():
        scale = max(float(grads[name].abs().max()), med)
        assert float((p.grad - grads[name]).abs().max()) \
            <= _GRAD_RTOL * scale, name


def test_three_adam_steps_match_the_reference():
    tower = _tower(1)
    ref = BertTower(BERT)
    state0 = {k: v.clone() for k, v in tower.state_dict().items()}
    rows = {k: torch.cat([v, _batch(2)[k]]) for k, v in _batch(1).items()}
    batches = [torch.arange(0, 8), torch.arange(8, 16), torch.arange(4, 12)]
    opt = tdt.adam(tower, 1e-3)
    got = []
    for idx in batches:
        opt.zero_grad(set_to_none=True)
        tdt.tower_loss(tower, {k: v[idx] for k, v in rows.items()}, False,
                       0.0).backward()
        opt.step()
        got.append({k: v.detach().clone()
                    for k, v in tower.state_dict().items()})
    want = ref.fit(state0, rows, batches, 1e-3, snapshots=(1, 2, 3),
                   block=5)
    for k in (1, 2, 3):
        for name, v in got[k - 1].items():
            assert float((v - want[k][name]).abs().max()) < _ADAM_ATOL, \
                (k, name)
            if name.endswith("query.weight"):
                assert float((v - state0[name]).abs().max()) > 1e-4


def test_documents_are_framed_by_cls_and_sep():
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "a": 4, "b": 5,
             "c": 6}
    tokens, mask = tdt._tokenize(["a b", "a b c a b c", "", "c"], vocab, 5)
    tokens, mask = tokens[:, None], mask[:, None]
    got, got_mask = tdt._bert_framed(tokens, mask, vocab)
    assert got[:, 0].tolist() == [[2, 4, 5, 3, 0], [2, 4, 5, 6, 3],
                                  [2, 3, 0, 0, 0], [2, 6, 3, 0, 0]]
    assert got_mask[:, 0].tolist() == [[1, 1, 1, 1, 0], [1, 1, 1, 1, 1],
                                       [1, 1, 0, 0, 0], [1, 1, 1, 0, 0]]


@pytest.mark.parametrize("case", ["width", "two-fields", "positions",
                                  "activation", "encoder"])
def test_refusals(case):
    """A hidden size its heads do not divide; BERT over two text columns
    (ROADMAP C.11); max_len past the position table; an activation other
    than gelu; a BERT config with another encoder."""
    cfg = dict(BERT)
    kw = dict(vocab_size=cfg["vocab_size"], num_wide=_D, num_units=8,
              windows=(1,), num_filters=4, num_hidden=6, ftr_ext="bert",
              max_len=_L)
    if case == "width":
        with pytest.raises(ValueError, match="not a multiple"):
            tdt.BertConfig(**dict(cfg, num_attention_heads=5))
        return
    if case == "activation":
        with pytest.raises(ValueError, match="gelu only"):
            tdt.BertConfig(**dict(cfg, hidden_act="relu"))
        return
    if case == "encoder":
        with pytest.raises(ValueError, match="sizes the bert encoder"):
            tdt.DeepTowerParams(ftr_ext="cnn", bert_config_file="x.json")
        return
    if case == "two-fields":
        kw["num_fields"], match = 2, "ROADMAP C.11"
    else:
        kw["max_len"], match = 33, "max_position_embeddings"
    with pytest.raises(ValueError, match=match):
        tdt._TextWideTower(**kw, bert=tdt.BertConfig(**cfg))


@pytest.fixture(scope="module")
def detext_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bert_ml"))
    data = movielens.generate_synthetic(num_users=40, num_movies=60,
                                        num_ratings=1500, seed=5)
    return os.path.join(movielens.prepare_gdmix_data(root, data,
                                                     with_detext=True),
                        "detext")


def _argv(data, out, action, cfg_file):
    metadata = os.path.join(data, "metadata", "tensor_metadata.json")
    return [f"--action={action}", "--stage=fixed_effect",
            "--model_type=detext", "--ftr_ext=bert",
            f"--bert_config_file={cfg_file}", "--feature_bag=wide_ftrs_sp",
            f"--vocab_file={os.path.join(data, 'vocab.txt')}",
            f"--metadata_file={metadata}",
            f"--training_data_dir={os.path.join(data, 'trainingData')}",
            f"--validation_data_dir={os.path.join(data, 'validationData')}",
            f"--output_model_dir={os.path.join(out, 'models')}",
            f"--training_score_dir={os.path.join(out, action, 'train')}",
            f"--validation_score_dir={os.path.join(out, action, 'valid')}",
            "--label_column_name=response", "--uid_column_name=uid",
            "--weight_column_name=weight",
            "--prediction_score_column_name=predictionScore",
            "--max_len=12", "--num_hidden=8", "--batch_size=64",
            "--num_epochs=2", "--learning_rate=0.001", "--device=cpu"]


def test_the_trainer_cli_trains_validates_scores_and_checkpoints(
        detext_data, tmp_path):
    """--model_type=detext --ftr_ext=bert --bert_config_file through the
    trainer's command line: two epochs with validation, the checkpoint,
    both score files; a cold inference from the checkpoint writes the
    same validation scores."""
    out = str(tmp_path)
    cfg_file = os.path.join(out, "bert_config.json")
    with open(cfg_file, "w") as f:
        json.dump(dict(BERT, vocab_size=400), f)
    torch_cli(_argv(detext_data, out, "train", cfg_file))
    ckpt = os.path.join(out, "models", "deep_tower_ckpt")
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "params.pt"]
    state = torch.load(os.path.join(ckpt, "params.pt"), weights_only=True)
    assert state["bert.layers.1.ff_in.weight"].shape == (256, 64)
    assert state["bert.word.weight"].shape == (400, 64)
    schema = Params(action="train", stage="fixed_effect",
                    model_type="detext", label_column_name="response",
                    uid_column_name="uid", weight_column_name="weight",
                    prediction_score_column_name="predictionScore")
    train = read_scores(os.path.join(out, "train", "train"), schema)
    warm = read_scores(os.path.join(out, "train", "valid"), schema)
    assert len(train["uid"]) and len(warm["uid"])
    assert np.isfinite(warm["predictionScore"]).all()
    torch_cli(_argv(detext_data, out, "inference", cfg_file))
    cold = read_scores(os.path.join(out, "inference", "valid"), schema)
    np.testing.assert_array_equal(cold["uid"], warm["uid"])
    np.testing.assert_allclose(cold["predictionScore"],
                               warm["predictionScore"], rtol=0, atol=1e-5)


def test_fit_rows_records_the_tower_spans_and_counters(detext_data,
                                                       tmp_path):
    """A fit cut short after 3 steps under a profiler: one `tower.fit`,
    3 `tower.step`s each holding a forward, a backward and an Adam span,
    an attention span a layer in each step's forward (none in scoring),
    one `tower.validate`; `last_fit` counts the steps, the values read
    back (the epoch's loss, the AUC, the training rows' encoded positions
    once a fit, and the validation forward's packed size: no step reads
    one), and the positions encoded and held over the 3 batches and the
    validation rows."""
    from torch.profiler import profile

    from gdmix_tpu_torch.util import timing
    cfg_file = str(tmp_path / "bert_config.json")
    with open(cfg_file, "w") as f:
        json.dump(dict(BERT, vocab_size=400), f)
    data = detext_data
    params = tdt.DeepTowerParams(
        metadata_file=os.path.join(data, "metadata", "tensor_metadata.json"),
        output_model_dir=str(tmp_path),
        vocab_file=os.path.join(data, "vocab.txt"), ftr_ext="bert",
        bert_config_file=cfg_file, max_len=12, num_hidden=8, batch_size=64,
        num_epochs=2)
    base = Params(action="train", stage="fixed_effect", model_type="detext",
                  label_column_name="response", uid_column_name="uid",
                  weight_column_name="weight",
                  prediction_score_column_name="predictionScore")
    model = tdt.DeepTowerModel(params, base, device="cpu")
    rows = model._on_device(model._rows(
        os.path.join(data, "trainingData"), base))
    valid = model._on_device(model._rows(
        os.path.join(data, "validationData"), base))
    log = timing._Log()
    old, timing._LOG = timing._LOG, log
    try:
        with profile():
            scores = model._fit_rows(rows, valid, model._initial_state(),
                                     max_steps=3)
    finally:
        timing._LOG = old
    names = [name for name, _, _ in log.entries]
    want = {"tower.fit": 1, "tower.step": 3, "tower.forward": 3,
            "tower.backward": 3, "tower.adam": 3, "tower.validate": 1,
            "tower.attention": 3 * BERT["num_hidden_layers"]}
    assert {n: names.count(n) for n in want} == want
    assert (model.last_fit["steps"], model.last_fit["host_syncs"]) \
        == (3, 2 + 1 + 1)
    # the batches' rows: the seed's permutation, as the fit draws it
    seen = np.random.RandomState(params.seed).permutation(
        rows["tokens"].shape[0])[:3 * params.batch_size]
    masks = torch.cat([rows["mask"][torch.as_tensor(seen)], valid["mask"]])
    # every framed document's keys start at its [CLS], so the encoded
    # positions are the mask's
    assert model.last_fit["encoded_positions"] == int(masks.sum())
    assert model.last_fit["padded_positions"] == masks.numel()
    assert model.last_fit["encoded_positions"] < masks.numel()
    assert scores.shape == (valid["tokens"].shape[0],)
