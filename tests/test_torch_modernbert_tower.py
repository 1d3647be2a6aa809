"""The deep tower's ModernBERT encoder (`--ftr_ext=bert --bert_config_file=`
a transformers ModernBERT config.json) against the benchmark's plain
reference (benchmark/reference/modernbert_tower.py: plain PyTorch, a
document at a time, written from ModernBERT's equations), at a small
ModernBERT (hidden 64, 4 heads of 16, 4 layers — 0 and 3 global —,
intermediate 96, local_attention 8) over documents of 3–40 tokens, some
shorter than the window, on seeded random weights; the packed forward
against a padded one; both poolings; the refusals, and BERT's config no
longer read from a ModernBERT file; the reference's encoder against
transformers' ModernBertModel where transformers imports; the tower's
spans and counters; the trainer's command line on the CPU.

Tolerances, float64 throughout (the reference computes the same sums in
other orders: per document, an explicit softmax, its own LayerNorm and
GELU): _FWD_RTOL on the logits and the loss (relative); _GRAD_RTOL on every
gradient, relative to the larger of its leaf's largest entry and the median
leaf's; _ADAM_ATOL on the parameters after three Adam steps of lr 1e-3
(updates of ~1e-3 an entry carrying the gradients' rounding). Against
transformers, _HF_RTOL: its RoPE tables are float32 whatever the model's
type."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference.modernbert_tower import ModernBertTower
from gdmix_tpu_torch.data import movielens
from gdmix_tpu_torch.gdmix import run as torch_cli
from gdmix_tpu_torch.io.scores import read_scores
from gdmix_tpu_torch.models import deep_tower as tdt
from gdmix_tpu_torch.params import Params

_FWD_RTOL = 1e-12
_GRAD_RTOL = 1e-10
_ADAM_ATOL = 1e-11
_HF_RTOL = 1e-5
MODERN = dict(model_type="modernbert", vocab_size=120, hidden_size=64,
              intermediate_size=96, num_hidden_layers=4,
              num_attention_heads=4, hidden_activation="gelu",
              max_position_embeddings=64, initializer_range=0.02,
              initializer_cutoff_factor=2.0, norm_eps=1e-5, norm_bias=False,
              global_rope_theta=160000.0, local_rope_theta=10000.0,
              global_attn_every_n_layers=3, local_attention=8,
              attention_bias=False, mlp_bias=False, attention_dropout=0.0,
              embedding_dropout=0.0, mlp_dropout=0.0,
              classifier_dropout=0.0, classifier_pooling="mean",
              classifier_activation="gelu", classifier_bias=False,
              cls_token_id=1, sep_token_id=2, pad_token_id=0)
_B, _L, _K, _D = 8, 42, 3, 11


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _config(**over) -> tdt.ModernBertConfig:
    keys = {f.name for f in dataclasses.fields(tdt.ModernBertConfig)}
    return tdt.ModernBertConfig(**{k: v for k, v in dict(MODERN, **over)
                                   .items() if k in keys})


def _tower(seed=0, **over):
    """A float64 ModernBERT tower on seeded random weights: ModernBERT's
    initialiser, then every LayerNorm, bias and the wide weights moved off
    their start so that each takes part."""
    tower = tdt._TextWideTower(
        vocab_size=MODERN["vocab_size"], num_wide=_D, num_units=8,
        windows=(1,), num_filters=4, num_hidden=6, ftr_ext="bert",
        max_len=_L, bert=_config(**over))
    gen = torch.Generator().manual_seed(seed)
    state = tdt.init_state(tower, gen)
    for k, v in state.items():
        if not k.endswith(".weight") or "norm" in k or k == "wide_w":
            v += 0.1 * torch.randn(v.shape, generator=gen)
    tower.load_state_dict(state)
    return tower.double()


def _batch(seed=0):
    """Documents of 3–40 tokens (one of 3, one of 40), framed by [CLS] and
    [SEP], padded to L."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, _L - 1, _B)
    lens[:2] = (3, _L - 2)
    tokens = rng.randint(5, MODERN["vocab_size"], (_B, 1, _L))
    pos = np.arange(_L)[None, None, :]
    mask = pos < lens[:, None, None] + 2
    tokens = np.where(mask, tokens, MODERN["pad_token_id"])
    tokens[:, 0, 0] = MODERN["cls_token_id"]
    tokens[np.arange(_B), 0, lens + 1] = MODERN["sep_token_id"]
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


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_forward_loss_and_gradients_match_the_reference(pooling):
    """The logits, the loss and the gradient of every parameter, computed
    over the packed documents, against the reference's a document at a
    time, for both poolings."""
    tower, batch = _tower(classifier_pooling=pooling), _batch()
    ref = ModernBertTower(dict(MODERN, classifier_pooling=pooling))
    P = ref.params(tower.state_dict())
    z = tower(batch["tokens"], batch["mask"], batch["indices"],
              batch["values"])
    want = ref.scores(P, batch)
    assert torch.isfinite(z).all()
    assert _max_rel(z.detach(), want) < _FWD_RTOL
    loss = tdt.tower_loss(tower, batch, False, 0.0)
    loss.backward()
    ref_loss, grads = ref.gradient(P, batch, torch.arange(_B))
    assert abs(float(loss.detach()) - ref_loss) < _FWD_RTOL * abs(ref_loss)
    med = float(np.median([float(g.abs().max()) for g in grads.values()]))
    for name, p in tower.named_parameters():
        scale = max(float(grads[name].abs().max()), med)
        assert float((p.grad - grads[name]).abs().max()) \
            <= _GRAD_RTOL * scale, name


def test_the_poolings_differ():
    batch = _batch(3)
    z = {pool: _tower(classifier_pooling=pool)(
        batch["tokens"], batch["mask"], batch["indices"], batch["values"])
        for pool in ("cls", "mean")}
    assert float((z["cls"] - z["mean"]).detach().abs().max()) > 1e-3


def test_three_adam_steps_match_the_reference():
    tower = _tower(1)
    ref = ModernBertTower(MODERN)
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
    want = ref.fit(state0, rows, batches, 1e-3, snapshots=(1, 2, 3))
    for k in (1, 2, 3):
        for name, v in got[k - 1].items():
            assert float((v - want[k][name]).abs().max()) < _ADAM_ATOL, \
                (k, name)
            if name.endswith("Wqkv.weight"):
                assert float((v - state0[name]).abs().max()) > 1e-4


def _padded_encoder(enc, tokens, mask):
    """ModernBERT's encoder over the padded [B, L, h] (every position
    computed, each document's queries masked to its keys and window): the
    head's output [B, h]."""
    c = enc.config
    b, length = tokens.shape
    ok = tdt._modernbert_positions(mask)
    x = enc.embeddings.norm(enc.embeddings.tok_embeddings(tokens))
    pos = torch.arange(length)
    dist = (pos[:, None] - pos[None, :]).abs()
    for i, layer in enumerate(enc.layers):
        theta = c.global_rope_theta if c.is_global(i) else \
            c.local_rope_theta
        cos, sin = tdt._rope_tables(pos.repeat(b), theta, c.head_dim,
                                    x.dtype)
        a = x if layer.attn_norm is None else layer.attn_norm(x)
        qkv = layer.attn.Wqkv(a).view(b * length, 3, c.num_attention_heads,
                                      -1)
        q, k = (tdt._rope(qkv[:, j], cos, sin).view(b, length, -1, c.head_dim)
                for j in (0, 1))
        v = qkv[:, 2].reshape(b, length, -1, c.head_dim)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / c.head_dim ** 0.5
        keep = ok[:, None, None, :].expand_as(s)
        if not c.is_global(i):
            keep = keep & (dist <= c.window)
        # a padding row attends to itself alone: finite, and read by none
        keep = keep | torch.eye(length, dtype=torch.bool)
        att = torch.einsum("bhqk,bkhd->bqhd",
                           torch.softmax(s.masked_fill(~keep, -torch.inf),
                                         -1), v)
        h = x + layer.attn.Wo(att.reshape(b, length, -1))
        u, g = layer.mlp.Wi(layer.mlp_norm(h)).chunk(2, -1)
        x = h + layer.mlp.Wo(torch.nn.functional.gelu(u) * g)
    x = enc.final_norm(x)
    w = ok.to(x.dtype)[..., None]
    pooled = (x[:, 0] if c.classifier_pooling == "cls"
              else (x * w).sum(1) / w.sum(1))
    return enc.head.norm(torch.nn.functional.gelu(enc.head.dense(pooled)))


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_the_packed_forward_equals_a_padded_one(pooling):
    """The encoder over its packed documents against the same weights over
    the padded batch, every position computed and masked."""
    tower, batch = _tower(4, classifier_pooling=pooling), _batch(4)
    enc = tower.bert
    t, m = batch["tokens"][:, 0], batch["mask"][:, 0]
    with torch.no_grad():
        got = enc(t, m)
        want = _padded_encoder(enc, t, m)
    assert _max_rel(got, want) < _FWD_RTOL
    assert enc.counts["encoded_positions"] == int(m.sum())
    assert enc.counts["longest_document"] == int(m.sum(1).max())


def test_the_initialiser_follows_modernbert():
    """σ 0.02 for the embedding, Wqkv and Wi; 0.02/√(2·layers) for both
    output projections and the head's dense layer; cut at ±2σ; norms 1."""
    tower = tdt._TextWideTower(
        vocab_size=MODERN["vocab_size"], num_wide=_D, num_units=8,
        windows=(1,), num_filters=4, num_hidden=6, ftr_ext="bert",
        max_len=_L, bert=_config(hidden_size=128, num_attention_heads=2,
                                 intermediate_size=256, vocab_size=4000))
    state = tdt.init_state(tower, torch.Generator().manual_seed(0))
    small = 0.02 / np.sqrt(8.0)
    for name, sd in (("bert.embeddings.tok_embeddings.weight", 0.02),
                     ("bert.layers.1.attn.Wqkv.weight", 0.02),
                     ("bert.layers.2.mlp.Wi.weight", 0.02),
                     ("bert.layers.0.attn.Wo.weight", small),
                     ("bert.layers.3.mlp.Wo.weight", small),
                     ("bert.head.dense.weight", small)):
        t = state[name]
        assert float(t.abs().max()) <= 2 * sd + 1e-12, name
        # a normal cut at ±2σ has 0.88σ
        assert abs(float(t.std()) / sd - 0.88) < 0.05, name
    for name in ("bert.embeddings.norm.weight", "bert.layers.1.attn_norm.weight",
                 "bert.final_norm.weight", "bert.head.norm.weight"):
        assert bool((state[name] == 1).all()), name
    assert "bert.layers.0.attn_norm.weight" not in state


def test_documents_are_framed_with_the_configs_ids():
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "a": 4, "b": 5}
    tokens, mask = tdt._tokenize(["a b", "b", ""], vocab, 5)
    got, got_mask = tdt._bert_framed(tokens[:, None], mask[:, None], vocab,
                                     (7, 8, 9))
    assert got[:, 0].tolist() == [[7, 4, 5, 8, 9], [7, 5, 8, 9, 9],
                                  [7, 8, 9, 9, 9]]
    assert got_mask[:, 0].tolist() == [[1, 1, 1, 1, 0], [1, 1, 1, 0, 0],
                                       [1, 1, 0, 0, 0]]


@pytest.mark.parametrize("case", [
    "dropout", "activation", "classifier-activation", "norm-bias",
    "attention-bias", "mlp-bias", "pooling", "positions", "two-fields",
    "model-type"])
def test_refusals(case, tmp_path):
    """What the encoder does not compute is refused when it is built: a
    dropout, another activation, a bias, another pooling, max_len past the
    positions, two text columns (ROADMAP C.11), another model_type."""
    bad = {"dropout": ("attention_dropout", 0.1, "dropout"),
           "activation": ("hidden_activation", "silu", "gelu only"),
           "classifier-activation": ("classifier_activation", "relu",
                                     "gelu only"),
           "norm-bias": ("norm_bias", True, "no biases"),
           "attention-bias": ("attention_bias", True, "no biases"),
           "mlp-bias": ("mlp_bias", True, "no biases"),
           "pooling": ("classifier_pooling", "max", "cls or mean")}
    if case in bad:
        key, value, match = bad[case]
        with pytest.raises(ValueError, match=match):
            _config(**{key: value})
        return
    if case == "model-type":
        path = tmp_path / "config.json"
        path.write_text(json.dumps(dict(MODERN, model_type="roberta")))
        with pytest.raises(ValueError, match="model_type 'roberta'"):
            tdt.encoder_config(str(path))
        return
    kw = dict(vocab_size=MODERN["vocab_size"], num_wide=_D, num_units=8,
              windows=(1,), num_filters=4, num_hidden=6, ftr_ext="bert",
              max_len=_L)
    if case == "two-fields":
        kw["num_fields"], match = 2, "ROADMAP C.11"
    else:
        kw["max_len"], match = 65, "max_position_embeddings"
    with pytest.raises(ValueError, match=match):
        tdt._TextWideTower(**kw, bert=_config())


def test_bert_reads_no_modernbert_file(tmp_path):
    """A ModernBERT config.json builds no BERT: BertConfig refuses its
    model_type, and the dispatch builds ModernBERT's; BERT-Base's own
    bert_config.json (no model_type), or one that says "bert", still
    loads as BERT's."""
    modern = tmp_path / "modern.json"
    modern.write_text(json.dumps(MODERN))
    with pytest.raises(ValueError, match="not BERT's"):
        tdt.BertConfig.from_file(str(modern))
    assert isinstance(tdt.encoder_config(str(modern)), tdt.ModernBertConfig)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "detext-bert-base.json")) as f:
        base = json.load(f)
    keys = {f.name for f in dataclasses.fields(tdt.BertConfig)}
    bert = {k: v for k, v in base.items() if k in keys}
    for extra in ({}, {"model_type": "bert"}):
        path = tmp_path / "bert_config.json"
        path.write_text(json.dumps(dict(bert, **extra)))
        cfg = tdt.encoder_config(str(path))
        assert isinstance(cfg, tdt.BertConfig)
        assert (cfg.hidden_size, cfg.num_hidden_layers) == (768, 12)
        assert tdt.BertConfig.from_file(str(path)) == cfg


def test_the_reference_encoder_matches_transformers():
    """An independent check of the equations: the reference's encoder
    (its head's output) against transformers' ModernBertModel, pooled and
    passed through its ModernBertPredictionHead, at the small config and
    the same weights, each document alone."""
    tr = pytest.importorskip("transformers")
    cfg = {k: v for k, v in MODERN.items() if k != "model_type"}
    hf_cfg = tr.ModernBertConfig(**cfg, reference_compile=False,
                                 attn_implementation="eager")
    hf = tr.ModernBertForSequenceClassification(hf_cfg).double().eval()
    tower = _tower(5)
    state = tower.state_dict()
    mapped = {}
    for name, v in state.items():
        if name.startswith("bert.head."):
            mapped[name[len("bert."):]] = v
        elif name.startswith("bert."):
            mapped["model." + name[len("bert."):]] = v
    missing, _ = hf.load_state_dict(mapped, strict=False)
    assert [k for k in missing if not k.startswith("classifier")] == []
    ref = ModernBertTower(MODERN)
    P = ref.params(state)
    batch = _batch(5)
    t, m = batch["tokens"][:, 0], batch["mask"][:, 0]
    for r in range(_B):
        n = int(m[r].sum())
        with torch.no_grad():
            x = hf.model(input_ids=t[r:r + 1, :n]).last_hidden_state[0]
            want = hf.head(x.mean(0, keepdim=True))[0]
            got = ref._encode(P, [t[r, :n]])[0]
        assert _max_rel(got, want) < _HF_RTOL, r


@pytest.fixture(scope="module")
def detext_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("modernbert_ml"))
    data = movielens.generate_synthetic(num_users=40, num_movies=60,
                                        num_ratings=1500, seed=5)
    return os.path.join(movielens.prepare_gdmix_data(root, data,
                                                     with_detext=True),
                        "detext")


def _config_file(tmp_path):
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(dict(MODERN, vocab_size=400, cls_token_id=396,
                       sep_token_id=397, pad_token_id=398), f)
    return path


def test_fit_rows_records_the_tower_spans_and_counters(detext_data,
                                                       tmp_path):
    """A fit cut short after 3 steps under a profiler: an attention span a
    layer in each step's forward, by kind (2 global, 2 local layers), and
    one a layer in each step's backward, none in scoring and no
    `tower.attention`; `last_fit` counts the steps, the values read back
    (the epoch's loss, the AUC, the training rows' positions once a fit,
    the validation forward's lengths), the positions, the attention calls
    of the steps and the validation, and the longest document."""
    from torch.profiler import profile

    from gdmix_tpu_torch.util import timing
    data = detext_data
    params = tdt.DeepTowerParams(
        metadata_file=os.path.join(data, "metadata", "tensor_metadata.json"),
        output_model_dir=str(tmp_path),
        vocab_file=os.path.join(data, "vocab.txt"), ftr_ext="bert",
        bert_config_file=_config_file(tmp_path), max_len=12, num_hidden=8,
        batch_size=64, num_epochs=2)
    base = Params(action="train", stage="fixed_effect", model_type="detext",
                  label_column_name="response", uid_column_name="uid",
                  weight_column_name="weight",
                  prediction_score_column_name="predictionScore")
    model = tdt.DeepTowerModel(params, base, device="cpu")
    assert isinstance(model.module.bert, tdt._ModernBertEncoder)
    rows = model._on_device(model._rows(
        os.path.join(data, "trainingData"), base))
    valid = model._on_device(model._rows(
        os.path.join(data, "validationData"), base))
    assert bool((rows["tokens"][:, 0, 0] == 396).all())
    log = timing._Log()
    old, timing._LOG = timing._LOG, log
    try:
        with profile():
            scores = model._fit_rows(rows, valid, model._initial_state(),
                                     max_steps=3)
    finally:
        timing._LOG = old
    names = [name for name, _, _ in log.entries]
    want = {"tower.fit": 1, "tower.step": 3, "tower.validate": 1,
            "tower.attention": 0, "tower.attention.full": 6,
            "tower.attention.window": 6, "tower.attention_grad.full": 6,
            "tower.attention_grad.window": 6}
    assert {n: names.count(n) for n in want} == want
    lf = model.last_fit
    assert (lf["steps"], lf["host_syncs"]) == (3, 2 + 1 + 1)
    assert (lf["attention_calls_full"], lf["attention_calls_window"]) \
        == (8, 8)
    seen = np.random.RandomState(params.seed).permutation(
        rows["tokens"].shape[0])[:3 * params.batch_size]
    masks = torch.cat([rows["mask"][torch.as_tensor(seen)], valid["mask"]])
    assert lf["encoded_positions"] == int(masks.sum())
    assert lf["padded_positions"] == masks.numel()
    assert lf["longest_document"] == int(masks[:, 0].sum(1).max())
    assert scores.shape == (valid["tokens"].shape[0],)


def test_the_trainer_cli_trains_and_scores(detext_data, tmp_path):
    """--model_type=detext --ftr_ext=bert with a ModernBERT config.json
    through the trainer's command line: two epochs, the checkpoint with
    ModernBERT's parameters, both score files; a cold inference from the
    checkpoint writes the same validation scores."""
    data, out = detext_data, str(tmp_path)
    metadata = os.path.join(data, "metadata", "tensor_metadata.json")

    def argv(action):
        return [f"--action={action}", "--stage=fixed_effect",
                "--model_type=detext", "--ftr_ext=bert",
                f"--bert_config_file={_config_file(tmp_path)}",
                "--feature_bag=wide_ftrs_sp",
                f"--vocab_file={os.path.join(data, 'vocab.txt')}",
                f"--metadata_file={metadata}",
                f"--training_data_dir={os.path.join(data, 'trainingData')}",
                f"--validation_data_dir="
                f"{os.path.join(data, 'validationData')}",
                f"--output_model_dir={os.path.join(out, 'models')}",
                f"--training_score_dir={os.path.join(out, action, 'train')}",
                f"--validation_score_dir="
                f"{os.path.join(out, action, 'valid')}",
                "--label_column_name=response", "--uid_column_name=uid",
                "--weight_column_name=weight",
                "--prediction_score_column_name=predictionScore",
                "--max_len=12", "--num_hidden=8", "--batch_size=64",
                "--num_epochs=2", "--learning_rate=0.001", "--device=cpu"]
    torch_cli(argv("train"))
    state = torch.load(os.path.join(out, "models", "deep_tower_ckpt",
                                    "params.pt"), weights_only=True)
    assert state["bert.layers.3.mlp.Wi.weight"].shape == (192, 64)
    assert state["bert.embeddings.tok_embeddings.weight"].shape == (400, 64)
    schema = Params(action="train", stage="fixed_effect",
                    model_type="detext", label_column_name="response",
                    uid_column_name="uid", weight_column_name="weight",
                    prediction_score_column_name="predictionScore")
    warm = read_scores(os.path.join(out, "train", "valid"), schema)
    assert len(warm["uid"]) and np.isfinite(warm["predictionScore"]).all()
    torch_cli(argv("inference"))
    cold = read_scores(os.path.join(out, "inference", "valid"), schema)
    np.testing.assert_array_equal(cold["uid"], warm["uid"])
    np.testing.assert_allclose(cold["predictionScore"],
                               warm["predictionScore"], rtol=0, atol=1e-5)


def test_a_card_takes_heads_of_64_only(detext_data, tmp_path):
    """On a card the attention kernel takes heads of 64: a ModernBERT of
    heads of 16 is refused before anything is built there."""
    data = detext_data
    params = tdt.DeepTowerParams(
        metadata_file=os.path.join(data, "metadata", "tensor_metadata.json"),
        output_model_dir=str(tmp_path),
        vocab_file=os.path.join(data, "vocab.txt"), ftr_ext="bert",
        bert_config_file=_config_file(tmp_path), max_len=12)
    with pytest.raises(ValueError, match="heads of 64"):
        tdt.DeepTowerModel(params, Params(action="train",
                                          label_column_name="response"),
                           device="cuda")
