"""Port parity of the deep fixed-effect tower (DeText): gdmix_tpu_torch's
_TextWideTower, its losses, Adam steps and DeepTowerModel against the JAX
package's deep_tower module on inputs made from a numpy seed, the JAX side
pinned to the CPU. Both towers start from one set of parameters: the flax
tree, carried across by util/convert.deep_tower_state_from_flax.

Tolerances: the forward in float64 within 1e-10 (relative to the logit's
size: a cnn/lstm doc with no tokens pools to −1e9, ROADMAP C.12); five
Adam steps in float64 within 1e-9; train() in float32 (the model's type)
within _TRAIN_SCORE_RTOL of the largest score."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdmix_tpu import constants
from gdmix_tpu.data import movielens
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.models import deep_tower as jdt
from gdmix_tpu.ops.logistic import stable_bce as jax_bce
from gdmix_tpu.params import Params as JaxParams
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.models import deep_tower as tdt
from gdmix_tpu_torch.params import Params
from gdmix_tpu_torch.util.convert import deep_tower_state_from_flax

_FWD_RTOL = 1e-10
_ADAM_TOL = 1e-9
# float32 scores after 2 epochs of Adam from one init: the two frameworks
# sum the same float32 products in other orders (and JAX over 8 CPU
# devices), and Adam's normalised steps carry those last bits along
_TRAIN_SCORE_RTOL = 1e-4
CTX = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
       constants.IS_CHIEF: True}

# (ftr_ext, text fields, encoder layers, windows): cnn with an even width
# (SAME padding: 0 before, 1 after in both frameworks), lstm at 1 and 2
# layers, the transformer at 1 and 2 layers with 2 heads
ENCODERS = [("cnn", 1, 1, (1, 2, 3)), ("cnn", 2, 1, (2, 3)),
            ("lstm", 1, 1, (1,)), ("lstm", 2, 2, (1,)),
            ("transformer", 1, 1, (1,)), ("transformer", 1, 2, (1,))]
_V, _D, _K, _L = 30, 11, 4, 6


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def lstm_carry_f64(monkeypatch):
    """flax's LSTM carry starts in the cell's param_dtype (float32), which
    a float64 scan refuses: start it in float64 for the float64 cases."""
    import flax.linen as fnn
    orig = fnn.OptimizedLSTMCell.initialize_carry

    def f64_carry(self, rng, shape):
        return jax.tree_util.tree_map(lambda c: c.astype(jnp.float64),
                                      orig(self, rng, shape))
    monkeypatch.setattr(fnn.OptimizedLSTMCell, "initialize_carry", f64_carry)


def _towers(ext, fields, layers, windows, seed=1):
    """(JAX tower, f64 flax params, port tower in f64 with those params);
    the params are JAX's init moved off zero, so that biases and the wide
    weights take part."""
    kw = dict(vocab_size=_V, num_wide=_D, num_units=8, windows=windows,
              num_filters=4, num_hidden=6, ftr_ext=ext, num_heads=2,
              num_layers=layers)
    jt = jdt._TextWideTower(**kw)
    rng = np.random.RandomState(seed)
    p = jt.init(jax.random.PRNGKey(seed),
                np.zeros((2, fields, _L), np.int32),
                np.ones((2, fields, _L), np.float32),
                np.zeros((2, _K), np.int32), np.ones((2, _K), np.float32))
    p = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64) + 0.1 * rng.randn(*x.shape), p)
    tt = tdt._TextWideTower(**kw, num_fields=fields, max_len=_L).double()
    tt.load_state_dict(_carry(p, ext, windows, fields, layers))
    return jt, p, tt


def _carry(p, ext, windows, fields, layers):
    return deep_tower_state_from_flax(
        jax.tree_util.tree_map(np.asarray, p), ftr_ext=ext, windows=windows,
        num_fields=fields, num_layers=layers)


def _batch(rng, b, fields, empty_first=False):
    mask = (rng.rand(b, fields, _L) < 0.7).astype(np.float64)
    mask[:, :, 0] = 1.0
    if empty_first:
        mask[0] = 0.0
    tokens = rng.randint(2, _V, (b, fields, _L)).astype(np.int32)
    tokens = np.where(mask > 0, tokens, 0).astype(np.int32)
    return dict(tokens=tokens, mask=mask,
                indices=rng.randint(0, _D, (b, _K)).astype(np.int32),
                values=rng.randn(b, _K),
                labels=rng.randint(0, 3, b) / 2.0,    # ties at 0, .5, 1
                weights=rng.uniform(0.5, 2.0, b),
                offsets=0.3 * rng.randn(b),
                groups=rng.randint(0, 3, b).astype(np.int32))


def _torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32
                               else torch.float64) for k, v in batch.items()}


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(a))))


@pytest.mark.parametrize("ext,fields,layers,windows", ENCODERS)
def test_forward_matches_jax(ext, fields, layers, windows, lstm_carry_f64):
    jt, p, tt = _towers(ext, fields, layers, windows)
    b = _batch(np.random.RandomState(3), 9, fields, empty_first=True)
    args = (b["tokens"], b["mask"], b["indices"], b["values"])
    want = np.asarray(jt.apply(p, *args))
    tb = _torch_batch(b)
    got = tt(tb["tokens"], tb["mask"], tb["indices"],
             tb["values"]).detach().numpy()
    assert _max_rel(want, got) <= _FWD_RTOL
    if ext == "transformer":
        # the empty doc attends uniformly and its masked mean is 0: finite
        assert np.all(np.isfinite(got)) and abs(got[0]) < 1e3
    else:
        # ROADMAP C.12, kept for parity: the empty doc pools to −1e9
        assert abs(got[0]) > 1e6 and abs(want[0]) > 1e6


@pytest.mark.parametrize("task", ["classification", "ranking"])
@pytest.mark.parametrize("ext,fields,layers,windows",
                         [ENCODERS[1], ENCODERS[3], ENCODERS[5]])
def test_adam_steps_match_jax(ext, fields, layers, windows, task,
                              lstm_carry_f64):
    """Five Adam steps on five batches, l2 > 0, float64: jax.value_and_grad
    + optax.adam (JAX deep_tower.py:312-326) against loss.backward() +
    torch.optim.Adam through the port's tower_loss and adam."""
    jt, p, tt = _towers(ext, fields, layers, windows)
    ranking, l2, lr = task == "ranking", 0.05, 0.01
    rng = np.random.RandomState(7)
    batches = [_batch(rng, 10, fields) for _ in range(5)]

    def loss_fn(prm, b):
        logits = jt.apply(prm, b["tokens"], b["mask"], b["indices"],
                          b["values"]) + b["offsets"]
        if ranking:
            data = jdt.pairwise_ranking_loss(logits, b["labels"],
                                             b["weights"], b["groups"])
        else:
            data = jnp.mean(b["weights"] * jax_bce(logits, b["labels"]))
        return data + l2 * sum(jnp.sum(x ** 2) for x in jax.tree.leaves(prm))
    step = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.adam(lr)
    st = tx.init(p)
    opt = tdt.adam(tt, lr)
    for b in batches:
        want, g = step(p, b)
        upd, st = tx.update(g, st)
        p = optax.apply_updates(p, upd)
        opt.zero_grad()
        got = tdt.tower_loss(tt, _torch_batch(b), ranking, l2)
        got.backward()
        opt.step()
        assert abs(float(got.detach()) - float(want)) <= _ADAM_TOL * abs(
            float(want))
    want_state = _carry(p, ext, windows, fields, layers)
    got_state = tt.state_dict()
    assert set(want_state) == set(got_state)
    worst = max(float((want_state[k] - got_state[k]).abs().max())
                for k in want_state)
    assert worst <= _ADAM_TOL


def test_pairwise_ranking_loss_matches_jax():
    """Ties in label and in score, several groups, a group with one label,
    weights: the pair mask and log1p(exp(−diff)) as in JAX."""
    rng = np.random.RandomState(2)
    logits = rng.randn(12)
    logits[3] = logits[4]
    labels = np.array([1, 0, 1, 1, 0, 0, 1, .5, .5, 0, 1, 1], np.float64)
    weights = rng.uniform(0.2, 3.0, 12)
    groups = np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 3], np.int32)
    want = float(jdt.pairwise_ranking_loss(logits, labels, weights, groups))
    got = float(tdt.pairwise_ranking_loss(*(torch.as_tensor(a) for a in (
        logits, labels, weights, groups))))
    assert abs(got - want) <= 1e-14 * abs(want)
    # a group whose labels are all equal, or all groups apart: no pairs
    none = tdt.pairwise_ranking_loss(torch.as_tensor(logits[10:]),
                                     torch.as_tensor(labels[10:]),
                                     torch.as_tensor(weights[10:]),
                                     torch.as_tensor(groups[10:]))
    assert float(none) == 0.0


def test_init_state_follows_the_jax_initialisers():
    """init_state draws every parameter of the tower, with the JAX
    package's initialisers: pooled over 16 seeds, the spread of each leaf
    within 15% of flax's init of the same leaf over 16 keys (≥ 16·40
    draws a leaf: ≤ 4% standard error), zeros and ones where flax has
    them, orthogonal LSTM gate blocks, a bias_ih that stays 0, and one
    seed one state."""
    seeds = 16
    for ext, fields, layers, windows in (ENCODERS[1], ENCODERS[3],
                                         ENCODERS[5]):
        kw = dict(vocab_size=400, num_wide=300, num_units=32,
                  windows=windows, num_filters=24, num_hidden=40,
                  ftr_ext=ext, num_heads=4, num_layers=layers)
        jt = jdt._TextWideTower(**kw)
        args = (np.zeros((1, fields, 16), np.int32),
                np.ones((1, fields, 16), np.float32),
                np.zeros((1, 1), np.int32), np.ones((1, 1), np.float32))
        jp = jax.jit(jax.vmap(lambda key: jt.init(key, *args)))(
            jax.random.split(jax.random.PRNGKey(0), seeds))
        want = [_carry(jax.tree_util.tree_map(lambda x: np.asarray(x)[i],
                                              jp),
                       ext, windows, fields, layers) for i in range(seeds)]
        tt = tdt._TextWideTower(**kw, num_fields=fields, max_len=16)
        got = [tdt.init_state(tt, torch.Generator().manual_seed(i))
               for i in range(seeds)]
        assert set(got[0]) == set(want[0]) == set(tt.state_dict())
        for k in want[0]:
            w = torch.stack([s[k] for s in want])
            g = torch.stack([s[k] for s in got])
            assert g.shape == w.shape, k
            if float(w.std()) == 0.0:
                assert torch.equal(g, w), k
            else:
                assert abs(float(g.std()) / float(w.std()) - 1) < 0.15, k
            if "weight_hh" in k:
                for gate in got[0][k].chunk(4):
                    eye = torch.eye(gate.shape[1])
                    assert torch.allclose(gate.T @ gate, eye, atol=1e-5)
        again = tdt.init_state(tt, torch.Generator().manual_seed(0))
        assert all(torch.equal(got[0][k], again[k]) for k in again)


# ------------------------------------------------------------- the model --

@pytest.fixture(scope="module")
def detext_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tdml"))
    data = movielens.generate_synthetic(num_users=60, num_movies=80,
                                        num_ratings=4000, seed=11)
    return os.path.join(movielens.prepare_gdmix_data(root, data,
                                                     with_detext=True),
                        "detext")


def _kwargs(detext_data, out_root, **over):
    kw = dict(
        metadata_file=os.path.join(detext_data, "metadata",
                                   "tensor_metadata.json"),
        output_model_dir=os.path.join(out_root, "models"),
        training_data_dir=os.path.join(detext_data, "trainingData"),
        validation_data_dir=os.path.join(detext_data, "validationData"),
        vocab_file=os.path.join(detext_data, "vocab.txt"),
        num_epochs=2, batch_size=256, num_units=16, num_filters=8,
        num_hidden=16, learning_rate=0.02, filter_window_sizes="1,2")
    kw.update(over)
    return kw


def _base(cls, out_root, **over):
    return cls(action="train", stage="fixed_effect", model_type="detext",
               label_column_name="response", uid_column_name="uid",
               weight_column_name="weight",
               prediction_score_column_name="predictionScore",
               training_score_dir=os.path.join(out_root, "train_scores"),
               validation_score_dir=os.path.join(out_root,
                                                 "validation_scores"),
               **over)


def _port_model(detext_data, out_root, **over):
    return tdt.DeepTowerModel(
        tdt.DeepTowerParams(**_kwargs(detext_data, out_root, **over)),
        _base(Params, out_root), device="cpu")


def _train(model):
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, CTX,
                model.base_params)


@pytest.mark.parametrize("over", [
    {}, {"task_type": "ranking", "query_column": "user_id",
         "ftr_ext": "lstm", "num_layers": 1, "l2_reg_weight": 1e-4}],
    ids=["cnn-classification", "lstm-ranking"])
def test_train_matches_jax(detext_data, tmp_path, monkeypatch, over):
    """train() in float32 over 2 epochs from JAX's own init
    (module.init(PRNGKey(seed), the first 8 rows)), carried into the port
    through _initial_state: the same batches in the same order, the same
    best epoch, and the written scores within _TRAIN_SCORE_RTOL."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    for root in (jroot, troot):
        for d in ("train_scores", "validation_scores", "models"):
            os.makedirs(os.path.join(root, d))
    jp = jdt.DeepTowerParams(**_kwargs(detext_data, jroot, **over))
    jb = _base(JaxParams, jroot)
    jm = jdt.DeepTowerModel(jp, jb)
    aucs = []
    orig_auc = jdt.auc_metric

    def recorded(scores, labels):
        out = orig_auc(scores, labels)
        aucs.append(float(out))
        return out
    monkeypatch.setattr(jdt, "auc_metric", recorded)
    jm.train(jm.training_data_dir, jm.validation_data_dir, jm.metadata_file,
             jm.checkpoint_path, CTX, jb)

    train = jm._load_arrays(jm.training_data_dir, jb)
    sample = jm._numpy_slice(train, np.arange(8))
    init = jm.module.init(jax.random.PRNGKey(jp.seed), *sample[:4])
    tm = _port_model(detext_data, troot, **over)
    state = _carry(init, jp.ftr_ext, jp.windows, len(jp.text_columns),
                   jp.num_layers)
    tm._initial_state = lambda: state
    _train(tm)

    want_best = int(np.argmax(aucs))      # the first of equal maxima
    assert tm.last_fit["best_epoch"] == want_best
    got_aucs = [e["val_auc"] for e in tm.last_fit["epochs"]]
    assert np.max(np.abs(np.array(got_aucs) - aucs)) < 1e-3
    for sub in ("train_scores", "validation_scores"):
        want = read_scores(os.path.join(jroot, sub), jb)
        got = read_scores(os.path.join(troot, sub), jb)
        np.testing.assert_array_equal(got["uid"], want["uid"])
        scale = np.max(np.abs(want["predictionScore"]))
        for col in ("predictionScore", "predictionScorePerCoordinate"):
            gap = np.max(np.abs(got[col] - want[col]))
            assert gap <= _TRAIN_SCORE_RTOL * scale, (sub, col, gap, scale)


@pytest.fixture(scope="module")
def trained(detext_data, tmp_path_factory):
    """A port model trained 1 epoch on the CPU: (model, output root)."""
    torch.set_num_threads(2)
    out_root = str(tmp_path_factory.mktemp("trained"))
    model = _port_model(detext_data, out_root, num_epochs=1)
    _train(model)
    return model, out_root


def test_checkpoint_round_trip_and_predict(detext_data, trained, tmp_path):
    """The checkpoint holds the trained state bit for bit; a cold predict
    from it writes the warm validation scores."""
    model, out_root = trained
    ckpt = os.path.join(out_root, "models", "deep_tower_ckpt")
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "params.pt"]
    import json
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["format_version"], manifest["model"],
            manifest["framework"]) == (1, "deep_tower", "torch")
    assert manifest["vocab_size"] == len(model.vocab)
    assert manifest["hparams"]["num_filters"] == 8

    cold = _port_model(detext_data, out_root, num_epochs=1)
    cold._load_checkpoint()
    warm_state = model.module.state_dict()
    assert all(torch.equal(v, warm_state[k])
               for k, v in cold.module.state_dict().items())
    pred = str(tmp_path / "pred")
    cold.predict(pred, cold.validation_data_dir, cold.metadata_file,
                 cold.checkpoint_path, CTX, cold.base_params)
    warm = read_scores(os.path.join(out_root, "validation_scores"),
                       model.base_params)
    got = read_scores(pred, model.base_params)
    np.testing.assert_array_equal(got["uid"], warm["uid"])
    np.testing.assert_allclose(got["predictionScore"],
                               warm["predictionScore"], rtol=0, atol=1e-5)


def test_checkpoint_on_a_remote_scheme(detext_data, trained, tmp_path,
                                       monkeypatch):
    """A mem:// output_model_dir: the checkpoint is written straight to it
    (no local staging directory) and restores from it; a checkpoint that
    is not the port's is refused."""
    model, _ = trained
    monkeypatch.setitem(fs._registry, "mem", fs.MemFS())
    monkeypatch.chdir(tmp_path)
    model.checkpoint_path = "mem://bkt/detext/models"
    model.export(model.checkpoint_path)
    ckpt = "mem://bkt/detext/models/deep_tower_ckpt"
    assert fs.isfile(ckpt + "/params.pt") and fs.isfile(ckpt +
                                                        "/manifest.json")
    assert os.listdir(tmp_path) == []
    cold = _port_model(detext_data, str(tmp_path),
                       output_model_dir="mem://bkt/detext/models")
    cold._load_checkpoint()
    warm_state = model.module.state_dict()
    assert all(torch.equal(v, warm_state[k])
               for k, v in cold.module.state_dict().items())
    with fs.open(ckpt + "/manifest.json", "w") as f:
        f.write('{"format_version": 1, "model": "deep_tower", '
                '"vocab_size": 1, "num_wide": 1, "hparams": {}}')
    with pytest.raises(ValueError, match="not written by gdmix_tpu_torch"):
        cold._load_checkpoint()


def test_refusals(detext_data, tmp_path, monkeypatch):
    """Across processes a batch size the process count does not divide
    raises, as in the JAX package (deep_tower.py:298; more than one worker
    now trains: tests/test_torch_multiprocess_deep_tower.py); a
    transformer over two text columns raises ROADMAP C.11 at construction
    (the JAX package cannot build it); without a card and without the CPU
    asked for, the model raises like the rest of the port."""
    model = _port_model(detext_data, str(tmp_path), batch_size=256)
    ctx = dict(CTX, **{constants.NUM_WORKERS: 3})
    with monkeypatch.context() as m:
        m.setattr(tdt, "process_index_and_count", lambda: (0, 3))
        with pytest.raises(ValueError, match="256 % 3"):
            model.train(model.training_data_dir, None, model.metadata_file,
                        model.checkpoint_path, ctx, model.base_params)
    with pytest.raises(ValueError, match="ROADMAP C.11"):
        _port_model(detext_data, str(tmp_path), ftr_ext="transformer",
                    doc_text_columns="doc_query,doc_query")
    with pytest.raises(ValueError, match="ROADMAP C.11"):
        tdt._TextWideTower(vocab_size=5, num_wide=3, num_units=4,
                           windows=(1,), num_filters=2, num_hidden=3,
                           ftr_ext="bert", num_fields=2)
    with pytest.raises(ValueError, match="ranking needs a query_column"):
        tdt.DeepTowerParams(task_type="ranking")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdt.DeepTowerModel(
            tdt.DeepTowerParams(**_kwargs(detext_data, str(tmp_path))),
            _base(Params, str(tmp_path)))


def test_multi_field_lstm_trains_and_predicts(detext_data, tmp_path):
    """Two text columns through the lstm encoder (one LSTM a field, one
    shared embedding): train, then a cold predict equal to the warm
    validation scores."""
    out_root = str(tmp_path)
    over = dict(doc_text_columns="doc_query,doc_query", ftr_ext="lstm",
                num_layers=1, num_epochs=1)
    model = _port_model(detext_data, out_root, **over)
    _train(model)
    assert len(model.module.lstms) == 2
    cold = _port_model(detext_data, out_root, **over)
    pred = str(tmp_path / "pred")
    cold.predict(pred, cold.validation_data_dir, cold.metadata_file,
                 cold.checkpoint_path, CTX, cold.base_params)
    warm = read_scores(os.path.join(out_root, "validation_scores"),
                       model.base_params)
    got = read_scores(pred, model.base_params)
    np.testing.assert_allclose(got["predictionScore"],
                               warm["predictionScore"], rtol=0, atol=1e-5)
