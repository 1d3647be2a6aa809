"""A deep fixed-effect stage: DeText's BERT tower fitted for one epoch from
the seed's initial state, through DeepTowerModel, over and over, for the
window.

The rows are made from the seed and uploaded once; the initial state θ₀
is drawn once in set-up, on the device, by the reference's initialiser
(BERT's, and the tower's head), and each fit starts from it. The fit goes
through DeepTowerModel._fit_rows, the method train() runs once its files
are read and uploaded: the epoch's Adam steps, the validation pass and its
AUC, the best epoch kept.

Unit: one fit. End to end: `fe_fit_s`, the window over the fits completed.

`correct`, as for training: set-up drives the same model object, through
the same call, for its first one, two and three steps (which also warms
every shape the window runs), and the plain reference
(reference/bert_tower.py, float64, the same rows, the program's batch
order: a permutation drawn from its seed) follows them and goes on to the
epoch's end:
  step_grad_gap   the first step's gradient (what the program handed
                  Adam, left on its parameters) against the reference's at
                  θ₀ on the same batch: the worst leaf's ‖g − g_ref‖
                  against the larger of ‖g_ref‖ and the median leaf's;
  step_loss_gap   max over the three of |F₃(θ_prog) − F₃(θ_ref)| / F₃(θ_ref),
                  F₃ the reference's mean loss over the three batches'
                  rows;
  step_param_gap  max over the three of the worst leaf's norm gap of the
                  change from θ₀: |‖θ_prog − θ₀‖ − ‖θ_ref − θ₀‖| against
                  the larger of ‖θ_ref − θ₀‖ and the median leaf's (a
                  state left unchanged reads 1);
and of the last timed fit, the answer the window produced:
  fit_param_gap   the same norm gap at the answer, θ_ref the reference's
                  answer after the same steps;
  fit_loss_gap    |F(θ_prog) − F(θ_ref)| / F(θ_ref), F the mean loss over
                  the training rows;
  val_score_gap   max |s_prog − s_ref| / max |s_ref| over the validation
                  rows: the scores the fit produced against the reference's
                  forward pass at the fit's answer.
Adam's first moves are ±lr an entry whatever the gradient holds, so the
gradient is compared before Adam normalises it. The trajectory is
compared by the norms of its moves, not entry by entry: the head's ReLU
makes the gradient jump where a pre-activation crosses 0,
a float32 forward puts a row on the other side of one now and then, and
Adam's first steps (±lr an entry where |g| ≫ eps) turn that ~1e-3 change
of the gradient into other signs for the entries of smallest gradient. A
leaf the exact fit leaves in place (an attention key's bias: the softmax
cancels its gradient) moves by float32 rounding alone and is not compared.
The control is the reference a step below float32 in the program's place:
the tower is matrix products, so TF32 operands; bfloat16 autocast is a
further step down, among the faults.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import gen, program
from benchmark.costs import tower as costs
from benchmark.reference.bert_tower import BertTower, initial_state

STEPS = (1, 2, 3)
# a fit stopped after this many steps: a fault the fit's numbers are read
# against (benchmark.control)
STOP = 12
# bert_config.json's keys, as the configuration file holds them
BERT_KEYS = ("attention_probs_dropout_prob", "hidden_act",
             "hidden_dropout_prob", "hidden_size", "initializer_range",
             "intermediate_size", "max_position_embeddings",
             "num_attention_heads", "num_hidden_layers", "type_vocab_size",
             "vocab_size", "layer_norm_eps")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def text_rows(t: dict, c: dict, seed: int, device):
    """(training rows, validation rows) of the cell as the program's
    per-row tensors on the device:
    documents of [CLS], a log-normal number of Zipf(zipf_s) token ids past
    the reserved ones, [SEP], then padding to max_len; the wide bag as
    lr-movielens's global bag (gen.movie_bag over its width: 1-3 one-hot
    ids and a value in [year_lo, year_hi) at the last id); labels
    Bernoulli(σ(z)), z the intercept and the planted effects, centred over
    the rows: token_sd × the mean of the document's token effects (N(0, 1)
    an id) and the wide effects (N(0, effect_sd²)). Offsets 0, weights
    1."""
    rng = np.random.default_rng(gen.seed32(seed, 1))
    n, length = t["train_rows"] + t["valid_rows"], c["max_len"]
    sp = c["special_ids"]
    lens = np.exp(rng.normal(np.log(t["len_median"]), t["len_sigma"], n))
    lens = np.clip(np.rint(lens), t["len_lo"], t["len_hi"]).astype(np.int64)
    first = t["first_token_id"]
    u = torch.from_numpy(rng.uniform(1e-7, 1.0, (n, length - 2)))
    ids = gen.fe_ids(u, c["vocab_size"] - first, t["zipf_s"]).numpy() + first
    pos = np.arange(length)
    body = (pos[None, 1:length - 1] <= lens[:, None])
    tokens = np.full((n, length), sp["[PAD]"], np.int64)
    tokens[:, 1:length - 1] = np.where(body, ids, sp["[PAD]"])
    tokens[:, 0] = sp["[CLS]"]
    tokens[np.arange(n), lens + 1] = sp["[SEP]"]
    mask = (pos[None, :] <= lens[:, None] + 1).astype(np.float32)
    width = c["wide_width"]
    idx, val, _ = gen.movie_bag(rng, n, width - 1, t["genres_lo"],
                                t["genres_hi"], t["year_lo"], t["year_hi"])
    tok_eff = rng.standard_normal(c["vocab_size"])
    wide_eff = rng.normal(0.0, t["effect_sd"], width)
    effect = (t["token_sd"] * (tok_eff[ids] * body).sum(1) / lens
              + (wide_eff[idx] * val).sum(1))
    # centred, so that the intercept alone sets the positive rate
    z = t["intercept"] + effect - effect.mean()
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    cols = dict(tokens=tokens[:, None], mask=mask[:, None], indices=idx,
                values=val.astype(np.float32), labels=labels,
                weights=np.ones(n, np.float32),
                offsets=np.zeros(n, np.float32),
                groups=np.zeros(n, np.int64))
    out = {k: torch.as_tensor(v, device=device) for k, v in cols.items()}
    out["indices"] = out["indices"].long()
    cut = t["train_rows"]
    return ({k: v[:cut] for k, v in out.items()},
            {k: v[cut:] for k, v in out.items()})


class Stage:
    unit = "fit"

    def __init__(self, cell: dict, seed: int, device, spans):
        self.cell, self.cfg = cell, cell["cfg"]
        self.seed, self.device, self.spans = seed, device, spans
        self.times = {}         # set-up's parts, seconds
        self.bert = {k: self.cfg[k] for k in BERT_KEYS}
        self.unit_log = []      # each timed fit's steps and host syncs

    def _model(self):
        from gdmix_tpu_torch.models.deep_tower import (DeepTowerModel,
                                                       DeepTowerParams)
        c, tmp = self.cfg, self.tmp
        vocab = [f"[unused{i}]" for i in range(c["vocab_size"])]
        for name, i in c["special_ids"].items():
            vocab[i] = name
        with open(os.path.join(tmp, "vocab.txt"), "w") as f:
            f.write("\n".join(vocab) + "\n")
        with open(os.path.join(tmp, "bert_config.json"), "w") as f:
            json.dump(self.bert, f)
        params = DeepTowerParams(
            metadata_file=program._metadata(tmp, c["feature_bag"],
                                            c["wide_width"]),
            output_model_dir=tmp, feature_bag=c["feature_bag"],
            vocab_file=os.path.join(tmp, "vocab.txt"),
            bert_config_file=os.path.join(tmp, "bert_config.json"),
            ftr_ext=c["ftr_ext"], max_len=c["max_len"],
            num_hidden=c["num_hidden"], task_type=c["task_type"],
            learning_rate=c["learning_rate"], batch_size=c["batch_size"],
            num_epochs=c["num_epochs"], l2_reg_weight=c["l2_reg_weight"],
            dtype=c["dtype"], seed=gen.seed32(self.seed, 2))
        return DeepTowerModel(params, program.base_params(c, "fixed_effect"),
                              device=self.device)

    def setup(self):
        t0 = time.perf_counter()
        self.tmp = tempfile.mkdtemp(prefix="gdx_benchmark_")
        self.train, self.valid = text_rows(self.cell, self.cfg, self.seed,
                                           self.device)
        self.model = self._model()
        c = self.cfg
        self.state0 = initial_state(self.bert, c["num_hidden"],
                                    c["wide_width"],
                                    gen.seed32(self.seed, 3), self.device)
        self.n_params = sum(v.numel() for v in self.state0.values())
        p = self.model.model_params
        n, b = self.train["tokens"].shape[0], p.batch_size
        perm = torch.as_tensor(np.random.RandomState(p.seed).permutation(n),
                               device=self.device)
        self.batches = [perm[s * b:(s + 1) * b] for s in range(n // b)]
        _sync(self.device)
        t1 = time.perf_counter()
        # the first steps, through the window's own call: they warm every
        # shape, and the reference follows them
        self.steps = []
        for k in STEPS:
            self.model._fit_rows(self.train, self.valid, self.state0,
                                 max_steps=k)
            module = self.model.module
            if k == 1:
                # the step's gradient stays on the parameters after Adam
                self.grad1 = {name: q.grad.detach().clone() for name, q
                              in module.named_parameters()
                              if q.grad is not None}
            self.steps.append({name: v.detach().clone() for name, v in
                               module.state_dict().items()})
        _sync(self.device)
        self.times = {"inputs_model_state": round(t1 - t0, 3),
                      "first_steps": round(time.perf_counter() - t1, 3),
                      "parameters": self.n_params}
        if self.device.type == "cuda":
            self.times["peak_after_setup"] = torch.cuda.max_memory_allocated(
                self.device)

    def run_unit(self):
        with self.spans.span("fit"):
            self.scores = self.model._fit_rows(self.train, self.valid,
                                               self.state0)
        lf = self.model.last_fit
        self.unit_log.append({k: lf[k] for k in ("steps", "host_syncs")})
        for k in ("steps", "host_syncs"):
            self.spans.add(f"fit.{k}", lf[k])

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"fe_fit_s": window_s / units}

    def after_window(self, traced: bool):
        """Nothing: the fits' counters are taken in every fit."""

    def release(self):
        self.answer = {k: v.detach().clone() for k, v in
                       self.model.module.state_dict().items()}
        self.model = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check --

    @staticmethod
    def _leaf_gap(gaps, ref) -> float:
        """The worst leaf's gaps[k] against the larger of ref[k] and the
        median of ref, over the leaves whose ref passes a millionth of
        the median."""
        med = float(np.median(list(ref.values())))
        return max(gaps[k] / max(ref[k], med)
                   for k in ref if ref[k] > 1e-6 * med)

    def _norm_gap(self, P, xr) -> float:
        """The worst leaf's |‖θ − θ₀‖ − ‖θ_ref − θ₀‖| (see _leaf_gap)."""
        moved = {k: float(torch.linalg.vector_norm(r - self.x0[k]))
                 for k, r in xr.items()}
        return self._leaf_gap(
            {k: abs(float(torch.linalg.vector_norm(
                P[k].to(torch.float64) - self.x0[k])) - moved[k])
             for k in xr}, moved)

    def _grad_gap(self, G) -> float:
        """The worst leaf's ‖g − g_ref‖ of the first step's gradient `G`
        (a leaf it lacks is 0) (see _leaf_gap)."""
        gaps = {}
        for k, r in self.g_ref.items():
            g = G.get(k)
            gaps[k] = float(torch.linalg.vector_norm(
                r if g is None else g.to(torch.float64) - r))
        return self._leaf_gap(gaps, {k: float(torch.linalg.vector_norm(r))
                                     for k, r in self.g_ref.items()})

    def _step_loss(self, P) -> float:
        return self.ref.mean_loss(self.ref.params(P), self.rows3)

    def _numbers(self, grad, steps, answer, scores) -> dict:
        """The compared numbers of the first step's gradient, the states
        after STEPS steps, the fit's answer and its validation scores,
        against the float64 reference's."""
        ref = self.ref
        fit = abs(ref.mean_loss(ref.params(answer), self.train)
                  - self.f_fit) / self.f_fit
        s_ref = ref.all_scores(ref.params(answer), self.valid)
        val = float((scores.to(torch.float64) - s_ref).abs().max()
                    / s_ref.abs().max())
        return {"step_grad_gap": self._grad_gap(grad),
                "step_loss_gap": max(abs(self._step_loss(P) - f) / f
                                     for P, f in zip(steps, self.f_steps)),
                "step_param_gap": max(self._norm_gap(P, self.x_ref[k])
                                      for P, k in zip(steps, STEPS)),
                "fit_param_gap": self._norm_gap(answer, self.x_fit),
                "fit_loss_gap": fit, "val_score_gap": val}

    def _fit(self, tower, snapshots, batches=None):
        return tower.fit(self.state0, self.train,
                         self.batches if batches is None else batches,
                         self.cfg["learning_rate"], snapshots=snapshots)

    def _as_program(self, tower, snaps):
        """(first gradient, states after STEPS steps, answer, validation
        scores) of a reference `tower` in the program's place, from its
        fit's snapshots."""
        last = len(self.batches)
        return (snaps["gradient"], [snaps[k] for k in STEPS], snaps[last],
                tower.all_scores(snaps[last], self.valid))

    def check(self):
        self.ref = BertTower(self.bert)
        last = len(self.batches)
        snaps = self._fit(self.ref, STEPS + (STOP, last))
        self.x0 = self.ref.params(self.state0)
        self.g_ref = snaps["gradient"]
        self.x_ref = {k: snaps[k] for k in STEPS}
        self.x_stop, self.x_fit = snaps[STOP], snaps[last]
        self.rows3 = {k: v[torch.cat(self.batches[:len(STEPS)])]
                      for k, v in self.train.items()}
        self.f_steps = [self.ref.mean_loss(self.x_ref[k], self.rows3)
                        for k in STEPS]
        self.f_fit = self.ref.mean_loss(self.x_fit, self.train)
        del snaps
        return self._numbers(self.grad1, self.steps, self.answer,
                             self.scores)

    def control(self) -> dict:
        """The compared numbers of the control (the reference with TF32
        operands, in the program's place); after check()."""
        tower = BertTower(self.bert, "tf32")
        last = len(self.batches)
        return self._numbers(*self._as_program(
            tower, self._fit(tower, STEPS + (last,))))

    def faults(self) -> dict:
        """The numbers of faults planted in the reference put in the
        program's place, after check(): bfloat16 autocast; the key mask
        ignored; the last encoder layer skipped; each batch's second half
        left out; the fit stopped after STOP steps; the validation scored
        at the initial state; the state left unchanged."""
        last = len(self.batches)
        f32 = "float32"
        half = [b[:len(b) // 2] for b in self.batches]
        out = {}
        for name, tower, batches in (
                ("bf16_autocast", BertTower(self.bert, "bf16"), None),
                ("mask_ignored", BertTower(self.bert, f32, mask_keys=False),
                 None),
                ("last_layer_skipped", BertTower(
                    self.bert, f32,
                    layers=self.bert["num_hidden_layers"] - 1), None),
                ("half_batch", BertTower(self.bert, f32), half)):
            out[name] = self._numbers(*self._as_program(
                tower, self._fit(tower, STEPS + (last,), batches)))
        steps = [self.x_ref[k] for k in STEPS]
        out[f"stop_at_{STOP}"] = self._numbers(
            self.g_ref, steps, self.x_stop,
            self.ref.all_scores(self.x_stop, self.valid))
        out["validated_at_start"] = self._numbers(
            self.g_ref, steps, self.x_fit,
            self.ref.all_scores(self.x0, self.valid))
        out["state_unchanged"] = self._numbers(
            {}, [self.x0] * len(STEPS), self.x0,
            self.ref.all_scores(self.x0, self.valid))
        return out

    def _lens(self, rows):
        return rows["mask"][:, 0].sum(1).cpu().numpy()

    def step_work(self):
        """[(flops, bytes)] of each of a fit's steps, over the real
        positions of its batch."""
        c = self.cfg
        lens = self._lens(self.train)
        k = self.train["indices"].shape[1]
        return [(costs.step_flops(lens[b.cpu().numpy()], c["hidden_size"],
                                  c["intermediate_size"],
                                  c["num_hidden_layers"], c["num_hidden"]),
                 costs.step_bytes(self.n_params, lens[b.cpu().numpy()], k))
                for b in self.batches]

    def counted_work(self):
        """(flops, bytes) of one fit: its steps and its validation pass."""
        c = self.cfg
        steps = self.step_work()
        return (sum(f for f, _ in steps)
                + costs.forward_flops(self._lens(self.valid),
                                      c["hidden_size"],
                                      c["intermediate_size"],
                                      c["num_hidden_layers"],
                                      c["num_hidden"]),
                sum(b for _, b in steps))

    def attention_work(self):
        """(flops, bytes) of one fit's attention calls in its steps'
        forward passes."""
        c = self.cfg
        lens = self._lens(self.train)[torch.cat(self.batches).cpu().numpy()]
        shape = (lens, c["hidden_size"], c["num_hidden_layers"])
        return costs.attention_flops(*shape), costs.attention_bytes(*shape)
