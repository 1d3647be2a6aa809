"""A deep fixed-effect stage: DeText's tower with ModernBERT's encoder
(`--ftr_ext=bert --bert_config_file=` a ModernBERT config.json) fitted for
one epoch from the seed's initial state, through DeepTowerModel, over and
over, for the window: the same loop as kinds/tower_fit.py (its rows, its
fit through `_fit_rows`, its checks), over long documents.

Set-up first imports the program's ModernBERT encoder and checks that the
built model's encoder is one, before the rows or the state are made: a
program without it fails there, within seconds, and never trains another
encoder in its place. The initial state θ₀ is drawn once in set-up, on the
device, by the reference's initialiser (ModernBERT's, and the tower's
head), and each fit starts from it.

The rows are tower_fit's but for their lengths, drawn one in each stratum
of equal probability (`stratified_lengths`): each is log-normal, and a
fit's work is nearly the same on every seed, so that `fe_fit_s` measures
the program and not the draw (with independent draws its spread over six
seeds read 7.1% on an H100 80GB HBM3, against 0.65% stratified).

Unit: one fit. End to end: `fe_fit_s`, the window over the fits
completed.

`correct`: the numbers of kinds/tower_fit.py (`step_grad_gap`,
`step_loss_gap`, `step_param_gap` over the first three steps, run through
the window's own call in set-up; `fit_param_gap`, `fit_loss_gap` and
`val_score_gap` at the last timed fit's answer), against the plain
reference (reference/modernbert_tower.py, float64, a document at a time,
the program's batch order). The control is the reference with TF32
operands in the program's place; the faults put in its place are bfloat16
operands, every layer global (the window ignored), the documents of a
batch attended as one pack (not separated), the two RoPE bases swapped,
the last layer skipped, each batch's second half left out, the fit
stopped after STOP steps, the validation scored at the initial state and
the state left unchanged.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from benchmark import gen
from benchmark.costs import bound_s
from benchmark.costs import modernbert as costs
from benchmark.kinds import tower_fit
from benchmark.kinds.tower_fit import STEPS, STOP
from benchmark.reference.modernbert_tower import (ModernBertTower,
                                                  initial_state)

# a ModernBERT config.json's keys, as the configuration file holds them
MODERNBERT_KEYS = (
    "model_type", "vocab_size", "hidden_size", "intermediate_size",
    "num_hidden_layers", "num_attention_heads", "hidden_activation",
    "max_position_embeddings", "initializer_range",
    "initializer_cutoff_factor", "norm_eps", "norm_bias",
    "global_rope_theta", "local_rope_theta", "global_attn_every_n_layers",
    "local_attention", "attention_bias", "mlp_bias", "attention_dropout",
    "embedding_dropout", "mlp_dropout", "classifier_dropout",
    "classifier_pooling", "classifier_activation", "classifier_bias",
    "cls_token_id", "sep_token_id", "pad_token_id")


def stratified_lengths(rng, t: dict, n: int) -> np.ndarray:
    """`n` document lengths (tokens), log-normal with median len_median and
    σ len_sigma, one in each of n strata of equal probability, in a random
    order; rounded and clipped to [len_lo, len_hi]. Each length is drawn
    from the log-normal, and the set's sums (its tokens, its attention's
    n²) barely move from seed to seed, so neither does a fit's work."""
    u = (rng.permutation(n) + rng.uniform(size=n)) / n
    z = torch.special.ndtri(torch.as_tensor(u, dtype=torch.float64)).numpy()
    lens = np.exp(np.log(t["len_median"]) + t["len_sigma"] * z)
    return np.clip(np.rint(lens), t["len_lo"], t["len_hi"]).astype(np.int64)


def document_rows(t: dict, c: dict, seed: int, device):
    """(training rows, validation rows) as kinds/tower_fit.py `text_rows`
    makes them, with the lengths of each set drawn by stratified_lengths,
    and the token ids over [first_token_id, token_ids): below the special
    ids."""
    rng = np.random.default_rng(gen.seed32(seed, 1))
    n, length = t["train_rows"] + t["valid_rows"], c["max_len"]
    sp = c["special_ids"]
    lens = np.concatenate([stratified_lengths(rng, t, t["train_rows"]),
                           stratified_lengths(rng, t, t["valid_rows"])])
    first, vocab = t["first_token_id"], t["token_ids"]
    u = torch.from_numpy(rng.uniform(1e-7, 1.0, (n, length - 2)))
    ids = gen.fe_ids(u, vocab - first, t["zipf_s"]).numpy() + first
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
    tok_eff = rng.standard_normal(vocab)
    wide_eff = rng.normal(0.0, t["effect_sd"], width)
    effect = (t["token_sd"] * (tok_eff[ids] * body).sum(1) / lens
              + (wide_eff[idx] * val).sum(1))
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


class Stage(tower_fit.Stage):

    def __init__(self, cell: dict, seed: int, device, spans):
        self.cell = cell
        self.bert = {k: cell["cfg"][k] for k in MODERNBERT_KEYS}
        # the file's model_type is ModernBERT's; the coordinate's, DeText's
        self.cfg = dict(cell["cfg"], model_type="detext")
        self.seed, self.device, self.spans = seed, device, spans
        self.times = {}
        self.unit_log = []

    def setup(self):
        # a program without ModernBERT's encoder stops here
        from gdmix_tpu_torch.models.deep_tower import _ModernBertEncoder
        t0 = time.perf_counter()
        self.tmp = tempfile.mkdtemp(prefix="gdx_benchmark_")
        self.model = self._model()
        if not isinstance(self.model.module.bert, _ModernBertEncoder):
            raise RuntimeError(
                f"the program built {type(self.model.module.bert).__name__} "
                "from a ModernBERT config.json")
        c = self.cfg
        self.train, self.valid = document_rows(self.cell, c, self.seed,
                                               self.device)
        self.state0 = initial_state(self.bert, c["num_hidden"],
                                    c["wide_width"],
                                    gen.seed32(self.seed, 3), self.device)
        self.n_params = sum(v.numel() for v in self.state0.values())
        p = self.model.model_params
        n, b = self.train["tokens"].shape[0], p.batch_size
        perm = torch.as_tensor(np.random.RandomState(p.seed).permutation(n),
                               device=self.device)
        self.batches = [perm[s * b:(s + 1) * b] for s in range(n // b)]
        tower_fit._sync(self.device)
        t1 = time.perf_counter()
        # the first steps, through the window's own call: they warm the
        # kernels and the shapes, and the reference follows them
        self.steps = []
        for k in STEPS:
            self.model._fit_rows(self.train, self.valid, self.state0,
                                 max_steps=k)
            module = self.model.module
            if k == 1:
                self.grad1 = {name: q.grad.detach().clone() for name, q
                              in module.named_parameters()
                              if q.grad is not None}
            self.steps.append({name: v.detach().clone() for name, v in
                               module.state_dict().items()})
        tower_fit._sync(self.device)
        self.times = {"model_inputs_state": round(t1 - t0, 3),
                      "first_steps": round(time.perf_counter() - t1, 3),
                      "parameters": self.n_params,
                      "longest_document": int(self._lens(self.train).max())}
        if self.device.type == "cuda":
            self.times["peak_after_setup"] = torch.cuda.max_memory_allocated(
                self.device)

    def run_unit(self):
        super().run_unit()
        lf = self.model.last_fit
        self.unit_log[-1].update({k: lf[k] for k in (
            "attention_calls_full", "attention_calls_window",
            "longest_document")})

    # ------------------------------------------------------------ the check --

    def check(self):
        self.ref = ModernBertTower(self.bert)
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
        tower = ModernBertTower(self.bert, "tf32")
        last = len(self.batches)
        return self._numbers(*self._as_program(
            tower, self._fit(tower, STEPS + (last,))))

    def faults(self) -> dict:
        """The numbers of faults planted in the reference put in the
        program's place, after check() (see the module's doc)."""
        last = len(self.batches)
        f32 = "float32"
        half = [b[:len(b) // 2] for b in self.batches]
        out = {}
        for name, tower, batches in (
                ("bf16_autocast", ModernBertTower(self.bert, "bf16"), None),
                ("window_ignored", ModernBertTower(self.bert, f32,
                                                   window=False), None),
                ("documents_not_separated", ModernBertTower(
                    self.bert, f32, separate=False), None),
                ("thetas_swapped", ModernBertTower(self.bert, f32,
                                                   swap_theta=True), None),
                ("last_layer_skipped", ModernBertTower(
                    self.bert, f32,
                    layers=self.bert["num_hidden_layers"] - 1), None),
                ("half_batch", ModernBertTower(self.bert, f32), half)):
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

    # ------------------------------------------------------- counted work --

    def _batch_lens(self):
        lens = self._lens(self.train)
        return [lens[b.cpu().numpy()] for b in self.batches]

    def step_work(self):
        """[(flops, bytes)] of each of a fit's steps, over its batch's
        documents."""
        c = self.cfg
        k = self.train["indices"].shape[1]
        return [(costs.step_flops(ls, c, c["num_hidden"]),
                 costs.step_bytes(self.n_params, ls, k))
                for ls in self._batch_lens()]

    def counted_work(self):
        """(flops, bytes) of one fit: its steps and its validation pass."""
        c = self.cfg
        steps = self.step_work()
        return (sum(f for f, _ in steps)
                + costs.forward_flops(self._lens(self.valid), c,
                                      c["num_hidden"]),
                sum(b for _, b in steps))

    def attention_least_s(self, kind: str) -> float:
        """The least seconds of one fit's steps' attention calls of `kind`
        ("full" or "window"), forward and backward, step by step."""
        return sum(bound_s(nbytes, flops)[0] for flops, nbytes in
                   (costs.attention_step(ls, self.cfg, kind)
                    for ls in self._batch_lens()))
