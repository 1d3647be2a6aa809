"""Deep fixed-effect tower: a DeText-style text ranker in PyTorch.

Port of gdmix_tpu/models/deep_tower.py, the fixed-effect coordinate that
stands where the reference delegates to the external DeText package
(linkedin/gdmix:gdmix-trainer/src/gdmix/models/detext/
fixed_effect_detext_model.py; arch per detext-movieLens.yaml: a text CNN
over doc_query + wide sparse features). It consumes the DeText data layout
(doc_query string + wide_ftrs_sp bag + uid/weight/label) and emits the
standard score interface (predictionScore / predictionScorePerCoordinate
avro) for the random effects downstream.

Covered, as in the JAX package (--ftr_ext, doc fields, losses):
  * encoders: `cnn` (one Conv1D per window + masked max-pool), `lstm`
    (stacked LSTM over every position + masked max-pool), `bert` /
    `transformer` (self-attention blocks trained from scratch + masked mean);
    with a `bert_config_file` (a google-research/bert `bert_config.json`,
    DeText's own argument), `bert` is BERT's encoder as that file sizes it:
    word, position and token-type embeddings under a LayerNorm, post-LN
    blocks with biases and an exact (erf) GELU, and BERT's pooler; the
    documents framed by [CLS] and [SEP]. Not ported: WordPiece (the tokens
    are the vocab file's whitespace lookup), `bert_init_ckpt` (the weights
    start from BERT's initialiser) and dropout (the tower has none). A
    transformers ModernBERT `config.json` (model_type "modernbert") makes
    `bert` ModernBERT's encoder instead: pre-LN blocks without biases,
    RoPE, a GeGLU MLP, global layers over the whole document alternating
    with local ones over ±local_attention/2 positions, a final norm, the
    classifier's pooling and head; attention over the packed documents by
    the varlen kernel (ops/varlen_attention.py), whatever their lengths up
    to max_position_embeddings. Any other model_type is refused;
  * multi-field docs: `doc_text_columns` = comma list; a shared embedding,
    an encoder per field, the representations concatenated (the attention
    encoders take one field: ROADMAP C.11);
  * losses: `classification` (pointwise weighted BCE) and `ranking`
    (in-batch pairwise logistic within `query_column` groups).

Training is mini-batch Adam on one device a process, the data uploaded
once and each batch gathered there; the loss of each step stays on the
device until the epoch ends (`_fit_rows`: the epochs, the validation AUC
and the best epoch, over per-row tensors already on the device; `train()`
reads the files, uploads them once and calls it). The best epoch by
validation AUC is kept and saved as the port's own checkpoint: a
`state_dict` written by `torch.save` through the filesystem seam, with a
manifest beside it, by the chief alone.
Checkpoints of the JAX package (orbax) do not load here. The JAX package
computes the tower outside any Pallas kernel, and so the port leaves it to
PyTorch's operators (BERT's attention to `scaled_dot_product_attention`),
but for ModernBERT's attention, which no PyTorch operator computes over
packed documents within a window: csrc/varlen_attention.cu.

Spans (util/timing.py): `tower.fit` (a `_fit_rows` call), `tower.step` (one
Adam step) holding `tower.forward`, `tower.backward` and `tower.adam`,
`tower.attention` (each BERT layer's attention call in a step's forward),
`tower.attention.full` / `tower.attention.window` (each ModernBERT layer's
in a step's forward) and `tower.attention_grad.full` / `.window` (their
backward), `tower.validate` (the scoring pass and its AUC); `last_fit`
counts the `steps`, the `host_syncs` (values read back to the host: the
epoch's loss,
the AUC and, with BERT, the training rows' encoded positions once a fit
and the packed size of each scoring forward) and, over the steps and the
validation, the `encoded_positions` and the `padded_positions` the
batches held (BERT encodes the positions its mask lets a query or the
pooler read, ModernBERT the documents' own; the other encoders every one)
and, with ModernBERT, the attention calls of each kind and the longest
document.

Across processes (a process group; gdmix_tpu/models/deep_tower.py:288-530)
training is data parallel: every process holds the full data and draws the
same permutation from the seed, takes its contiguous slice of each global
batch, and the gradients are averaged by one all-reduce a step before Adam,
so every replica stays identical (batch_size % processes == 0, as in the
JAX package). The ranking loss pairs rows across the whole global batch, so
there each process also gathers the batch's logits. Scoring splits each
chunk over the processes and gathers the scores back; each process writes
its interleaved share of the rows. NUM_WORKERS > 1 with no process group
means independent replicas: each scores only its interleaved share.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import math
import os
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.device import resolve_device
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.io import scores as scores_io
from gdmix_tpu_torch.io.input_pipeline import read_per_record
from gdmix_tpu_torch.io.metadata import DatasetMetadata
from gdmix_tpu_torch.models.api import Model
from gdmix_tpu_torch.ops.logistic import stable_bce
from gdmix_tpu_torch.ops.metrics import auc as auc_metric
from gdmix_tpu_torch.ops.varlen_attention import HEAD_DIM, varlen_attention
from gdmix_tpu_torch.parallel.process_group import (all_gather_rows,
                                                    all_reduce_sum, barrier,
                                                    process_index_and_count)
from gdmix_tpu_torch.params import Params, from_argv
from gdmix_tpu_torch.util.timing import span

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the masked max-pool's fill (JAX deep_tower.py:130, :138)
_POOL_FILL = -1e9
# flax's LayerNorm epsilon (torch's default is 1e-5)
_LN_EPS = 1e-6


@dataclass(frozen=True)
class BertConfig:
    """The keys of a google-research/bert `bert_config.json` that size the
    encoder. The dropout probabilities are read and not applied: the tower
    has no dropout."""
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12      # BERT's LayerNorm epsilon
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"BERT's hidden_size {self.hidden_size} is not a multiple of "
                f"its num_attention_heads {self.num_attention_heads}")
        if self.hidden_act != "gelu":
            raise ValueError(f"hidden_act {self.hidden_act!r}: the BERT "
                             "encoder computes gelu only")

    @classmethod
    def from_file(cls, path: str) -> "BertConfig":
        raw = _config_json(path)
        if raw.get("model_type", "bert") != "bert":
            raise ValueError(f"{path}: model_type {raw['model_type']!r} is "
                             "not BERT's")
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in keys})


def _config_json(path: str) -> dict:
    with fs.open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class ModernBertConfig:
    """The keys of a transformers ModernBERT `config.json` (model_type
    "modernbert") that define the encoder, at ModernBERT-base's values by
    default. The file's other keys (the MLM decoder's, flash-attention
    switches, the tokenizer's bos / eos ids) do not change what the encoder
    computes and are not read. What the encoder does not compute is refused:
    a dropout, another activation, a bias in a norm, attention, the MLP or
    the head."""
    vocab_size: int = 50368
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    hidden_activation: str = "gelu"
    max_position_embeddings: int = 8192
    initializer_range: float = 0.02
    initializer_cutoff_factor: float = 2.0
    norm_eps: float = 1e-5
    norm_bias: bool = False
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    attention_bias: bool = False
    mlp_bias: bool = False
    attention_dropout: float = 0.0
    embedding_dropout: float = 0.0
    mlp_dropout: float = 0.0
    classifier_dropout: float = 0.0
    classifier_pooling: str = "cls"
    classifier_activation: str = "gelu"
    classifier_bias: bool = False
    cls_token_id: int = 50281
    sep_token_id: int = 50282
    pad_token_id: int = 50283

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"ModernBERT's hidden_size {self.hidden_size} is not a "
                f"multiple of its num_attention_heads "
                f"{self.num_attention_heads}")
        dropout = {k: getattr(self, k) for k in (
            "attention_dropout", "embedding_dropout", "mlp_dropout",
            "classifier_dropout") if getattr(self, k)}
        if dropout:
            raise ValueError(f"dropout {dropout}: the tower has no dropout, "
                             "and a step must be deterministic")
        for k in ("hidden_activation", "classifier_activation"):
            if getattr(self, k) != "gelu":
                raise ValueError(f"{k} {getattr(self, k)!r}: the ModernBERT "
                                 "encoder computes gelu only")
        bias = [k for k in ("norm_bias", "attention_bias", "mlp_bias",
                            "classifier_bias") if getattr(self, k)]
        if bias:
            raise ValueError(f"{bias}: the ModernBERT encoder has no biases")
        if self.classifier_pooling not in ("cls", "mean"):
            raise ValueError(f"classifier_pooling "
                             f"{self.classifier_pooling!r}: cls or mean")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def window(self) -> int:
        """A local layer's reach: a query sees keys |i − j| ≤ window."""
        return self.local_attention // 2

    def is_global(self, layer: int) -> bool:
        return layer % self.global_attn_every_n_layers == 0


def encoder_config(path: str):
    """The encoder config of a `bert_config_file`, by its model_type: absent
    or "bert", BERT's (BertConfig); "modernbert", ModernBertConfig; any
    other is refused."""
    raw = _config_json(path)
    kind = raw.get("model_type", "bert")
    if kind == "bert":
        return BertConfig.from_file(path)
    if kind == "modernbert":
        keys = {f.name for f in dataclasses.fields(ModernBertConfig)}
        return ModernBertConfig(**{k: v for k, v in raw.items()
                                   if k in keys})
    raise ValueError(f"{path}: model_type {kind!r}: the tower builds BERT "
                     "(absent or 'bert') or ModernBERT ('modernbert')")


@dataclass
class DeepTowerParams:
    """Hyperparameters, named after the DeText args used by the reference's
    detext-movieLens.yaml where they correspond."""
    metadata_file: str = ""
    output_model_dir: str = ""
    training_data_dir: Optional[str] = None
    validation_data_dir: Optional[str] = None
    feature_bag: Optional[str] = "wide_ftrs_sp"
    vocab_file: str = ""
    doc_text_column: str = "doc_query"
    doc_text_columns: Optional[str] = None  # comma list; overrides the single
    max_len: int = 16
    ftr_ext: str = "cnn"           # cnn | lstm | bert | transformer
    num_units: int = 64            # embedding dim
    filter_window_sizes: str = "1,2,3"
    num_filters: int = 50
    num_hidden: int = 100
    num_heads: int = 4             # transformer encoder
    num_layers: int = 2            # transformer/lstm encoder depth
    task_type: str = "classification"   # classification | ranking
    query_column: Optional[str] = None  # ranking group key (e.g. user_id)
    learning_rate: float = 0.002
    batch_size: int = 512
    num_epochs: int = 10
    l2_reg_weight: float = 0.0
    offset_column_name: str = "offset"
    dtype: str = "float32"         # the parameters' and the batches' type
    seed: int = 0
    data_format: str = constants.TFRECORD
    # a google-research/bert bert_config.json (`bert` becomes BERT's
    # encoder) or a transformers ModernBERT config.json (ModernBERT's)
    bert_config_file: Optional[str] = None

    def __post_init__(self):
        if self.ftr_ext not in ("cnn", "lstm", "bert", "transformer"):
            raise ValueError(f"unknown ftr_ext {self.ftr_ext!r}")
        if self.bert_config_file and self.ftr_ext != "bert":
            raise ValueError(f"bert_config_file sizes the bert encoder; "
                             f"ftr_ext is {self.ftr_ext!r}")
        if self.task_type not in ("classification", "ranking"):
            raise ValueError(f"unknown task_type {self.task_type!r}")
        if self.task_type == "ranking" and not self.query_column:
            raise ValueError("ranking needs a query_column to group by")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")

    @property
    def windows(self) -> List[int]:
        return [int(x) for x in str(self.filter_window_sizes).split(",")]

    @property
    def text_columns(self) -> List[str]:
        if self.doc_text_columns:
            return [c.strip() for c in str(self.doc_text_columns).split(",")]
        return [self.doc_text_column]


class _LayerNorm(nn.Module):
    """flax's LayerNorm: variance as E[x²] − E[x]² clipped at 0, eps 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        return (x - mean) * (torch.rsqrt(var + _LN_EPS) * self.scale) \
            + self.bias


class _EncoderLayer(nn.Module):
    """flax SelfAttention → LayerNorm(x + att) → a 4× ReLU FFN →
    LayerNorm(x + ff) (JAX deep_tower.py:147-152)."""

    def __init__(self, units: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(units, units)
        self.key = nn.Linear(units, units)
        self.value = nn.Linear(units, units)
        self.out = nn.Linear(units, units)
        self.norm_att = _LayerNorm(units)
        self.ff_in = nn.Linear(units, 4 * units)
        self.ff_out = nn.Linear(4 * units, units)
        self.norm_ff = _LayerNorm(units)

    def forward(self, x, key_ok):
        b, length, units = x.shape
        shape = (b, length, self.heads, units // self.heads)
        q = self.query(x).view(shape) / math.sqrt(shape[-1])
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # masked keys take the type's least value, not −inf (flax
        # dot_product_attention_weights): a doc with no tokens attends
        # uniformly instead of giving NaN
        logits = logits.masked_fill(~key_ok, torch.finfo(logits.dtype).min)
        att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
        x = self.norm_att(x + self.out(att.reshape(b, length, units)))
        return self.norm_ff(x + self.ff_out(torch.relu(self.ff_in(x))))


def _attend(q, k, v, key_ok):
    """Attention of q, k, v [B, heads, L, d] over the keys `key_ok`
    [B, 1, 1, L] allows; a span of its own in a step's forward (grad on),
    none in scoring."""
    if not torch.is_grad_enabled():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=key_ok)
    with span("tower.attention"):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=key_ok)


def _bert_positions(mask):
    """(keys, encoded positions) of a token_mask [B, L], both boolean
    [B, L]: the keys are the mask's, or every position of a doc with no
    tokens (flax's masking attends to them alike, and not NaN); the
    encoded positions are the keys and each row's position 0, which the
    pooler reads."""
    key_ok = mask > 0
    key_ok = key_ok | ~key_ok.any(-1, keepdim=True)
    encoded = key_ok.clone()
    encoded[:, 0] = True
    return key_ok, encoded


class _BertLayer(nn.Module):
    """BERT's post-LN block: a = LN(x + Wo·MHA(x) + bo), then
    LN(a + W2·gelu(W1·a + b1) + b2), GELU exact (erf). forward takes the
    encoded positions' rows x [T, h], their flat places `at` [T] in the
    batch's [B·L] and the key mask [B, 1, 1, L]: every product, norm and
    GELU runs on the T rows, attention in the batch's padded layout."""

    def __init__(self, c: BertConfig):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_attention_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.attn_norm = nn.LayerNorm(h, eps=c.layer_norm_eps)
        self.ff_in = nn.Linear(h, c.intermediate_size)
        self.ff_out = nn.Linear(c.intermediate_size, h)
        self.ff_norm = nn.LayerNorm(h, eps=c.layer_norm_eps)

    def forward(self, x, at, key_ok):
        b, length = key_ok.shape[0], key_ok.shape[-1]

        def heads(t):
            # [T, h] scattered to [B, heads, L, d], zero where not encoded
            full = t.new_zeros(b * length, t.shape[-1]).index_copy_(0, at, t)
            return full.view(b, length, self.heads, -1).transpose(1, 2)
        att = _attend(heads(self.query(x)), heads(self.key(x)),
                      heads(self.value(x)), key_ok)
        att = att.transpose(1, 2).reshape(b * length, -1).index_select(0, at)
        a = self.attn_norm(x + self.attn_out(att))
        return self.ff_norm(a + self.ff_out(F.gelu(self.ff_in(a))))


class _BertEncoder(nn.Module):
    """BERT's encoder over one text field: LN(word[t] + pos[i] + type[0]),
    the blocks, and the pooler tanh(Wp·x[:, 0] + bp). forward takes tokens
    and token_mask [B, L] and gives [B, hidden_size].

    Only the encoded positions are computed: every key and each row's
    position 0, which the pooler reads. A position outside that set is no
    key, so it feeds only itself: no output or gradient of the set depends
    on it. Their count T sizes the pack: `next_size`, where the caller
    knows it (consumed by the next forward), else read back from the
    device. `counts` gains each read (`host_syncs`), T
    (`encoded_positions`) and B·L (`padded_positions`) until a caller
    clears it."""

    def __init__(self, c: BertConfig):
        super().__init__()
        h = c.hidden_size
        self.initializer_range = c.initializer_range
        self.word = nn.Embedding(c.vocab_size, h)
        self.position = nn.Embedding(c.max_position_embeddings, h)
        self.token_type = nn.Embedding(c.type_vocab_size, h)
        self.embed_norm = nn.LayerNorm(h, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(_BertLayer(c)
                                    for _ in range(c.num_hidden_layers))
        self.pooler = nn.Linear(h, h)
        self.counts = Counter()
        self.next_size: Optional[int] = None

    def forward(self, tokens, mask):
        length = tokens.shape[1]
        key_ok, encoded = _bert_positions(mask)
        size, self.next_size = self.next_size, None
        if size is None:
            at = encoded.reshape(-1).nonzero()[:, 0]    # reads T back
            self.counts.update(host_syncs=1)
        else:
            at = torch.nonzero_static(encoded.reshape(-1), size=size)[:, 0]
        self.counts.update(encoded_positions=len(at),
                           padded_positions=encoded.numel())
        x = self.embed_norm(self.word(tokens.reshape(-1).index_select(0, at))
                            + self.position(at % length)
                            + self.token_type.weight[0])
        for layer in self.layers:
            x = layer(x, at, key_ok[:, None, None, :])
        # each row's position 0 is its first encoded one
        per_row = encoded.sum(1)
        return torch.tanh(self.pooler(
            x.index_select(0, per_row.cumsum(0) - per_row)))


def _modernbert_positions(mask):
    """The encoded positions [B, L] (boolean) of a framed token_mask [B, L]:
    the document, [CLS] to [SEP] (a prefix of its row), never padding; a
    row with no mask at all keeps its position 0."""
    encoded = mask > 0
    encoded[:, 0] = True
    return encoded


def _rope_tables(pos, theta: float, dim: int, dtype):
    """(cos, sin) [T, dim / 2] of RoPE at positions `pos` [T] with base
    `theta`: the angle pos·θ^(−2i/dim) taken in float64, then rounded to
    `dtype`."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=pos.device) / dim)
    angle = pos.to(torch.float64)[:, None] * inv[None, :]
    return torch.cos(angle).to(dtype), torch.sin(angle).to(dtype)


def _rope(x, cos, sin):
    """Rotate-half RoPE of x [T, heads, d]: x·cos + rotate_half(x)·sin, the
    tables [T, d / 2] repeated over both halves."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _attend_packed(q, k, v, offsets, longest: int, window: int):
    """varlen attention of packed q, k, v [T, heads, d] (window −1: whole
    documents); a span of its own in a step's forward (grad on),
    `tower.attention.full` or `tower.attention.window`, none in scoring."""
    if not torch.is_grad_enabled():
        return varlen_attention(q, k, v, offsets, longest, window)
    with span("tower.attention." + ("full" if window < 0 else "window")):
        return varlen_attention(q, k, v, offsets, longest, window)


class _ModernBertLayer(nn.Module):
    """ModernBERT's pre-LN block over the packed rows x [T, h]:
    h = x + Wo·Attn(RoPE(Wqkv·n(x))), then h + Wo'·(gelu(u) ⊙ g) with
    [u | g] = Wi·LN(h); n is the identity in layer 0, a LayerNorm after.
    No biases; GELU exact (erf). A global layer attends over the whole
    document, a local one within ±window positions, each with its own RoPE
    base."""

    def __init__(self, c: ModernBertConfig, index: int):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_attention_heads
        self.window = -1 if c.is_global(index) else c.window
        self.attn_norm = (None if index == 0 else
                          nn.LayerNorm(h, eps=c.norm_eps, bias=False))
        self.attn = nn.Module()
        self.attn.Wqkv = nn.Linear(h, 3 * h, bias=False)
        self.attn.Wo = nn.Linear(h, h, bias=False)
        self.mlp_norm = nn.LayerNorm(h, eps=c.norm_eps, bias=False)
        self.mlp = nn.Module()
        self.mlp.Wi = nn.Linear(h, 2 * c.intermediate_size, bias=False)
        self.mlp.Wo = nn.Linear(c.intermediate_size, h, bias=False)

    def forward(self, x, rope, offsets, longest: int):
        n = x.shape[0]
        a = x if self.attn_norm is None else self.attn_norm(x)
        qkv = self.attn.Wqkv(a).view(n, 3, self.heads, -1)   # q | k | v
        cos, sin = rope
        att = _attend_packed(_rope(qkv[:, 0], cos, sin),
                             _rope(qkv[:, 1], cos, sin),
                             qkv[:, 2].contiguous(), offsets, longest,
                             self.window)
        h = x + self.attn.Wo(att.reshape(n, -1))
        u, g = self.mlp.Wi(self.mlp_norm(h)).chunk(2, dim=-1)
        return h + self.mlp.Wo(F.gelu(u) * g)


class _ModernBertEncoder(nn.Module):
    """ModernBERT's encoder over one text field: x = LN(E[t]) (no position
    or token-type embedding), the blocks, a final LayerNorm, the
    classifier's pooling (`cls`: the document's first position; `mean`:
    the mean over its positions) and its head LN(gelu(Wd·p)). forward
    takes tokens and token_mask [B, L] and gives [B, hidden_size].

    Only the documents' positions are computed, packed [T, h]: each row's
    [CLS], tokens and [SEP], a prefix of the row, so a position's RoPE
    index is its place in the row. Attention is the varlen kernel over the
    documents' offsets: no padding, no pair across documents. T and the
    longest document size the pack and the kernel's grid: `next_size` and
    `next_longest` where the caller knows them (consumed by the next
    forward), else read back from the device. `counts` gains each read
    (`host_syncs`), T (`encoded_positions`), B·L (`padded_positions`),
    each layer's attention call (`attention_calls_full`,
    `attention_calls_window`) and the longest document seen
    (`longest_document`, a maximum) until a caller clears it."""

    def __init__(self, c: ModernBertConfig):
        super().__init__()
        h = c.hidden_size
        self.config = c
        self.embeddings = nn.Module()
        self.embeddings.tok_embeddings = nn.Embedding(c.vocab_size, h)
        self.embeddings.norm = nn.LayerNorm(h, eps=c.norm_eps, bias=False)
        self.layers = nn.ModuleList(_ModernBertLayer(c, i)
                                    for i in range(c.num_hidden_layers))
        self.final_norm = nn.LayerNorm(h, eps=c.norm_eps, bias=False)
        self.head = nn.Module()
        self.head.dense = nn.Linear(h, h, bias=False)
        self.head.norm = nn.LayerNorm(h, eps=c.norm_eps, bias=False)
        self.counts = Counter()
        self.next_size: Optional[int] = None
        self.next_longest: Optional[int] = None

    def init_std(self, name: str) -> Tuple[float, float]:
        """(σ, cut) of ModernBERT's initialiser for the weight `name`: a
        normal cut at ±cutoff·σ, σ initializer_range for the embedding,
        Wqkv and Wi, and initializer_range / √(2·layers) for both output
        projections and the head's dense layer."""
        c = self.config
        sd = c.initializer_range
        if name.endswith(("attn.Wo.weight", "mlp.Wo.weight",
                          "head.dense.weight")):
            sd /= math.sqrt(2.0 * c.num_hidden_layers)
        return sd, c.initializer_cutoff_factor * sd

    def forward(self, tokens, mask):
        c = self.config
        b, length = tokens.shape
        encoded = _modernbert_positions(mask)
        lens = encoded.sum(1)
        size, self.next_size = self.next_size, None
        longest, self.next_longest = self.next_longest, None
        if size is None or longest is None:
            host = lens.cpu()                    # reads the lengths back
            self.counts.update(host_syncs=1)
            size, longest = int(host.sum()), int(host.max())
        at = torch.nonzero_static(encoded.reshape(-1), size=size)[:, 0]
        offsets = F.pad(torch.cumsum(lens, 0), (1, 0)).to(torch.int32)
        n_global = sum(c.is_global(i) for i in range(len(self.layers)))
        self.counts.update(encoded_positions=size,
                           padded_positions=encoded.numel(),
                           attention_calls_full=n_global,
                           attention_calls_window=len(self.layers)
                           - n_global)
        self.counts["longest_document"] = max(
            self.counts["longest_document"], longest)
        emb = self.embeddings
        x = emb.norm(emb.tok_embeddings(tokens.reshape(-1).index_select(
            0, at)))
        pos = at % length
        ropes = {theta: _rope_tables(pos, theta, c.head_dim, x.dtype)
                 for theta in (c.global_rope_theta, c.local_rope_theta)}
        for i, layer in enumerate(self.layers):
            theta = (c.global_rope_theta if c.is_global(i)
                     else c.local_rope_theta)
            x = layer(x, ropes[theta], offsets, longest)
        x = self.final_norm(x)
        if c.classifier_pooling == "cls":
            pooled = x.index_select(0, offsets[:-1].long())
        else:
            # each document's sum as one product with its [b, T] indicator:
            # no atomics (index_add_ has them on a card), so that a step
            # repeats bit for bit
            member = x.new_zeros(b, size)
            member[at // length, torch.arange(size, device=x.device)] = 1.0
            pooled = (member @ x) / lens[:, None].to(x.dtype)
        return self.head.norm(F.gelu(self.head.dense(pooled)))


class _TextWideTower(nn.Module):
    """Text encoder (cnn | lstm | transformer) + wide linear tower → MLP →
    logit, as JAX's _TextWideTower. Multi-field docs share the embedding
    table; each field gets its own encoder parameters and the
    representations concatenate. forward takes tokens / token_mask
    [B, F, L], wide_indices / wide_values [B, K]. With `bert` (ftr_ext
    "bert") the encoder is BERT's (_BertEncoder) or, for a ModernBertConfig,
    ModernBERT's (_ModernBertEncoder), with its own embeddings and its
    width hidden_size in place of num_units."""

    def __init__(self, vocab_size: int, num_wide: int, num_units: int,
                 windows: Tuple[int, ...], num_filters: int, num_hidden: int,
                 ftr_ext: str = "cnn", num_heads: int = 4, num_layers: int = 2,
                 num_fields: int = 1, max_len: int = 16,
                 bert=None):
        super().__init__()
        if ftr_ext in ("bert", "transformer") and num_fields > 1:
            raise ValueError(
                "ROADMAP C.11: the JAX package cannot build a "
                f"{ftr_ext} encoder over {num_fields} text columns (its "
                "position embedding is one parameter per tower)")
        self.ftr_ext = ftr_ext
        self.windows = tuple(windows)
        self.bert = None
        if bert is not None:
            if ftr_ext != "bert":
                raise ValueError(f"a BERT config needs ftr_ext 'bert', not "
                                 f"{ftr_ext!r}")
            if max_len > bert.max_position_embeddings:
                raise ValueError(
                    f"max_len {max_len} is past the encoder's "
                    f"max_position_embeddings {bert.max_position_embeddings}")
            self.bert = (_ModernBertEncoder(bert)
                         if isinstance(bert, ModernBertConfig)
                         else _BertEncoder(bert))
            self.counts = self.bert.counts
            self.wide_w = nn.Parameter(torch.empty(num_wide))
            self.hidden = nn.Linear(bert.hidden_size + 1, num_hidden)
            self.logit = nn.Linear(num_hidden, 1)
            return
        # the forwards' positions encoded and held (B·F·L) until a caller
        # clears it: these encoders compute every one
        self.counts = Counter()
        self.embed = nn.Embedding(vocab_size, num_units)
        self.wide_w = nn.Parameter(torch.empty(num_wide))
        if ftr_ext == "cnn":
            # field f's window i is convs[f·W + i], flax's Conv_{f·W+i}
            self.convs = nn.ModuleList(
                nn.Conv1d(num_units, num_filters, w, padding="same")
                for _ in range(num_fields) for w in self.windows)
            width = num_filters * len(self.windows)
        elif ftr_ext == "lstm":
            self.lstms = nn.ModuleList(
                nn.LSTM(num_units, num_units, num_layers=num_layers,
                        batch_first=True) for _ in range(num_fields))
            for lstm in self.lstms:
                for k in range(num_layers):
                    # flax's cell has one bias per gate, on the hidden
                    # side: the input side's stays 0 and out of training
                    getattr(lstm, f"bias_ih_l{k}").requires_grad_(False)
            width = num_units
        else:
            self.posemb = nn.Parameter(torch.empty(1, max_len, num_units))
            self.layers = nn.ModuleList(_EncoderLayer(num_units, num_heads)
                                        for _ in range(num_layers))
            width = num_units
        self.hidden = nn.Linear(num_fields * width + 1, num_hidden)
        self.logit = nn.Linear(num_hidden, 1)

    def _encode_cnn(self, f, emb, mask):
        x = emb.transpose(1, 2)                      # [B, units, L]
        pooled = []
        for i in range(len(self.windows)):
            conv = torch.relu(self.convs[f * len(self.windows) + i](x))
            # ROADMAP C.12, kept for parity: a doc with no tokens pools to
            # −1e9, as in the JAX package
            conv = torch.where(mask[:, None, :] > 0, conv, _POOL_FILL)
            pooled.append(torch.amax(conv, dim=-1))
        return torch.cat(pooled, dim=-1)

    def _encode_lstm(self, f, emb, mask):
        # every position runs through the cell, pads too (flax's nn.RNN
        # without seq_lengths): no packed sequences
        x, _ = self.lstms[f](emb)
        # ROADMAP C.12, kept for parity (see _encode_cnn)
        x = torch.where(mask[..., None] > 0, x, _POOL_FILL)
        return torch.amax(x, dim=1)

    def _encode_transformer(self, f, emb, mask):
        x = emb + self.posemb
        key_ok = (mask > 0)[:, None, None, :]        # [B, 1, 1, L]
        for layer in self.layers:
            x = layer(x, key_ok)
        denom = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
        return (x * mask[..., None]).sum(dim=1) / denom   # masked mean

    def forward(self, tokens, token_mask, wide_indices, wide_values):
        reprs = []
        if self.bert is not None:
            reprs.append(self.bert(tokens[:, 0], token_mask[:, 0]))
        else:
            self.counts.update(encoded_positions=token_mask.numel(),
                               padded_positions=token_mask.numel())
            encode = {"cnn": self._encode_cnn, "lstm": self._encode_lstm,
                      "bert": self._encode_transformer,
                      "transformer": self._encode_transformer}[self.ftr_ext]
            for f in range(tokens.shape[1]):
                mask_f = token_mask[:, f]
                emb = self.embed(tokens[:, f]) * mask_f[..., None]
                reprs.append(encode(f, emb, mask_f))
        # wide tower: linear over the sparse bag
        wide = (self.wide_w[wide_indices] * wide_values).sum(dim=-1,
                                                             keepdim=True)
        h = torch.relu(self.hidden(torch.cat(reprs + [wide], dim=-1)))
        return self.logit(h)[..., 0] + wide[..., 0]


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's lecun_normal: a normal truncated at ±2σ, scaled so that the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


def init_state(tower: _TextWideTower, gen: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """A fresh state for `tower`, on the CPU, drawn from `gen` with the JAX
    package's initialisers: embedding N(0, 0.1), wide weights 0, position
    embedding N(0, 0.02), LeCun-normal kernels over their fan-in (a
    convolution's is in·width), biases 0, LayerNorm scales 1, and flax's
    LSTM cell defaults (LeCun-normal input kernels, an orthogonal hidden
    kernel per gate). BERT's encoder takes BERT's initialiser: every
    embedding and kernel a normal of σ initializer_range truncated at ±2σ,
    biases 0, LayerNorm scales 1 and offsets 0; ModernBERT's takes its own
    (_ModernBertEncoder.init_std; LayerNorm scales 1); the head and the wide
    weights keep the tower's."""
    state = {}
    for name, p in tower.named_parameters():
        t = torch.zeros(p.shape, dtype=p.dtype)
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("bert."):
            if leaf == "weight" and "norm" in name:
                t.fill_(1.0)
            elif leaf == "weight" and isinstance(tower.bert,
                                                 _ModernBertEncoder):
                sd, cut = tower.bert.init_std(name)
                nn.init.trunc_normal_(t, 0.0, sd, -cut, cut, generator=gen)
            elif leaf == "weight":
                sd = tower.bert.initializer_range
                nn.init.trunc_normal_(t, 0.0, sd, -2 * sd, 2 * sd,
                                      generator=gen)
        elif name == "embed.weight":
            nn.init.normal_(t, 0.0, 0.1, generator=gen)
        elif name == "posemb":
            nn.init.normal_(t, 0.0, 0.02, generator=gen)
        elif leaf == "scale":
            t.fill_(1.0)
        elif leaf.startswith("weight_hh"):
            for gate in t.chunk(4, dim=0):
                nn.init.orthogonal_(gate, generator=gen)
        elif leaf.startswith("weight"):
            _lecun_normal_(t, int(np.prod(t.shape[1:])), gen)
        state[name] = t
    for name, b in tower.named_buffers():
        state[name] = b.detach().cpu().clone()
    return state


def pairwise_ranking_loss(logits, labels, weights, group_ids):
    """In-batch pairwise logistic (RankNet) loss over same-group pairs with
    label_i > label_j — the DeText ranking objective family. Group-less or
    single-label groups contribute nothing."""
    diff = logits[:, None] - logits[None, :]
    pair = ((labels[:, None] > labels[None, :])
            & (group_ids[:, None] == group_ids[None, :]))
    w = weights[:, None] * pair
    per = torch.log1p(torch.exp(-diff))
    return torch.sum(w * per) / torch.clamp_min(torch.sum(w), 1.0)


def tower_loss(tower: _TextWideTower, batch: Dict[str, torch.Tensor],
               ranking: bool, l2_reg_weight: float) -> torch.Tensor:
    """The training objective of one batch (JAX deep_tower.py:314-323): the
    data loss of score + offset, plus l2_reg_weight · Σ‖leaf‖² over every
    trained parameter (an l2 term in the loss, not Adam's weight decay)."""
    logits = tower(batch["tokens"], batch["mask"], batch["indices"],
                   batch["values"]) + batch["offsets"]
    if ranking:
        data_loss = pairwise_ranking_loss(logits, batch["labels"],
                                          batch["weights"], batch["groups"])
    else:
        data_loss = torch.mean(batch["weights"]
                               * stable_bce(logits, batch["labels"]))
    if not l2_reg_weight:
        # the term is 0·Σ‖leaf‖²: leaving it out changes no bit of the loss
        # or of a gradient, and saves a pass over every parameter
        return data_loss
    l2 = sum(torch.sum(p * p) for p in tower.parameters() if p.requires_grad)
    return data_loss + l2_reg_weight * l2


def adam(tower: _TextWideTower, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0). On a card
    the update of every parameter runs as one fused step."""
    params = [p for p in tower.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            fused=all(p.is_cuda for p in params))


def _load_vocab(vocab_file: str) -> Dict[str, int]:
    # fs seam: the vocab may live on a remote scheme, like DeText's vocab on
    # HDFS (reference detext-movieLens.yaml vocab_file + tf.io.gfile reads)
    with fs.open(vocab_file, encoding="utf-8") as f:
        return {line.strip(): i for i, line in enumerate(f) if line.strip()}


def _tokenize(texts, vocab: Dict[str, int], max_len: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    pad = vocab.get("[PAD]", 0)
    unk = vocab.get("[UNK]", 1)
    n = len(texts)
    tokens = np.full((n, max_len), pad, dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    for i, t in enumerate(texts):
        if isinstance(t, bytes):
            t = t.decode("utf-8")
        words = str(t).split()[:max_len]
        for j, w in enumerate(words):
            tokens[i, j] = vocab.get(w, unk)
            mask[i, j] = 1.0
    return tokens, mask


def _bert_framed(tokens: np.ndarray, mask: np.ndarray, vocab: Dict[str, int],
                 special: Optional[Tuple[int, int, int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """_tokenize's [n, F, L] tokens and mask as BERT reads a document:
    [CLS], the first L − 2 tokens, [SEP], then padding (every position
    past [SEP]). The ids are the vocab's [CLS], [SEP] and [PAD], or
    `special`'s (cls, sep, pad)."""
    cls, sep, pad = ((vocab["[CLS]"], vocab["[SEP]"], vocab.get("[PAD]", 0))
                     if special is None else special)
    length = tokens.shape[-1]
    kept = np.minimum(mask.sum(-1).astype(np.int64), length - 2)[..., None]
    out = np.full_like(tokens, pad)
    out[..., 1:length - 1] = tokens[..., :length - 2]
    pos = np.arange(length)
    out = np.where(pos <= kept, out, pad)
    out[..., 0] = cls
    np.put_along_axis(out, kept + 1, sep, axis=-1)
    return out, (pos <= kept + 1).astype(mask.dtype)


_ROW_KEYS = ("tokens", "mask", "indices", "values", "labels", "weights",
             "offsets", "groups")


class DeepTowerModel(Model):
    """Deep fixed-effect coordinate with the standard score interface, on
    one device a process: the process's card, or the CPU when it is asked
    for."""

    CKPT_FORMAT_VERSION = 1

    def __init__(self, model_params: DeepTowerParams, base_params: Params,
                 device=None):
        self.model_params = model_params
        self.base_params = base_params
        self.device = resolve_device(device)
        self.dtype = _DTYPES[model_params.dtype]
        self.metadata_file = model_params.metadata_file
        self.checkpoint_path = model_params.output_model_dir
        self.training_data_dir = model_params.training_data_dir
        self.validation_data_dir = model_params.validation_data_dir
        self.metadata = DatasetMetadata.from_file(self.metadata_file)
        self.feature_bag = model_params.feature_bag
        self.num_wide = self.metadata.num_features(self.feature_bag)
        self.vocab = _load_vocab(model_params.vocab_file)
        p = model_params
        self.bert_config = (encoder_config(p.bert_config_file)
                            if p.bert_config_file else None)
        # ModernBERT frames a document with its config's ids
        self.special_ids: Optional[Tuple[int, int, int]] = None
        if isinstance(self.bert_config, ModernBertConfig):
            c = self.bert_config
            if self.device.type == "cuda" and c.head_dim != HEAD_DIM:
                raise ValueError(
                    f"ModernBERT's head size {c.head_dim}: the card's "
                    f"attention kernel takes heads of {HEAD_DIM}")
            self.special_ids = (c.cls_token_id, c.sep_token_id,
                                c.pad_token_id)
            if len(self.vocab) > c.vocab_size \
                    or max(self.special_ids) >= c.vocab_size:
                raise ValueError(
                    f"the vocab ({len(self.vocab)} entries) or the ids "
                    f"{self.special_ids} of [CLS], [SEP] and [PAD] do not "
                    f"fit ModernBERT's vocab_size {c.vocab_size}")
        elif self.bert_config is not None:
            missing = {"[CLS]", "[SEP]"} - set(self.vocab)
            if missing or len(self.vocab) > self.bert_config.vocab_size:
                raise ValueError(
                    f"the vocab ({len(self.vocab)} entries, missing "
                    f"{sorted(missing)}) does not fit BERT's vocab_size "
                    f"{self.bert_config.vocab_size} with [CLS] and [SEP]")
            if max(self.bert_config.hidden_dropout_prob,
                   self.bert_config.attention_probs_dropout_prob) > 0:
                logger.info("the tower has no dropout: BERT's dropout "
                            "probabilities are not applied")
        # built without values: every use loads a state (_initial_state, a
        # checkpoint) first
        with torch.device("meta"):
            tower = _TextWideTower(
                vocab_size=len(self.vocab), num_wide=self.num_wide,
                num_units=p.num_units, windows=tuple(p.windows),
                num_filters=p.num_filters, num_hidden=p.num_hidden,
                ftr_ext=p.ftr_ext, num_heads=p.num_heads,
                num_layers=p.num_layers, num_fields=len(p.text_columns),
                max_len=p.max_len, bert=self.bert_config)
        self.module = tower.to_empty(device=self.device).to(self.dtype)
        self.has_params = False
        # the last train(): per-epoch mean loss and validation AUC, the
        # best epoch, the fit's seconds
        self.last_fit: Optional[dict] = None
        # with BERT, each training row's encoded positions (host), read
        # once a fit
        self._row_positions: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ data --

    def _load_arrays(self, data_dir: str, schema_params):
        data = read_per_record(data_dir, self.metadata, self.feature_bag)
        p = self.model_params
        per_field = [_tokenize(data.columns[c], self.vocab, p.max_len)
                     for c in p.text_columns]
        tokens = np.stack([t for t, _ in per_field], axis=1)   # [n, F, L]
        mask = np.stack([m for _, m in per_field], axis=1)
        n = data.num_samples
        md = self.metadata
        labels = (data.column(schema_params.label_column_name).astype(np.float32)
                  if md.has_label(schema_params.label_column_name)
                  else np.zeros(n, np.float32))
        weights = (data.column(schema_params.weight_column_name).astype(np.float32)
                   if md.has_feature(schema_params.weight_column_name)
                   else np.ones(n, np.float32))
        # coordinate semantics: the offset may come from the dataset schema OR
        # be injected by the in-memory pipeline's score ledger — column
        # presence decides, exactly like the LR fixed effect
        offsets = (data.columns[p.offset_column_name].astype(np.float32)
                   if p.offset_column_name in data.columns
                   else np.zeros(n, np.float32))
        uid = data.column(schema_params.uid_column_name).astype(np.int64)
        if p.query_column and p.query_column in data.columns:
            qcol = data.columns[p.query_column]
            _, groups = np.unique(np.asarray([str(q) for q in qcol]),
                                  return_inverse=True)
            groups = groups.astype(np.int32)
        else:
            groups = np.zeros(n, np.int32)
        return dict(tokens=tokens, mask=mask, indices=data.indices,
                    values=data.values.astype(np.float32), labels=labels,
                    weights=weights, offsets=offsets, uid=uid, n=n,
                    groups=groups)

    def _rows(self, data_dir: str, schema_params):
        """_load_arrays' columns, the documents framed as BERT reads them
        when the encoder is BERT's or ModernBERT's."""
        arrays = self._load_arrays(data_dir, schema_params)
        if self.bert_config is not None:
            arrays["tokens"], arrays["mask"] = _bert_framed(
                arrays["tokens"], arrays["mask"], self.vocab,
                self.special_ids)
        return arrays

    def _on_device(self, arrays) -> Dict[str, torch.Tensor]:
        """The per-row arrays as tensors on the model's device, uploaded
        once: ids as int64, the rest in the model's type."""
        out = {}
        for k in _ROW_KEYS:
            integral = k in ("tokens", "indices", "groups")
            out[k] = torch.as_tensor(
                np.asarray(arrays[k]),
                dtype=torch.int64 if integral else self.dtype,
                device=self.device)
        return out

    # ----------------------------------------------------------------- train --

    def _initial_state(self) -> Dict[str, torch.Tensor]:
        """The state the fit starts from: the JAX package's initialisers
        (init_state), drawn from a generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(self.model_params.seed)
        return init_state(self.module, gen)

    def _shared_step(self, opt, rows, idx, ranking: bool) -> torch.Tensor:
        """One data-parallel step of this process: its contiguous share of
        the global batch `idx`, the gradients averaged over the processes
        (one all-reduce, the loss packed with them), then Adam. Returns the
        global batch's loss. Each process differentiates n·(its share of
        the global data loss) + l2·Σ‖leaf‖², so the average is the global
        batch's gradient: for the pointwise loss that share is the mean
        over its slice; for the ranking loss, whose pairs span the batch,
        it is the global pairwise loss with only this process's logits
        live (the others' gathered)."""
        rank, nproc = process_index_and_count()
        per = len(idx) // nproc
        local = self._batch(rows, idx[rank * per:(rank + 1) * per])
        p = self.model_params
        opt.zero_grad(set_to_none=True)
        with span("tower.forward"):
            if not ranking:
                loss = tower_loss(self.module, local, False, p.l2_reg_weight)
                shown = loss.detach()
            else:
                z = self.module(local["tokens"], local["mask"],
                                local["indices"], local["values"]) \
                    + local["offsets"]
                z_all = all_gather_rows(z.detach())
                z = torch.cat([z_all[:rank * per], z,
                               z_all[(rank + 1) * per:]])
                idx = idx.to(self.device, non_blocking=True)
                data = pairwise_ranking_loss(z, rows["labels"][idx],
                                             rows["weights"][idx],
                                             rows["groups"][idx])
                l2 = (p.l2_reg_weight * sum(
                    torch.sum(q * q) for q in self.module.parameters()
                    if q.requires_grad) if p.l2_reg_weight else 0.0)
                loss = nproc * data + l2
                shown = (data + l2).detach()
        with span("tower.backward"):
            loss.backward()
        params = [q for q in self.module.parameters() if q.grad is not None]
        flat = all_reduce_sum(torch.cat(
            [q.grad.reshape(-1) for q in params] + [shown.reshape(1)])) / nproc
        at = 0
        for q in params:
            q.grad.copy_(flat[at:at + q.numel()].view_as(q))
            at += q.numel()
        with span("tower.adam"):
            opt.step()
        return flat[-1]

    def _batch(self, rows, idx) -> Dict[str, torch.Tensor]:
        """The training rows `idx` (ids in a host tensor) of `rows`,
        gathered on the device. BERT's encoder is handed the count of
        their encoded positions (ModernBERT's also the longest row's),
        from the fit's one read of each row's, so that no step waits on the
        device."""
        bert = self.module.bert
        if bert is not None:
            counts = self._row_positions[idx]
            bert.next_size = int(counts.sum())
            if isinstance(bert, _ModernBertEncoder):
                bert.next_longest = int(counts.max())
        at = idx.to(self.device, non_blocking=True)
        return {k: v[at] for k, v in rows.items()}

    def _step(self, opt, rows, idx, ranking: bool) -> torch.Tensor:
        """One Adam step of one process over the rows `idx` (ids in a host
        tensor); its loss."""
        batch = self._batch(rows, idx)
        opt.zero_grad(set_to_none=True)
        with span("tower.forward"):
            loss = tower_loss(self.module, batch, ranking,
                              self.model_params.l2_reg_weight)
        with span("tower.backward"):
            loss.backward()
        with span("tower.adam"):
            opt.step()
        return loss.detach()

    def _fit_rows(self, train_t: Dict[str, torch.Tensor],
                  valid_t: Optional[Dict[str, torch.Tensor]],
                  state: Dict[str, torch.Tensor],
                  max_steps: Optional[int] = None) -> Optional[torch.Tensor]:
        """Fit from `state` over the per-row tensors `train_t` (and score
        `valid_t` an epoch) already on the device: num_epochs epochs of
        Adam steps over batches drawn by a permutation seeded with `seed`,
        the best epoch by validation AUC kept in the module (the last
        without validation). A fit cut short stops after `max_steps` steps
        and that epoch's validation. Returns the kept epoch's validation
        scores (None without validation); sets last_fit."""
        p = self.model_params
        _, nproc = process_index_and_count()
        if nproc > 1 and p.batch_size % nproc:
            raise ValueError(
                f"multi-process deep-tower training needs batch_size "
                f"divisible by the process count ({p.batch_size} % {nproc})")
        with span("tower.fit") as fit_span:
            self.module.load_state_dict(state)
            self.has_params = True
            opt = adam(self.module, p.learning_rate)
            ranking = p.task_type == "ranking"
            rng_np = np.random.RandomState(p.seed)
            n = train_t["tokens"].shape[0]
            steps_per_epoch = max(1, n // p.batch_size)
            best_auc, best_state, best_epoch = -1.0, None, p.num_epochs - 1
            best_scores = None
            history = []
            steps = syncs = 0
            self.module.counts.clear()
            bert = self.module.bert
            if bert is not None:
                # each training row's encoded positions, read back once
                mask = train_t["mask"][:, 0]
                self._row_positions = (
                    _modernbert_positions(mask)
                    if isinstance(bert, _ModernBertEncoder)
                    else _bert_positions(mask)[1]).sum(1).cpu()
                syncs += 1
            for epoch in range(p.num_epochs):
                # the batches' ids stay on the host, pinned on a card so
                # that each step's copy does not wait
                perm = torch.as_tensor(rng_np.permutation(n))
                if self.device.type == "cuda":
                    perm = perm.pin_memory()
                losses = []
                for s in range(steps_per_epoch):
                    if steps == max_steps:
                        break
                    idx = perm[s * p.batch_size:(s + 1) * p.batch_size]
                    if nproc > 1:
                        # a global batch short of a multiple of the process
                        # count (n < batch_size) drops its remainder
                        idx = idx[:len(idx) // nproc * nproc]
                        if not len(idx):
                            continue
                    with span("tower.step"):
                        step = self._shared_step if nproc > 1 else self._step
                        losses.append(step(opt, train_t, idx, ranking))
                    steps += 1
                mean_loss = float(torch.stack(losses).mean())
                syncs += 1
                if valid_t is None:
                    history.append({"epoch": epoch, "loss": mean_loss})
                else:
                    with span("tower.validate"):
                        vscores = self._score_all(valid_t)
                        vauc = float(auc_metric(vscores + valid_t["offsets"],
                                                valid_t["labels"]))
                    syncs += 1
                    logger.info("epoch %d loss %.5f val auc %.4f", epoch,
                                mean_loss, vauc)
                    history.append({"epoch": epoch, "loss": mean_loss,
                                    "val_auc": vauc})
                    if vauc > best_auc:
                        best_auc, best_epoch = vauc, epoch
                        best_scores = vscores
                        best_state = {k: v.detach().clone() for k, v
                                      in self.module.state_dict().items()}
                if steps == max_steps:
                    break
            if best_state is not None:
                self.module.load_state_dict(best_state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        counts = self.module.counts
        self.last_fit = {"epochs": history, "best_epoch": best_epoch,
                         "steps_per_epoch": steps_per_epoch, "steps": steps,
                         "host_syncs": syncs + counts["host_syncs"],
                         "encoded_positions": counts["encoded_positions"],
                         "padded_positions": counts["padded_positions"],
                         "seconds": fit_span.seconds}
        if isinstance(self.module.bert, _ModernBertEncoder):
            self.last_fit.update({k: counts[k] for k in (
                "attention_calls_full", "attention_calls_window",
                "longest_document")})
        logger.info("deep tower: best epoch %d of %d, %d steps an epoch, "
                    "%.3f s", best_epoch, p.num_epochs, steps_per_epoch,
                    self.last_fit["seconds"],
                    extra={"deep_tower_fit": self.last_fit})
        return best_scores

    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        logger.info("Kicking off deep-tower training on %s", self.device)
        train = self._rows(training_data_dir, schema_params)
        valid = (self._rows(validation_data_dir, schema_params)
                 if validation_data_dir else None)
        train_t = self._on_device(train)
        valid_t = self._on_device(valid) if valid is not None else None
        self._fit_rows(train_t, valid_t, self._initial_state())
        # one writer (ROADMAP C.4), and no process reads it before it is
        # written
        if execution_context.get(constants.IS_CHIEF, True):
            self._save_checkpoint()
        barrier()

        # score train + validation with the best epoch's parameters
        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        self._write_scores(train, train_t, schema_params,
                           self.base_params.training_score_dir, task_index,
                           num_workers)
        if valid is not None:
            self._write_scores(valid, valid_t, schema_params,
                               self.base_params.validation_score_dir,
                               task_index, num_workers)

    @torch.no_grad()
    def _score_all(self, rows: Dict[str, torch.Tensor],
                   chunk: int = 4096) -> torch.Tensor:
        """Scores (without the offset) of every row, in chunks of `chunk`
        rows, on the device. Across processes each process scores its
        contiguous slice of each chunk (the chunk padded with its last row
        to a multiple of the process count) and the slices are gathered
        back, so every process holds every score."""
        n = rows["tokens"].shape[0]
        rank, nproc = process_index_and_count()
        if nproc > 1:
            out = []
            for s in range(0, n, chunk):
                idx = torch.arange(s, min(s + chunk, n), device=self.device)
                true_len = len(idx)
                idx = torch.cat([idx, idx[-1:].repeat((-true_len) % nproc)])
                per = len(idx) // nproc
                mine = idx[rank * per:(rank + 1) * per]
                z = self.module(rows["tokens"][mine], rows["mask"][mine],
                                rows["indices"][mine], rows["values"][mine])
                out.append(all_gather_rows(z)[:true_len])
            return torch.cat(out) if out else torch.zeros(
                0, dtype=self.dtype, device=self.device)
        out = [self.module(rows["tokens"][s:s + chunk],
                           rows["mask"][s:s + chunk],
                           rows["indices"][s:s + chunk],
                           rows["values"][s:s + chunk])
               for s in range(0, n, chunk)]
        return torch.cat(out) if out else torch.zeros(0, dtype=self.dtype,
                                                      device=self.device)

    def _write_scores(self, arrays, rows, schema_params, output_dir,
                      task_index, num_workers: int = 1):
        """This worker's part-{task_index:05d}.avro: its interleaved share
        (rows task_index::num_workers), so that the workers' part files
        hold every row once. In a process group every process scores every
        row together (_score_all) and keeps its share; independent
        replicas (num_workers > 1 with no group) score only their share."""
        if not output_dir:
            return
        n = arrays["n"]
        if num_workers > 1 and process_index_and_count()[1] == 1:
            sub = np.arange(task_index, n, num_workers)
            arrays = dict(arrays, n=len(sub), **{
                k: arrays[k][sub] for k in ("offsets", "uid", "labels",
                                            "weights")})
            rows = {k: v[torch.as_tensor(sub, device=self.device)]
                    for k, v in rows.items()}
            keep = slice(None)
        else:
            keep = slice(task_index, None, num_workers)
        per_coordinate = self._score_all(rows).cpu().numpy()
        total = per_coordinate + arrays["offsets"]
        out = os.path.join(output_dir, f"part-{task_index:05d}.avro")
        scores_io.write_scores(out, schema_params, arrays["uid"][keep],
                               total[keep],
                               scores_per_coordinate=per_coordinate[keep],
                               labels=arrays["labels"][keep],
                               weights=arrays["weights"][keep])
        logger.info("Wrote %d deep-tower scores to %s",
                    len(arrays["uid"][keep]), out)

    # ------------------------------------------------------------ checkpoint --
    # The port's checkpoint: <output_model_dir>/deep_tower_ckpt/params.pt (a
    # torch.save of the state_dict) and manifest.json (the JAX package's
    # keys, and "framework": "torch"). Both are written once, straight to
    # their place through the filesystem seam, local or remote alike.

    def _ckpt_dir(self) -> str:
        return os.path.join(self.checkpoint_path, "deep_tower_ckpt")

    def _save_checkpoint(self) -> None:
        buf = io.BytesIO()
        torch.save({k: v.detach().cpu()
                    for k, v in self.module.state_dict().items()}, buf)
        ckpt_dir = self._ckpt_dir()
        fs.makedirs(ckpt_dir, exist_ok=True)
        with fs.open(os.path.join(ckpt_dir, "params.pt"), "wb") as f:
            f.write(buf.getvalue())
        with fs.open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
            json.dump({"format_version": self.CKPT_FORMAT_VERSION,
                       "model": "deep_tower",
                       "framework": "torch",
                       "vocab_size": len(self.vocab),
                       "num_wide": self.num_wide,
                       "hparams": dataclasses.asdict(self.model_params)}, f,
                      indent=2)
        logger.info("Saved deep-tower checkpoint to %s", ckpt_dir)

    def _load_checkpoint(self) -> None:
        ckpt_dir = self._ckpt_dir()
        with fs.open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != self.CKPT_FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version "
                             f"{manifest.get('format_version')}")
        if manifest.get("framework") != "torch":
            raise ValueError(f"{ckpt_dir} was not written by "
                             "gdmix_tpu_torch (an orbax checkpoint of the "
                             "JAX package does not load here)")
        if manifest["vocab_size"] != len(self.vocab) \
                or manifest["num_wide"] != self.num_wide:
            raise ValueError("checkpoint was trained with a different "
                             "vocab/feature space")
        with fs.open(os.path.join(ckpt_dir, "params.pt"), "rb") as f:
            state = torch.load(io.BytesIO(f.read()), weights_only=True,
                               map_location=self.device)
        self.module.load_state_dict(state)
        self.has_params = True

    def export(self, output_model_dir):
        if self.has_params:
            self._save_checkpoint()

    # --------------------------------------------------------------- predict --

    def predict(self, output_dir, input_data_path, metadata_file,
                checkpoint_path, execution_context, schema_params):
        self._load_checkpoint()
        arrays = self._rows(input_data_path, schema_params)
        self._write_scores(arrays, self._on_device(arrays), schema_params,
                           output_dir,
                           execution_context.get(constants.TASK_INDEX, 0),
                           execution_context.get(constants.NUM_WORKERS, 1))

    @staticmethod
    def from_argv(argv, base_params: Params,
                  device=None) -> "DeepTowerModel":
        return DeepTowerModel(from_argv(DeepTowerParams, argv), base_params,
                              device)
