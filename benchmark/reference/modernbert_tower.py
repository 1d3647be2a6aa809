"""Plain DeText ModernBERT tower: ModernBERT's encoder (answerdotai/
ModernBERT-base, arXiv:2412.13663), its classifier's pooling and head, and
the deep tower's head, with the pointwise weighted BCE and Adam, in plain
PyTorch, one document at a time and unpadded:

    x⁰   = LN(E[t])                                  (no position embedding)
    h    = xˡ + Wo·Attn_ℓ(RoPE_ℓ(Wqkv·n_ℓ(xˡ)))       (n_0 the identity)
    xˡ⁺¹ = h + Wo'·(gelu(u) ⊙ g),   [u | g] = Wi·LN(h)
    p    = pool(LN(x^L)),   e = LN(gelu(Wd·p))
    s    = Wl·relu(Wh·[e, wide] + bh) + bl + wide,   wide = Σ_k w[id_k]·v_k
    loss = mean_i w_i·bce(s_i + o_i, y_i)

Layer ℓ is global when ℓ % global_attn_every_n_layers == 0 (the whole
document, RoPE base global_rope_theta), else local (keys |i − j| ≤
local_attention / 2, base local_rope_theta). RoPE is the rotate-half form
over a head's dimensions at the token's index in its document, its angles
taken in float64, each base's table made once a document. LayerNorm
(without bias), GELU (exact) and softmax are PyTorch's functional ops.
Attention is the two products and a softmax under the window mask, a
block of queries at a time, each block
recomputed in the backward pass (torch.utils.checkpoint) so that no
[heads, n, n] logits are held. Pooling: `cls` the document's first
position, `mean` the mean over its positions. No biases but the tower's
head's. The gradients come from autograd, summed document by document;
Adam is written out (b1 0.9, b2 0.999, eps 1e-8, bias corrected).
Parameters are named as the program's state_dict names them.

Precisions as reference/bert_tower.py: "float64" the reference, "float32",
and the controls "tf32" and "bf16" (every matrix product's operands, and
for bf16 its products, rounded). Faults, for the control's readings:
`window=False` makes every layer global; `separate=False` attends over
each block's documents packed together (global layers across the whole
pack, local ones across its documents' edges); `swap_theta` swaps the two
RoPE bases; `layers` runs only the first that many blocks.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.bert_tower import (PRECISIONS, _bce, _cut,
                                            _RoundedMatmul, _trunc_normal)

# queries a block of attention's explicit softmax
QUERY_BLOCK = 1024


def initial_state(cfg: dict, hidden: int, wide: int, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """θ₀ of the tower of ModernBERT config `cfg` with a head of `hidden`
    units over a `wide`-wide bag, float32 on `device`, drawn from `seed`
    there: ModernBERT's initialiser (normals cut at ±cutoff·σ, σ
    initializer_range for the embedding, Wqkv and Wi and
    initializer_range / √(2·layers) for both output projections and the
    head's dense layer; LayerNorm scales 1), and the tower's head
    (LeCun-normal kernels; biases and the wide weights 0)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    sd = cfg["initializer_range"]
    out_sd = sd / math.sqrt(2.0 * layers)
    cut = cfg["initializer_cutoff_factor"]
    out = {}

    def weight(name, shape, std):
        t = torch.empty(shape, device=device)
        out[name] = torch.nn.init.trunc_normal_(t, 0.0, std, -cut * std,
                                                cut * std, generator=gen)

    def norm(name):
        out[name] = torch.ones(h, device=device)
    weight("bert.embeddings.tok_embeddings.weight", (cfg["vocab_size"], h),
           sd)
    norm("bert.embeddings.norm.weight")
    for i in range(layers):
        pre = f"bert.layers.{i}."
        if i:
            norm(pre + "attn_norm.weight")
        weight(pre + "attn.Wqkv.weight", (3 * h, h), sd)
        weight(pre + "attn.Wo.weight", (h, h), out_sd)
        norm(pre + "mlp_norm.weight")
        weight(pre + "mlp.Wi.weight", (2 * inter, h), sd)
        weight(pre + "mlp.Wo.weight", (h, inter), out_sd)
    norm("bert.final_norm.weight")
    weight("bert.head.dense.weight", (h, h), out_sd)
    norm("bert.head.norm.weight")
    out["wide_w"] = torch.zeros(wide, device=device)
    lecun = 1.0 / .87962566103423978     # a cut normal's σ for variance 1
    out["hidden.weight"] = _trunc_normal((hidden, h + 1),
                                         lecun / math.sqrt(h + 1), gen,
                                         device)
    out["hidden.bias"] = torch.zeros(hidden, device=device)
    out["logit.weight"] = _trunc_normal((1, hidden), lecun / math.sqrt(hidden),
                                        gen, device)
    out["logit.bias"] = torch.zeros(1, device=device)
    return out


class ModernBertTower:
    """The tower of ModernBERT config `cfg` (config.json's keys) in
    `precision`, with the faults of the module's doc."""

    def __init__(self, cfg: dict, precision: str = "float64",
                 window: bool = True, separate: bool = True,
                 swap_theta: bool = False, layers: Optional[int] = None):
        self.h = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.d = self.h // self.heads
        self.eps = cfg["norm_eps"]
        self.every = cfg["global_attn_every_n_layers"]
        self.reach = cfg["local_attention"] // 2
        self.thetas = (cfg["global_rope_theta"], cfg["local_rope_theta"])
        if swap_theta:
            self.thetas = self.thetas[::-1]
        self.pooling = cfg["classifier_pooling"]
        self.layers = cfg["num_hidden_layers"] if layers is None else layers
        self.dtype, self.rnd = PRECISIONS[precision]
        self.products = precision == "bf16"
        self.window, self.separate = window, separate
        if self.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def params(self, state: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Copies of `state` in this tower's type."""
        return {k: v.detach().to(self.dtype).clone()
                for k, v in state.items()}

    # ------------------------------------------------------------ forward --

    def _mm(self, a, b):
        if self.rnd is None:
            return a @ b
        return _RoundedMatmul.apply(a, b, self.rnd, self.products)

    def _linear(self, x, w):
        return self._mm(x, w.t())

    def _ln(self, x, g):
        return F.layer_norm(x, (self.h,), g, None, self.eps)

    def _tables(self, pos, dtype):
        """{θ: (cos, sin) [n, 1, d / 2]} of RoPE at positions `pos` [n]."""
        out = {}
        for theta in self.thetas:
            inv = theta ** (-torch.arange(0, self.d, 2, dtype=torch.float64,
                                          device=pos.device) / self.d)
            angle = pos.to(torch.float64)[:, None] * inv[None, :]
            out[theta] = (torch.cos(angle).to(dtype)[:, None, :],
                          torch.sin(angle).to(dtype)[:, None, :])
        return out

    def _rope(self, x, table):
        """Rotate-half RoPE of x [n, heads, d] by its (cos, sin) table."""
        c, s = table
        x1, x2 = x[..., :self.d // 2], x[..., self.d // 2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)

    def _attention_block(self, q, k, v, a, lo, reach):
        """Queries q [b, heads, d] (rows a…) over keys k, v (rows lo…): the
        masked softmax's output [b, heads, d]."""
        s = self._mm(q.transpose(0, 1), k.permute(1, 2, 0)) \
            / math.sqrt(self.d)
        if reach >= 0:
            i = torch.arange(a, a + q.shape[0], device=q.device)[:, None]
            j = torch.arange(lo, lo + k.shape[0], device=q.device)[None, :]
            s = s.masked_fill((i - j).abs() > reach, float("-inf"))
        return self._mm(torch.softmax(s, -1),
                        v.transpose(0, 1)).transpose(0, 1)

    def _attention(self, q, k, v, reach):
        """Attention of one sequence's q, k, v [n, heads, d]: every key
        (reach −1) or those |i − j| ≤ reach."""
        n, out = q.shape[0], []
        for a in range(0, n, QUERY_BLOCK):
            b = min(n, a + QUERY_BLOCK)
            lo, hi = ((0, n) if reach < 0
                      else (max(0, a - reach), min(n, b + reach)))
            fn = functools.partial(self._attention_block, a=a, lo=lo,
                                   reach=reach)
            if torch.is_grad_enabled():
                out.append(checkpoint(fn, q[a:b], k[lo:hi], v[lo:hi],
                                      use_reentrant=False))
            else:
                out.append(fn(q[a:b], k[lo:hi], v[lo:hi]))
        return torch.cat(out)

    def _layer(self, P, i, x, tables):
        pre = f"bert.layers.{i}."
        n = x.shape[0]
        glob = i % self.every == 0
        a = x if i == 0 else self._ln(x, P[pre + "attn_norm.weight"])
        qkv = self._linear(a, P[pre + "attn.Wqkv.weight"]).reshape(
            n, 3, self.heads, self.d)
        table = tables[self.thetas[0 if glob else 1]]
        q = self._rope(qkv[:, 0], table)
        k = self._rope(qkv[:, 1], table)
        reach = -1 if glob or not self.window else self.reach
        att = self._attention(q, k, qkv[:, 2], reach)
        h = x + self._linear(att.reshape(n, self.h), P[pre + "attn.Wo.weight"])
        u, g = self._linear(self._ln(h, P[pre + "mlp_norm.weight"]),
                            P[pre + "mlp.Wi.weight"]).chunk(2, -1)
        return h + self._linear(F.gelu(u) * g, P[pre + "mlp.Wo.weight"])

    def _encode(self, P, docs: List[torch.Tensor]) -> torch.Tensor:
        """The head's output [len(docs), h] of the documents (token ids,
        framed): each its own sequence, or (separate=False) all one."""
        seqs = [[t] for t in docs] if self.separate else [docs]
        pooled = []
        for seq in seqs:
            ids = torch.cat(seq)
            pos = torch.cat([torch.arange(len(t), device=ids.device)
                             for t in seq])
            x = self._ln(P["bert.embeddings.tok_embeddings.weight"][ids],
                         P["bert.embeddings.norm.weight"])
            tables = self._tables(pos, x.dtype)
            for i in range(self.layers):
                if torch.is_grad_enabled() and not self.separate:
                    # a batch's pack: each layer recomputed in the backward
                    # pass, so that one layer's activations are held
                    x = checkpoint(self._layer, P, i, x, tables,
                                   use_reentrant=False)
                else:
                    x = self._layer(P, i, x, tables)
            x = self._ln(x, P["bert.final_norm.weight"])
            at = 0
            for t in seq:
                part = x[at:at + len(t)]
                pooled.append(part[0] if self.pooling == "cls"
                              else part.mean(0))
                at += len(t)
        p = torch.stack(pooled)
        return self._ln(F.gelu(self._linear(p, P["bert.head.dense.weight"])),
                        P["bert.head.norm.weight"])

    def scores(self, P, rows) -> torch.Tensor:
        """The tower's scores (without the offset) of `rows` (tokens and
        mask [n, 1, L], framed; indices and values [n, K])."""
        t, m = rows["tokens"][:, 0], rows["mask"][:, 0]
        lens = (m > 0).sum(1).clamp_min(1).tolist()
        e = self._encode(P, [t[r, :n] for r, n in enumerate(lens)])
        wide = (P["wide_w"][rows["indices"]]
                * rows["values"].to(self.dtype)).sum(-1)
        hid = torch.relu(self._linear(torch.cat([e, wide[:, None]], -1),
                                      P["hidden.weight"]) + P["hidden.bias"])
        return (self._linear(hid, P["logit.weight"]) + P["logit.bias"])[:, 0] \
            + wide

    def _loss_sum(self, P, rows):
        z = self.scores(P, rows) + rows["offsets"].to(self.dtype)
        return (rows["weights"].to(self.dtype)
                * _bce(z, rows["labels"].to(self.dtype))).sum()

    # -------------------------------------------------------- evaluations --

    @torch.no_grad()
    def mean_loss(self, P, rows, block: int = 16) -> float:
        """The mean weighted BCE over every row of `rows`."""
        n = rows["tokens"].shape[0]
        tot = sum(float(self._loss_sum(P, _cut(rows, slice(a, a + block))))
                  for a in range(0, n, block))
        return tot / n

    @torch.no_grad()
    def all_scores(self, P, rows, block: int = 16) -> torch.Tensor:
        n = rows["tokens"].shape[0]
        return torch.cat([self.scores(P, _cut(rows, slice(a, a + block)))
                          for a in range(0, n, block)])

    # ----------------------------------------------------------- training --

    def gradient(self, P, rows, idx):
        """(the batch's mean loss, its gradient by name) over the rows
        `idx`: a document at a time, or the whole batch packed where the
        documents are not separated."""
        names = list(P)
        leaves = [P[k].requires_grad_(True) for k in names]
        grads = [torch.zeros_like(p) for p in leaves]
        n, tot = len(idx), 0.0
        block = 1 if self.separate else n
        for a in range(0, n, block):
            loss = self._loss_sum(P, _cut(rows, idx[a:a + block])) / n
            for g, d in zip(grads, torch.autograd.grad(loss, leaves,
                                                       allow_unused=True)):
                if d is not None:       # a leaf the faults leave out
                    g += d
            tot += float(loss.detach())
        for p in leaves:
            p.requires_grad_(False)
        return tot, dict(zip(names, grads))

    def fit(self, state, rows, batches: List[torch.Tensor], lr: float,
            snapshots=()) -> Dict:
        """Adam from `state` over the batches of row indices, in order:
        {k: the parameters after k steps} for each k in `snapshots`, and
        under "gradient" the first step's gradient by name."""
        P = self.params(state)
        m = {k: torch.zeros_like(v) for k, v in P.items()}
        v2 = {k: torch.zeros_like(v) for k, v in P.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for t, idx in enumerate(batches, 1):
            _, G = self.gradient(P, rows, idx)
            if t == 1:
                out["gradient"] = {k: g.clone() for k, g in G.items()}
            with torch.no_grad():
                for k in P:
                    m[k].mul_(b1).add_(G[k], alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(G[k], G[k], value=1 - b2)
                    denom = v2[k].sqrt() / math.sqrt(1 - b2 ** t) + eps
                    P[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            del G
            if t in snapshots:
                out[t] = {k: p.clone() for k, p in P.items()}
        return out
