"""Plain DeText BERT tower: BERT's encoder (google-research/bert
modeling.py, BERT-Base's post-LN block), its pooler and the deep tower's
head, with the pointwise weighted BCE and Adam, in plain PyTorch:

    x⁰  = LN(word[t] + pos[i] + type[0])
    a   = LN(xˡ + Wo·softmax(QKᵀ/√d, keys masked)·V + bo)
    xˡ⁺¹ = LN(a + W2·gelu(W1·a + b1) + b2),   gelu(u) = u·Φ(u) (erf)
    p   = tanh(Wp·x[:, 0] + bp)
    s   = Wl·relu(Wh·[p, wide] + bh) + bl + wide,   wide = Σ_k w[id_k]·v_k
    loss = mean_i w_i·bce(s_i + o_i, y_i)

Attention is the two products and an explicit softmax over the whole
[B, heads, L, L] logits; a document with no tokens attends to every
position alike. The gradients come from autograd over row blocks, summed;
Adam is written out (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
corrected). Parameters are named as the program's state_dict names them.

Precisions: "float64" is the reference; "float32" a plain float32 one;
"tf32" and "bf16" are the controls, float32 throughout with every operand
of every matrix product (forward and backward) rounded to TF32, or to
bfloat16 with the products rounded too (what bfloat16 autocast does to a
product), the sums in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from benchmark.reference.precision import bf16_round, tf32_round

PRECISIONS = {"float64": (torch.float64, None),
              "float32": (torch.float32, None),
              "tf32": (torch.float32, tf32_round),
              "bf16": (torch.float32, bf16_round)}


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with the operands rounded by `rnd`, forward and backward, and
    the products too where `products` is set."""

    @staticmethod
    def forward(ctx, a, b, rnd, products):
        a, b = rnd(a), rnd(b)
        ctx.save_for_backward(a, b)
        ctx.rnd, ctx.products = rnd, products
        y = a @ b
        return rnd(y) if products else y

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = ctx.rnd(g)
        ga, gb = g @ b.mT, a.mT @ g
        if ctx.products:
            ga, gb = ctx.rnd(ga), ctx.rnd(gb)
        return ga, gb, None, None


def _trunc_normal(shape, sd, gen, device):
    t = torch.empty(shape, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, sd, -2 * sd, 2 * sd,
                                       generator=gen)


def initial_state(cfg: dict, hidden: int, wide: int, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """θ₀ of the tower of BERT config `cfg` with a head of `hidden` units
    over a `wide`-wide bag, float32 on `device`, drawn from `seed` there:
    BERT's initialiser (every embedding and kernel a normal of σ
    initializer_range cut at ±2σ, biases 0, LayerNorm scales 1 and offsets
    0), and the tower's head (LeCun-normal kernels over their fan-in, cut
    at ±2σ and scaled for a variance of 1/fan_in; biases and the wide
    weights 0)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    sd = cfg["initializer_range"]
    out = {}

    def dense(name, n_out, n_in, std):
        out[name + ".weight"] = _trunc_normal((n_out, n_in), std, gen,
                                              device)
        out[name + ".bias"] = torch.zeros(n_out, device=device)

    def norm(name):
        out[name + ".weight"] = torch.ones(h, device=device)
        out[name + ".bias"] = torch.zeros(h, device=device)
    for name, rows in (("word", cfg["vocab_size"]),
                       ("position", cfg["max_position_embeddings"]),
                       ("token_type", cfg["type_vocab_size"])):
        out[f"bert.{name}.weight"] = _trunc_normal((rows, h), sd, gen,
                                                   device)
    norm("bert.embed_norm")
    for i in range(cfg["num_hidden_layers"]):
        pre = f"bert.layers.{i}."
        for name in ("query", "key", "value", "attn_out"):
            dense(pre + name, h, h, sd)
        norm(pre + "attn_norm")
        dense(pre + "ff_in", inter, h, sd)
        dense(pre + "ff_out", h, inter, sd)
        norm(pre + "ff_norm")
    dense("bert.pooler", h, h, sd)
    out["wide_w"] = torch.zeros(wide, device=device)
    lecun = 1.0 / .87962566103423978     # a cut normal's σ for variance 1
    dense("hidden", hidden, h + 1, lecun / math.sqrt(h + 1))
    dense("logit", 1, hidden, lecun / math.sqrt(hidden))
    return out


def _bce(z, y):
    return torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))


class BertTower:
    """The tower of BERT config `cfg` (bert_config.json's keys) in
    `precision`. Faults for the control's readings: `mask_keys=False`
    attends to padding too; `layers` runs only the first that many
    blocks."""

    def __init__(self, cfg: dict, precision: str = "float64",
                 mask_keys: bool = True, layers: Optional[int] = None):
        self.h = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.eps = cfg.get("layer_norm_eps", 1e-12)
        self.layers = cfg["num_hidden_layers"] if layers is None else layers
        self.dtype, self.rnd = PRECISIONS[precision]
        self.products = precision == "bf16"
        self.mask_keys = mask_keys
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

    def _linear(self, x, w, b):
        y = self._mm(x.reshape(-1, x.shape[-1]), w.t())
        return y.reshape(*x.shape[:-1], w.shape[0]) + b

    def _ln(self, x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * g + b

    def _layer(self, P, i, x, ok):
        pre = f"bert.layers.{i}."
        bsz, length, h = x.shape
        d = h // self.heads

        def lin(t, name):
            return self._linear(t, P[pre + name + ".weight"],
                                P[pre + name + ".bias"])

        def split(t):
            return t.reshape(bsz, length, self.heads, d).transpose(1, 2)
        q, k, v = split(lin(x, "query")), split(lin(x, "key")), \
            split(lin(x, "value"))
        s = self._mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
        e = torch.exp(s - s.amax(-1, keepdim=True))
        o = self._mm(e / e.sum(-1, keepdim=True), v)
        o = o.transpose(1, 2).reshape(bsz, length, h)
        a = self._ln(x + lin(o, "attn_out"), P[pre + "attn_norm.weight"],
                     P[pre + "attn_norm.bias"])
        u = lin(a, "ff_in")
        f = lin(0.5 * u * (1.0 + torch.erf(u / math.sqrt(2.0))), "ff_out")
        return self._ln(a + f, P[pre + "ff_norm.weight"],
                        P[pre + "ff_norm.bias"])

    def scores(self, P, rows) -> torch.Tensor:
        """The tower's scores (without the offset) of `rows` (tokens and
        mask [n, 1, L], indices and values [n, K])."""
        t, m = rows["tokens"][:, 0], rows["mask"][:, 0]
        length = t.shape[1]
        x = (P["bert.word.weight"][t] + P["bert.position.weight"][:length]
             + P["bert.token_type.weight"][0])
        x = self._ln(x, P["bert.embed_norm.weight"],
                     P["bert.embed_norm.bias"])
        ok = m > 0
        ok = ok | ~ok.any(-1, keepdim=True)
        if not self.mask_keys:
            ok = torch.ones_like(ok)
        for i in range(self.layers):
            x = self._layer(P, i, x, ok)
        pooled = torch.tanh(self._linear(x[:, 0], P["bert.pooler.weight"],
                                         P["bert.pooler.bias"]))
        wide = (P["wide_w"][rows["indices"]]
                * rows["values"].to(self.dtype)).sum(-1)
        hid = torch.relu(self._linear(torch.cat([pooled, wide[:, None]], -1),
                                      P["hidden.weight"], P["hidden.bias"]))
        return self._linear(hid, P["logit.weight"], P["logit.bias"])[:, 0] \
            + wide

    def _loss_sum(self, P, rows):
        z = self.scores(P, rows) + rows["offsets"].to(self.dtype)
        return (rows["weights"].to(self.dtype)
                * _bce(z, rows["labels"].to(self.dtype))).sum()

    # -------------------------------------------------------- evaluations --

    @torch.no_grad()
    def mean_loss(self, P, rows, block: int = 256) -> float:
        """The mean weighted BCE over every row of `rows`."""
        n = rows["tokens"].shape[0]
        tot = sum(float(self._loss_sum(P, _cut(rows, slice(a, a + block))))
                  for a in range(0, n, block))
        return tot / n

    @torch.no_grad()
    def all_scores(self, P, rows, block: int = 256) -> torch.Tensor:
        n = rows["tokens"].shape[0]
        return torch.cat([self.scores(P, _cut(rows, slice(a, a + block)))
                          for a in range(0, n, block)])

    # ----------------------------------------------------------- training --

    def gradient(self, P, rows, idx, block: int):
        """(the batch's mean loss, its gradient by name) over the rows
        `idx`, in blocks of `block` rows."""
        names = list(P)
        leaves = [P[k].requires_grad_(True) for k in names]
        grads = [torch.zeros_like(p) for p in leaves]
        n, tot = len(idx), 0.0
        for a in range(0, n, block):
            loss = self._loss_sum(P, _cut(rows, idx[a:a + block])) / n
            for g, d in zip(grads, torch.autograd.grad(loss, leaves,
                                                       allow_unused=True)):
                if d is not None:       # a block the faults leave out
                    g += d
            tot += float(loss.detach())
        for p in leaves:
            p.requires_grad_(False)
        return tot, dict(zip(names, grads))

    def fit(self, state, rows, batches: List[torch.Tensor], lr: float,
            snapshots=(), block: int = 64) -> Dict:
        """Adam from `state` over the batches of row indices, in order:
        {k: the parameters after k steps} for each k in `snapshots`, and
        under "gradient" the first step's gradient by name."""
        P = self.params(state)
        m = {k: torch.zeros_like(v) for k, v in P.items()}
        v2 = {k: torch.zeros_like(v) for k, v in P.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for t, idx in enumerate(batches, 1):
            _, G = self.gradient(P, rows, idx, block)
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


def _cut(rows, at):
    return {k: v[at] for k, v in rows.items()}
