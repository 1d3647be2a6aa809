"""The ModernBERT tower's counted work, from its documents' own lengths
(the mask's sum: [CLS], the tokens, [SEP]; never the program's counts):
`layers` pre-LN blocks of width h, GeGLU width `inter` and `heads` heads of
d = h / heads, every `every`-th layer global (each query attends to its
whole document) and the others local (keys |i − j| ≤ reach).

A block's products are 2·(3h² + h² + 2h·inter + inter·h) FLOPs a position
(Wqkv, Wo, Wi and the MLP's Wo); attention's 4·d·heads FLOPs a computed
query-key pair forward (Q·Kᵀ and P·V), and 2.5 times that backward (dV,
dP, dQ, dK and S again, as FlashAttention-2 counts it); the classifier
head 2·h² a row and the tower's head 2·(h + 1)·hidden + 2·hidden. A
product's backward costs twice its forward. Norms, RoPE, GELU, softmax and
Adam's elementwise work are not counted as FLOPs. Attention moves Q, K, V
and O once forward, and Q, K, V, O, dO, dQ, dK and dV once backward.
"""
from __future__ import annotations

import numpy as np

from benchmark.costs.tower import step_bytes  # noqa: F401  (the step's bytes)


def pairs(lens, reach: int) -> float:
    """Query-key pairs of documents of `lens`: every pair (reach < 0), or
    those |i − j| ≤ reach: n² where n ≤ reach, else n·(2·reach + 1) −
    reach·(reach + 1) (each edge's first reach rows miss 1…reach keys)."""
    n = np.asarray(lens, dtype=np.float64).reshape(-1)
    if reach < 0:
        return float((n * n).sum())
    w = float(reach)
    return float(np.where(n <= w, n * n, n * (2 * w + 1) - w * (w + 1))
                 .sum())


def _kinds(cfg: dict):
    """(global layers, local layers, the local reach) of `cfg`."""
    layers = cfg["num_hidden_layers"]
    n_global = len(range(0, layers, cfg["global_attn_every_n_layers"]))
    return n_global, layers - n_global, cfg["local_attention"] // 2


def attention_call(lens, heads: int, d: int, reach: int,
                   backward: bool = False):
    """(FLOPs, bytes) of one attention call over documents of `lens`
    (reach < 0: whole documents), float32: its forward, or its
    backward."""
    tokens = float(np.asarray(lens, dtype=np.float64).sum())
    flops = 4.0 * d * heads * pairs(lens, reach)
    nbytes = 4 * tokens * heads * d * 4.0          # Q, K, V, O
    return (2.5 * flops, 2 * nbytes) if backward else (flops, nbytes)


def _calls(cfg: dict, kind: str):
    """(the calls of `kind` a forward pass, heads, d, reach)."""
    n_global, n_local, reach = _kinds(cfg)
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    if kind == "full":
        return n_global, heads, d, -1
    return n_local, heads, d, reach


def attention_forward(lens, cfg: dict, kind: str):
    """(FLOPs, bytes) of one forward pass's attention calls of `kind`
    ("full": the global layers; "window": the local ones) over documents
    of `lens`."""
    count, *shape = _calls(cfg, kind)
    flops, nbytes = attention_call(lens, *shape)
    return count * flops, count * nbytes


def attention_step(lens, cfg: dict, kind: str):
    """(FLOPs, bytes) of one Adam step's attention calls of `kind`, forward
    and backward."""
    count, *shape = _calls(cfg, kind)
    (f, b), (fb, bb) = (attention_call(lens, *shape),
                        attention_call(lens, *shape, backward=True))
    return count * (f + fb), count * (b + bb)


def forward_flops(lens, cfg: dict, hidden: int) -> float:
    """One forward pass over documents of `lens`."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    n = np.asarray(lens, dtype=np.float64).reshape(-1)
    gemm = (cfg["num_hidden_layers"] * 2.0 * (4 * h * h + 3 * h * inter)
            * float(n.sum()))
    head = len(n) * (2.0 * h * h + 2.0 * (h + 1) * hidden + 2.0 * hidden)
    return (gemm + head + attention_forward(n, cfg, "full")[0]
            + attention_forward(n, cfg, "window")[0])


def step_flops(lens, cfg: dict, hidden: int) -> float:
    """One Adam step over documents of `lens`: its products three times
    their forward, its attention 3.5 times."""
    attn = (attention_forward(lens, cfg, "full")[0]
            + attention_forward(lens, cfg, "window")[0])
    return 3.0 * (forward_flops(lens, cfg, hidden) - attn) + 3.5 * attn
