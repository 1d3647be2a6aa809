"""The BERT tower's counted work, from its documents' real lengths: rows
whose lengths (the key mask's sum: [CLS], the tokens, [SEP]) are `lens`,
through `layers` post-LN blocks of width h and FFN width `inter`. Padding
is not counted: the encoder computes it, but no answer needs it, so a
path that skips it reads no more than 100% of its roofline.

A block's products are 2·(4·h² + 2·h·inter) FLOPs a real position (Q, K,
V and the output projection; the FFN's two) and attention's 4·len·h a
real position (QKᵀ and PV over the row's real keys, so 4·len²·h a row);
the pooler 2·h² a row and the head 2·(h + 1)·hidden + 2·hidden. The
backward pass costs twice the forward, so a step is three forwards. The
norms, softmax, GELU and Adam's elementwise work are not counted as FLOPs.
"""
from __future__ import annotations

import numpy as np


def _sums(lens):
    """(rows, Σ len, Σ len²) of `lens`."""
    n = np.asarray(lens, dtype=np.float64).reshape(-1)
    return len(n), float(n.sum()), float((n * n).sum())


def forward_flops(lens, h: int, inter: int, layers: int,
                  hidden: int) -> float:
    """One forward pass over rows of real lengths `lens`."""
    rows, tokens, sq = _sums(lens)
    per_row = 2.0 * h * h + 2.0 * (h + 1) * hidden + 2.0 * hidden
    return (layers * (2.0 * (4 * h * h + 2 * h * inter) * tokens
                      + 4.0 * h * sq)
            + rows * per_row)


def step_flops(lens, h: int, inter: int, layers: int, hidden: int) -> float:
    """One Adam step over a batch of rows of real lengths `lens`: forward
    and backward."""
    return 3.0 * forward_flops(lens, h, inter, layers, hidden)


def step_bytes(params: int, lens, k: int, item: int = 4) -> float:
    """The bytes one step must move, each read or written once: the
    parameters and Adam's two moments read and written; the batch's real
    positions' token ids (int64) and mask; each row's wide ids (int64) and
    values, label, weight and offset."""
    rows, tokens, _ = _sums(lens)
    return (6.0 * params * item + tokens * (8 + item)
            + rows * (k * (8 + item) + 3 * item))


def attention_flops(lens, h: int, layers: int) -> float:
    """The forward attention calls (QKᵀ and PV) of rows of real lengths
    `lens`."""
    _, _, sq = _sums(lens)
    return 4.0 * layers * h * sq


def attention_bytes(lens, h: int, layers: int, item: int = 4) -> float:
    """Their bytes: Q, K and V of the real positions read and their output
    written once, and the key mask (a byte a real key) read."""
    _, tokens, _ = _sums(lens)
    return layers * tokens * (4.0 * h * item + 1)
