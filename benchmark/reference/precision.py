"""The controls' precisions: float32 operands rounded to the format a
tempting lower-precision path would read, by round-to-nearest-even on the
bits float32 has beyond it. TF32 (8 exponent bits, 10 mantissa bits) is
what the tensor cores read when TF32 is on: the step below float32 for a
matrix product. bfloat16 (7 mantissa bits) is the step below float32 for
work that is no matrix product (a gather, a scatter, a per-row sum):
values and coefficients stored in half the bytes."""
from __future__ import annotations

import torch


def _round(t: torch.Tensor, drop: int) -> torch.Tensor:
    x = t.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    lsb = (bits >> drop) & 1
    half = (1 << (drop - 1)) - 1
    bits = (bits + half + lsb) & ~((1 << drop) - 1)
    return bits.view(torch.float32)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, rounded to the nearest TF32 value."""
    return _round(t, 13)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, rounded to the nearest bfloat16 value."""
    return _round(t, 16)
