"""Attention over packed documents of different lengths (csrc/varlen_attention.cu).

q, k and v are the packed rows [T, heads, d] of a batch's documents,
document b owning rows [offsets[b], offsets[b + 1]); a query attends to the
keys of its own document only, all of them (`window` −1) or those at most
`window` positions away (|i − j| ≤ window), with the logits scaled by
1/√d. Nothing is padded and no pair of positions from two documents is
computed.

The forward pass gives O and each row's log-sum-exp of its scaled logits
(natural log, [T, heads]), which the backward pass reads in place of the
softmax. On a card both directions are hand-written kernels (d = 64,
float32): FlashAttention-2's tiling with an online softmax forward, and a
backward of three kernels — D = rowsum(dO ⊙ O), dK and dV over key tiles,
dQ over query tiles — with no atomics, so that a step repeats bit for bit.
On a CPU tensor the plain versions below compute the same functions a
document at a time. `varlen_attention` is the autograd Function the
ModernBERT encoder calls; its backward is the span
`tower.attention_grad.full` or `tower.attention_grad.window`.

Replaces no TPU kernel: the JAX package has no ModernBERT encoder, and its
attention encoders run outside any Pallas kernel. Each wrapper counts its
launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.util.timing import span

# the kernels' head size and tile (kD, kTile in csrc/varlen_attention.cu)
HEAD_DIM = 64
TILE = 64
# queries a block of the plain versions (bounds their [heads, block, keys]
# logits)
_PLAIN_BLOCK = 1024


def _key_range(a: int, b: int, n: int, window: int) -> Tuple[int, int]:
    """The keys [lo, hi) that queries [a, b) of an n-row document can see."""
    if window < 0:
        return 0, n
    return max(0, a - window), min(n, b + window)


def _block_logits(q, k, a, lo, window):
    """The scaled logits [heads, queries, keys] of queries q (rows a… of a
    document) over keys k (rows lo…), −∞ outside the window."""
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    if window >= 0:
        i = torch.arange(a, a + q.shape[0], device=q.device)[:, None]
        j = torch.arange(lo, lo + k.shape[0], device=q.device)[None, :]
        s = s.masked_fill((i - j).abs() > window, float("-inf"))
    return s


def _docs(offsets: torch.Tensor) -> List[Tuple[int, int]]:
    o = offsets.tolist()
    return list(zip(o[:-1], o[1:]))


def varlen_attention_forward_plain(q, k, v, offsets, window: int):
    """(O [T, heads, d], log-sum-exp [T, heads]): the masked softmax of each
    document's own rows, in blocks of queries."""
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:2], dtype=q.dtype, device=q.device)
    for s0, e0 in _docs(offsets):
        n = e0 - s0
        for a in range(0, n, _PLAIN_BLOCK):
            b = min(n, a + _PLAIN_BLOCK)
            lo, hi = _key_range(a, b, n, window)
            s = _block_logits(q[s0 + a:s0 + b], k[s0 + lo:s0 + hi], a, lo,
                              window)
            m = torch.logsumexp(s, -1)                       # [heads, q]
            lse[s0 + a:s0 + b] = m.t()
            o[s0 + a:s0 + b] = torch.einsum(
                "hqk,khd->qhd", torch.exp(s - m[:, :, None]),
                v[s0 + lo:s0 + hi])
    return o, lse


def varlen_attention_backward_plain(q, k, v, o, lse, do, offsets,
                                    window: int):
    """(dQ, dK, dV) of the forward's O against the gradient dO, from its
    log-sum-exp: dS = P ⊙ (dO·Vᵀ − D), D = rowsum(dO ⊙ O)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq, dk, dv = (torch.zeros_like(q), torch.zeros_like(k),
                  torch.zeros_like(v))
    delta = (do * o).sum(-1)                                  # [T, heads]
    for s0, e0 in _docs(offsets):
        n = e0 - s0
        for a in range(0, n, _PLAIN_BLOCK):
            b = min(n, a + _PLAIN_BLOCK)
            lo, hi = _key_range(a, b, n, window)
            qa, ka, va = (q[s0 + a:s0 + b], k[s0 + lo:s0 + hi],
                          v[s0 + lo:s0 + hi])
            p = torch.exp(_block_logits(qa, ka, a, lo, window)
                          - lse[s0 + a:s0 + b].t()[:, :, None])
            doa = do[s0 + a:s0 + b]
            dp = torch.einsum("qhd,khd->hqk", doa, va)
            ds = p * (dp - delta[s0 + a:s0 + b].t()[:, :, None]) * scale
            dv[s0 + lo:s0 + hi] += torch.einsum("hqk,qhd->khd", p, doa)
            dk[s0 + lo:s0 + hi] += torch.einsum("hqk,qhd->khd", ds, qa)
            dq[s0 + a:s0 + b] = torch.einsum("hqk,khd->qhd", ds, ka)
    return dq, dk, dv


def _library():
    """The library, its entry points typed once, at its first use."""
    lib = _cuda.load("varlen_attention")
    if not getattr(lib, "_gdx_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gdx_varlen_attention_forward.argtypes = [P, P, P, P, I, I, I, I,
                                                     P, P, P]
        lib.gdx_varlen_attention_backward.argtypes = [P] * 7 + [I, I, I, I,
                                                                L] + [P] * 5
        for fn in (lib.gdx_varlen_attention_forward,
                   lib.gdx_varlen_attention_backward):
            fn.restype = I
        for name in ("gdx_varlen_attention_head_dim",
                     "gdx_varlen_attention_tile"):
            getattr(lib, name).restype = I
        shape = (lib.gdx_varlen_attention_head_dim(),
                 lib.gdx_varlen_attention_tile())
        if shape != (HEAD_DIM, TILE):
            raise RuntimeError(f"varlen_attention: the library's (head, "
                               f"tile) {shape} is not the wrapper's "
                               f"{(HEAD_DIM, TILE)}")
        lib._gdx_typed = True
    return lib


def _check_args(what, tensors, offsets):
    q = tensors[0]
    _cuda.require_cuda(what, *tensors)
    _cuda.require_cuda(what, offsets, dtypes=(torch.int32,))
    if q.dim() != 3 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{what}: q, k, v must be [T, heads, {HEAD_DIM}]; "
                         f"got {tuple(q.shape)}")
    if any(t.shape[:2] != q.shape[:2] for t in tensors[1:]):
        raise ValueError(f"{what}: the tensors' [T, heads] differ")
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"{what}: offsets must be [B + 1]")


def varlen_attention_forward(q, k, v, offsets, longest: int, window: int):
    """(O, log-sum-exp) of packed q, k, v [T, heads, d] over the documents
    of `offsets` [B + 1] (int32, on q's device); `longest` bounds every
    document's length (the kernel's grid); `window` −1 (whole documents)
    or ≥ 0. On a CPU tensor the plain version."""
    if q.device.type == "cpu":
        return varlen_attention_forward_plain(q, k, v, offsets, window)
    what = "varlen_attention_forward"
    _check_args(what, (q, k, v), offsets)
    T, heads, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(T, heads, dtype=q.dtype, device=q.device)
    if T == 0:
        return o, lse
    lib = _library()
    with _cuda.on_card(q) as stream:
        err = lib.gdx_varlen_attention_forward(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(offsets),
            offsets.shape[0] - 1, heads, int(longest), int(window),
            _cuda.ptr(o), _cuda.ptr(lse), stream)
    _cuda.check(lib, err, what)
    varlen_attention_forward.launches += 1
    return o, lse


varlen_attention_forward.launches = 0


def varlen_attention_backward(q, k, v, o, lse, do, offsets, longest: int,
                              window: int):
    """(dQ, dK, dV) of varlen_attention_forward's O against dO. On a CPU
    tensor the plain version."""
    if q.device.type == "cpu":
        return varlen_attention_backward_plain(q, k, v, o, lse, do, offsets,
                                               window)
    what = "varlen_attention_backward"
    _check_args(what, (q, k, v, o, lse, do), offsets)
    T, heads, _ = q.shape
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if T == 0:
        return dq, dk, dv
    delta = torch.empty(T, heads, dtype=q.dtype, device=q.device)
    lib = _library()
    with _cuda.on_card(q) as stream:
        err = lib.gdx_varlen_attention_backward(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
            _cuda.ptr(lse), _cuda.ptr(do), _cuda.ptr(offsets),
            offsets.shape[0] - 1, heads, int(longest), int(window), T,
            _cuda.ptr(delta), _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv),
            stream)
    _cuda.check(lib, err, what)
    varlen_attention_backward.launches += 1
    return dq, dk, dv


varlen_attention_backward.launches = 0


class _VarlenAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, offsets, longest, window):
        o, lse = varlen_attention_forward(q, k, v, offsets, longest, window)
        ctx.save_for_backward(q, k, v, o, lse, offsets)
        ctx.longest, ctx.window = longest, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, offsets = ctx.saved_tensors
        kind = "full" if ctx.window < 0 else "window"
        with span(f"tower.attention_grad.{kind}"):
            dq, dk, dv = varlen_attention_backward(
                q, k, v, o, lse, do.contiguous(), offsets, ctx.longest,
                ctx.window)
        return dq, dk, dv, None, None, None


def varlen_attention(q, k, v, offsets, longest: int, window: int):
    """O [T, heads, d] of packed, contiguous q, k, v over the documents of
    `offsets`, differentiable in q, k and v (see the module's doc)."""
    return _VarlenAttention.apply(q, k, v, offsets, longest, window)
