"""The benchmark's traffic generators: every input a cell runs, made from
the run's seed.

Frozen copies, so that the yardstick does not move with the program:
`draws` and `fe_ids` are copies of gdmix_tpu_torch/bench.py's `_draws` and
`fe_ids` (the JAX bench's draws). The tests hold each copy to its original
at a small size.

A seed may be any whole number up to a little over 2**31 and beyond 32
bits: `seed32` folds it into the 32 bits numpy's RandomState takes, and
torch generators take it as it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


def seed32(seed: int, stream: int = 0) -> int:
    """A 32-bit seed for stream `stream` of the run seed `seed`."""
    return int(np.random.SeedSequence([int(seed), int(stream)])
               .generate_state(1)[0])


def pareto_counts(rng: np.random.RandomState, n: int, pareto_a: float,
                  lo: int, hi: int) -> np.ndarray:
    """Records per entity: pareto(a)·8 + lo, clipped to [lo, hi]: the JAX
    bench's first draw."""
    return np.clip((rng.pareto(pareto_a, n) * 8 + lo).astype(int), lo, hi)


def draws(num_entities, seed, d, max_nnz, count_lo, count_hi, pareto_a):
    """Copy of gdmix_tpu_torch/bench.py `_draws` (the JAX bench's draws, in
    its order)."""
    rng = np.random.RandomState(seed)
    counts = pareto_counts(rng, num_entities, pareto_a, count_lo, count_hi)
    total = int(counts.sum())
    idx_all = rng.randint(0, d, size=(total, max_nnz)).astype(np.int32)
    val_all = rng.randn(total, max_nnz)
    nnz_all = rng.randint(1, max_nnz + 1, size=total).astype(np.int32)
    mask = np.arange(max_nnz)[None, :] < nnz_all[:, None]
    val_all = val_all * mask
    w_true = np.repeat(rng.randn(num_entities), counts)
    z = val_all.sum(1) * 0.5 + w_true
    y_all = (rng.rand(total) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return rng, counts, idx_all, val_all, nnz_all, y_all


def fe_ids(u: torch.Tensor, d: int, zipf_s: float) -> torch.Tensor:
    """Copy of gdmix_tpu_torch/bench.py `fe_ids`: ids on [0, d) from
    uniforms `u` in (0, 1), log-uniform for s = 1, Zipf(s) on [1, d]
    shifted to 0 otherwise (id 0 the most frequent)."""
    if zipf_s == 1.0:
        ids = torch.exp(u * float(np.log(float(d)))).to(torch.int32) - 1
    else:
        a = 1.0 - zipf_s
        ids = ((1.0 + u * (float(d) ** a - 1.0)) ** (1.0 / a)
               ).to(torch.int32) - 1
    return ids.clamp_(0, d - 1)


def _distinct3(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """[n, 3] ids on [0, k), distinct within a row, each row a uniform
    draw without replacement."""
    a = rng.integers(0, k, n)
    b = rng.integers(0, k - 1, n)
    b = b + (b >= a)
    c = rng.integers(0, k - 2, n)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    c = c + (c >= lo)
    c = c + (c >= hi)
    return np.stack([a, b, c], 1)


def movie_bag(rng: np.random.Generator, n: int, genres: int,
              genres_lo: int, genres_hi: int, year_lo: float,
              year_hi: float):
    """The per-user bag of `n` ratings (a movie's features): genres_lo to
    genres_hi distinct genres of `genres`, value 1, then the release date
    at id `genres` with a value uniform on [year_lo, year_hi): indices and
    values [n, genres_hi + 1] padded with id 0, value 0, and the nonzeros
    of each row."""
    k = genres_hi + 1
    ng = rng.integers(genres_lo, genres_hi + 1, n)
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float64)
    g = _distinct3(rng, n, genres)[:, :genres_hi]
    on = np.arange(genres_hi)[None, :] < ng[:, None]
    idx[:, :genres_hi] = np.where(on, g, 0)
    val[:, :genres_hi] = on
    rows = np.arange(n)
    idx[rows, ng] = genres
    val[rows, ng] = rng.uniform(year_lo, year_hi, n)
    return idx, val, (ng + 1).astype(np.int32)


@dataclass
class Fleet:
    """A per-entity RE partition in columnar form (FlatGroups' fields)."""
    counts: np.ndarray        # [E] records per entity
    labels: np.ndarray        # [N] 0/1
    offsets: np.ndarray       # [N]
    indices: np.ndarray       # [N, K] int32, padded with 0
    values: np.ndarray        # [N, K], padded with 0
    nnz: np.ndarray           # [N]


def re_fleet(t: Dict, width: int, seed: int) -> Fleet:
    """The light-user fleet of a per-user coordinate: t["entities"] users,
    ratings a user by the JAX bench's primary count draw, each rating the
    movie bag (`movie_bag`), labels Bernoulli from planted effects (a user
    bias N(0, user_sd²), genre and release-date effects N(0,
    effect_sd²)), offsets offset_sd·N(0, 1) standing in for the earlier
    coordinates' scores."""
    genres = width - 1
    counts = pareto_counts(np.random.RandomState(seed32(seed, 1)),
                           t["entities"], t["pareto_a"], t["count_lo"],
                           t["count_hi"])
    rng = np.random.default_rng(seed32(seed, 2))
    n = int(counts.sum())
    idx, val, nnz = movie_bag(rng, n, genres, t["genres_lo"],
                              t["genres_hi"], t["year_lo"], t["year_hi"])
    effect = rng.normal(0.0, t["effect_sd"], width)
    bias = np.repeat(rng.normal(0.0, t["user_sd"], len(counts)), counts)
    offsets = t["offset_sd"] * rng.standard_normal(n)
    z = (effect[idx] * val).sum(1) + bias + offsets
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return Fleet(counts=counts.astype(np.int64), labels=labels,
                 offsets=offsets, indices=idx, values=val, nnz=nnz)


@dataclass
class WideBatch:
    """A fixed-effect batch on the device (SparseBatch's fields)."""
    indices: torch.Tensor     # [N, K] int32
    values: torch.Tensor      # [N, K]
    offsets: torch.Tensor     # [N]
    labels: torch.Tensor      # [N]
    weights: torch.Tensor     # [N]


def criteo_rows(t: Dict, width: int, seed: int, device,
                dtype=torch.float32) -> WideBatch:
    """Criteo-shaped rows on the device: t["numeric"] numeric fields at
    the fixed ids 0.. with log-normal values exp(lognormal_sigma·N(0, 1)),
    then t["categorical"] fields with value 1 and Zipf(t["zipf_s"]) ids
    over the other width − numeric ids, each row then scaled to unit
    length (as LIBSVM's criteo rows are); labels Bernoulli(σ(z)) from
    planted weights N(0, effect_sd²) and the intercept t["intercept"];
    offsets 0, weights 1. Made in blocks of t["block_rows"] rows from one
    generator on the card, so that no block's float64 uniforms outgrow a
    few GB."""
    n, nn, nc = t["rows"], t["numeric"], t["categorical"]
    k = nn + nc
    g = torch.Generator(device=device).manual_seed(int(seed))
    w_true = torch.randn(width, generator=g, device=device,
                         dtype=torch.float32) * t["effect_sd"]
    idx = torch.empty(n, k, dtype=torch.int32, device=device)
    val = torch.empty(n, k, dtype=dtype, device=device)
    labels = torch.empty(n, dtype=dtype, device=device)
    idx[:, :nn] = torch.arange(nn, dtype=torch.int32, device=device)
    step = int(t["block_rows"])
    for a in range(0, n, step):
        b = min(n, a + step)
        v = torch.randn(b - a, nn, generator=g, device=device,
                        dtype=torch.float32)
        v = torch.cat([torch.exp(v * t["lognormal_sigma"]),
                       torch.ones(b - a, nc, device=device)], 1)
        val[a:b] = (v / torch.linalg.vector_norm(v, dim=1,
                                                 keepdim=True)).to(dtype)
        u = torch.empty(b - a, nc, dtype=torch.float64, device=device) \
            .uniform_(1e-7, 1.0, generator=g)
        idx[a:b, nn:] = fe_ids(u, width - nn, t["zipf_s"]) + nn
        del u, v
        z = (w_true[idx[a:b].long()] * val[a:b].float()).sum(1) \
            + t["intercept"]
        labels[a:b] = (torch.rand(b - a, generator=g, device=device)
                       < torch.sigmoid(z)).to(dtype)
    return WideBatch(indices=idx, values=val,
                     offsets=torch.zeros(n, dtype=dtype, device=device),
                     labels=labels,
                     weights=torch.ones(n, dtype=dtype, device=device))

