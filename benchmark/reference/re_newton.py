"""Plain per-entity logistic regression: every entity's regularised LR
problem solved by damped Newton, in blocks of entities, in plain PyTorch.

The problem is the one GDMix's random effects state (the mean form, whose
optimum is the sum form's): for each entity e with rows X_e (an intercept
column first, then the coordinate's whole feature bag), labels y, weights
w and offsets o,

    f(θ) = (Σᵢ wᵢ·bce(xᵢθ + oᵢ, yᵢ) + λ/2·θᵀMθ) / n_e,

with M the identity except a 0 on the intercept when the bias is not
regularised. A feature the entity never sees has a zero column, so the
penalty holds its coefficient at 0, as the program's per-entity support
leaves it out: one dense width serves every entity.

Newton steps with Armijo backtracking. The configuration's stopping rule
(a relative decrease of at most ftol, or a largest gradient entry of at
most pgtol) gives each entity's converged flag and the iterations its
solve needs; an entity with a finite optimum then runs on to it, to
rounding level, so that its θ is the optimum and not another place the
rule allows. An entity whose labels are all one value has no finite
optimum (its intercept grows without bound); its θ is where the rule stops
it, so the comparison judges such entities by their predicted
probabilities, not by θ.

`tf32=True` is the control: every operand of every product rounded to
TF32 (10 mantissa bits), sums kept in float32 — what a TF32 matrix product
does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.precision import tf32_round

_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 30


class EntitySolve(NamedTuple):
    theta: np.ndarray        # [E, 1 + width] float64, intercept first
    converged: np.ndarray    # [E] bool: the configuration's rule met
    iterations: np.ndarray   # [E] int64: the iterations the rule took
    mixed: np.ndarray        # [E] bool: both labels present (finite optimum)


def _bce(z, y):
    """Σ-ready binary cross-entropy of logits z against labels y."""
    return torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))


def _block(X, y, w, o, n, lam, mask, tight, maxiter, ftol, pgtol, tf32):
    """Newton over one block: X [B, m, d], y/w/o [B, m], n [B]. An entity
    with a finite optimum (`tight`) runs on past the configuration's rule
    until its gradient is at rounding level or no step decreases f; the
    others stop at the rule. Finished entities leave the batch once half
    of it has finished. Returns θ, whether the rule was met, and the
    iterations the rule took (maxiter where it never held)."""
    B, _, d = X.shape
    dev = X.device
    rnd = tf32_round if tf32 else (lambda t: t)
    g_tight = 1e-11 if X.dtype == torch.float64 else 0.0
    eye = torch.eye(d, dtype=X.dtype, device=dev)
    out_theta = torch.zeros(B, d, dtype=X.dtype, device=dev)
    out_conv = torch.zeros(B, dtype=torch.bool, device=dev)
    out_iters = torch.full((B,), maxiter, dtype=torch.int64, device=dev)
    pos = torch.arange(B, device=dev)          # live entities' places
    Xr = rnd(X)
    inv_n = 1.0 / n
    theta = torch.zeros(B, d, dtype=X.dtype, device=dev)

    def value(th):
        z = torch.einsum("bmd,bd->bm", Xr, rnd(th)) + o
        return ((w * _bce(z, y)).sum(1)
                + 0.5 * lam * (mask * th * th).sum(1)) * inv_n, z

    f, z = value(theta)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    conv = torch.zeros_like(done)
    iters = out_iters.clone()
    for k in range(maxiter):
        p = torch.sigmoid(z)
        r = w * (p - y)
        g = (torch.einsum("bmd,bm->bd", Xr, rnd(r))
             + lam * mask * theta) * inv_n[:, None]
        gmax = g.abs().amax(1)
        met = (gmax <= pgtol) & ~conv
        iters = torch.where(met, k, iters)
        conv |= met
        done |= (conv & ~tight) | (gmax <= g_tight)
        n_done = int(done.sum())
        if n_done == len(pos):
            break
        if 2 * n_done >= len(pos):             # compact the live ones
            out_theta[pos[done]] = theta[done]
            out_conv[pos[done]] = conv[done]
            out_iters[pos[done]] = iters[done]
            keep = torch.nonzero(~done)[:, 0]
            pos, Xr, y, w, o, inv_n, tight, theta, f, z, conv, iters, g, \
                p = (t[keep] for t in (pos, Xr, y, w, o, inv_n, tight,
                                       theta, f, z, conv, iters, g, p))
            done = torch.zeros(len(pos), dtype=torch.bool, device=dev)
        D = w * p * (1 - p)
        H = (torch.einsum("bmd,bme->bde", Xr, rnd(D[..., None] * Xr))
             + lam * torch.diag_embed(mask.expand(len(pos), d))) \
            * inv_n[:, None, None]
        L, info = torch.linalg.cholesky_ex(H + 1e-12 * eye)
        step = -torch.cholesky_solve(g[..., None], L)[..., 0]
        step = torch.where((info == 0)[:, None], step, -g)
        gd = (g * step).sum(1)
        t = torch.ones(len(pos), dtype=X.dtype, device=dev)
        accepted = torch.zeros_like(done)
        th_new, f_new, z_new = theta, f, z
        for _ in range(_MAX_BACKTRACKS):
            cand = theta + t[:, None] * step
            fc, zc = value(cand)
            ok = (fc <= f + _ARMIJO_C1 * t * gd) & ~accepted & ~done
            th_new = torch.where(ok[:, None], cand, th_new)
            f_new = torch.where(ok, fc, f_new)
            z_new = torch.where(ok[:, None], zc, z_new)
            accepted |= ok
            if bool((accepted | done).all()):
                break
            t = torch.where(accepted, t, 0.5 * t)
        live = ~done
        move = live & accepted
        rel = torch.maximum(torch.maximum(f.abs(), f_new.abs()),
                            torch.ones_like(f))
        met = move & (f - f_new <= ftol * rel) & ~conv
        iters = torch.where(met, k + 1, iters)
        conv |= met
        theta = torch.where(move[:, None], th_new, theta)
        f = torch.where(move, f_new, f)
        z = torch.where(move[:, None], z_new, z)
        done |= (conv & ~tight) | (live & ~accepted)
    out_theta[pos] = theta
    out_conv[pos] = conv
    out_iters[pos] = iters
    return out_theta, out_conv, out_iters


def solve_entities(counts, labels, offsets, indices, values, nnz,
                   width: int, *, lam: float, regularize_bias: bool,
                   maxiter: int, ftol: float, pgtol: float, device,
                   tf32: bool = False, block_rows: int = 1 << 22,
                   weights=None) -> EntitySolve:
    """Every entity's solve. Entities are taken in order of record count,
    in blocks of at most `block_rows` padded rows, each padded to its
    longest entity. Inputs are host arrays (the flat records, entity-major,
    `counts` a entity); float64 throughout unless `tf32`."""
    dtype = torch.float32 if tf32 else torch.float64
    counts = np.asarray(counts, np.int64)
    E, d = len(counts), width + 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(counts, kind="stable")
    labels = np.asarray(labels, np.float64)
    w_all = (np.ones(len(labels)) if weights is None
             else np.asarray(weights, np.float64))
    pos_any = np.add.reduceat(labels, starts) if E else np.zeros(0)
    mixed = (pos_any > 0) & (pos_any < counts)
    theta = np.zeros((E, d))
    conv = np.zeros(E, bool)
    iters = np.zeros(E, np.int64)
    mask = torch.ones(d, dtype=dtype, device=device)
    if not regularize_bias:
        mask[0] = 0.0
    K = indices.shape[1]
    sc = counts[order]
    a = 0
    while a < E:
        fits = np.arange(1, E - a + 1) * sc[a:] <= block_rows
        b = a + max(1, int(np.argmin(fits)) if not fits.all() else E - a)
        ents = order[a:b]
        m = int(counts[ents].max())
        B = len(ents)
        j = np.arange(m)
        live = j[None, :] < counts[ents][:, None]
        rows = np.where(live, starts[ents][:, None] + j[None, :], 0)
        # dense rows: intercept column 0, feature f at column 1 + f
        ent_nnz = np.where(live[..., None],
                           np.arange(K)[None, None, :]
                           < np.asarray(nnz)[rows][..., None], False)
        cols = 1 + np.asarray(indices)[rows].astype(np.int64)
        vals = np.where(ent_nnz, np.asarray(values)[rows], 0.0)
        X = torch.zeros(B, m, d, dtype=dtype, device=device)
        X.scatter_add_(2, torch.as_tensor(cols, device=device),
                       torch.as_tensor(vals, dtype=dtype, device=device))
        X[:, :, 0] = torch.as_tensor(live, dtype=dtype, device=device)
        lv = torch.as_tensor(live, dtype=dtype, device=device)
        y = torch.as_tensor(labels[rows], dtype=dtype, device=device) * lv
        w = torch.as_tensor(w_all[rows], dtype=dtype, device=device) * lv
        o = torch.as_tensor(np.asarray(offsets)[rows], dtype=dtype,
                            device=device) * lv
        n = torch.as_tensor(counts[ents], dtype=dtype, device=device)
        tight = torch.as_tensor(mixed[ents], device=device)
        th, cv, it = _block(X, y, w, o, n, lam, mask, tight, maxiter, ftol,
                            pgtol, tf32)
        theta[ents] = th.to("cpu", torch.float64).numpy()
        conv[ents] = cv.cpu().numpy()
        iters[ents] = it.cpu().numpy()
        a = b
    return EntitySolve(theta=theta, converged=conv, iterations=iters,
                       mixed=mixed)
