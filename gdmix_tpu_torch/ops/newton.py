"""Batched damped Newton for per-entity logistic regression (primal).

Port of gdmix_tpu/ops/newton.py:newton_lr_batch and densify_bucket.
Objective (the reference's MEAN form): f(θ) = (Σ wᵢ·bce(zᵢ) + λ/2·θᵀMθ)/n
with z = Xθ + offset and M the bias-exclusion mask.

Dispatch, as in the JAX package: float32 on a card with dim ≤ 64 and a
static mask layout goes to the fused kernels of ops/newton_lanes.py; every
other case runs the batch-major loop here, whose linear solve is the
hand-written kernel of ops/linsolve.py on a card and a Cholesky solve on
the CPU (the JAX package's non-TPU solve).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gdmix_tpu_torch.ops.linsolve import spd_solve_batched
from gdmix_tpu_torch.ops.newton_lanes import MAX_DIM, newton_lr_batch_lanes

_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 20
_Z_REFRESH = 16   # iterations between exact recomputations of z = Xθ + off


class NewtonResult(NamedTuple):
    theta: torch.Tensor           # [B, dim]
    converged: torch.Tensor       # [B] bool
    num_iterations: torch.Tensor  # [B] int32


def _cholesky_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0]


def newton_lr_batch(theta0: torch.Tensor,
                    X: torch.Tensor,
                    labels: torch.Tensor,
                    weights: torch.Tensor,
                    offsets: torch.Tensor,
                    counts: torch.Tensor,
                    *,
                    l2_reg_weight: float,
                    l2_mask: torch.Tensor,
                    maxiter: int = 50,
                    ftol: float = 1e-12,
                    pgtol: float = 1e-5,
                    dual: bool = False,
                    static_unreg_bias: Optional[bool] = None) -> NewtonResult:
    """Minimize the per-entity LR objective for a whole bucket at once.

    theta0 [B, dim]; X [B, n, dim] (dense, intercept column included by the
    caller); labels/weights/offsets [B, n] (padding rows have weight 0);
    counts [B] true sample counts; l2_mask [dim] (0 on an unregularized
    intercept). `static_unreg_bias` states the mask layout for the fused
    kernels (True: a 0 at coordinate 0 only; False: all ones)."""
    if dual:
        raise NotImplementedError("ROADMAP A.3: dual Newton")
    dtype = theta0.dtype
    B, n, dim = X.shape
    if (static_unreg_bias is not None and dtype == torch.float32
            and X.device.type == "cuda" and dim <= MAX_DIM):
        return newton_lr_batch_lanes(
            theta0, X, labels, weights, offsets, counts,
            l2_reg_weight=float(l2_reg_weight), unreg_bias=static_unreg_bias,
            maxiter=maxiter, ftol=ftol, pgtol=pgtol)

    lam = float(l2_reg_weight)
    mask = l2_mask.to(dtype)
    inv_n = 1.0 / torch.clamp_min(counts.to(dtype), 1.0)           # [B]
    eps = 1e-10 if dtype == torch.float64 else 1e-6
    solve = spd_solve_batched if X.device.type == "cuda" else _cholesky_solve

    # z = Xθ + offset is carried and updated incrementally (z − step·Xδ), so
    # X is read once per line search, not once per trial
    def f_from_z(z, theta):
        bce = torch.clamp_min(z, 0) - z * labels \
            + torch.log1p(torch.exp(-z.abs()))
        reg = 0.5 * lam * torch.sum(mask * theta * theta, dim=1)
        return (torch.sum(weights * bce, dim=1) + reg) * inv_n

    def grad_from_z(z, theta):
        r = weights * (torch.sigmoid(z) - labels)
        return (torch.einsum("bnd,bn->bd", X, r) + lam * mask * theta) \
            * inv_n[:, None]

    def delta_of(g, p):
        d = weights * p * (1 - p)
        H = (torch.einsum("bnd,bne->bde", X, X * d[:, :, None])
             + lam * torch.diag(mask)) * inv_n[:, None, None]
        # Levenberg damping keeps padded/degenerate lanes solvable
        damp = eps * (1.0 + torch.diagonal(H, dim1=1, dim2=2).abs())
        return solve((H + torch.diag_embed(damp)).contiguous(),
                     g.contiguous())

    theta = theta0
    z = torch.einsum("bnd,bd->bn", X, theta0) + offsets
    f = f_from_z(z, theta)
    g = grad_from_z(z, theta)
    done = g.abs().amax(dim=1) <= pgtol
    iters = torch.zeros(B, dtype=torch.int32, device=X.device)
    k = 0
    while k < maxiter and not bool(done.all()):
        delta = delta_of(g, torch.sigmoid(z))
        gdot = torch.sum(g * delta, dim=1)
        zdelta = torch.einsum("bnd,bd->bn", X, delta)
        step = torch.ones_like(f)
        accepted = torch.zeros_like(done)
        f_new = f
        i = 0
        while i < _MAX_BACKTRACKS and not bool((accepted | done).all()):
            f_trial = f_from_z(z - step[:, None] * zdelta,
                               theta - step[:, None] * delta)
            ok = f_trial <= f - _ARMIJO_C1 * step * gdot
            newly = ok & ~accepted
            f_new = torch.where(newly, f_trial, f_new)
            step = torch.where(accepted | newly, step, step * 0.5)
            accepted = accepted | newly
            i += 1
        move = accepted & ~done
        theta = torch.where(move[:, None], theta - step[:, None] * delta,
                            theta)
        z = torch.where(move[:, None], z - step[:, None] * zdelta, z)
        if (k + 1) % _Z_REFRESH == 0:
            # bound the drift of the incremental margins
            z = torch.einsum("bnd,bd->bn", X, theta) + offsets
        f_next = torch.where(move, f_new, f)
        g = grad_from_z(z, theta)
        gmax = g.abs().amax(dim=1)
        rel = torch.clamp_min(torch.maximum(f.abs(), f_next.abs()), 1.0)
        conv = (gmax <= pgtol) | (f - f_next <= ftol * rel)
        iters = torch.where(done, iters, iters + 1)
        # a lane that can't backtrack any decrease is finished too
        done = done | conv | ~accepted
        f = f_next
        k += 1
    return NewtonResult(theta=theta, converged=done, num_iterations=iters)


def densify_bucket(indices: torch.Tensor, values: torch.Tensor, u_cap: int,
                   has_intercept: bool) -> torch.Tensor:
    """Padded-COO bucket [B, n, K] → dense [B, n, dim] with the intercept
    column FIRST. A scatter-add: duplicate entry indices accumulate (the
    JAX package builds the same sum from one-hots only to keep XLA's
    compile time down)."""
    B, n, K = indices.shape
    off = 1 if has_intercept else 0
    X = torch.zeros((B, n, u_cap + off), dtype=values.dtype,
                    device=values.device)
    X.scatter_add_(2, indices.long() + off, values)
    if has_intercept:
        X[:, :, 0] = 1.0
    return X
