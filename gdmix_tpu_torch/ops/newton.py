"""Batched damped Newton for per-entity logistic regression.

Port of gdmix_tpu/ops/newton.py: newton_lr_batch (primal and sample-space
dual), dual_variance and densify_bucket; beside them newton_two_phase, the
two-phase Newton of gdmix_tpu/models/random_effect_lr.py:235-294.
Objective (the reference's MEAN form): f(θ) = (Σ wᵢ·bce(zᵢ) +
λ/2·θᵀMθ)/n with z = Xθ + offset and M the bias-exclusion mask.

Dispatch, as in the JAX package:
  * primal, float32 on a card with dim ≤ 64 and a static mask layout: the
    fused kernels of ops/newton_lanes.py;
  * every other primal case: the batch-major loop here, whose dim×dim solve
    is the hand-written kernel of ops/linsolve.py (K3) on a card and a
    Cholesky solve on the CPU (the JAX package's non-TPU solve);
  * dual (Woodbury, samples-per-entity < dim): the same loop with the step
    taken in sample space through the n×n kernel system, solved by the
    multi-RHS kernel (K4) on a card when n ≤ 128 and by a Cholesky solve
    otherwise — the rule of gdmix_tpu/ops/newton.py:168-172, chosen by shape
    before any launch;
  * two-phase (newton_two_phase, over one tier's shards; a bucket is a
    tier of one shard): on the lanes path two launches of its kernels a
    shard, the second over the lane list the tier's cut hands the shard on
    the card (ops/newton_lanes.newton_two_phase_lanes); elsewhere the
    batch-major loop twice, with one host read of the shards' counts
    between.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from gdmix_tpu_torch.ops.linsolve import (spd_solve_batched,
                                          spd_solve_batched_mrhs)
from gdmix_tpu_torch.ops.newton_lanes import (
    MAX_DIM, newton_lr_batch_lanes, newton_two_phase_lanes,
    two_phase_shard_lanes)

_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 20
_Z_REFRESH = 16   # iterations between exact recomputations of z = Xθ + off
DUAL_KERNEL_MAX_N = 128   # the dual's n×n solve runs K4 up to this n


class NewtonResult(NamedTuple):
    theta: torch.Tensor           # [B, dim]
    converged: torch.Tensor       # [B] bool
    num_iterations: torch.Tensor  # [B] int32


class TwoPhaseResult(NamedTuple):
    """newton_two_phase's result for one shard: NewtonResult's fields,
    then phase 1's lane order and straggler count over the whole tier (all
    its shards), from which prefix_size gives the lanes solved again
    (order[:P])."""
    theta: torch.Tensor           # [B, dim]
    converged: torch.Tensor       # [B] bool
    num_iterations: torch.Tensor  # [B] int32: phase 1 + phase 2
    order: torch.Tensor           # [B] int32, stragglers first
    n_unconverged: torch.Tensor   # [1] int32


def _cholesky_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0]


def _cho_solve_batched(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """K⁻¹·rhs from L = chol(K); L [B, n, n], rhs [B, n, r]."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


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
    kernels (True: a 0 at coordinate 0 only; False: all ones).

    dual=True takes the Newton step in SAMPLE space (Woodbury): with
    Ũ = √D·X and D = diag(w·p·(1−p)), the primal Hessian λM + XᵀDX is
    inverted through the n×n system K = αI_n + ŨŨᵀ instead of a dim×dim
    one, and no [B, dim, dim] Hessian is formed. It requires l2_mask to be
    all ones except an optional 0 at coordinate 0; that rank-1 hole is
    folded back in by Sherman–Morrison."""
    dtype = theta0.dtype
    B, n, dim = X.shape
    if (not dual and static_unreg_bias is not None
            and dtype == torch.float32 and X.device.type == "cuda"
            and dim <= MAX_DIM):
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

    def delta_primal(g, p):
        d = weights * p * (1 - p)
        H = (torch.einsum("bnd,bne->bde", X, X * d[:, :, None])
             + lam * torch.diag(mask)) * inv_n[:, None, None]
        # Levenberg damping keeps padded/degenerate lanes solvable
        damp = eps * (1.0 + torch.diagonal(H, dim1=1, dim2=2).abs())
        return solve((H + torch.diag_embed(damp)).contiguous(),
                     g.contiguous())

    if dual:
        # the Gram matrix is iteration-invariant: ŨŨᵀ = √d√dᵀ ⊙ (XXᵀ), so
        # each iteration's n×n system is built elementwise
        G = torch.einsum("bnd,bmd->bnm", X, X)
        XX = X * X
        eye_n = torch.eye(n, dtype=dtype, device=X.device)
        e0 = torch.zeros(dim, dtype=dtype, device=X.device)
        e0[0] = 1.0
        X0 = X[:, :, 0]          # intercept column
        n_f = torch.clamp_min(counts.to(dtype), 1.0)
        c = lam * (1.0 - mask[0])                           # intercept hole
        use_kernel = X.device.type == "cuda" and n <= DUAL_KERNEL_MAX_N

    def delta_dual(g, p):
        # solve (λI + XᵀDX − c·e₀e₀ᵀ + μI)·δ = g_un in sample space
        d = weights * p * (1 - p)                               # [B, n]
        g_un = g * n_f[:, None]                                 # drop the 1/n
        diag_un = lam * mask[None, :] + torch.einsum("bnd,bn->bd", XX, d)
        mu = eps * (1.0 + diag_un.amax(dim=1))                  # damping
        alpha = lam + mu                                        # [B]
        sd = torch.sqrt(d)
        K = sd[:, :, None] * sd[:, None, :] * G \
            + alpha[:, None, None] * eye_n
        t = sd * torch.einsum("bnd,bd->bn", X, g_un)            # Ũ·g_un
        rhs = torch.stack([t, sd * X0], dim=-1)                 # [B, n, 2]
        if use_kernel:
            sol = spd_solve_batched_mrhs(K.contiguous(), rhs.contiguous())
        else:
            sol = _cho_solve_batched(torch.linalg.cholesky(K), rhs)
        # A⁻¹v = (v − Ũᵀ K⁻¹ Ũ v)/α for A = αI + ŨᵀŨ, Ũᵀw = Xᵀ(√d ⊙ w):
        # both back-substitutions in one batched product
        back = torch.einsum("bnd,bnk->bkd", X, sd[:, :, None] * sol)
        Ag = (g_un - back[:, 0]) / alpha[:, None]
        Ae0 = (e0[None, :] - back[:, 1]) / alpha[:, None]
        # Sherman–Morrison for −c·e₀e₀ᵀ; denom ≥ μ/α > 0 by construction
        denom = 1.0 - c * Ae0[:, 0]
        return Ag + c * Ae0 * (Ag[:, 0] / denom)[:, None]

    delta_of = delta_dual if dual else delta_primal

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


def newton_two_phase(shards, *, l2_reg_weight: float,
                     l2_mask: torch.Tensor, phase1_iters: int,
                     maxiter: int = 50, ftol: float = 1e-12,
                     pgtol: float = 1e-5,
                     static_unreg_bias: Optional[bool] = None
                     ) -> List[TwoPhaseResult]:
    """Two-phase Newton with straggler compaction
    (gdmix_tpu/models/random_effect_lr.py:235-294) over one tier's shards,
    each a (θ0, X, labels, weights, offsets, counts) of the same shape on
    its own device (a bucket of the host plane is a tier of one shard):
    newton_lr_batch for `phase1_iters` iterations on every shard; the
    tier's lanes ordered stragglers first across its shards and
    the smallest ladder prefix that holds the tier's stragglers cut
    (two_phase_shard_lanes), as the JAX solver cuts its sharded array;
    each shard's lanes of that prefix solved again from phase 1's θ for
    `maxiter`, and scattered back. Arguments as newton_lr_batch (primal
    only). On the lanes path (float32 on a card, dim ≤ MAX_DIM, a static
    mask layout) both phases are kernel launches and the lane lists stay
    on the card; the batch-major loop, which reads the host every
    iteration, reads the shards' counts once to cut their lists. Returns
    one TwoPhaseResult a shard, with the tier's order and count."""
    theta0, X0 = shards[0][:2]
    if (static_unreg_bias is not None and theta0.dtype == torch.float32
            and X0.device.type == "cuda" and X0.shape[2] <= MAX_DIM):
        return newton_two_phase_lanes(
            shards, l2_reg_weight=float(l2_reg_weight),
            unreg_bias=static_unreg_bias, phase1_iters=phase1_iters,
            maxiter=maxiter, ftol=ftol, pgtol=pgtol)
    kw = [dict(l2_reg_weight=l2_reg_weight, ftol=ftol, pgtol=pgtol,
               l2_mask=l2_mask.to(shard[1].device)) for shard in shards]
    first = [newton_lr_batch(*shard, maxiter=phase1_iters, **k)
             for shard, k in zip(shards, kw)]
    order, n_un, lists = two_phase_shard_lanes(
        [res1.converged for res1 in first], X0.shape[0])
    taken = torch.cat([n.to(order.device) for _, n in lists]).tolist()
    out = []
    for (_, X, labels, weights, offsets, counts), res1, (lanes, _), n, k \
            in zip(shards, first, lists, taken, kw):
        theta, conv = res1.theta.clone(), res1.converged.clone()
        iters = res1.num_iterations.clone()
        pre = lanes[:n].long()
        res2 = newton_lr_batch(res1.theta[pre], X[pre], labels[pre],
                               weights[pre], offsets[pre], counts[pre],
                               maxiter=maxiter, **k)
        theta[pre], conv[pre] = res2.theta, res2.converged
        iters[pre] += res2.num_iterations
        out.append(TwoPhaseResult(theta=theta, converged=conv,
                                  num_iterations=iters, order=order,
                                  n_unconverged=n_un))
    return out


def dual_variance(theta: torch.Tensor, X: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor, offsets: torch.Tensor, *,
                  l2_reg_weight: float, l2_mask: torch.Tensor,
                  full: bool, epsilon: float = 1e-12) -> torch.Tensor:
    """Per-entity coefficient variance without forming [B, dim, dim].

    The estimator of the primal path (reference
    binary_logistic_regression.py:144-189, un-normalized Hessian
    H = λM + XᵀDX with an ε ridge): SIMPLE = 1/diag(H), FULL = diag(H⁻¹),
    the FULL diagonal taken in sample space, diag(A⁻¹) =
    (1 − colnorms²(L⁻¹Ũ))/α for A = αI + ŨᵀŨ, plus the Sherman–Morrison
    correction for the unregularized-intercept hole. l2_mask: all ones
    except an optional 0 at coordinate 0 (the contract of the dual
    newton_lr_batch)."""
    dtype = theta.dtype
    B, n, dim = X.shape
    lam = float(l2_reg_weight)
    mask = l2_mask.to(dtype)
    z = torch.einsum("bnd,bd->bn", X, theta) + offsets
    p = torch.sigmoid(z)
    d = weights * p * (1 - p)                                   # [B, n]
    diag_un = lam * mask[None, :] + torch.einsum("bnd,bn->bd", X * X, d)
    if not full:
        return 1.0 / (diag_un + epsilon)
    alpha = lam + epsilon
    Xs = X * torch.sqrt(d)[..., None]                           # Ũ
    K = torch.einsum("bnd,bmd->bnm", Xs, Xs) \
        + alpha * torch.eye(n, dtype=dtype, device=X.device)
    L = torch.linalg.cholesky(K)
    W = torch.linalg.solve_triangular(L, Xs, upper=False)
    diag_A = (1.0 - torch.sum(W * W, dim=1)) / alpha            # [B, dim]
    c = lam * (1.0 - mask[0])
    yu = _cho_solve_batched(L, Xs[:, :, 0:1])[..., 0]           # K⁻¹·Ũe₀
    e0 = torch.zeros(dim, dtype=dtype, device=X.device)
    e0[0] = 1.0
    Ae0 = (e0[None, :] - torch.einsum("bnd,bn->bd", Xs, yu)) / alpha
    denom = 1.0 - c * Ae0[:, 0]                                 # = ε/(λ+ε) > 0
    return diag_A + c * (Ae0 * Ae0) / denom[:, None]


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
