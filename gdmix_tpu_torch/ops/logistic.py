"""Logistic/linear regression objectives on padded-sparse batches: the
fixed-effect subset of gdmix_tpu/ops/logistic.py and the random-effect
per-entity objective (the sparse L-BFGS rung's), batched over entities.

The math of the reference, unchanged:

  * numerically stable weighted BCE:  max(z,0) − z·y + log1p(exp(−|z|))
    (linkedin/gdmix:gdmix-trainer/src/gdmix/models/custom/
    binary_logistic_regression.py:84-110)
  * fixed-effect objective = SUM of weighted losses + λ·½‖w‖² (bias excluded
    iff has_intercept and not regularize_bias)
  * linear regression uses squared difference (y−z)², not halved
    (fixed_effect_lr_lbfgs_model.py:357-358)

Sparse features are padded COO per example: (indices [N, K] int32,
values [N, K]) where padding has value 0.0 (the index content is then
irrelevant for both X·θ and Xᵀr). The gather + `index_add_` form of
`fixed_effect_value_and_grad` is the plain version of the fused FE kernels
(ops/fe_loss_grad.py). The JAX package's other strategies for the same sums
(`onehot`, `block`, `segment`, `hybrid`) are TPU layouts and are not carried
over; the psum of the multi-device objective is ROADMAP A.6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseBatch(NamedTuple):
    """A batch of examples with one sparse feature bag, padded to K
    nnz/example."""
    indices: torch.Tensor   # [N, K] int32, global feature ids (padding: any id)
    values: torch.Tensor    # [N, K] float, padding must be 0.0
    offsets: torch.Tensor   # [N] float
    labels: torch.Tensor    # [N] float (0/1 for LR, real for linear regression)
    weights: torch.Tensor   # [N] float, padding rows must be 0.0


def sparse_matvec(theta_w: torch.Tensor, indices: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """X·w for padded-COO X: [N] = Σ_k values[n,k] · w[indices[n,k]]."""
    return torch.sum(theta_w[indices.long()] * values, dim=-1)


def sparse_rmatvec(indices: torch.Tensor, values: torch.Tensor,
                   residual: torch.Tensor, num_features: int) -> torch.Tensor:
    """Xᵀ·r for padded-COO X: [D] scatter-add of values[n,k]·r[n] at
    indices[n,k]."""
    contrib = (values * residual[:, None]).reshape(-1)
    return torch.zeros(num_features, dtype=values.dtype,
                       device=values.device).index_add_(
        0, indices.reshape(-1).long(), contrib)


def stable_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """max(z,0) − z·y + log1p(exp(−|z|)) — the reference's stable form."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _l2_mask(d: int, has_intercept: bool, regularize_bias: bool,
             intercept_at_end: bool, dtype, device=None) -> torch.Tensor:
    """1.0 where the L2 penalty applies. The intercept is excluded iff
    has_intercept and not regularize_bias."""
    mask = torch.ones(d, dtype=dtype, device=device)
    if has_intercept and not regularize_bias:
        mask[d - 1 if intercept_at_end else 0] = 0.0
    return mask


def l2_value_and_grad(x: torch.Tensor, l2_reg_weight, *, has_intercept: bool,
                      regularize_bias: bool, intercept_at_end: bool):
    """Standalone λ·½‖x‖² term (added once per funcall to the data term)."""
    mask = _l2_mask(x.shape[0], has_intercept, regularize_bias,
                    intercept_at_end, x.dtype, x.device)
    lam = float(l2_reg_weight)
    return 0.5 * lam * torch.sum(mask * x * x), lam * mask * x


def _split_intercept(x: torch.Tensor, has_intercept: bool,
                     intercept_at_end: bool = True):
    if not has_intercept:
        return x, torch.zeros((), dtype=x.dtype, device=x.device)
    if intercept_at_end:
        return x[:-1], x[-1]
    return x[1:], x[0]


def fixed_effect_value_and_grad(x: torch.Tensor,
                                batch: SparseBatch,
                                num_features: int,
                                *,
                                has_intercept: bool = True,
                                regularize_bias: bool = True,
                                l2_reg_weight: float = 1.0,
                                model_type: str = "logistic_regression"):
    """Fixed-effect objective: Σ over the batch's samples + the L2 term.

    x layout: [w(num_features), b] if has_intercept else [w] — matching the
    reference (fixed_effect_lr_lbfgs_model.py:254-258, intercept last).
    Returns (value, grad)."""
    w, b = _split_intercept(x, has_intercept)
    z = sparse_matvec(w, batch.indices, batch.values) + batch.offsets + b
    if model_type == "linear_regression":
        per = (batch.labels - z) ** 2
        dz = 2.0 * (z - batch.labels)
    else:
        per = stable_bce(z, batch.labels)
        dz = torch.sigmoid(z) - batch.labels
    value = torch.sum(batch.weights * per)
    r = batch.weights * dz
    grad = sparse_rmatvec(batch.indices, batch.values, r, num_features)
    if has_intercept:
        grad = torch.cat([grad, torch.sum(r)[None]])
    lv, lg = l2_value_and_grad(x, l2_reg_weight, has_intercept=has_intercept,
                               regularize_bias=regularize_bias,
                               intercept_at_end=True)
    return value + lv, grad + lg


def entity_logits(theta: torch.Tensor, batch: SparseBatch, *,
                  has_intercept: bool = True) -> torch.Tensor:
    """Logits incl. offsets [B, n] of B entities at once (intercept FIRST;
    batch fields [B, n, K] / [B, n]): `vmap` of predict_logits with
    intercept_at_end=False."""
    B = theta.shape[0]
    w = theta[:, 1:] if has_intercept else theta
    flat = batch.indices.reshape(B, -1).long()
    z = torch.sum(torch.gather(w, 1, flat).reshape(batch.values.shape)
                  * batch.values, dim=-1) + batch.offsets
    return z + theta[:, :1] if has_intercept else z


def per_entity_value_and_grad(theta: torch.Tensor,
                              batch: SparseBatch,
                              num_features: int,
                              *,
                              has_intercept: bool = True,
                              regularize_bias: bool = False,
                              l2_reg_weight: float = 0.0,
                              sample_count=None):
    """Per-entity objective (MEAN form, reference
    binary_logistic_regression.py:84-131), for B entities at once: what
    `vmap` of gdmix_tpu/ops/logistic.py:per_entity_value_and_grad computes.

    theta [B, dim]: [b, w(num_features)] if has_intercept else [w] —
    intercept FIRST. batch fields carry a leading entity axis: indices and
    values [B, n, K] (entity-LOCAL feature ids), offsets/labels/weights
    [B, n]; rows beyond an entity's true sample count have weight 0.
    sample_count [B] is the true n of the 1/n normalization (default the
    padded row count). Returns (value [B], grad [B, dim])."""
    dtype = theta.dtype
    B = theta.shape[0]
    if sample_count is None:
        n = torch.full((B,), float(batch.labels.shape[1]), dtype=dtype,
                       device=theta.device)
    else:
        n = sample_count.to(dtype)
    n = torch.clamp_min(n, 1.0)
    flat = batch.indices.reshape(B, -1).long()                  # [B, n·K]
    z = entity_logits(theta, batch, has_intercept=has_intercept)
    per = stable_bce(z, batch.labels)
    dz = torch.sigmoid(z) - batch.labels

    value = torch.sum(batch.weights * per, dim=1)
    r = batch.weights * dz                                      # [B, n]
    grad_w = torch.zeros(B, num_features, dtype=dtype,
                         device=theta.device).scatter_add_(
        1, flat, (batch.values * r[..., None]).reshape(B, -1))
    grad = (torch.cat([torch.sum(r, dim=1)[:, None], grad_w], dim=1)
            if has_intercept else grad_w)

    mask = _l2_mask(theta.shape[1], has_intercept, regularize_bias, False,
                    dtype, theta.device)
    lam = float(l2_reg_weight)
    value = (value + 0.5 * lam * torch.sum(mask * theta * theta, dim=1)) / n
    grad = (grad + lam * mask * theta) / n[:, None]
    return value, grad


def predict_logits(theta: torch.Tensor, batch: SparseBatch, *,
                   has_intercept: bool = True,
                   intercept_at_end: bool = False) -> torch.Tensor:
    """Logits including offsets for either coefficient layout."""
    w, b = _split_intercept(theta, has_intercept, intercept_at_end)
    return sparse_matvec(w, batch.indices, batch.values) + batch.offsets + b


def _hessian_weights(theta, batch, has_intercept, intercept_at_end):
    z = predict_logits(theta, batch, has_intercept=has_intercept,
                       intercept_at_end=intercept_at_end)
    rho = torch.sigmoid(z)
    return rho * (1 - rho) * batch.weights


def hessian_diag(theta: torch.Tensor, batch: SparseBatch, num_features: int,
                 *, has_intercept: bool = True,
                 intercept_at_end: bool = False) -> torch.Tensor:
    """diag(XᵀDX) with D = diag(w·ρ(1−ρ)), ρ = σ(logit incl offset).
    λ/ε handling is left to the caller."""
    d = _hessian_weights(theta, batch, has_intercept, intercept_at_end)
    diag_w = sparse_rmatvec(batch.indices, batch.values ** 2, d, num_features)
    if not has_intercept:
        return diag_w
    diag_b = torch.sum(d)[None]
    return (torch.cat([diag_w, diag_b]) if intercept_at_end
            else torch.cat([diag_b, diag_w]))


def hessian_full(theta: torch.Tensor, batch: SparseBatch, num_features: int,
                 *, has_intercept: bool = True,
                 intercept_at_end: bool = False) -> torch.Tensor:
    """Full XᵀDX (densified) for FULL-mode variance; fine for small d."""
    d = _hessian_weights(theta, batch, has_intercept, intercept_at_end)
    n, k = batch.indices.shape
    X = torch.zeros(n * num_features, dtype=theta.dtype, device=theta.device)
    row = torch.arange(n, device=theta.device)[:, None].expand(n, k)
    flat = (row * num_features + batch.indices.long()).reshape(-1)
    X = X.index_add_(0, flat, batch.values.reshape(-1)).reshape(
        n, num_features)
    if has_intercept:
        ones = torch.ones(n, 1, dtype=theta.dtype, device=theta.device)
        X = torch.cat([X, ones] if intercept_at_end else [ones, X], dim=1)
    return X.T @ (X * d[:, None])
