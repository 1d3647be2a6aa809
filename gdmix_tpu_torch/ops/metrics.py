"""Evaluation metrics (AUC / MSE).

Port of gdmix_tpu/ops/metrics.py, which replaces the Spark Evaluator job
(linkedin/gdmix:gdmix-data/src/main/scala/com/linkedin/gdmix/evaluation/
Evaluator.scala:29-44). AUC is the Mann-Whitney statistic with average-rank
tie correction — identical to the trapezoidal area under the ROC curve that
BinaryClassificationMetrics / sklearn.roc_auc_score compute. Inputs may be
numpy arrays or tensors; the sums run in float64 on the inputs' device.
"""
from __future__ import annotations

import torch


def _f64(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.float64)


def auc(scores, labels, weights=None) -> torch.Tensor:
    """Area under the ROC curve with tie averaging. labels in {0,1}.

    With `weights`, computes the weighted Mann-Whitney statistic
    Σ_{i∈pos,j∈neg} wᵢwⱼ·[sᵢ>sⱼ] + ½·wᵢwⱼ·[sᵢ=sⱼ], normalized by W₊·W₋ —
    identical to sklearn.roc_auc_score(sample_weight=...)."""
    scores = _f64(scores)
    labels = _f64(labels, scores.device)
    n = scores.shape[0]
    w = (torch.ones_like(scores) if weights is None
         else _f64(weights, scores.device))
    order = torch.argsort(scores, stable=True)
    s_sorted, y_sorted, w_sorted = scores[order], labels[order], w[order]

    # Tie groups: per group, positives beat the negative weight strictly
    # below and half-beat the negative weight inside the group.
    new_group = torch.ones(n, dtype=torch.int64, device=scores.device)
    new_group[1:] = (s_sorted[1:] != s_sorted[:-1]).long()
    group_id = torch.cumsum(new_group, 0) - 1             # 0-based group ids
    pos_w = w_sorted * y_sorted
    neg_w = w_sorted * (1.0 - y_sorted)
    g_pos = torch.zeros_like(scores).index_add_(0, group_id, pos_w)
    g_neg = torch.zeros_like(scores).index_add_(0, group_id, neg_w)
    neg_below = torch.cumsum(g_neg, 0) - g_neg             # exclusive
    u = torch.sum(g_pos * (neg_below + 0.5 * g_neg))
    total = torch.sum(pos_w) * torch.sum(neg_w)
    return u / torch.clamp_min(total, 1e-30)


def mse(scores, labels) -> torch.Tensor:
    scores = _f64(scores)
    labels = _f64(labels, scores.device)
    return torch.mean((scores - labels) ** 2)
