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
(ops/fe_loss_grad.py). The wide-D hot/cold split (`HybridAux`,
`build_hybrid_aux`, the windowed cold layouts and the two hybrid objectives)
is ported with its kernels (ops/fe_hybrid.py, ops/windowed_scatter.py). The
JAX package's other strategies for the same sums (`onehot`, `block`,
`segment`) are TPU layouts and are not carried over. These objectives sum
over the rows they are given; across processes each process sums its own
rows and the trainer adds the processes' sums with one all-reduce
(models/fixed_effect_lr.py, parallel/process_group.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gdmix_tpu_torch.ops.windowed_scatter import WindowedPlan, windowed_plan


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


class HybridAux(NamedTuple):
    """Hot/cold feature split for the wide-D fixed-effect regime (port of
    gdmix_tpu/ops/logistic.py:334-372).

    Recommender feature spaces are power-law: at D ≫ 1M most entries hit a
    small hot set. The split remaps the top-A frequent features to a compact
    id space [0, A) and runs every record's hot entries through one fused
    pass over that space (ops/fe_hybrid.py: the compact θ and gradient fit a
    block's shared memory, so the hottest ids never meet in device-memory
    atomics), while the cold tail pays a per-entry gather and scatter
    against the full D. Built once per fit by build_hybrid_aux (the batch is
    fixed across L-BFGS iterations; sweeps reuse it via the device cache)."""
    hot_ids: torch.Tensor   # [A] int32 global feature id per compact slot
    hot_idx: torch.Tensor   # [N, K] int32 compact ids; cold/padding → A (dump)
    cold_idx: torch.Tensor  # [Mc] int32 global ids of cold entries (pad: 0)
    cold_row: torch.Tensor  # [Mc] int32 source record ids (pad: 0)
    cold_val: torch.Tensor  # [Mc] values (pad: 0.0 — inert)
    # Optional WINDOWED cold layouts (extend_hybrid_aux_windowed): both cold
    # scatters become sorted windowed reductions (ops/windowed_scatter.py);
    # the random gather halves stay PyTorch indexing (the two scatters need
    # opposite sort orders).
    gs_idxl: Optional[torch.Tensor] = None  # [Mg/16,16] id − win·W (id-sorted)
    gs_val: Optional[torch.Tensor] = None   # [Mg/16,16] values (pad 0)
    gs_row: Optional[torch.Tensor] = None   # [Mg/16,16] source record ids
    gs_win: Optional[torch.Tensor] = None   # [n_tiles_g] window per tile
    zs_rowl: Optional[torch.Tensor] = None  # [Mz/16,16] row − win·W (row-major)
    zs_idx: Optional[torch.Tensor] = None   # [Mz/16,16] global feature ids
    zs_val: Optional[torch.Tensor] = None   # [Mz/16,16] values (pad 0)
    zs_win: Optional[torch.Tensor] = None   # [n_tiles_z] window per tile
    # the row layout's window count (JAX carries it as the shape of an int8
    # array, which its kernel needs static; here it is the number itself)
    zs_nwin: Optional[int] = None
    # the windowed-scatter kernel's work plan of each layout (JAX has none):
    # built once with the layouts on a card, read by every call there; None
    # on the CPU, whose route reads no plan
    gs_plan: Optional[WindowedPlan] = None
    zs_plan: Optional[WindowedPlan] = None


# The cost model of the ADAPTIVE hot-set size (hot_features=0), per entry:
#   hot(A, e)  ≈ e · (HOT_BASE + HOT_PER_FEATURE · A)
#   cold(A, e) ≈ cold_fraction(A) · e · COLD_ENTRY_S
# These are the JAX package's constants, copied so that the port picks the
# same A from the same data; they were not measured on the H100, and
# calibrating them there is open work (ROADMAP).
HYBRID_HOT_BASE_S = 0.6e-9
HYBRID_HOT_PER_FEATURE_S = 5.8e-14
HYBRID_COLD_ENTRY_S = 35e-9
_HYBRID_A_CANDIDATES = (4096, 8192, 16384, 32768, 65536, 131072)


def _hybrid_counts(indices: torch.Tensor, values: torch.Tensor,
                   num_features: int):
    """(per-feature count of non-zero entries [D] int32, their total)."""
    m = (values != 0).reshape(-1)
    counts = torch.zeros(num_features, dtype=torch.int32,
                         device=indices.device).index_add_(
        0, indices.reshape(-1).long(), m.to(torch.int32))
    return counts, torch.sum(m, dtype=torch.int64)


def _hybrid_hot(counts: torch.Tensor, hot: int):
    """(the `hot` most frequent ids, the running sum of their counts). A
    stable descending sort puts the lower id first among equal counts, as
    jax.lax.top_k does; torch.topk promises no order among ties."""
    top_counts, order = torch.sort(counts, descending=True, stable=True)
    return (order[:hot].to(torch.int32),
            torch.cumsum(top_counts[:hot].to(torch.int64), 0))


def _hybrid_build(indices, values, hot_ids, num_features: int, hot: int,
                  mc: int, mc_pad: int) -> HybridAux:
    """The split arrays (gdmix_tpu/ops/logistic.py:419-438): compact ids of
    the hot entries, and the cold entries in row-major order, zero-padded to
    mc_pad."""
    dev = indices.device
    k = indices.shape[1]
    remap = torch.full((num_features,), hot, dtype=torch.int32, device=dev)
    remap[hot_ids.long()] = torch.arange(hot, dtype=torch.int32, device=dev)
    idx_c = remap[indices.long()]                              # [N, K]
    m = values != 0
    hot_idx = torch.where(m & (idx_c < hot), idx_c, hot).to(torch.int32)
    pos = torch.nonzero(((idx_c == hot) & m).reshape(-1)).squeeze(1)
    assert pos.shape[0] == mc, (pos.shape[0], mc)

    def cold(a, dtype):
        out = torch.zeros(mc_pad, dtype=dtype, device=dev)
        out[:mc] = a.to(dtype)
        return out
    return HybridAux(hot_ids, hot_idx,
                     cold(indices.reshape(-1)[pos], torch.int32),
                     cold(pos // k, torch.int32),
                     cold(values.reshape(-1)[pos], values.dtype))


def build_hybrid_aux(indices: torch.Tensor, values: torch.Tensor,
                     num_features: int, *, hot_features: int = 0,
                     cold_max_frac: float = 0.5,
                     pad_multiple: int = 8) -> Optional[HybridAux]:
    """The hot/cold split of a concrete batch (port of
    gdmix_tpu/ops/logistic.py:442-503). Every heavy pass runs on the batch's
    device; only small scalars reach the host. Returns None when the data
    does not reward the split (cold fraction above `cold_max_frac`, e.g.
    uniform ids): the caller then keeps the plain scatter path.

    hot_features=0 picks the hot-set size ADAPTIVELY: the cost model above,
    evaluated at the pow-2 candidate sizes on the batch's own frequency
    profile, and its argmin taken. `cold_max_frac` defaults to the model's
    `hybrid_cold_max_frac` (0.5), not JAX's 0.6 (ROADMAP C.2)."""
    adaptive = hot_features <= 0
    cap = min(_HYBRID_A_CANDIDATES[-1] if adaptive else hot_features,
              num_features)
    if cap <= 0:
        return None
    counts, total = _hybrid_counts(indices, values, num_features)
    hot_ids_full, cum = _hybrid_hot(counts, int(cap))
    total = int(total)
    if total == 0:
        return None
    if adaptive:
        cands = [c for c in _HYBRID_A_CANDIDATES if c <= cap] or [int(cap)]
        covered = cum[torch.as_tensor([c - 1 for c in cands],
                                      device=cum.device)].cpu().numpy()
        best_a, best_cost = cands[0], float("inf")
        for c, cov in zip(cands, covered):
            cost = (total * (HYBRID_HOT_BASE_S + HYBRID_HOT_PER_FEATURE_S * c)
                    + (total - int(cov)) * HYBRID_COLD_ENTRY_S)
            if cost < best_cost:
                best_a, best_cost = c, cost
        a_eff = int(best_a)
        mc = total - int(covered[cands.index(best_a)])
        hot_ids = hot_ids_full[:a_eff]
    else:
        a_eff = int(cap)
        mc = total - int(cum[a_eff - 1])
        hot_ids = hot_ids_full
    if mc / max(total, 1) > cold_max_frac:
        return None
    # capacity tiers with 1/8-mantissa pow-2 steps keep the cold padding
    # ≤ 12.5%: padding entries are inert but still walked by the cold side
    mult = max(int(pad_multiple), 1)
    mc_eff = max(mc, 1)
    step = 1 << max((mc_eff - 1).bit_length() - 3, 0)
    mc_pad = ((mc_eff + step - 1) // step) * step
    mc_pad = ((mc_pad + mult - 1) // mult) * mult
    return _hybrid_build(indices, values, hot_ids, num_features, a_eff, mc,
                         mc_pad)


HYBRID_SCATTER_WINDOW = 4096
HYBRID_SCATTER_TILE_ROWS = 128   # 2048 entries per kernel tile


def _windowed_layout(key, idx, row, val, num_targets: int,
                     window: int, tile_rows: int):
    """Sort cold entries by `key`, group them into aligned target windows
    with per-window padding to whole tiles of tile_rows·16 entries (every
    window gets at least one tile). Returns ([M/16,16] key_local, idx, row,
    val, [n_tiles] win) tensors (gdmix_tpu/ops/logistic.py:510-545)."""
    dev = key.device
    mc = key.shape[0]
    order = torch.argsort(key, stable=True)   # padding (key 0) sorts first
    skey = key[order].long()
    sidx, srow, sval = idx[order], row[order], val[order]
    nw = (num_targets + window - 1) // window
    bounds = torch.searchsorted(
        skey, torch.arange(1, nw + 1, dtype=torch.int64, device=dev) * window)
    counts = np.diff(np.concatenate([[0], bounds.cpu().numpy()]))
    tile_e = tile_rows * 16
    padded = np.maximum((counts + tile_e - 1) // tile_e, 1) * tile_e
    offs = np.concatenate([[0], np.cumsum(padded)])
    m_pad = int(offs[-1])
    win_of_tile = np.repeat(np.arange(nw, dtype=np.int32),
                            (padded // tile_e).astype(np.int64))
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                             dtype=torch.int64, device=dev)
    offs_dev = torch.as_tensor(offs[:-1], dtype=torch.int64, device=dev)
    win_of_entry = skey // window
    dest = (offs_dev[win_of_entry]
            + (torch.arange(mc, dtype=torch.int64, device=dev)
               - starts[win_of_entry]))
    key_local = skey - win_of_entry * window

    def place(a, dtype):
        out = torch.zeros(m_pad, dtype=dtype, device=dev)
        out[dest] = a.to(dtype)
        return out.reshape(m_pad // 16, 16)
    return (place(key_local, torch.int32), place(sidx, torch.int32),
            place(srow, torch.int32), place(sval, torch.float32),
            torch.as_tensor(win_of_tile, device=dev))


def extend_hybrid_aux_windowed(aux: HybridAux, num_features: int,
                               num_rows: int, *,
                               tile_rows: int = HYBRID_SCATTER_TILE_ROWS
                               ) -> HybridAux:
    """Attach the windowed cold layouts (see HybridAux fields) for the
    windowed-scatter kernel (gdmix_tpu/ops/logistic.py:548-570), and, on a
    card, the kernel's work plan of each (ops/windowed_scatter.py
    windowed_plan). Built once per fit from the flat cold arrays; two small
    host fetches per layout on a card (per-window counts, which tiles hold
    a non-zero value), one on the CPU. `num_rows` must cover every batch
    row."""
    window = HYBRID_SCATTER_WINDOW
    g_idxl, _, g_row, g_val, g_win = _windowed_layout(
        aux.cold_idx, aux.cold_idx, aux.cold_row, aux.cold_val,
        num_features, window, tile_rows)
    z_rowl, z_idx, _, z_val, z_win = _windowed_layout(
        aux.cold_row, aux.cold_idx, aux.cold_row, aux.cold_val,
        num_rows, window, tile_rows)
    z_nwin = (num_rows + window - 1) // window
    on_card = g_win.device.type == "cuda"
    return aux._replace(
        gs_idxl=g_idxl, gs_val=g_val, gs_row=g_row, gs_win=g_win,
        zs_rowl=z_rowl, zs_idx=z_idx, zs_val=z_val, zs_win=z_win,
        zs_nwin=z_nwin,
        gs_plan=windowed_plan(g_win, g_val, (num_features + window - 1)
                              // window, window) if on_card else None,
        zs_plan=windowed_plan(z_win, z_val, z_nwin,
                              window) if on_card else None)


def fixed_effect_value_and_grad_hybrid(x: torch.Tensor,
                                       batch: SparseBatch,
                                       aux: HybridAux,
                                       num_features: int,
                                       *,
                                       has_intercept: bool = True,
                                       model_type: str =
                                       "logistic_regression"):
    """Fixed-effect data term with the hot/cold split (see HybridAux), in
    the type of x (port of gdmix_tpu/ops/logistic.py:573-719).

    Forward: z = z_hot + z_cold + offset + b. z_cold is a per-entry gather
    over the cold minority and a row scatter; it folds into the offsets the
    hot side reads. The hot side is the fused pass of ops/fe_hybrid.py
    (fe_hybrid_hot) over the compact ids: z_hot, the loss, the residual r,
    the compact gradient and Σr. Backward: the compact gradient lands in
    grad[hot_ids] (unique ids); cold entries scatter v·r[row] straight into
    grad[D]. When the aux carries the windowed layouts, both cold scatters
    run the windowed-scatter kernel in float32, cast at the places the JAX
    package casts; otherwise they are `index_add_`. Same math as
    fixed_effect_value_and_grad with l2_reg_weight=0: the caller adds the
    λ-term once. JAX's chunked one-hot matmuls and their precision table
    were TPU devices for the same sums and are not carried over."""
    from gdmix_tpu_torch.ops.fe_hybrid import fe_hybrid_hot
    from gdmix_tpu_torch.ops.windowed_scatter import windowed_scatter_add
    dtype = x.dtype
    w, b = _split_intercept(x, has_intercept)
    n = aux.hot_idx.shape[0]
    windowed = aux.zs_win is not None
    if windowed:
        W = HYBRID_SCATTER_WINDOW
        wv = (w[aux.zs_idx.long()] * aux.zs_val.to(dtype)).to(torch.float32)
        z_cold = windowed_scatter_add(
            aux.zs_rowl, wv, aux.zs_win, aux.zs_nwin, W,
            aux.zs_rowl.shape[0] // aux.zs_win.shape[0],
            aux.zs_plan)[:n].to(dtype)
    else:
        z_cold = torch.zeros(n, dtype=dtype, device=x.device).index_add_(
            0, aux.cold_row.long(),
            w[aux.cold_idx.long()] * aux.cold_val.to(dtype))
    loss, g_hot, r_sum, r = fe_hybrid_hot(
        w[aux.hot_ids.long()], b, aux.hot_idx, batch.values, batch.labels,
        batch.weights, batch.offsets + z_cold, aux.hot_ids.shape[0],
        linear=model_type == "linear_regression")
    if windowed:
        ce = (aux.gs_val.to(dtype) * r[aux.gs_row.long()]).to(torch.float32)
        grad_w = windowed_scatter_add(
            aux.gs_idxl, ce, aux.gs_win, (num_features + W - 1) // W, W,
            aux.gs_idxl.shape[0] // aux.gs_win.shape[0],
            aux.gs_plan)[:num_features].to(dtype)
    else:
        grad_w = torch.zeros(num_features, dtype=dtype,
                             device=x.device).index_add_(
            0, aux.cold_idx.long(),
            aux.cold_val.to(dtype) * r[aux.cold_row.long()])
    grad_w.index_add_(0, aux.hot_ids.long(), g_hot)
    grad = torch.cat([grad_w, r_sum[None]]) if has_intercept else grad_w
    return loss, grad


def fixed_effect_value_and_grad_hybrid_pallas(x: torch.Tensor,
                                              batch: SparseBatch,
                                              aux: HybridAux,
                                              num_features: int,
                                              *,
                                              has_intercept: bool = True,
                                              model_type: str =
                                              "logistic_regression"):
    """fixed_effect_value_and_grad_hybrid as the JAX package's `pallas_hybrid`
    mode runs it (gdmix_tpu/ops/logistic.py:722-763): the hot side through
    fe_hybrid_hot in float32, whatever the type of x, and the cold side
    always `index_add_` (the windowed layouts are not read). The casts sit
    where JAX's wrapper puts them."""
    from gdmix_tpu_torch.ops.fe_hybrid import fe_hybrid_hot
    dtype, f32 = x.dtype, torch.float32
    w, b = _split_intercept(x, has_intercept)
    n = aux.hot_idx.shape[0]
    z_cold = torch.zeros(n, dtype=f32, device=x.device).index_add_(
        0, aux.cold_row.long(),
        (w[aux.cold_idx.long()] * aux.cold_val.to(dtype)).to(f32))
    loss, g_hot, r_sum, r = fe_hybrid_hot(
        w[aux.hot_ids.long()].to(f32), b.to(f32), aux.hot_idx,
        batch.values.to(f32), batch.labels.to(f32), batch.weights.to(f32),
        batch.offsets.to(f32) + z_cold, aux.hot_ids.shape[0],
        linear=model_type == "linear_regression")
    grad_w = torch.zeros(num_features, dtype=dtype,
                         device=x.device).index_add_(
        0, aux.cold_idx.long(),
        aux.cold_val.to(dtype) * r[aux.cold_row.long()].to(dtype))
    grad_w.index_add_(0, aux.hot_ids.long(), g_hot.to(dtype))
    grad = (torch.cat([grad_w, r_sum[None].to(dtype)]) if has_intercept
            else grad_w)
    return loss.to(dtype), grad


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
