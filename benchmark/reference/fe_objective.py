"""Plain fixed-effect logistic regression: the objective GDMix's fixed
effect states and its gradient, over a padded-COO batch, in plain PyTorch:

    F(x) = Σᵢ wᵢ·bce(zᵢ, yᵢ) + λ/2·Σ_{j<D} x_j²,   zᵢ = Σ_k x[id_ik]·v_ik
                                                       + x_D + oᵢ,

coefficients [w(D), b] with the intercept last and not regularised.

The margins are gathered in blocks of rows. The gradient's sum over the
entries of each feature is a product with the transposed batch: for a
field whose entries all hold one fixed id (`fixed`: column k holds id k) a
column sum, and for the rest a CSR matrix of the transposed entries, built
once from the batch (a sort by id), whose product with the residuals
cuSPARSE computes. No scatter with atomics: on Zipf ids its contention
would take seconds a call.

`low=True` is the control: float32 throughout, every operand of every
product rounded to bfloat16 (the objective is gathers, scatters and row
sums, no matrix product, so TF32 does not apply to it).
"""
from __future__ import annotations

import warnings

import torch

from benchmark.reference.precision import bf16_round


def _bce(z, y):
    return torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))


class Objective:
    """F and ∇F over a batch (indices [N, K] int32, values [N, K], labels,
    weights, offsets [N]) of width D. Columns [0, fixed) hold the ids
    0..fixed-1."""

    def __init__(self, indices, values, labels, weights, offsets,
                 width: int, lam: float, *, fixed: int = 0,
                 low: bool = False, block_rows: int = 1 << 22):
        self.dtype = torch.float32 if low else torch.float64
        self.rnd = bf16_round if low else (lambda t: t)
        self.idx, self.val = indices, values
        self.y, self.w, self.o = labels, weights, offsets
        self.D, self.lam, self.fixed = width, float(lam), fixed
        self.block = block_rows
        n, k = indices.shape
        if fixed:
            want = torch.arange(fixed, dtype=indices.dtype,
                                device=indices.device)
            if not bool((indices[:, :fixed] == want).all()):
                raise ValueError("the fixed columns do not hold their ids")
        # the free columns' entries, transposed: CSR [D, N]
        keys, perm = torch.sort(indices[:, fixed:].reshape(-1))
        rows = torch.div(perm, k - fixed, rounding_mode="floor")
        perm.add_(rows, alpha=fixed).add_(fixed)    # its place in [N, K]
        vals = self.rnd(values.reshape(-1)[perm].to(self.dtype))
        del perm
        rows = rows.to(torch.int32)
        crow = torch.zeros(width + 1, dtype=torch.int64,
                           device=indices.device)
        crow[1:] = torch.cumsum(torch.bincount(keys, minlength=width), 0)
        del keys
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # "beta state"
            self.XT = torch.sparse_csr_tensor(
                crow.to(torch.int32), rows, vals, size=(width, n),
                check_invariants=False)

    def __call__(self, x: torch.Tensor):
        """(F(x), ∇F(x)) as tensors of the objective's type."""
        x = x.to(self.dtype)
        w, b = self.rnd(x[:-1]), x[-1]
        n = self.idx.shape[0]
        r_all = torch.empty(n, dtype=self.dtype, device=x.device)
        f = torch.zeros((), dtype=self.dtype, device=x.device)
        g = torch.zeros_like(x)
        for a in range(0, n, self.block):
            e = min(n, a + self.block)
            v = self.rnd(self.val[a:e].to(self.dtype))
            z = (w[self.idx[a:e].long()] * v).sum(1) + b \
                + self.o[a:e].to(self.dtype)
            y = self.y[a:e].to(self.dtype)
            wt = self.w[a:e].to(self.dtype)
            f = f + (wt * _bce(z, y)).sum()
            r = wt * (torch.sigmoid(z) - y)
            r_all[a:e] = r
            if self.fixed:
                g[:self.fixed] += (self.rnd(r)[:, None]
                                   * v[:, :self.fixed]).sum(0)
            g[-1] += r.sum()
        g[:-1] += torch.mv(self.XT, self.rnd(r_all))
        f = f + 0.5 * self.lam * (x[:-1] * x[:-1]).sum()
        g[:-1] += self.lam * x[:-1]
        return f, g
