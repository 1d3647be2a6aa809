"""Columnar random-effect model store.

The reference keeps per-entity models as one python object per entity
(`TrainingResult`, linkedin/gdmix:gdmix-trainer/src/gdmix/models/custom/scipy/
job_consumers.py:18) inside a dict — fine at its process-pool throughput, but
at this framework's solve rates (>100k models/sec/chip) the per-entity object
creation, dict churn, and per-model numpy slicing around the solver become the
wall clock. ModelTable stores ALL models of a partition columnar:

    ids        [E]   model ids (object array of str)
    offs       [E+1] ragged row offsets into the coef arrays
    coef_ids   [M]   global feature indices (entity-major, per-entity sorted)
    coef_vals  [M]   coefficient means
    icpt       [E]   intercepts (None when the models have no intercept)
    coef_vars/icpt_vars — variances (None or all-present)

It implements Mapping[str, SparseModel] so every existing consumer (warm-start
reconciliation, tests, the multi-host model exchange) keeps working — __getitem__
materializes a per-entity SparseModel view on demand — while the hot paths
(bucket collection, photon-ml avro export/load, dense scoring tables, prior∪new
merge) run as whole-array numpy with zero per-entity python.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Sequence

import numpy as np

from gdmix_tpu_torch.io.model_avro import SparseModel

__all__ = ["ModelTable", "flat_positions", "intersect_prior_support"]


def flat_positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flattened element positions of ragged slices: for each i and each
    j < lens[i], yields starts[i] + j (row-major). The one ragged-expansion
    idiom (arange minus repeated cumsum) shared by every columnar consumer."""
    total = int(lens.sum())
    inner = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(starts, lens) + inner


def _ragged_copy(dst: np.ndarray, dst_starts: np.ndarray,
                 src: np.ndarray, src_starts: np.ndarray,
                 lens: np.ndarray) -> None:
    """dst[dst_starts[i] + j] = src[src_starts[i] + j] for j < lens[i].
    The inner-offset expansion is computed once and shared by both sides
    (this runs several times per partition merge over all coefficients)."""
    total = int(lens.sum())
    if total == 0:
        return
    inner = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    dst[np.repeat(dst_starts, lens) + inner] = \
        src[np.repeat(src_starts, lens) + inner]


def intersect_prior_support(prior: "ModelTable", ent_of_row: np.ndarray,
                            rows: np.ndarray, sup_keys: np.ndarray,
                            key_span: int):
    """Warm-start key intersection (reference job_consumers.py:260-288,
    vectorized): flatten the coefficients of prior table `rows` (rows[i]
    belongs to entity index ent_of_row[i]) and locate each (entity, feature)
    pair in the sorted combined-key support `sup_keys` (= ent*key_span + fid,
    ascending). Returns (p_ent, p_fid, p_val, pos, hit) flat arrays — one
    entry per prior coefficient; `hit` marks coefficients whose feature is in
    the entity's current support, `pos` its index in sup_keys (clamped)."""
    lens = prior.lens[rows]
    src = flat_positions(prior.offs[rows], lens)
    p_ent = np.repeat(np.asarray(ent_of_row, np.int64), lens)
    p_fid = prior.coef_ids[src]
    p_val = prior.coef_vals[src]
    keys = p_ent * key_span + p_fid
    pos = np.minimum(np.searchsorted(sup_keys, keys),
                     max(len(sup_keys) - 1, 0))
    hit = (sup_keys[pos] == keys) if len(sup_keys) \
        else np.zeros(len(keys), bool)
    return p_ent, p_fid, p_val, pos, hit


class ModelTable(Mapping):
    """Columnar {model_id: SparseModel}; see module docstring."""

    __slots__ = ("ids", "offs", "coef_ids", "coef_vals", "icpt",
                 "coef_vars", "icpt_vars", "_id2row")

    def __init__(self, ids, offs, coef_ids, coef_vals, icpt=None,
                 coef_vars=None, icpt_vars=None):
        self.ids = np.asarray(ids, dtype=object)
        self.offs = np.asarray(offs, dtype=np.int64)
        self.coef_ids = np.asarray(coef_ids, dtype=np.int64)
        self.coef_vals = np.asarray(coef_vals, dtype=np.float64)
        self.icpt = None if icpt is None else np.asarray(icpt, np.float64)
        self.coef_vars = (None if coef_vars is None
                          else np.asarray(coef_vars, np.float64))
        self.icpt_vars = (None if icpt_vars is None
                          else np.asarray(icpt_vars, np.float64))
        self._id2row: Optional[Dict[str, int]] = None
        assert len(self.offs) == len(self.ids) + 1

    # ------------------------------------------------------------- Mapping --

    @property
    def id2row(self) -> Dict[str, int]:
        if self._id2row is None:
            self._id2row = {mid: i for i, mid in enumerate(self.ids)}
        return self._id2row

    def __len__(self) -> int:
        return len(self.ids)

    def __iter__(self) -> Iterator[str]:
        return iter(self.ids)

    def __contains__(self, key) -> bool:
        return key in self.id2row

    def __getitem__(self, key) -> SparseModel:
        row = self.id2row.get(key)
        if row is None:
            raise KeyError(key)
        return self.row_model(row)

    def row_model(self, row: int) -> SparseModel:
        """Materialize one entity's SparseModel (theta = [b?, w...])."""
        o0, o1 = int(self.offs[row]), int(self.offs[row + 1])
        vals = self.coef_vals[o0:o1]
        if self.icpt is not None:
            theta = np.empty(1 + (o1 - o0), np.float64)
            theta[0] = self.icpt[row]
            theta[1:] = vals
        else:
            theta = vals.copy()
        variance = None
        if self.coef_vars is not None:
            v = self.coef_vars[o0:o1]
            if self.icpt_vars is not None:
                variance = np.empty(1 + (o1 - o0), np.float64)
                variance[0] = self.icpt_vars[row]
                variance[1:] = v
            else:
                variance = v.copy()
        return SparseModel(model_id=self.ids[row], theta=theta,
                           variance=variance,
                           unique_global_indices=self.coef_ids[o0:o1])

    @property
    def has_intercept(self) -> bool:
        return self.icpt is not None

    @property
    def with_variance(self) -> bool:
        return self.coef_vars is not None

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    # -------------------------------------------------------- constructors --

    @classmethod
    def empty(cls, has_intercept: bool = True,
              with_variance: bool = False) -> "ModelTable":
        z = np.zeros(0, np.float64)
        return cls(ids=np.zeros(0, object), offs=np.zeros(1, np.int64),
                   coef_ids=np.zeros(0, np.int64), coef_vals=z,
                   icpt=z if has_intercept else None,
                   coef_vars=z if with_variance else None,
                   icpt_vars=z if with_variance and has_intercept else None)

    @classmethod
    def from_models(cls, models: Mapping[str, SparseModel],
                    has_intercept: bool) -> Optional["ModelTable"]:
        """Wrap a {id: SparseModel} dict (per-entity work — the compatibility
        path for priors loaded by non-columnar code). Returns None when
        variance presence is mixed across models (not representable)."""
        if isinstance(models, ModelTable):
            return models
        E = len(models)
        sms = list(models.values())
        n_var = sum(sm.variance is not None for sm in sms)
        if 0 < n_var < E:
            return None
        with_var = n_var == E and E > 0
        if with_var and any(len(sm.variance) != len(sm.theta) for sm in sms):
            return None  # intercept-only models carry variance for the
            # intercept but a dummy weight in theta (io_utils.py:86-99)
        off = 1 if has_intercept else 0
        lens = np.fromiter((len(sm.unique_global_indices) for sm in sms),
                           np.int64, E)
        offs = np.zeros(E + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        coef_ids = np.zeros(total, np.int64)
        coef_vals = np.zeros(total, np.float64)
        coef_vars = np.zeros(total, np.float64) if with_var else None
        icpt = np.zeros(E, np.float64) if has_intercept else None
        icpt_vars = (np.zeros(E, np.float64)
                     if with_var and has_intercept else None)
        for i, sm in enumerate(sms):
            o0, o1 = offs[i], offs[i + 1]
            coef_ids[o0:o1] = sm.unique_global_indices
            coef_vals[o0:o1] = sm.theta[off:]
            if has_intercept:
                icpt[i] = sm.theta[0]
            if with_var:
                coef_vars[o0:o1] = sm.variance[off:]
                if has_intercept:
                    icpt_vars[i] = sm.variance[0]
        return cls(ids=np.asarray(list(models.keys()), object), offs=offs,
                   coef_ids=coef_ids, coef_vals=coef_vals, icpt=icpt,
                   coef_vars=coef_vars, icpt_vars=icpt_vars)

    @classmethod
    def concat(cls, tables: Sequence["ModelTable"], has_intercept: bool,
               with_variance: bool) -> "ModelTable":
        tables = [t for t in tables if len(t)]
        if not tables:
            return cls.empty(has_intercept, with_variance)
        if len(tables) == 1:
            return tables[0]
        sizes = np.asarray([len(t) for t in tables], np.int64)
        shifts = np.repeat(np.concatenate(
            [[0], np.cumsum([t.offs[-1] for t in tables])[:-1]]), sizes + 1)
        offs_parts = np.concatenate([t.offs for t in tables]) + shifts
        # drop the duplicated boundary zeros: keep each table's offs[:-1], plus
        # the final total
        keep = np.ones(len(offs_parts), bool)
        keep[np.cumsum(sizes + 1)[:-1] - 1] = False
        cat = lambda key: np.concatenate([getattr(t, key) for t in tables])
        return cls(
            ids=cat("ids"), offs=offs_parts[keep],
            coef_ids=cat("coef_ids"), coef_vals=cat("coef_vals"),
            icpt=cat("icpt") if has_intercept else None,
            coef_vars=cat("coef_vars") if with_variance else None,
            icpt_vars=(cat("icpt_vars") if with_variance and has_intercept
                       else None))

    def select_rows(self, rows: np.ndarray) -> "ModelTable":
        """New table with the given rows (in the given order)."""
        rows = np.asarray(rows, np.int64)
        lens = self.lens[rows]
        offs = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        coef_ids = np.zeros(total, np.int64)
        coef_vals = np.zeros(total, np.float64)
        coef_vars = np.zeros(total, np.float64) if self.with_variance else None
        src_starts = self.offs[rows]
        _ragged_copy(coef_ids, offs[:-1], self.coef_ids, src_starts, lens)
        _ragged_copy(coef_vals, offs[:-1], self.coef_vals, src_starts, lens)
        if coef_vars is not None:
            _ragged_copy(coef_vars, offs[:-1], self.coef_vars, src_starts, lens)
        return ModelTable(
            ids=self.ids[rows], offs=offs, coef_ids=coef_ids,
            coef_vals=coef_vals,
            icpt=None if self.icpt is None else self.icpt[rows],
            coef_vars=coef_vars,
            icpt_vars=None if self.icpt_vars is None else self.icpt_vars[rows])

    def deduped_last(self) -> "ModelTable":
        """Collapse duplicate ids keeping the LAST row per id (dict last-wins
        semantics, in first-occurrence order — what repeated dict[k]=v yields).
        Duplicate ids arise when a capped entity's overflow groups
        (DataPartitioner upper-bound pairs) are trained as separate groups;
        the pre-columnar dict path deduped implicitly. No-op (returns self)
        when ids are already unique."""
        if len(self.id2row) == len(self):
            return self
        first = {}
        for i, mid in enumerate(self.ids):
            if mid not in first:
                first[mid] = i
        rows = np.fromiter((self.id2row[mid] for mid in first), np.int64,
                           len(first))
        return self.select_rows(rows)

    # --------------------------------------------------------------- merge --

    def merged_with(self, new: "ModelTable"):
        """prior ∪ new with dict.update order semantics: prior ids keep their
        position (values replaced when retrained), new-only ids append in new
        order (reference random_effect_lr_lbfgs_model.py:162). Falls back to a
        plain dict when intercept/variance layouts are incompatible."""
        if len(self) == 0:
            return new
        if len(new) == 0:
            return self
        if (self.has_intercept != new.has_intercept
                or self.with_variance != new.with_variance):
            out: Dict[str, SparseModel] = dict(self)
            out.update(new)
            return out
        new_rows = new.id2row
        # per-prior-row replacement source (dict lookups only — no objects)
        repl = np.fromiter((new_rows.get(mid, -1) for mid in self.ids),
                           np.int64, len(self))
        prior_hit = repl >= 0
        in_prior = self.id2row
        new_only = np.fromiter((mid not in in_prior for mid in new.ids),
                               bool, len(new))
        E_out = len(self) + int(new_only.sum())
        ids = np.concatenate([self.ids, new.ids[new_only]])

        src_tab = np.concatenate([np.where(prior_hit, 1, 0),
                                  np.ones(int(new_only.sum()), np.int64)])
        src_row = np.concatenate([np.where(prior_hit, repl, np.arange(len(self))),
                                  np.flatnonzero(new_only)])
        lens_by = (self.lens, new.lens)
        out_lens = np.where(src_tab == 0,
                            lens_by[0][np.minimum(src_row, len(self) - 1)],
                            lens_by[1][np.minimum(src_row, len(new) - 1)])
        offs = np.zeros(E_out + 1, np.int64)
        np.cumsum(out_lens, out=offs[1:])
        total = int(offs[-1])
        coef_ids = np.zeros(total, np.int64)
        coef_vals = np.zeros(total, np.float64)
        coef_vars = np.zeros(total, np.float64) if self.with_variance else None
        for t, tab in ((0, self), (1, new)):
            sel = np.flatnonzero(src_tab == t)
            if not len(sel):
                continue
            rows = src_row[sel]
            lens = tab.lens[rows]
            _ragged_copy(coef_ids, offs[sel], tab.coef_ids, tab.offs[rows], lens)
            _ragged_copy(coef_vals, offs[sel], tab.coef_vals, tab.offs[rows],
                         lens)
            if coef_vars is not None:
                _ragged_copy(coef_vars, offs[sel], tab.coef_vars,
                             tab.offs[rows], lens)
        pick = lambda key: (None if getattr(self, key) is None else
                            np.where(src_tab == 0,
                                     getattr(self, key)[np.minimum(
                                         src_row, len(self) - 1)],
                                     getattr(new, key)[np.minimum(
                                         src_row, len(new) - 1)]))
        return ModelTable(ids=ids, offs=offs, coef_ids=coef_ids,
                          coef_vals=coef_vals, icpt=pick("icpt"),
                          coef_vars=coef_vars, icpt_vars=pick("icpt_vars"))

    # ------------------------------------------------------------- scoring --

    def scoring_csr(self):
        """Sparse scoring arrays — the O(nnz)-memory replacement for a dense
        [E+1, D] coefficient table (which is O(E·D) and impossible at
        production scale; the reference scores per-entity sparse,
        job_consumers.py:138-152). Feature ids are rank-compacted against the
        table's own support union (U distinct features), so the combined
        (entity, feature-rank) key span is E·(U+1) — independent of the
        global feature-space width D, no int64 overflow at any real scale.
        Returns (keys, vals, icpt, uniq_fids):
          keys [M] int64  — sorted row·(U+1) + rank(coef_id)
          vals [M] f64    — coefficient per key
          icpt [E+1] f64  — intercepts; row E stays 0 (entities without a
                            model score as logits = offsets)
          uniq_fids [U]   — sorted distinct global feature ids (for ranking
                            record indices at score time)."""
        E = len(self)
        uniq = np.unique(self.coef_ids)
        U = len(uniq)
        assert E * (U + 1) < (1 << 62), "scoring key span overflow"
        rank = np.searchsorted(uniq, self.coef_ids)
        rows = np.repeat(np.arange(E, dtype=np.int64), self.lens)
        key = rows * np.int64(U + 1) + rank
        order = np.argsort(key, kind="stable")  # rows ascend already; sorts
        # within each entity's span (coef_ids are not guaranteed sorted)
        icpt = np.zeros(E + 1)
        if self.icpt is not None:
            icpt[:E] = self.icpt
        return key[order], self.coef_vals[order], icpt, uniq
