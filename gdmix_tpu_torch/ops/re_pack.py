"""The random-effect fit's marshal on the card: a columnar partition
(data/bucketing.py FlatGroups) packed into the solver's tier tensors from
one upload of its flat columns. Every input of the host plane reaches it
through `flat_groups`: a List[EntityGroup] flattened, a FlatGroups without
a feature block given an inert one.

The plan stays on the host and is the JAX package's: `_sample_caps` and
`plan_lane_buckets` of data/bucketing.py over the entities' record counts,
so the tiers, their members, the slot order, B = max(8, next pow2), k =
round_up(max nnz, 4) and u = round_up(max distinct ids, 8) are those of
`iter_bucketize_flat`. Everything that reads the records runs on the card,
in the two passes of csrc/re_pack.cu:

  re_supports   each entity's sorted distinct feature ids, their count and
                its largest nnz, and per tier the maxima that fix k and u
                (read back once a fit: the marshal's one host sync);
  re_pack_tier  one tier's [B, n_cap, k] local ids (int64) and values,
                [B, n_cap] labels, offsets and weights, [B] sample counts in
                the model's dtype, and the members' distinct ids into a
                compact buffer the host fetches with the solutions.

The tensors equal, bit for bit, what `iter_bucketize_flat` and
`util/convert.py newton_inputs_from_numpy` give: both round the float64
columns to the model's dtype once, to nearest. On a CUDA tensor each
wrapper launches its kernel and counts the launch in `.launches`; on a CPU
tensor it takes the plain PyTorch version beside it. Replaces no TPU
kernel: the JAX package packs on the host (csrc/re_pack.cu says what bounds
the kernels and how).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from gdmix_tpu_torch.data.bucketing import (FlatGroups, _next_pow2,
                                            _round_up, _sample_caps,
                                            plan_lane_buckets)
from gdmix_tpu_torch.ops import _cuda

# iter_bucketize_flat's defaults, which fit_groups takes
MIN_BUCKET_ROWS, BATCH_ALIGN, NNZ_ALIGN, U_ALIGN = 8, 8, 4, 8
# the kernel's paths (kWarpKeys, kBlockKeys in csrc/re_pack.cu): a warp an
# entity up to WARP_KEYS of its count·K entries, past that a block, its keys
# in shared memory up to BLOCK_KEYS and past that in a device workspace;
# checked against the library at its first load
WARP_KEYS, BLOCK_KEYS = 256, 4096
_SHIFT = 32
_BIAS = 1 << 31     # an int32 id as a non-negative 32-bit field of a key


class BlockPath(NamedTuple):
    """The entities pass 1 gives a block each (count·K > WARP_KEYS):
    their indices [n] int32 and the offset of each one's keys in the int32
    workspace [n] int64 (−1: in shared memory), and the workspace's size."""
    ents: torch.Tensor
    ws_off: torch.Tensor
    ws_size: int


class Supports(NamedTuple):
    """Pass 1's outputs. uniq [max(N·K, 1)] int32: entity e's u_count[e]
    sorted distinct ids at starts[e]·K (the rest undefined); u_count and
    max_nnz [E] int32; tier_max [T, 2] int32: per tier the largest
    max(u_count, 1) and the largest nnz of its members."""
    uniq: torch.Tensor
    u_count: torch.Tensor
    max_nnz: torch.Tensor
    tier_max: torch.Tensor


def block_path(counts: np.ndarray, K: int) -> tuple:
    """(entities, workspace offsets, workspace size) of pass 1's block
    path, as numpy, from the record counts."""
    n = np.asarray(counts, np.int64) * K
    ents = np.flatnonzero(n > WARP_KEYS)
    # the next power of two of each n > WARP_KEYS ≥ 2: 2^e with n − 1 < 2^e
    p = np.left_shift(1, np.frexp(n[ents] - 1)[1].astype(np.int64))
    big = p > BLOCK_KEYS
    ws_off = np.full(len(ents), -1, np.int64)
    ws_off[big] = np.cumsum(p[big]) - p[big]
    return ents.astype(np.int32), ws_off, int(p[big].sum())


# ------------------------------------------------------------- pass 1 --

def re_supports_plain(indices, nnz, counts, starts, tier_of,
                      n_tiers: int) -> Supports:
    """The plain version of pass 1: one sort of (entity, id) keys."""
    N, K = indices.shape
    E = counts.shape[0]
    dev = indices.device
    cnt = counts.long()
    ent = torch.repeat_interleave(torch.arange(E, device=dev), cnt)
    nz = (nnz.long() if nnz is not None
          else torch.full((N,), K, dtype=torch.long, device=dev))
    live = torch.arange(K, device=dev)[None, :] < nz[:, None]
    key = (ent[:, None] << _SHIFT) + (indices.long() + _BIAS)
    ukey = torch.unique(key[live])
    uent = ukey >> _SHIFT
    u_count = torch.bincount(uent, minlength=E)
    rank = (torch.arange(ukey.shape[0], device=dev)
            - (torch.cumsum(u_count, 0) - u_count)[uent])
    uniq = torch.zeros(max(N * K, 1), dtype=torch.int32, device=dev)
    uniq[starts[uent] * K + rank] = ((ukey & ((1 << _SHIFT) - 1))
                                     - _BIAS).int()
    zeros = lambda n: torch.zeros(n, dtype=torch.long, device=dev)  # noqa
    max_nnz = zeros(E).scatter_reduce_(0, ent, nz, "amax")
    t = tier_of.long()
    tier_max = torch.stack(
        [zeros(n_tiers).scatter_reduce_(0, t, u_count.clamp_min(1), "amax"),
         zeros(n_tiers).scatter_reduce_(0, t, max_nnz, "amax")], 1)
    return Supports(uniq, u_count.int(), max_nnz.int(), tier_max.int())


def _library():
    """The library, its entry points typed once, at its first use."""
    lib = _cuda.load("re_pack")
    if not getattr(lib, "_gdx_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gdx_re_supports.argtypes = [P, P, P, P, P, L, I, P, P, P, L, P,
                                        P, P, P, P]
        lib.gdx_re_supports.restype = I
        for name in ("gdx_re_pack_tier_f32", "gdx_re_pack_tier_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [P] * 12 + [L, L, L, I, I] + [P] * 8
            fn.restype = I
        for name in ("gdx_re_pack_warp_keys", "gdx_re_pack_block_keys"):
            getattr(lib, name).restype = I
        paths = (lib.gdx_re_pack_warp_keys(), lib.gdx_re_pack_block_keys())
        if paths != (WARP_KEYS, BLOCK_KEYS):
            raise RuntimeError(f"re_pack: the library's paths {paths} are "
                               f"not the wrapper's {(WARP_KEYS, BLOCK_KEYS)}")
        lib._gdx_typed = True
    return lib


def _opt(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def re_supports(indices: torch.Tensor, nnz: Optional[torch.Tensor],
                counts: torch.Tensor, starts: torch.Tensor,
                tier_of: torch.Tensor, n_tiers: int,
                block: BlockPath) -> Supports:
    """Pass 1 over every entity: indices [N, K] int32 (records
    entity-contiguous), nnz [N] int32 or None (all K live), counts [E]
    int32, starts [E] int64, tier_of [E] int32; `block` the block path's
    lists (block_path, on the same device). On a CPU tensor the plain
    version."""
    if indices.device.type == "cpu":
        return re_supports_plain(indices, nnz, counts, starts, tier_of,
                                 n_tiers)
    what = "re_supports"
    ints = [indices, counts, tier_of, block.ents] + (
        [] if nnz is None else [nnz])
    _cuda.require_cuda(what, *ints, dtypes=(torch.int32,))
    _cuda.require_cuda(what, starts, block.ws_off, dtypes=(torch.int64,))
    N, K = indices.shape
    E = counts.shape[0]
    if (starts.shape != (E,) or tier_of.shape != (E,)
            or (nnz is not None and nnz.shape != (N,))
            or block.ents.shape != block.ws_off.shape):
        raise ValueError(f"{what}: counts, starts and tier_of must be [E], "
                         "nnz [N], the block lists of one length")
    dev = indices.device
    uniq = torch.empty(max(N * K, 1), dtype=torch.int32, device=dev)
    u_count = torch.empty(E, dtype=torch.int32, device=dev)
    max_nnz = torch.empty(E, dtype=torch.int32, device=dev)
    tier_max = torch.zeros(n_tiers, 2, dtype=torch.int32, device=dev)
    ws = torch.empty(max(block.ws_size, 1), dtype=torch.int32, device=dev)
    lib = _library()
    with _cuda.on_card(indices) as stream:
        err = lib.gdx_re_supports(
            _cuda.ptr(indices), _opt(nnz), _cuda.ptr(counts),
            _cuda.ptr(starts), _cuda.ptr(tier_of), E, K,
            _cuda.ptr(block.ents), _cuda.ptr(block.ws_off), _cuda.ptr(ws),
            block.ents.shape[0], _cuda.ptr(uniq), _cuda.ptr(u_count),
            _cuda.ptr(max_nnz), _cuda.ptr(tier_max), stream)
    _cuda.check(lib, err, what)
    re_supports.launches += 1
    return Supports(uniq, u_count, max_nnz, tier_max)


re_supports.launches = 0


# ------------------------------------------------------------- pass 2 --

class Columns(NamedTuple):
    """A partition's flat columns on one device: indices [N, K] int32,
    values [N, K], labels / offsets / weights [N] or None, in the model's
    dtype; nnz [N] int32 or None; counts [E] int32; starts [E] int64."""
    indices: Optional[torch.Tensor]
    values: Optional[torch.Tensor]
    nnz: Optional[torch.Tensor]
    labels: Optional[torch.Tensor]
    offsets: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]
    counts: torch.Tensor
    starts: torch.Tensor


def re_pack_tier_plain(cols: Columns, sup: Optional[Supports],
                       members: torch.Tensor, coff: Optional[torch.Tensor],
                       b: int, n_cap: int, k: int, dtype,
                       static: bool = True,
                       sup_out: Optional[torch.Tensor] = None) -> dict:
    """The plain version of pass 2: gathers by (slot, row)."""
    dev = members.device
    m = members.long()
    br = m.shape[0]
    cnt = cols.counts[m].long()
    row = torch.arange(n_cap, device=dev)
    real = row[None, :] < cnt[:, None]
    rec = torch.where(real, cols.starts[m][:, None] + row[None, :], 0)

    def col(x, fill):
        out = torch.zeros(b, n_cap, dtype=dtype, device=dev)
        out[:br] = (torch.where(real, x[rec], 0) if x is not None
                    else real.to(dtype) * fill)
        return out

    out = {"offsets": col(cols.offsets, 0.0)}
    if static:
        out["labels"] = col(cols.labels, 0.0)
        out["weights"] = col(cols.weights, 1.0)
        out["sample_count"] = torch.zeros(b, dtype=dtype, device=dev)
        out["sample_count"][:br] = cnt.to(dtype)
        K = cols.indices.shape[1]
        kk = min(k, K)
        nz = (cols.nnz[rec].long() if cols.nnz is not None
              else torch.full_like(rec, K)).clamp_max(K)
        live = real[:, :, None] & (torch.arange(kk, device=dev)
                                   < nz[..., None])
        idx = torch.zeros(b, n_cap, k, dtype=torch.int64, device=dev)
        val = torch.zeros(b, n_cap, k, dtype=dtype, device=dev)
        u = sup.u_count[m].long()
        slot = torch.repeat_interleave(torch.arange(br, device=dev), u)
        first = torch.cumsum(u, 0) - u
        j = torch.arange(slot.shape[0], device=dev) - first[slot]
        skey = (slot << _SHIFT) + (
            sup.uniq[cols.starts[m][slot] * K + j].long() + _BIAS)
        q = ((torch.arange(br, device=dev)[:, None, None] << _SHIFT)
             + (cols.indices[rec][:, :, :kk].long() + _BIAS))[live]
        qslot = torch.nonzero(live)[:, 0]
        idx[:br, :, :kk][live] = torch.searchsorted(skey, q) - first[qslot]
        val[:br, :, :kk][live] = cols.values[rec][:, :, :kk][live]
        out["indices"], out["values"] = idx, val
    if sup_out is not None:
        u = sup.u_count[m].long()
        ue = u.clamp_min(1)
        slot = torch.repeat_interleave(torch.arange(br, device=dev), ue)
        j = torch.arange(slot.shape[0], device=dev) \
            - (torch.cumsum(ue, 0) - ue)[slot]
        src = cols.starts[m][slot] * cols.indices.shape[1] + j
        ids = torch.where(u[slot] > 0, sup.uniq[src.clamp_max(
            sup.uniq.shape[0] - 1)], 0)
        sup_out[coff[slot] + j] = ids
    return out


def re_pack_tier(cols: Columns, sup: Optional[Supports],
                 members: torch.Tensor, coff: Optional[torch.Tensor],
                 b: int, n_cap: int, k: int, dtype, static: bool = True,
                 sup_out: Optional[torch.Tensor] = None) -> dict:
    """Pass 2 over one tier: the members [b_real] int32 (the entity in
    each slot) packed into {offsets} and, with `static`, {labels, weights,
    sample_count, indices, values} ([b, n_cap, k] local ids as int64);
    with `sup_out`, each member's distinct ids (a dummy 0 where it has
    none) written to sup_out at coff [b_real] int64. `sup` (pass 1's) is
    read for the entries and the supports. On a CPU tensor the plain
    version."""
    if members.device.type == "cpu":
        return re_pack_tier_plain(cols, sup, members, coff, b, n_cap, k,
                                  dtype, static, sup_out)
    what = "re_pack_tier"
    _cuda.require_cuda(what, members, cols.counts, dtypes=(torch.int32,))
    _cuda.require_cuda(what, cols.starts, dtypes=(torch.int64,))
    fl = [t for t in (cols.values, cols.labels, cols.offsets, cols.weights)
          if t is not None]
    if fl:
        _cuda.require_cuda(what, *fl, dtypes=(dtype,))
    br = members.shape[0]
    if br > b or (sup_out is not None and (coff is None
                                           or coff.shape != (br,))):
        raise ValueError(f"{what}: {br} members for {b} slots; sup_out "
                         "needs coff [b_real]")
    if static or sup_out is not None:
        if sup is None or cols.indices is None:
            raise ValueError(f"{what}: the entries need pass 1's supports")
        _cuda.require_cuda(what, cols.indices, sup.uniq, sup.u_count,
                           dtypes=(torch.int32,))
    dev = members.device
    e3 = lambda t: torch.empty(b, n_cap, k, dtype=t, device=dev)  # noqa
    e2 = lambda: torch.empty(b, n_cap, dtype=dtype, device=dev)  # noqa
    out = {"offsets": e2()}
    if static:
        out.update(labels=e2(), weights=e2(),
                   sample_count=torch.empty(b, dtype=dtype, device=dev),
                   indices=e3(torch.int64), values=e3(dtype))
    K = 0 if cols.indices is None else cols.indices.shape[1]
    lib = _library()
    fn = (lib.gdx_re_pack_tier_f64 if dtype == torch.float64
          else lib.gdx_re_pack_tier_f32)
    with _cuda.on_card(members) as stream:
        err = fn(_opt(cols.indices), _opt(cols.values), _opt(cols.nnz),
                 _opt(cols.labels), _opt(cols.offsets), _opt(cols.weights),
                 _cuda.ptr(cols.counts), _cuda.ptr(cols.starts),
                 _opt(sup and sup.uniq), _opt(sup and sup.u_count),
                 _cuda.ptr(members), _opt(coff), br, b, n_cap, k, K,
                 _opt(out.get("indices")), _opt(out.get("values")),
                 _opt(out.get("labels")), _cuda.ptr(out["offsets"]),
                 _opt(out.get("weights")), _opt(out.get("sample_count")),
                 _opt(sup_out), stream)
    _cuda.check(lib, err, what)
    re_pack_tier.launches += 1
    return out


re_pack_tier.launches = 0


# ------------------------------------------------------- one fit's marshal --

class Tier(NamedTuple):
    """One tier of the plan: its sample cap, its members (entity indices,
    in slot order), B, and where its slots start in the plan's order."""
    n_cap: int
    members: np.ndarray
    b: int
    base: int


def flat_groups(groups, *, weight_column: Optional[str]) -> FlatGroups:
    """Any input of the host plane as the FlatGroups FlatPack packs into
    the tensors `bucketize` / `iter_bucketize_flat` give it. A FlatGroups
    with a feature block stays as it is; one without (an intercept-only
    coordinate) gets an inert [N, 1] block of nnz 0, so every entity packs
    with the dummy support [0]. A List[EntityGroup] is flattened in list
    order, each group's first sample_count records, its ids and values
    padded to the largest nnz; a column a group lacks reads 1 for
    `weight_column` and 0 for any other, as bucketize reads it."""
    if not isinstance(groups, FlatGroups):
        counts = np.array([g.sample_count for g in groups], np.int64)
        starts, N = np.cumsum(counts) - counts, int(counts.sum())
        nnz = np.zeros(N, np.int32)
        for g, s, n in zip(groups, starts, counts):
            lens = (g.rec_nnz if g.padded_indices is not None
                    else [len(r) for r in g.ragged_indices])[:n]
            nnz[s:s + len(lens)] = lens
        idx = np.zeros((N, max(int(nnz.max(initial=0)), 1)), np.int32)
        val = np.zeros(idx.shape)
        for g, s, n in zip(groups, starts, counts):
            if g.padded_indices is not None:
                w = min(g.padded_indices.shape[1], idx.shape[1])
                idx[s:s + n, :w] = g.padded_indices[:n, :w]
                val[s:s + n, :w] = g.padded_values[:n, :w]
                continue
            for r, (i, v) in enumerate(zip(g.ragged_indices[:n],
                                           g.ragged_values[:n])):
                idx[s + r, :len(i)], val[s + r, :len(i)] = i, v
        names = dict.fromkeys(k for g in groups for k in g.columns)
        columns = {k: np.concatenate(
            [np.asarray(g.columns[k])[:n] if k in g.columns
             else np.full(n, 1 if k == weight_column else 0)
             for g, n in zip(groups, counts)]) for k in names}
        groups = FlatGroups(
            entity_ids=np.array([g.entity_id for g in groups], object),
            counts=counts, columns=columns, indices=idx, values=val,
            rec_nnz=nnz)
    if groups.indices is None:
        N = int(np.asarray(groups.counts, np.int64).sum())
        groups = dataclasses.replace(
            groups, indices=np.zeros((N, 1), np.int32),
            values=np.zeros((N, 1), np.float32),
            rec_nnz=np.zeros(N, np.int32))
    return groups


def _float_column(a) -> np.ndarray:
    """A record column as it crosses: float32 and float64 as they are
    (the card rounds to the model's dtype), anything else as float64 (as
    iter_bucketize_flat reads it)."""
    a = np.asarray(a)
    return np.ascontiguousarray(
        a, a.dtype if a.dtype in (np.float32, np.float64) else np.float64)


class FlatPack:
    """One fit's marshal of any input of the host plane, on one device:
    the input as a FlatGroups (flat_groups) and the host plan at
    construction, then `upload` (the flat columns,
    one copy each), `supports` (pass 1 and its caps), and `tier` (pass 2 of
    one tier). `support_ids` is the buffer the host fetches after the
    solves: [E] the members' distinct-id counts in the plan's order, then
    their ids, each tier's after the last."""

    def __init__(self, groups, *, label_column: Optional[str],
                 weight_column: Optional[str], offset_column: Optional[str],
                 device, dtype):
        fg = flat_groups(groups, weight_column=weight_column)
        self.fg, self.device, self.dtype = fg, torch.device(device), dtype
        self.names = {"labels": label_column, "weights": weight_column,
                      "offsets": offset_column}
        counts = np.asarray(fg.counts, np.int64)
        self.counts = counts
        self.E, self.K = len(counts), fg.indices.shape[1]
        plan = plan_lane_buckets(
            counts, _sample_caps(counts, MIN_BUCKET_ROWS),
            dispatch_latency_s=1e-3)
        self.tiers: List[Tier] = []
        base = 0
        for n_cap, members in plan:
            self.tiers.append(Tier(n_cap, members,
                                   max(BATCH_ALIGN, _next_pow2(len(members))),
                                   base))
            base += len(members)
        self.order = np.concatenate([t.members for t in self.tiers])
        self.cols = self.sup = self.support_ids = self._coff = None
        self.k = self.u = None

    def _column(self, name) -> Optional[np.ndarray]:
        col = self.names[name]
        return (_float_column(self.fg.columns[col])
                if col and col in self.fg.columns else None)

    def upload(self, static: bool = True) -> list:
        """Copy the columns to the device, without waiting for the copies
        (a copy from pageable memory is staged before it returns): all of
        them, or with `static` False the offsets and what packs them.
        Returns the tensors as they crossed."""
        dev, fg = self.device, self.fg
        host = {"counts": self.counts.astype(np.int32),
                "starts": np.cumsum(self.counts) - self.counts,
                "order": self.order.astype(np.int32),
                "offsets": self._column("offsets")}
        if static:
            tier_of = np.empty(self.E, np.int32)
            for i, t in enumerate(self.tiers):
                tier_of[t.members] = i
            ents, ws_off, self._ws_size = block_path(self.counts, self.K)
            host.update(
                indices=np.ascontiguousarray(fg.indices, np.int32),
                values=_float_column(fg.values),
                nnz=(None if fg.rec_nnz is None
                     else np.ascontiguousarray(fg.rec_nnz, np.int32)),
                labels=self._column("labels"),
                weights=self._column("weights"), tier_of=tier_of,
                block_ents=ents, ws_off=ws_off)
        crossed = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                   for k, v in host.items() if v is not None}
        floats = ("values", "labels", "offsets", "weights")
        as_model = {k: crossed[k].to(self.dtype) if k in crossed else None
                    for k in floats}
        self._dev = {k: v for k, v in crossed.items() if k not in floats}
        self.cols = Columns(indices=crossed.get("indices"),
                            nnz=crossed.get("nnz"), counts=crossed["counts"],
                            starts=crossed["starts"], **as_model)
        return list(crossed.values())

    def release(self) -> None:
        """Drop the flat columns and pass 1's outputs once every tier is
        packed (the device frees them in stream order, after the passes
        that read them); `support_ids` stays for the read-back."""
        self.cols = self.sup = self._dev = self._coff = None

    def supports(self) -> None:
        """Pass 1, then each tier's k and u from its caps, read back with
        the size of the compact supports: the one host sync."""
        d, cols = self._dev, self.cols
        self.sup = re_supports(
            cols.indices, cols.nnz, cols.counts, cols.starts, d["tier_of"],
            len(self.tiers), BlockPath(d["block_ents"], d["ws_off"],
                                       self._ws_size))
        u_ordered = self.sup.u_count[d["order"].long()]
        ue = u_ordered.long().clamp_min(1)
        self._coff = torch.cumsum(ue, 0) - ue
        caps = torch.cat([self.sup.tier_max.reshape(-1).long(),
                          (self._coff[-1:] + ue[-1:])]).cpu().numpy()
        tier_max, total = caps[:-1].reshape(-1, 2), int(caps[-1])
        self.u = [_round_up(int(a), U_ALIGN) for a in tier_max[:, 0]]
        self.k = [_round_up(max(int(a), 1), NNZ_ALIGN)
                  for a in tier_max[:, 1]]
        self.support_ids = torch.empty(self.E + total, dtype=torch.int32,
                                       device=self.device)
        self.support_ids[:self.E] = u_ordered
        self._coff += self.E

    def tier(self, i: int, static: bool = True) -> dict:
        """Pass 2 of tier i: its solver tensors (no θ0); with `static`
        False only its offsets (the sweep cache holds the rest)."""
        t = self.tiers[i]
        sl = slice(t.base, t.base + len(t.members))
        members = self._dev["order"][sl]
        return re_pack_tier(
            self.cols, self.sup, members,
            None if self._coff is None else self._coff[sl], t.b, t.n_cap,
            self.k[i] if static else 0, self.dtype, static=static,
            sup_out=self.support_ids if static else None)

    def host_supports(self, ids: np.ndarray, i: int) -> tuple:
        """(distinct-id counts [b_real] int64, the ids [Σ max(count, 1)]
        int64: a dummy 0 where an entity has none) of tier i, from the
        fetched `support_ids`."""
        t = self.tiers[i]
        u = ids[t.base:t.base + len(t.members)].astype(np.int64)
        ue = np.maximum(u, 1)
        head = self.E + int(np.maximum(ids[:t.base].astype(np.int64), 1)
                            .sum())
        return u, ids[head:head + int(ue.sum())].astype(np.int64)


def prior_theta0(entity_ids: list, supports: list, u_caps: list, bs: list,
                 prior, has_intercept: bool) -> list:
    """Each tier's warm start [b, dim] float64 from a prior (a ModelTable
    or a dict of SparseModel): iter_bucketize_flat's reconciliation
    (reference job_consumers.py:260-288), on the fetched supports. A copy
    that must track data/bucketing.py's: the ModelTable intersection at
    lines 363-403 (the fid_hi retry, the zero-nnz dummy support) and each
    tier's θ0 fill at lines 478-495 (the per-slot _warm_start for a dict).
    That file stays byte-equal to the JAX package's and so cannot call a
    shared helper; tests/test_torch_re_pack.py holds both θ0 equal under
    each kind of prior. Tier i
    has entity_ids[i] (its members in slot order) and supports[i] = (their
    distinct-id counts, their ids with a dummy 0 where the count is 0).
    The tiers' members one after another stand in for the partition's
    entities: in that order too every entity's ids follow the last one's,
    as the key intersection needs."""
    from gdmix_tpu_torch.data.bucketing import _warm_start
    from gdmix_tpu_torch.io.model_table import (ModelTable, flat_positions,
                                                intersect_prior_support)
    off = 1 if has_intercept else 0
    thetas = [np.zeros((b, u + off), np.float64) for b, u in zip(bs, u_caps)]
    if not prior:
        return thetas
    lens = [len(e) for e in entity_ids]
    bases = np.cumsum(lens) - lens
    eids = np.concatenate(entity_ids)
    E = len(eids)
    u_counts = np.concatenate([s[0] for s in supports]).astype(np.int64)
    ids = np.concatenate([s[1] for s in supports]).astype(np.int64)
    uniq_fid = ids[np.repeat(u_counts > 0, np.maximum(u_counts, 1))]
    uniq_ent = np.repeat(np.arange(E), u_counts)
    u_off = np.cumsum(u_counts) - u_counts
    warm = None
    if (isinstance(prior, ModelTable) and len(prior)
            and prior.has_intercept == has_intercept):
        id2row = prior.id2row
        prow = np.fromiter((id2row.get(e, -1) for e in eids), np.int64, E)
        hasp = prow >= 0
        ents = np.flatnonzero(hasp)
        fid_hi = max(int(prior.coef_ids.max(initial=0)),
                     int(uniq_fid.max(initial=0))) + 1
        if E * fid_hi >= (1 << 62):
            lens_m = prior.lens[prow[ents]]
            src_m = flat_positions(prior.offs[prow[ents]], lens_m)
            fid_hi = max(int(prior.coef_ids[src_m].max(initial=0)),
                         int(uniq_fid.max(initial=0))) + 1
        if E * fid_hi < (1 << 62):
            p_ent, p_fid, p_val, pos_c, hit = intersect_prior_support(
                prior, ents, prow[ents], uniq_ent * fid_hi + uniq_fid,
                fid_hi)
            warm_ent = p_ent[hit]
            warm_local = pos_c[hit] - u_off[warm_ent]
            warm_val = p_val[hit]
            z = (p_fid == 0) & (u_counts[p_ent] == 0)
            if z.any():
                warm_ent = np.concatenate([warm_ent, p_ent[z]])
                warm_local = np.concatenate(
                    [warm_local, np.zeros(int(z.sum()), np.int64)])
                warm_val = np.concatenate([warm_val, p_val[z]])
            warm = (warm_ent, warm_local, warm_val, hasp, prow)
    for i, (theta0, base, n) in enumerate(zip(thetas, bases, lens)):
        if warm is not None:
            warm_ent, warm_local, warm_val, hasp, prow = warm
            if has_intercept:
                wm = base + np.flatnonzero(hasp[base:base + n])
                theta0[wm - base, 0] = prior.icpt[prow[wm]]
            sel = (warm_ent >= base) & (warm_ent < base + n)
            theta0[warm_ent[sel] - base, off + warm_local[sel]] = \
                warm_val[sel]
            continue
        u_starts = np.cumsum(np.maximum(supports[i][0], 1)) \
            - np.maximum(supports[i][0], 1)
        for slot in range(n):
            p = prior.get(entity_ids[i][slot])
            if p is None:
                continue
            a = u_starts[slot]
            uq = supports[i][1][a:a + max(int(supports[i][0][slot]), 1)]
            theta0[slot] = _warm_start(uq, p, has_intercept, u_caps[i])
    return thetas
