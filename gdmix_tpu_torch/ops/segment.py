"""On-device entity grouping: sort-by-entity + segment ops.

Port of gdmix_tpu/ops/segment.py: the device-side replacement for Spark's
`groupBy(entity).agg(collect_list(*))` shuffle (reference
gdmix-data/.../DataPartitioner.scala:296-317), a stable sort by entity id
followed by segment-boundary arithmetic, on whatever device the tensors
live on. Production caller: the sharded random-effect plane
(parallel/entity_sharding.pack_tier groups each shard's routed records with
`build_entity_blocks`), used by RandomEffectLRModel.fit_records_sharded.

Nothing here reads a value back to the host: no bincount (it sizes its
output from the data's max on a card), no boolean-mask indexing. Segment
sums are scatter_adds, the segment max a scatter_reduce.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

ENTITY_SENTINEL = torch.iinfo(torch.int32).max  # sorts after every entity id


class EntitySegments(NamedTuple):
    order: torch.Tensor        # [N] permutation sorting records by entity
    segment_ids: torch.Tensor  # [N] dense segment index per SORTED record
    unique_count: torch.Tensor # [] number of distinct entities (<= N)
    seg_entity: torch.Tensor   # [N] entity id per segment slot (dtype min
    #                            past unique_count, JAX's segment_max fill)
    seg_counts: torch.Tensor   # [N] records per segment slot (0 beyond unique)
    seg_starts: torch.Tensor   # [N] start offset of each segment in sorted order


def group_by_entity_device(entity_ids: torch.Tensor) -> EntitySegments:
    """Stable grouping of records by integer entity id, on their device."""
    n = entity_ids.shape[0]
    dev = entity_ids.device
    sorted_e, order = torch.sort(entity_ids, stable=True)
    new_seg = torch.ones(n, dtype=torch.int64, device=dev)
    new_seg[1:] = (sorted_e[1:] != sorted_e[:-1]).to(torch.int64)
    segment_ids = torch.cumsum(new_seg, 0) - 1                  # [N]
    unique_count = segment_ids[-1] + 1
    seg_counts = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(
        0, segment_ids, torch.ones_like(segment_ids))
    seg_starts = torch.zeros_like(seg_counts)
    seg_starts[1:] = torch.cumsum(seg_counts, 0)[:-1]
    seg_entity = torch.full((n,), torch.iinfo(sorted_e.dtype).min,
                            dtype=sorted_e.dtype, device=dev).scatter_reduce_(
        0, segment_ids, sorted_e, reduce="amax", include_self=False)
    return EntitySegments(order=order, segment_ids=segment_ids,
                          unique_count=unique_count, seg_entity=seg_entity,
                          seg_counts=seg_counts, seg_starts=seg_starts)


def build_entity_blocks(ent: torch.Tensor, arrays: Dict[str, torch.Tensor],
                        valid: torch.Tensor, b_cap: int, n_cap: int
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """Group records by entity and pack them into dense solver blocks
    [b_cap, n_cap, ...] on their device (one shard's records in the sharded
    plane).

    ent:    [N] int32 entity index per record (invalid records get the
            sentinel and never land in a block)
    arrays: {name: [N, ...]} record payloads to pack
    valid:  [N] bool (False = empty routed slot / padding)

    Returns (blocks, slot_entity [b_cap] (-1 = empty slot), slot_count
    [b_cap], dropped []) where dropped counts records lost to b_cap/n_cap
    capacity. One sort and one scatter replace the host bucketize loop.
    Every kept record has a slot of its own; only the trash slot past the
    blocks takes duplicates (which of them a card keeps there is undefined,
    and the slot is cut off)."""
    n = ent.shape[0]
    assert b_cap <= n, (b_cap, n)
    dev = ent.device
    ent_eff = torch.where(valid, ent,
                          torch.full_like(ent, ENTITY_SENTINEL))
    segs = group_by_entity_device(ent_eff)
    j = torch.arange(n, device=dev)
    sid = segs.segment_ids                       # [N] per SORTED record
    rank = j - segs.seg_starts[sid]
    ent_sorted = ent_eff[segs.order]
    live = ent_sorted != ENTITY_SENTINEL
    keep = live & (sid < b_cap) & (rank < n_cap)
    slot = torch.where(keep, sid * n_cap + rank,
                       torch.full_like(sid, b_cap * n_cap))   # trash slot

    def pack(a):
        out = torch.zeros((b_cap * n_cap + 1,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=dev)
        out[slot] = a[segs.order]
        return out[:-1].reshape((b_cap, n_cap) + tuple(a.shape[1:]))

    blocks = {k: pack(v) for k, v in arrays.items()}
    # the sentinel group (if present) is always the LAST segment
    has_sentinel = torch.any(ent_eff == ENTITY_SENTINEL)
    real_count = segs.unique_count - has_sentinel.to(segs.unique_count.dtype)
    slot_live = torch.arange(b_cap, device=dev) < real_count
    slot_entity = torch.where(slot_live, segs.seg_entity[:b_cap],
                              torch.full_like(segs.seg_entity[:b_cap], -1))
    slot_count = torch.where(
        slot_live, torch.clamp_max(segs.seg_counts[:b_cap], n_cap),
        torch.zeros_like(segs.seg_counts[:b_cap]))
    dropped = torch.sum(live & ~keep)
    return blocks, slot_entity, slot_count, dropped


def per_entity_sample_counts(entity_ids: torch.Tensor) -> torch.Tensor:
    """[N] per-RECORD count of its entity's samples (for active/passive
    bounding on device — DataPartitioner.getGroupId's broadcast-join
    count)."""
    segs = group_by_entity_device(entity_ids)
    out = torch.empty_like(segs.seg_counts)
    out[segs.order] = segs.seg_counts[segs.segment_ids]
    return out


def assign_group_ids_device(entity_ids: torch.Tensor, uids: torch.Tensor,
                            min_samples: Optional[int],
                            max_samples: Optional[int]) -> torch.Tensor:
    """Device version of the partitioner's group-id rule: 0 = active,
    −1 = below lower bound, >0 = upper-bound overflow (uid mod group
    count)."""
    n = entity_ids.shape[0]
    if min_samples is None and max_samples is None:
        return torch.zeros(n, dtype=torch.int32, device=entity_ids.device)
    counts = per_entity_sample_counts(entity_ids)
    if max_samples is not None:
        group_count = counts // max_samples + 1
    else:
        group_count = torch.ones_like(counts)
    group = torch.remainder(uids, group_count.to(uids.dtype)).to(torch.int32)
    if min_samples is not None:
        group = torch.where(counts < min_samples,
                            torch.full_like(group, -1), group)
    return group
