"""The entity-sharded random-effect data plane: shuffle-by-entity, on device.

Port of gdmix_tpu/parallel/entity_sharding.py, the equivalent of the
reference's Spark shuffle + partition assignment (DataPartitioner.scala:
235-276 routes records to the partition owning their entity;
random_effect_driver.py:60-68 assigns partitions to workers): every record
moves, in one exchange (parallel/routing.py), to the mesh shard that owns
its entity's coefficient row, where it is grouped and packed into dense
solver blocks on that shard's device (ops/segment.build_entity_blocks).
Production caller: RandomEffectLRModel.fit_records_sharded.

The JAX package jits each stage under shard_map; here each is a plain
function over one tensor per shard (a list in mesh order), run shard by
shard. Block arrays are per shard [b_cap, n_cap, ...]: concatenated in mesh
order they are the JAX package's global [P·b_cap, n_cap, ...] arrays.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from gdmix_tpu_torch.ops.segment import build_entity_blocks
from gdmix_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from gdmix_tpu_torch.parallel.routing import Routed, route_to_entity_shards


class ShardedBlocks(NamedTuple):
    blocks: Dict[str, List[torch.Tensor]]  # per shard [b_cap, n_cap, ...]
    slot_entity: List[torch.Tensor]        # per shard [b_cap] entity (-1 empty)
    slot_count: List[torch.Tensor]         # per shard [b_cap] records per slot
    dropped: List[torch.Tensor]            # [1] each: route (P), then pack (P)


def route_records(mesh: Mesh, arrays: Dict[str, List[torch.Tensor]],
                  owner: List[torch.Tensor], *, capacity: int) -> Routed:
    """One fixed-capacity exchange delivering ALL payload columns to their
    entity-owner shards; per-tier packing (pack_tier) then reuses the routed
    arrays without routing again."""
    return route_to_entity_shards(mesh, arrays,
                                  [o.to(torch.int32) for o in owner],
                                  capacity)


def pack_tier(mesh: Mesh, routed: Routed, ent: List[torch.Tensor],
              tier_col: List[torch.Tensor], t: int, *, b_cap: int,
              n_cap: int):
    """Pack ONE sample-count tier's routed records into per-shard
    [b_cap, n_cap, ...] solver blocks, on each shard's device (records of
    other tiers are masked to the entity sentinel and never enter a block).

    Returns (blocks, slot_entity, slot_count, dropped), each a list in mesh
    order (blocks a dict of them)."""
    keys = [k for k in routed.arrays if k not in ("_ent", "_tier")]
    blocks = {k: [] for k in keys}
    slot_entity, slot_count, dropped = [], [], []
    for s in range(mesh.size):
        v = routed.valid[s] & (tier_col[s] == t)
        b, se, sc, dr = build_entity_blocks(
            ent[s], {k: routed.arrays[k][s] for k in keys}, v, b_cap, n_cap)
        for k in keys:
            blocks[k].append(b[k])
        slot_entity.append(se)
        slot_count.append(sc)
        dropped.append(dr.reshape(1))
    return blocks, slot_entity, slot_count, dropped


def route_and_bucket(mesh: Mesh, arrays: Dict[str, List[torch.Tensor]],
                     ent_idx: List[torch.Tensor], owner: List[torch.Tensor],
                     *, capacity: int, b_cap: int,
                     n_cap: int) -> ShardedBlocks:
    """Route records (one tensor per shard) to their entity-owner shards
    and pack each shard's records into [b_cap, n_cap, ...] solver blocks.

    arrays:  {name: per shard [N_s, ...]} record payloads
    ent_idx: per shard [N_s] global entity index per record
    owner:   per shard [N_s] owning shard per record, in [0, P)
    """
    routed = route_records(
        mesh, dict(arrays, _ent=[e.to(torch.int32) for e in ent_idx]),
        owner, capacity=capacity)
    keys = [k for k in routed.arrays if k != "_ent"]
    blocks = {k: [] for k in keys}
    slot_entity, slot_count, pack_dropped = [], [], []
    for s in range(mesh.size):
        b, se, sc, dr = build_entity_blocks(
            routed.arrays["_ent"][s], {k: routed.arrays[k][s] for k in keys},
            routed.valid[s], b_cap, n_cap)
        for k in keys:
            blocks[k].append(b[k])
        slot_entity.append(se)
        slot_count.append(sc)
        pack_dropped.append(dr.reshape(1))
    return ShardedBlocks(blocks=blocks, slot_entity=slot_entity,
                         slot_count=slot_count,
                         dropped=list(routed.overflow) + pack_dropped)


def plan_capacities(owner_of_entity: np.ndarray, ent_idx: np.ndarray,
                    num_shards: int, rows_per_shard: int):
    """Host-side exact capacity planning for the fixed-capacity exchange.

    Returns (capacity, b_cap, n_cap_min): the max records any source shard
    sends to any destination (rounded up ×8), the max entities owned by one
    shard (rounded up ×8), and the max records of any single entity.
    """
    owner = owner_of_entity[ent_idx]
    n = len(ent_idx)
    src = np.arange(n) // rows_per_shard
    pair_counts = np.bincount(src * num_shards + owner,
                              minlength=num_shards * num_shards)
    capacity = max(int(pair_counts.max()), 1)
    capacity = pad_to_multiple(capacity, 8)
    b_cap = max(int(np.bincount(owner_of_entity,
                                minlength=num_shards).max()), 1)
    b_cap = pad_to_multiple(b_cap, 8)
    n_cap_min = int(np.bincount(ent_idx).max())
    return capacity, b_cap, n_cap_min


def shard_rows(mesh: Mesh, a: np.ndarray, dtype=None) -> List[torch.Tensor]:
    """A host array split into P equal row blocks, block s uploaded to
    mesh.devices[s] (in `dtype` when given). Dim 0 must divide by P."""
    a = np.asarray(a)
    if a.shape[0] % mesh.size:
        raise ValueError(f"shard_rows: {a.shape[0]} rows over "
                         f"{mesh.size} shards")
    rows = a.shape[0] // mesh.size
    return [torch.as_tensor(np.ascontiguousarray(a[s * rows:(s + 1) * rows]),
                            dtype=dtype, device=dev)
            for s, dev in enumerate(mesh.devices)]
