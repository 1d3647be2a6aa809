"""Fixed-capacity routing: send each record to the shard owning its entity.

Port of gdmix_tpu/parallel/routing.py, the replacement for Spark's
shuffle-by-entity: the random-effect coefficient table is row-sharded over
the mesh (parallel/mesh.py), so records move to the device holding their
entity's coefficients. Each shard sorts its records by destination and
packs them into [P, C] capacity-padded slots; shard s's block for
destination d then moves with one copy to `mesh.devices[d]`, and each
receiving shard concatenates the blocks it gets in SOURCE order. That is
`lax.all_to_all(split_axis=0, concat_axis=0)`'s layout, so the routed
arrays equal the JAX package's slot for slot.

Capacity C is fixed by the caller; records beyond a destination's capacity
are dropped and reported in the per-shard overflow count, so callers size
C exactly (parallel/entity_sharding.plan_capacities) and assert zero.

Arrays come in and go out as one tensor per shard: a list in mesh order,
shard s's tensor on mesh.devices[s].
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from gdmix_tpu_torch.parallel.mesh import Mesh


class Routed(NamedTuple):
    arrays: Dict[str, List[torch.Tensor]]  # per shard [P*C, ...]
    valid: List[torch.Tensor]              # per shard [P*C] bool
    overflow: List[torch.Tensor]           # per shard [1]: dropped at send


def _route_local(arrays: Dict[str, torch.Tensor], target: torch.Tensor,
                 num_shards: int, capacity: int):
    """One shard's send side: its records sorted by destination and packed
    into [P·C] slots (destination-major), the validity of each slot, and
    the count of records past a destination's capacity."""
    n = target.shape[0]
    dev = target.device
    t_sorted, order = torch.sort(target.to(torch.int64), stable=True)
    # position of each sorted record within its destination group
    idx = torch.arange(n, device=dev)
    first_of_dest = torch.searchsorted(
        t_sorted, torch.arange(num_shards, dtype=torch.int64, device=dev))
    rank_in_dest = idx - first_of_dest[t_sorted]
    keep = rank_in_dest < capacity
    # overflow records go to a trash slot past the packed area, so they can
    # never clobber a kept record (kept slots are unique)
    slot = torch.where(keep, t_sorted * capacity + rank_in_dest,
                       torch.full_like(t_sorted, num_shards * capacity))

    def pack(a):
        packed = torch.zeros((num_shards * capacity + 1,)
                             + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        packed[slot] = a[order]
        return packed[:-1]

    packed = {k: pack(v) for k, v in arrays.items()}
    valid = torch.zeros(num_shards * capacity + 1, dtype=torch.bool,
                        device=dev)
    valid[slot] = keep
    return packed, valid[:-1], torch.sum(~keep).reshape(1)


def _exchange(mesh: Mesh, per_shard: List[torch.Tensor],
              capacity: int) -> List[torch.Tensor]:
    """The all-to-all: shard s's block d (slots [d·C, (d+1)·C)) goes to
    shard d, which concatenates the blocks it receives in source order."""
    P = mesh.size
    out = []
    for d, dev in enumerate(mesh.devices):
        blocks = [per_shard[s][d * capacity:(d + 1) * capacity]
                  .to(dev, non_blocking=True) for s in range(P)]
        out.append(torch.cat(blocks, 0) if P > 1 else blocks[0])
    return out


def route_to_entity_shards(mesh: Mesh, arrays: Dict[str, List[torch.Tensor]],
                           target_shard: List[torch.Tensor],
                           capacity: int) -> Routed:
    """Route records to their target shards.

    arrays: {name: [per-shard [N_s, ...]]}; target_shard: per shard [N_s]
    in [0, P). Returns per-shard [P·C]-slot arrays, their validity masks
    and the per-shard overflow counts."""
    P = mesh.size
    sent = [_route_local({k: v[s] for k, v in arrays.items()},
                         target_shard[s], P, capacity) for s in range(P)]
    out = {k: _exchange(mesh, [p[k] for p, _, _ in sent], capacity)
           for k in arrays}
    valid = _exchange(mesh, [v for _, v, _ in sent], capacity)
    return Routed(arrays=out, valid=valid, overflow=[o for _, _, o in sent])
