"""What the two wrappers of the fused pass kernel share.

csrc/fe_common.cuh is one pass over padded COO records, launched by
`fe_loss_grad_fused` (ops/fe_loss_grad.py) and `fe_hybrid_hot`
(ops/fe_hybrid.py). This module holds the kernel's contract as both wrappers
see it: the shared memory it takes besides the gradient table, how it holds
a record (its path and shape, a pure function of K and the rows'
alignment), and the one check of a call's inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gdmix_tpu_torch.ops import _cuda

FLOATS = (torch.float32, torch.float64)
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# static shared memory of the kernel besides what it is given (the block sum)
SMEM_RESERVE = 1024
# the kernel's lane-private strips: STRIP_IDS ids, 32 slots each (kStrip in
# csrc/fe_common.cuh; each wrapper checks it at its library's first load)
STRIP_IDS = 32
# the vector path: K ≤ 16, K % 4 == 0, rows 16-byte aligned; four lanes a
# record, four entries each
VEC_MAX_K, VEC_LANES = 16, 4
# the lane-group path, every other shape (kLanesMinE, kLanesMaxE and
# kLanesMaxG in csrc/fe_common.cuh; each wrapper checks its library's
# lane_group against `lane_group` at its first load)
LANES_MIN_E, LANES_MAX_E, LANES_MAX_G = 3, 5, 32


class PassShape(NamedTuple):
    """How the pass holds a record: `lanes` lanes share it, `entries` of its
    entries in each lane's registers; past lanes·entries (the lane-group
    path at LANES_MAX_G lanes only) it is read in chunks of that size."""
    path: str       # "vector" (16-byte loads) or "lanes" (4-byte loads)
    lanes: int
    entries: int


def strip_bytes(element_size: int) -> int:
    return 32 * STRIP_IDS * element_size


def vector_shape(k: int) -> bool:
    """Whether records of k entries may take the 16-byte loads at all."""
    return k <= VEC_MAX_K and k % 4 == 0


def vector_path(k: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernel may read a record's entries with 16-byte loads."""
    return vector_shape(k) and all(t.data_ptr() % 16 == 0 for t in tensors)


def lane_group(k: int) -> PassShape:
    """The lane-group path's shape for records of k entries: the fewest
    lanes (a power of two) that hold a record at LANES_MAX_E entries or
    fewer each, entries ⌈k/lanes⌉ but at least LANES_MIN_E; past
    LANES_MAX_G lanes of LANES_MAX_E, chunks of that size."""
    lanes = 1
    while lanes < LANES_MAX_G and -(-k // lanes) > LANES_MAX_E:
        lanes *= 2
    return PassShape("lanes", lanes,
                     min(max(-(-k // lanes), LANES_MIN_E), LANES_MAX_E))


def pass_shape(k: int, *tensors: torch.Tensor) -> PassShape:
    """How the kernel holds records of k entries read from `tensors` (the
    ids and values): the vector path where `vector_path` allows it, else
    the lane-group path."""
    if vector_path(k, *tensors):
        return PassShape("vector", VEC_LANES, VEC_MAX_K // VEC_LANES)
    return lane_group(k)


def check_lane_group(fn, what: str) -> None:
    """Raise unless the library's lane_group (`fn(k)` = lanes·100 +
    entries) is `lane_group` for every K up to twice the chunk size."""
    for k in range(1, 2 * LANES_MAX_G * LANES_MAX_E + 1):
        want = lane_group(k)
        if fn(k) != want.lanes * 100 + want.entries:
            raise RuntimeError(
                f"{what}: the library holds records of {k} entries as "
                f"{fn(k)} (lanes·100 + entries), the wrapper as {want}")


def check_records(what, table, table_len, indices, values, per_record):
    """Raise unless the inputs of a fused pass have its shapes and types:
    int32 ids [N, K], values [N, K], the per-record vectors [N] and the
    coefficient table [table_len], floats of one type (float32 or float64),
    all on one device; off the CPU also contiguous, on a Hopper card."""
    floats = (table, values) + tuple(per_record)
    if indices.dtype != torch.int32:
        raise TypeError(f"{what}: ids must be int32, got {indices.dtype}")
    if table.dtype not in FLOATS or any(t.dtype != table.dtype
                                        for t in floats):
        raise TypeError(f"{what}: float32 or float64 throughout, got "
                        f"{sorted({str(t.dtype) for t in floats})}")
    shape = tuple(indices.shape)
    if (len(shape) != 2 or tuple(values.shape) != shape
            or tuple(table.shape) != (table_len,)
            or any(tuple(t.shape) != shape[:1] for t in per_record)):
        raise ValueError(
            f"{what}: table {tuple(table.shape)} (want ({table_len},)), ids "
            f"{shape}, values {tuple(values.shape)}, per-record vectors "
            f"{[tuple(t.shape) for t in per_record]}")
    if len({t.device for t in (indices,) + floats}) != 1:
        raise ValueError(f"{what}: tensors on more than one device")
    if table.device.type != "cpu":
        _cuda.require_cuda(what, indices, *floats,
                           dtypes=(torch.int32,) + FLOATS)
