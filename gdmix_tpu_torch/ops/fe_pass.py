"""What the two wrappers of the fused pass kernel share.

csrc/fe_common.cuh is one pass over padded COO records, launched by
`fe_loss_grad_fused` (ops/fe_loss_grad.py) and `fe_hybrid_hot`
(ops/fe_hybrid.py). This module holds the kernel's contract as both wrappers
see it: the shared memory it takes besides the gradient table, which shapes
may take its 16-byte loads, and the one check of a call's inputs.
"""
from __future__ import annotations

import torch

from gdmix_tpu_torch.ops import _cuda

FLOATS = (torch.float32, torch.float64)
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# static shared memory of the kernel besides what it is given (the block sum)
SMEM_RESERVE = 1024
# the kernel's lane-private strips: STRIP_IDS ids, 32 slots each (kStrip in
# csrc/fe_common.cuh; each wrapper checks it at its library's first load)
STRIP_IDS = 32
# the vector path: K ≤ 16, K % 4 == 0, rows 16-byte aligned
VEC_MAX_K = 16


def strip_bytes(element_size: int) -> int:
    return 32 * STRIP_IDS * element_size


def vector_shape(k: int) -> bool:
    """Whether records of k entries may take the 16-byte loads at all."""
    return k <= VEC_MAX_K and k % 4 == 0


def vector_path(k: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernel may read a record's entries with 16-byte loads."""
    return vector_shape(k) and all(t.data_ptr() % 16 == 0 for t in tensors)


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
