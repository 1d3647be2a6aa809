"""The device mesh of one process: an ordered list of devices.

Port of gdmix_tpu/parallel/mesh.py. There, a mesh is one program over P
devices (GSPMD, shard_map, lax.all_to_all); here it is one process that
holds P `torch.device`s and moves the data between them itself
(parallel/routing.py): shard s's rows live on `mesh.devices[s]`. The
random-effect plane row-shards its coefficient table over the mesh: each
shard owns a slice of the entities and solves them on its own device.

A mesh may name one device more than once (eight `cpu` entries stand for
the JAX tests' eight virtual CPU devices, and a card repeated exercises the
P > 1 exchange on CUDA tensors), which is what the tests do with it.

Not here: `batch_sharding` and `replicated`. Across processes the fixed
effect's batch is split by hand (each process loads its own rows) and its
loss and gradient are summed by one all-reduce
(parallel/process_group.py); the coefficients are replicated because
every process runs the same L-BFGS on the same sums.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from gdmix_tpu_torch.device import pad_to_multiple, resolve_device
from gdmix_tpu_torch.parallel.process_group import (host_process_count,
                                                    process_index_and_count)

__all__ = ["Mesh", "get_mesh", "local_mesh", "on_device", "pad_to_multiple"]


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices; shard s lives on devices[s]."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(devices: Optional[Sequence] = None, device=None) -> Mesh:
    """The mesh over `devices` when given; else the CPU's one-entry mesh
    when `device` is the CPU, and every visible card otherwise (raising, as
    resolve_device does, when there is no card and the CPU was not asked
    for)."""
    if devices is not None:
        return Mesh(tuple(torch.device(d) for d in devices))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,))
    return Mesh(tuple(torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())))


def local_mesh(device=None) -> Mesh:
    """The process-LOCAL mesh: this process's devices only. In one process
    it is get_mesh(). Across processes the random-effect plane composes
    round-robin entity ownership between processes with the routing inside
    each process's local mesh, so the exchange never leaves the process:
    the mesh is every visible card when the process is alone on its host,
    else the one card the job gave it (resolve_device: the current card;
    two processes sharing one card both hold it)."""
    if process_index_and_count()[1] == 1 or host_process_count() == 1:
        return get_mesh(device=device)
    return Mesh((resolve_device(device),))


def on_device(device: torch.device):
    """A context that makes `device` the thread's current card for the
    launches inside it; nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
