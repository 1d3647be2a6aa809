"""The process group of a multi-process run: who this process is, which
card it drives, which backend the group speaks, and the few collectives
the trainers need.

The JAX package runs one SPMD program across processes
(jax.distributed + GSPMD): a batch sharded over every process's devices is
summed by the collectives XLA inserts. Here each process computes its own
share with the hand-written kernels on its own card and the results are
summed by one explicit torch.distributed collective. The group is joined
by workflow/distributed.py `maybe_initialize_distributed`; without it
every helper below is the one-process identity.

The backend rule, decided before the group forms, from the environment
alone so that every rank decides alike: `nccl` when the processes of this
host have a card each, `gloo` when they outnumber its cards (NCCL refuses
two ranks on one card) or on the CPU. Gloo reduces host tensors, so a
collective of a card's tensor over gloo goes through the host: copied out,
reduced, copied back.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

from gdmix_tpu_torch.device import resolve_device

_LOOPBACK = ("localhost", "::1", "[::1]")


def process_index_and_count() -> Tuple[int, int]:
    """(rank, world size) of the joined group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_process_count() -> int:
    """How many processes of the job share this host: torchrun's
    LOCAL_WORLD_SIZE; under the JAX package's contract (COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID) all of them when the coordinator is a
    loopback address, else one (a pod a process, as workflow/k8s.py lays
    the job out)."""
    env = os.environ
    if env.get("LOCAL_WORLD_SIZE"):
        return int(env["LOCAL_WORLD_SIZE"])
    coordinator = env.get("COORDINATOR_ADDRESS")
    if coordinator:
        host = coordinator.rsplit(":", 1)[0]
        if host in _LOOPBACK or host.startswith("127."):
            return int(env["NUM_PROCESSES"])
    return 1


def process_device(device, rank: int) -> torch.device:
    """This process's device: `device` when given; else the card
    LOCAL_RANK (torchrun), or else the rank, names modulo the visible
    cards. No card and no request for the CPU raises, as resolve_device
    does."""
    if device is not None or not torch.cuda.is_available():
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """The backend rule of the module docstring."""
    if device.type != "cuda":
        return "gloo"
    return ("nccl" if host_process_count() <= torch.cuda.device_count()
            else "gloo")


def _through_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() != "nccl"


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the processes of `t` (the same shape on every rank), bit-equal
    on every rank; `t` itself in one process. A collective that fails
    raises: no rank goes on alone."""
    if process_index_and_count()[1] == 1:
        return t
    if _through_host(t):
        host = t.to("cpu")
        dist.all_reduce(host)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out)
    return out


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The processes' `t` (equal shapes) concatenated along dim 0 in rank
    order; `t` itself in one process."""
    world = process_index_and_count()[1]
    if world == 1:
        return t
    src = t.to("cpu") if _through_host(t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def barrier() -> None:
    """Wait for every process; nothing in one process (under nccl on the
    card the join made current)."""
    if process_index_and_count()[1] > 1:
        dist.barrier()
