"""Joining a multi-process job (gdmix_tpu_torch/workflow/distributed.py
maybe_initialize_distributed, parallel/process_group.py): the JAX
package's environment contract and torchrun's, the card a process takes,
the backend rule, and the failures that must end the run rather than let
it go on in one process."""
import sys

import pytest
import torch

from gdmix_tpu_torch.parallel import process_group as pg
from gdmix_tpu_torch.workflow.distributed import maybe_initialize_distributed
from tests.torch_multiproc_runner import free_port, job_env, run_procs

_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "WORLD_SIZE",
         "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
         "MASTER_PORT")


@pytest.fixture
def env(monkeypatch):
    for v in _VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.mark.parametrize("setting,want", [
    ({}, 1),
    ({"LOCAL_WORLD_SIZE": "4"}, 4),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1234", "NUM_PROCESSES": "3"}, 3),
    ({"COORDINATOR_ADDRESS": "localhost:1234", "NUM_PROCESSES": "2"}, 2),
    # one pod a process (workflow/k8s.py): alone on its host
    ({"COORDINATOR_ADDRESS": "train-0.train.ns.svc:8476",
      "NUM_PROCESSES": "4"}, 1),
])
def test_host_process_count(env, setting, want):
    for k, v in setting.items():
        env.setenv(k, v)
    assert pg.host_process_count() == want


def test_device_and_backend_rule(env):
    assert pg.process_device("cpu", 3) == torch.device("cpu")
    assert pg.backend_for(torch.device("cpu")) == "gloo"
    env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pg.process_device(None, 0)
    env.setattr(torch.cuda, "is_available", lambda: True)
    env.setattr(torch.cuda, "device_count", lambda: 2)
    assert pg.process_device(None, 3) == torch.device("cuda", 1)
    env.setenv("LOCAL_RANK", "0")
    assert pg.process_device(None, 3) == torch.device("cuda", 0)
    card = torch.device("cuda", 0)
    env.setenv("LOCAL_WORLD_SIZE", "2")
    assert pg.backend_for(card) == "nccl"      # a card each
    env.setenv("LOCAL_WORLD_SIZE", "3")
    assert pg.backend_for(card) == "gloo"      # processes share a card
    env.setattr(torch.cuda, "device_count", lambda: 1)
    env.delenv("LOCAL_WORLD_SIZE")
    env.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    env.setenv("NUM_PROCESSES", "2")
    assert pg.backend_for(card) == "gloo"      # two on the one card


def test_one_process_without_a_job(env):
    assert maybe_initialize_distributed("cpu") == dict(
        process_id=0, num_processes=1, backend=None, device=None)
    env.setenv("WORLD_SIZE", "1")                # torchrun, one process
    assert maybe_initialize_distributed("cpu")["num_processes"] == 1
    assert pg.process_index_and_count() == (0, 1)
    t = torch.arange(3.0)
    assert pg.all_reduce_sum(t) is t and pg.all_gather_rows(t) is t
    pg.barrier()


def test_a_bad_rank_raises(env):
    env.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    env.setenv("NUM_PROCESSES", "2")
    env.setenv("PROCESS_ID", "2")
    with pytest.raises(ValueError, match="process 2 of a job of 2"):
        maybe_initialize_distributed("cpu")


_CHILD = """
import sys, torch
from gdmix_tpu_torch.workflow.distributed import maybe_initialize_distributed
from gdmix_tpu_torch.parallel import process_group as pg
j = maybe_initialize_distributed("cpu")
rank, world = pg.process_index_and_count()
t = torch.full((3,), rank + 1.0, dtype=torch.float64)
s = pg.all_reduce_sum(t)
g = pg.all_gather_rows(torch.tensor([float(rank)]))
print("JOINED", j["backend"], rank, world, s.tolist(), g.tolist(), flush=True)
if sys.argv[1] == "die" and rank == 1:
    raise SystemExit(3)
pg.all_reduce_sum(t)     # rank 1 is gone: this must raise, not go on
print("UNREACHED", flush=True)
"""


@pytest.mark.parametrize("launcher", ["env_contract", "torchrun"])
def test_two_processes_join_and_a_lost_peer_fails_the_run(launcher):
    """Both contracts form one gloo group whose collectives add and gather
    across the processes; when a process dies, the other's next collective
    raises and its run fails (no rank goes on alone)."""
    port = free_port()
    cmds = []
    for r in range(2):
        e = job_env(r, 2, port)
        if launcher == "torchrun":
            for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
                e.pop(k)
            e.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))
        cmds.append(([sys.executable, "-c", _CHILD, "die"], e))
    with pytest.raises(AssertionError, match="process 0 failed") as err:
        run_procs(cmds, timeout=120)
    msg = str(err.value)
    assert "JOINED gloo 0 2 [3.0, 3.0, 3.0] [0.0, 1.0]" in msg
    assert "UNREACHED" not in msg
