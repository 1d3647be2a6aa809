"""Distributed workflow: the job DAG and joining a multi-process job.

Port of gdmix_tpu/workflow/distributed.py. The reference
compiles a Kubeflow Pipeline of TFJob/SparkApplication CRDs
(gdmix-workflow/src/gdmixworkflow/distributed/container_ops.py); here:

  1. `generate_job_dag`: the explicit job sequence (for external schedulers —
     each node is a shell command on this package's CLIs, chained by the same
     directory contract as the reference's container ops)
  2. `execute_job_dag`: a dependency-aware executor for that DAG — the role of
     the reference's K8s launchers (launch_crd.py:25-152: create, poll for
     condition, fail the pipeline on job failure), with subprocesses instead
     of CRDs and ready-set parallelism instead of `.after()` chaining

  3. `maybe_initialize_distributed`: torch.distributed from the JAX
     package's environment contract (COORDINATOR_ADDRESS / NUM_PROCESSES /
     PROCESS_ID, what workflow/k8s.py injects), or from torchrun's
     (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT)

The train jobs run on the first card, as the trainer CLI does, unless the
DAG is generated for another device (`--device=<d>` on each of them).
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.parallel import process_group
from gdmix_tpu_torch.workflow.config import (METRIC, MODELS, PARTITION,
                                             TRAINING_SCORES,
                                             VALIDATION_SCORES,
                                             WorkflowConfig)

logger = logging.getLogger(__name__)


def _leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize_distributed(device=None) -> Dict[str, object]:
    """Join the job's process group when the environment names one, and
    make this process's card current. Returns {process_id, num_processes,
    backend, device}.

    COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and PROCESS_ID are the
    JAX package's contract (gdmix_tpu/workflow/distributed.py:36-51) and
    become `init_process_group(init_method="tcp://host:port")`; without
    them a torchrun launch (WORLD_SIZE > 1) joins through `env://`. The
    card: `device` when given, else LOCAL_RANK or the rank modulo the
    visible cards (parallel/process_group.process_device); the backend by
    the rule of parallel/process_group.py, logged. A group that fails to
    form raises: the run never goes on in one process."""
    if dist.is_initialized():
        rank, world = process_group.process_index_and_count()
        return dict(process_id=rank, num_processes=world,
                    backend=dist.get_backend(), device=None)
    env = os.environ
    if env.get("COORDINATOR_ADDRESS"):
        world, rank = int(env["NUM_PROCESSES"]), int(env["PROCESS_ID"])
        init_method = f"tcp://{env['COORDINATOR_ADDRESS']}"
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = "env://"
    else:
        return dict(process_id=0, num_processes=1, backend=None,
                    device=None)
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} of a job of {world} processes")
    dev = process_group.process_device(device, rank)
    backend = process_group.backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    # leave the group before the interpreter tears down (a peer that has
    # already gone must not leave this process's gloo threads to die with
    # it: that aborts the process after its work is done)
    atexit.register(_leave_group)
    logger.info("torch.distributed joined: process %d/%d on %s, backend %s "
                "(%d processes on this host, %d visible cards)", rank, world,
                dev, backend, process_group.host_process_count(),
                torch.cuda.device_count())
    return dict(process_id=rank, num_processes=world, backend=backend,
                device=str(dev))


def _flags(d: Dict) -> List[str]:
    return [f"--{k}={v}" for k, v in d.items() if v is not None]


def generate_job_dag(config: WorkflowConfig,
                     device: Optional[str] = None) -> List[dict]:
    """Explicit job list: [{name, type, depends_on, command}] — the reference's
    gen_workflow chain (workflow_generator.py:66-100) as portable data. Every
    command is COMPLETE and runnable (execute_job_dag runs them; external
    schedulers can too): one argv carries driver + model params, exactly like
    the reference's container ops serialize their params dataclasses.
    `device` (e.g. "cpu") goes to every train job as --device; without it
    they run on the first card."""
    jobs: List[dict] = []
    root = config.output_dir
    device_flag = [f"--device={device}"] if device else []

    (fe_name, fe_conf), = config.fixed_effect_config.items()
    fe_conf = dict(fe_conf)
    fe_gdmix = dict(fe_conf.pop("gdmix_config"))
    fe_dir = os.path.join(root, fe_name)
    jobs.append({
        "name": f"{fe_name}-tf-train",
        "type": "gdmix_tpu_train",
        "depends_on": [],
        "command": ["python", "-m", "gdmix_tpu_torch.gdmix"] + _flags({
            **fe_gdmix, **fe_conf,
            "stage": "fixed_effect",
            "output_model_dir": os.path.join(fe_dir, MODELS),
            "training_score_dir": os.path.join(fe_dir, TRAINING_SCORES),
            "validation_score_dir": os.path.join(fe_dir, VALIDATION_SCORES)})
        + device_flag,
    })
    jobs.append({
        "name": f"{fe_name}-compute-metric",
        "type": "gdmix_tpu_evaluate",
        "depends_on": [f"{fe_name}-tf-train"],
        "command": ["python", "-m", "gdmix_tpu_torch.workflow.jobs",
                    "evaluator",
                    f"--metricsInputDir={os.path.join(fe_dir, VALIDATION_SCORES)}",
                    f"--outputMetricFile={os.path.join(fe_dir, METRIC)}",
                    f"--labelColumnName={fe_gdmix.get('label_column_name', 'response')}",
                    f"--predictionColumnName={fe_gdmix.get('prediction_score_column_name', 'predictionScore')}"],
    })

    prev = fe_name
    for name, re_raw in config.random_effect_config.items():
        re_conf = dict(re_raw)
        re_gdmix = dict(re_conf.pop("gdmix_config"))
        num_partitions = int(re_conf.pop("num_partitions", 1))
        re_dir = os.path.join(root, name)
        part_dir = os.path.join(re_dir, PARTITION)
        part_train = os.path.join(part_dir, "trainingData")
        part_valid = os.path.join(part_dir, "validationData")
        part_md = os.path.join(part_dir, "metadata", "tensor_metadata.json")
        part_list = os.path.join(part_dir, "partitionList.txt")
        jobs.append({
            "name": f"{name}-partition",
            "type": "gdmix_tpu_partition",
            "depends_on": [f"{prev}-compute-metric"],
            "command": ["python", "-m", "gdmix_tpu_torch.workflow.jobs",
                        "partitioner"] + _flags({
                "trainingDataDir": re_conf["training_data_dir"],
                "validationDataDir": re_conf.get("validation_data_dir"),
                "metadataFile": re_conf["metadata_file"],
                "partitionId": re_conf["partition_entity"],
                "numPartitions": num_partitions,
                "featureBag": re_conf.get("feature_bag"),
                "partitionedTrainingDataDir": part_train,
                "partitionedValidationDataDir": part_valid,
                "outputMetadataFile": part_md,
                "outputPartitionListFile": part_list,
                "uidColumnName": re_gdmix.get("uid_column_name", "uid"),
                "predictionScoreColumnName": re_gdmix.get(
                    "prediction_score_column_name", "predictionScore"),
                "maxNumOfSamplesPerModel": re_conf.pop("max_samples", None),
                "minNumOfSamplesPerModel": re_conf.pop("min_samples", None),
                "trainingScoreDir": os.path.join(root, prev, TRAINING_SCORES),
                "validationScoreDir": os.path.join(root, prev,
                                                   VALIDATION_SCORES)}),
        })
        train_overrides = dict(re_conf)
        train_overrides.update(
            training_data_dir=part_train, validation_data_dir=part_valid,
            metadata_file=part_md)
        jobs.append({
            "name": f"{name}-tf-train",
            "type": "gdmix_tpu_train",
            "depends_on": [f"{name}-partition"],
            "command": ["python", "-m", "gdmix_tpu_torch.gdmix"] + _flags({
                **re_gdmix, **train_overrides,
                "stage": "random_effect",
                "partition_list_file": part_list,
                "output_model_dir": os.path.join(re_dir, MODELS),
                "training_score_dir": os.path.join(re_dir, TRAINING_SCORES),
                "validation_score_dir": os.path.join(re_dir,
                                                     VALIDATION_SCORES)})
            + device_flag,
        })
        jobs.append({
            "name": f"{name}-compute-metric",
            "type": "gdmix_tpu_evaluate",
            "depends_on": [f"{name}-tf-train"],
            "command": ["python", "-m", "gdmix_tpu_torch.workflow.jobs",
                        "evaluator",
                        f"--metricsInputDir={os.path.join(re_dir, VALIDATION_SCORES)}",
                        f"--outputMetricFile={os.path.join(re_dir, METRIC)}",
                        f"--labelColumnName={re_gdmix.get('label_column_name', 'response')}",
                        f"--predictionColumnName={re_gdmix.get('prediction_score_column_name', 'predictionScore')}"],
        })
        prev = name
    return jobs


JOB_TIMEOUT_S = 3600.0   # one job's limit in execute_job_dag


def _jobs_by_name(jobs: List[dict]) -> Dict[str, dict]:
    """{name: job}; raises if a job depends on a name the DAG lacks."""
    by_name = {j["name"]: j for j in jobs}
    unknown = {d for j in jobs for d in j["depends_on"]} - set(by_name)
    if unknown:
        raise RuntimeError(f"DAG references unknown jobs: {sorted(unknown)}")
    return by_name


def iter_dependency_order(jobs: List[dict]):
    """Yield jobs serially in dependency order: a job appears only after all
    of its `depends_on` have been yielded. Raises on unknown deps/deadlock.
    For any one-at-a-time runner; execute_job_dag below is the parallel
    variant."""
    done: set = set()
    pending = _jobs_by_name(jobs)
    while pending:
        name = next((n for n, j in pending.items()
                     if all(d in done for d in j["depends_on"])), None)
        if name is None:
            raise RuntimeError(f"DAG deadlock among {sorted(pending)} "
                               f"(done: {sorted(done)})")
        yield pending.pop(name)
        done.add(name)


def execute_job_dag(jobs: List[dict], max_parallel: int = 1) -> List[str]:
    """Run a job DAG (from `generate_job_dag` or a compiled JSON file) with
    dependency ordering, each job in a subprocess of this environment with
    JOB_TIMEOUT_S to finish. Jobs whose dependencies have all succeeded run
    concurrently up to `max_parallel`. Any failure aborts the pipeline with
    the failing job's output — the launcher contract of the reference's
    `K8sCR.wait_for_condition` (launch_crd.py:31-101). Returns the completion
    order; logs each job's wall from launch to exit and its output (the
    record's `job`, `seconds` and `output`)."""
    pending = _jobs_by_name(jobs)
    done: List[str] = []
    running: Dict[str, subprocess.Popen] = {}
    started: Dict[str, float] = {}

    def ready():
        return [n for n, j in pending.items()
                if all(d in done for d in j["depends_on"])
                and n not in running]

    try:
        while pending or running:
            for name in ready()[: max(max_parallel - len(running), 0)]:
                logger.info("DAG: launching %s: %s", name,
                            " ".join(pending[name]["command"]))
                started[name] = time.perf_counter()
                running[name] = subprocess.Popen(
                    pending[name]["command"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            if not running:
                raise RuntimeError(
                    f"DAG deadlock: no runnable job among {sorted(pending)} "
                    f"(done: {done})")
            # wait for one running job to finish (in submission order)
            name, proc = next(iter(running.items()))
            out, _ = proc.communicate(timeout=JOB_TIMEOUT_S)
            del running[name]
            out = out.decode(errors="replace")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"DAG job {name!r} failed (exit {proc.returncode}):\n"
                    f"{out[-4000:]}")
            seconds = time.perf_counter() - started[name]
            logger.info("DAG: %s succeeded in %.3f s", name, seconds,
                        extra={"job": name, "seconds": seconds,
                               "output": out})
            done.append(name)
            pending.pop(name)
    finally:
        # a failed, timed-out or interrupted run leaves no job behind
        for proc in running.values():
            proc.kill()
            proc.wait()
    return done


def compile_dag(config_path: str, output_file: str,
                device: Optional[str] = None) -> List[dict]:
    config = WorkflowConfig.from_file(config_path)
    dag = generate_job_dag(config, device=device)
    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with fs.open(output_file, "w") as f:
        json.dump({"name": "gdmix-tpu-workflow", "jobs": dag}, f, indent=2)
    logger.info("Wrote %d-job DAG to %s", len(dag), output_file)
    return dag
