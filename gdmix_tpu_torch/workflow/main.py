"""Workflow CLI: ``python -m gdmix_tpu_torch.workflow.main --config_path X
[--mode M]``.

Port of gdmix_tpu/workflow/main.py (reference gdmixworkflow/main.py:12-66).
Modes:
  single_node — the default and the reference semantics: the coordinates
                run in this process with file handoffs between stages
                (workflow/single_node.py); --resume restarts a crashed run
                from its first unfinished coordinate
  in_memory   — the whole coordinate descent in one process with the score
                ledger in memory, no stage files (workflow/pipeline.py)
  distributed — join the job the environment names (COORDINATOR_ADDRESS /
                NUM_PROCESSES / PROCESS_ID, or torchrun's) and run
                single_node in every process: the train stages in every
                process, the set-up and the data jobs on the chief
                (workflow/single_node.py, ROADMAP C.14)
  dag         — generate the job DAG and EXECUTE it: one subprocess per
                job on this package's CLIs, dependency-ordered, up to
                --max_parallel at once (workflow/distributed.py)
  kubernetes  — compile the DAG to batch/v1 Job manifests (+ headless
                Services for multi-host trainer stages) under
                --k8s_output_dir; with --launch, drive them through kubectl
                in dependency order (workflow/k8s.py)
With --compile_dag_to the DAG is written as JSON instead of run. Every
mode runs on a card (the first, or in `distributed` the process's) and
raises without one; `--device cpu` runs the plain kernel versions on the
CPU (in dag mode: each train job gets --device).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

logging.basicConfig(
    format="%(asctime)s:%(levelname)s:%(module)s:%(message)s",
    datefmt="%Y/%m/%d %I:%M:%S", level=logging.INFO)
logger = logging.getLogger(__name__)

def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gdmix-tpu workflow "
                                                 "(PyTorch port)")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--mode", default="single_node",
                        choices=["single_node", "in_memory", "distributed",
                                 "dag", "kubernetes"])
    parser.add_argument("--k8s_output_dir", default="k8s-manifests",
                        help="manifest output directory (kubernetes mode)")
    parser.add_argument("--launch", action="store_true",
                        help="kubernetes mode: launch the compiled plan "
                             "through kubectl and wait for completion")
    parser.add_argument("--namespace", default=None,
                        help="kubernetes namespace (kubernetes mode; "
                             "defaults to the config's k8s_config.namespace)")
    parser.add_argument("--num_sweeps", type=int, default=1,
                        help="coordinate-descent sweeps (in_memory mode)")
    parser.add_argument("--re_mode", default=None,
                        choices=["auto", "host", "sharded"],
                        help="random-effect training plane (in_memory "
                             "mode): host = numpy grouping + bucketed "
                             "batches; sharded = route records to the "
                             "device shard owning their entity and group/"
                             "pack there; auto (default, also a YAML "
                             "top-level key) = sharded when the mesh has "
                             ">1 device, else host")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first card; "
                             "cpu runs the plain kernel versions)")
    parser.add_argument("--compile_dag_to", default=None,
                        help="emit the job DAG json here instead of running")
    parser.add_argument("--max_parallel", type=int, default=1,
                        help="concurrent ready jobs (dag mode)")
    parser.add_argument("--resume", action="store_true",
                        help="skip coordinates whose evalSummary.json exists "
                             "(single_node mode: restart a crashed run)")
    # accepted for reference-config compatibility; unused:
    parser.add_argument("--jar_path", default="", help=argparse.SUPPRESS)
    return parser


def main(args=None) -> dict:
    args = get_parser().parse_args(args)
    if args.compile_dag_to:
        from gdmix_tpu_torch.workflow.distributed import compile_dag
        compile_dag(args.config_path, args.compile_dag_to,
                    device=args.device)
        return {}
    if args.mode == "distributed":
        from gdmix_tpu_torch.workflow.distributed import \
            maybe_initialize_distributed
        maybe_initialize_distributed(args.device)
    if args.mode == "kubernetes":
        from gdmix_tpu_torch.workflow.k8s import compile_kubernetes, \
            launch_dag
        overrides = {"namespace": args.namespace} if args.namespace else {}
        plan = compile_kubernetes(args.config_path, args.k8s_output_dir,
                                  **overrides)
        if args.launch:
            order = launch_dag(args.k8s_output_dir)
            logger.info("kubernetes plan complete: %s", order)
            return {"jobs": order}
        logger.info("compiled %d jobs to %s (use --launch to run)",
                    len(plan), args.k8s_output_dir)
        return {"jobs": [j["name"] for j in plan]}
    if args.mode == "dag":
        from gdmix_tpu_torch.device import resolve_device
        from gdmix_tpu_torch.workflow.config import WorkflowConfig
        from gdmix_tpu_torch.workflow.distributed import (execute_job_dag,
                                                          generate_job_dag)
        resolve_device(args.device)   # no card and no request: raise here
        dag = generate_job_dag(WorkflowConfig.from_file(args.config_path),
                               device=args.device)
        order = execute_job_dag(dag, max_parallel=args.max_parallel)
        logger.info("DAG complete: %s", order)
        return {"jobs": order}
    if args.mode == "in_memory":
        from gdmix_tpu_torch.workflow.pipeline import run_gdmix_in_memory
        metrics = run_gdmix_in_memory(args.config_path,
                                      num_sweeps=args.num_sweeps,
                                      re_mode=args.re_mode,
                                      device=args.device)
    else:
        from gdmix_tpu_torch.workflow.single_node import \
            run_gdmix_single_node
        metrics = run_gdmix_single_node(args.config_path, resume=args.resume,
                                        device=args.device)
    from gdmix_tpu_torch.gdmix import kernel_launches
    logger.info("workflow metrics: %s", json.dumps(metrics))
    logger.info("kernel launches: %s", json.dumps(kernel_launches()))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
