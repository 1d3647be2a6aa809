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
  dag         — generate the job DAG and EXECUTE it: one subprocess per
                job on this package's CLIs, dependency-ordered, up to
                --max_parallel at once (workflow/distributed.py)
With --compile_dag_to the DAG is written as JSON instead of run. The
`distributed` and `kubernetes` modes raise: they are ROADMAP A.6b. Every
mode runs on the first card and raises without one; `--device cpu` runs
the plain kernel versions on the CPU (in dag mode: each train job gets
--device).
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

_NOT_PORTED = {
    "distributed": "ROADMAP A.6b: --mode distributed",
    "kubernetes": "ROADMAP A.6b: --mode kubernetes (workflow/k8s.py)",
}


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gdmix-tpu workflow "
                                                 "(PyTorch port)")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--mode", default="single_node",
                        choices=["single_node", "in_memory", "distributed",
                                 "dag", "kubernetes"])
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
    if args.mode in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[args.mode])
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
    logger.info("workflow metrics: %s", json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
