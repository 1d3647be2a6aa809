"""Workflow CLI: ``python -m gdmix_tpu_torch.workflow.main --config_path X
--mode in_memory``.

Port of gdmix_tpu/workflow/main.py (reference gdmixworkflow/main.py:12-66).
The port runs `in_memory`: the whole coordinate descent in one process with
the score ledger in memory (workflow/pipeline.py). The other modes raise,
naming their ROADMAP item: `single_node` (file handoffs between stages) is
A.5; `distributed`, `dag` and `kubernetes` are A.6/A.9. It runs on the
first card; `--device cpu` runs the plain kernel versions on the CPU.
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
    "single_node": "ROADMAP A.5: --mode single_node (file handoffs between "
                   "stages)",
    "distributed": "ROADMAP A.6/A.9: --mode distributed",
    "dag": "ROADMAP A.6/A.9: --mode dag (the job DAG launcher)",
    "kubernetes": "ROADMAP A.6/A.9: --mode kubernetes",
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
                             "batches; auto (default, also a YAML top-level "
                             "key) takes host on one device; sharded is "
                             "ROADMAP A.6")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first card; "
                             "cpu runs the plain kernel versions)")
    parser.add_argument("--compile_dag_to", default=None,
                        help=argparse.SUPPRESS)
    # accepted for reference-config compatibility; unused:
    parser.add_argument("--jar_path", default="", help=argparse.SUPPRESS)
    return parser


def main(args=None) -> dict:
    args = get_parser().parse_args(args)
    if args.compile_dag_to:
        raise NotImplementedError(_NOT_PORTED["dag"])
    if args.mode != "in_memory":
        raise NotImplementedError(_NOT_PORTED[args.mode])
    from gdmix_tpu_torch.workflow.pipeline import run_gdmix_in_memory
    metrics = run_gdmix_in_memory(args.config_path,
                                  num_sweeps=args.num_sweeps,
                                  re_mode=args.re_mode, device=args.device)
    logger.info("workflow metrics: %s", json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
