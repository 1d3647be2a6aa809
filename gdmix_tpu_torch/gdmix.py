"""CLI entry point: ``python -m gdmix_tpu_torch.gdmix --<flags>``.

The port of gdmix_tpu/gdmix.py (reference gdmix.py:13-40): one argv serves
both the run's Params and the model's params; unknown flags are ignored by
each parser. The port trains and scores the fixed effect (logistic or
linear regression, or the deep detext tower) and random-effect logistic
regression on one device a process: the first card (or the card a
multi-process job gives the process), or the CPU with --device=cpu (taken
out of argv before the params parsers see it). A process started with
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID set, or by torchrun, joins
that job first (workflow/distributed.py maybe_initialize_distributed). A
run ends by logging how many times it launched each hand-written kernel
(`kernel launches: {...}`, all 0 on the CPU), so that a job run in its own
process, as the job DAG runs it, shows which kernels it went through.
"""
from __future__ import annotations

import json
import logging
import sys

from gdmix_tpu_torch import constants
from gdmix_tpu_torch.device import pop_device_flag
from gdmix_tpu_torch.drivers.factory import get_driver
from gdmix_tpu_torch.params import Params, from_argv

logging.basicConfig(
    format="%(asctime)s:%(levelname)s:%(module)s:%(message)s",
    datefmt="%Y/%m/%d %I:%M:%S", level=logging.INFO)
logger = logging.getLogger(__name__)


def _print_help() -> None:
    import dataclasses

    from gdmix_tpu_torch.models.deep_tower import DeepTowerParams
    from gdmix_tpu_torch.params import FixedLRParams, REParams, SchemaParams
    print("usage: python -m gdmix_tpu_torch.gdmix --action=train|inference "
          "--stage=fixed_effect|random_effect "
          "--model_type=logistic_regression|linear_regression|detext "
          "--<flags>\n\n"
          "One argv serves driver, schema, and model params; flags each parser"
          " doesn't know are ignored (reference gdmix.py:13-40 behavior).\n"
          "--device=cpu runs on the CPU (default: the first card).\n")
    for title, cls in (("driver params", Params),
                       ("schema params", SchemaParams),
                       ("fixed-effect LR params", FixedLRParams),
                       ("random-effect LR params", REParams),
                       ("deep fixed-effect (detext) params",
                        DeepTowerParams)):
        print(f"{title}:")
        for f in dataclasses.fields(cls):
            default = "" if f.default is dataclasses.MISSING \
                else f" (default: {f.default})"
            print(f"  --{f.name}{default}")
        print()


def kernel_launches() -> dict:
    """{kernel: launches} of this process, from each wrapper's counter
    (the varlen attention's forward and backward under one name)."""
    from gdmix_tpu_torch.ops import (fe_hybrid, fe_loss_grad, linsolve,
                                     newton_lanes, re_pack, varlen_attention,
                                     windowed_scatter)
    out = {f.__name__: f.launches for f in (
        newton_lanes.newton_full, newton_lanes.newton_block,
        linsolve.spd_solve_batched, linsolve.spd_solve_batched_mrhs,
        fe_loss_grad.fe_loss_grad_fused, fe_loss_grad.fe_gather_entries,
        fe_loss_grad.fe_scatter_entries, fe_hybrid.fe_hybrid_hot,
        windowed_scatter.windowed_scatter_add, re_pack.re_supports,
        re_pack.re_pack_tier)}
    out["varlen_attention"] = (
        varlen_attention.varlen_attention_forward.launches
        + varlen_attention.varlen_attention_backward.launches)
    return out


def run(argv) -> None:
    if not argv or "--help" in argv or "-h" in argv:
        _print_help()
        return
    argv, device = pop_device_flag(argv)
    # join the job named by the environment (COORDINATOR_ADDRESS /
    # NUM_PROCESSES / PROCESS_ID, as workflow/k8s.py injects them, or
    # torchrun's), as the JAX package's trainer does; no-op without it
    from gdmix_tpu_torch.workflow.distributed import \
        maybe_initialize_distributed
    maybe_initialize_distributed(device)
    params = from_argv(Params, argv)
    driver = get_driver(params, argv, device)
    if params.action == constants.ACTION_INFERENCE:
        driver.run_inference(params)
    elif params.action == constants.ACTION_TRAIN:
        driver.run_training(params)
    else:
        raise ValueError(f"Unsupported action {params.action}")
    logger.info("kernel launches: %s", json.dumps(kernel_launches()))


if __name__ == "__main__":
    run(sys.argv[1:])
