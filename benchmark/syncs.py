"""Host syncs counted by the line of Python that made them: a copy of
gdmix_tpu_torch/bench.py `count_syncs`."""
from __future__ import annotations

import os
import warnings

import torch

from benchmark.harness import ROOT


def count_syncs(fn, device: torch.device):
    """(fn(), {"file:line": count} of the synchronizing calls PyTorch made
    inside it): its sync debug mode set to warn, each warning counted by
    the line of Python that made it. Empty on the CPU, where there is
    nothing to wait for."""
    if device.type != "cuda":
        return fn(), {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = {}
    for w in seen:
        if "called a synchronizing" in str(w.message):
            at = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            lines[at] = lines.get(at, 0) + 1
    return out, lines
