"""Tiny versions of the benchmark's cells for the CPU tests."""
from __future__ import annotations

import time

import torch

from benchmark import harness as h
from benchmark import run

SMALL = {
    "lr-movielens.re-fleet": {"entities": 1500},
    "lr-criteo.fe-fit": {"block_rows": 4096, "cfg": {"rows": 6000}},
}


_CELL = h.cell


def small_cell(name: str) -> dict:
    c = _CELL(name)
    for k, v in SMALL[name].items():
        if k == "cfg":
            c["cfg"].update(v)
        else:
            c[k] = v
    return c


def run_small(monkeypatch, name: str, traced: bool = False,
              seed: int = 2 ** 31 + 7):
    """(exit code, result line) of one CPU run of the tiny cell `name`."""
    monkeypatch.setattr(h, "cell", small_cell)
    m = h.manifest()
    # a cell the manifest does not list yet runs as a one-card cell
    w = next((x for x in m["workloads"] if x["name"] == name),
             {"name": name, "chips": 1})
    return run.run_cell(m, w, seed, 0.2, traced, torch.device("cpu"),
                        time.perf_counter())
