"""The readings a cell's limits are set from, on the card, at the cell's
own size:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

For each seed: the cell's set-up and one unit of its timed work through
the program, then the compared numbers of that unit against the plain
reference (the lower readings: sound runs of the program), and the same
numbers of the control, the reference a precision step below float32 in
the program's place (the upper readings), and, where the cell's kind has
them, the same numbers of faults planted in the reference put in the
program's place. One JSON line a seed on standard output. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    from benchmark import harness as h
    from benchmark.run import _environment
    _environment(h)
    import torch
    if not torch.cuda.is_available():
        h.say("benchmark.control: no CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    c = h.cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        stage = h.kind(c["kind"]).Stage(c, seed, device, h.Spans())
        stage.setup()
        t1 = time.perf_counter()
        stage.run_unit()
        stage.release()
        t2 = time.perf_counter()
        out = {"seed": seed, "program": stage.check()}
        t3 = time.perf_counter()
        out["control"] = stage.control()
        if hasattr(stage, "faults"):
            out["faults"] = stage.faults()
        out["seconds"] = {"setup": t1 - t0, "unit": t2 - t1,
                          "reference": t3 - t2,
                          "control": time.perf_counter() - t3}
        print(json.dumps(out), flush=True)
        del stage
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
