"""Run one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's inputs from the seed, builds the program's model
and runs one unit of the cell's work (every shape the window uses, and
the first build of the program's kernels into build/gdmix_tpu_torch/ of
this checkout). The window then runs whole units until `--seconds` have
passed. Once it has closed, the program's state is freed, the plain
reference judges what the last units produced, and one JSON line goes to
standard output, last: the end-to-end metrics with `--trace 0`, the
per-layer metrics (read by benchmark/metrics/<name>.py from a
torch.profiler trace of the window, the benchmark's spans and the
program's counters) with `--trace 1`. Each compared number and its limit
go to standard error last, and into the line under "checks".

No card, fewer cards than the cell asks for, or a module of JAX or of the
JAX package loaded when the result is due (after the window, the check and
the metric readers): a message on standard error, no result, and a code
other than 0.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_T0 = time.perf_counter()


def _args(argv):
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment(h):
    """Every cache of the program inside this checkout, at fixed paths."""
    os.environ["GDMIX_TPU_COMPILE_CACHE"] = h.BUILD_DIR
    os.environ["TRITON_CACHE_DIR"] = os.path.join(h.ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(h.ROOT, "build",
                                                      "torch_extensions")


def _power_limit() -> str:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return (r.stdout.strip().splitlines() or ["?"])[0]
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi failed"


def main(argv=None) -> int:
    a = _args(sys.argv[1:] if argv is None else argv)
    from benchmark import harness as h
    age = h.process_age_s()
    start = time.perf_counter() - age if age is not None else _T0
    _environment(h)
    m = h.manifest()
    w = next((x for x in m["workloads"] if x["name"] == a.workload), None)
    if w is None:
        h.say(f"benchmark: no workload {a.workload!r} in BENCHMARK.json")
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < w["chips"]:
        h.say(f"benchmark: {a.workload} needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()} — no measurement taken")
        return 2
    code, line = run_cell(m, w, a.seed, a.seconds, bool(a.trace),
                          torch.device("cuda", 0), start)
    if line is not None:
        print(line, flush=True)
    return code


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(m: dict, w: dict, seed: int, seconds: float, traced: bool,
             device, start: float):
    """(exit code, the result line or None) of one run of cell `w` of
    manifest `m` on `device`, its set-up counted from `start`
    (perf_counter seconds)."""
    import torch
    from benchmark import harness as h
    from benchmark.compare import judge
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = h.cell(w["name"])
    spans = h.Spans(traced=traced)
    stage = h.kind(c["kind"]).Stage(c, seed, device, spans)
    stage.setup()
    _sync(device)
    setup_s = time.perf_counter() - start
    spans.items.clear()                 # set-up's warm unit is not timed
    spans.counters.clear()

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    units = 0
    t0 = time.perf_counter()
    with spans.span("window"):
        while True:
            stage.run_unit()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = h.reduce_trace(prof, window_s) if prof is not None else None
    prof = None
    stage.after_window(traced)
    stage.release()
    t_check = time.perf_counter()
    correct, checks = judge(stage.check(), c["limits"])
    check_s = time.perf_counter() - t_check

    units_of = {x["name"]: x["unit"] for x in m["end_to_end"] + m["per_layer"]}
    metrics = {}
    if not traced:
        values = dict(stage.end_to_end(window_s, units), setup_s=setup_s)
        for x in h.cell_metrics(m, w["name"], "end_to_end"):
            metrics[x["name"]] = {"value": values[x["name"]],
                                  "unit": x["unit"]}
    else:
        ctx = dict(stage=stage, spans=spans, trace=trace, units=units,
                   window_s=window_s)
        for x in h.cell_metrics(m, w["name"], "per_layer"):
            v = h.reader(x["name"])(ctx)
            if v is not None:
                metrics[x["name"]] = {"value": v, "unit": units_of[x["name"]]}
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": name, "count": w["chips"],
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace is not None:
        device_info.update(busy_s=trace["busy_s"], window_s=window_s)
        breakdown = {"device_ops": trace["device_ops"],
                     "idle_gaps": trace["idle_gaps"]}
    h.say(f"benchmark: {stage.unit} seconds "
          f"{[round(b - a, 3) for n, a, b in spans.items if n == stage.unit]}"
          f"{getattr(stage, 'unit_log', '')}")
    h.say(f"benchmark: {w['name']} seed {seed}: {units} {stage.unit}s in "
          f"{window_s:.3f} s, set-up {setup_s:.3f} s {stage.times}, check "
          f"{check_s:.3f} s, peak {peak} B, "
          f"card {_power_limit() if device.type == 'cuda' else 'cpu'}, "
          f"kernels {stage_launches()}")
    for cname, v, lim in checks:
        h.say(f"check {cname}: {v!r} (limit {lim!r})")
    # last, once the reference, the control's imports and the metric
    # readers have all run
    bad = h.forbidden_modules()
    if bad:
        h.say(f"benchmark: modules of JAX or of the JAX package are loaded: "
              f"{bad} — no result")
        return 3, None
    return 0, h.result_line(correct, units, 0 if correct else 1, metrics,
                            device_info, checks, breakdown)


def stage_launches() -> dict:
    from benchmark import program
    return {k: v for k, v in program.kernel_launches().items() if v}


if __name__ == "__main__":
    sys.exit(main())
