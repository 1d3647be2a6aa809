"""gdmix_tpu_torch/util/timing.py against gdmix_tpu/util/timing.py: the
phase log line and the resident set (tests/test_util.py:10-18), the
dispatch-latency probe and its class rule, and the torch.profiler trace of
device_profile, on the CPU; and the port's span recorder: its stamps on
the trace's clock, nothing entered or logged without a profiler, nesting,
and the bounded log."""
import glob
import logging
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gdmix_tpu.util import timing as jax_timing
from gdmix_tpu_torch.util import timing


def test_phase_logs(caplog):
    with caplog.at_level(logging.INFO, logger="gdmix_tpu_torch.util.timing"):
        with timing.phase("unit-test-phase"):
            pass
    got = [r.message for r in caplog.records if "unit-test-phase" in r.message]
    assert len(got) == 1
    # the JAX package's line, field for field
    with caplog.at_level(logging.INFO, logger="gdmix_tpu.util.timing"):
        with jax_timing.phase("unit-test-phase"):
            pass
    want = [r.message for r in caplog.records
            if r.name == "gdmix_tpu.util.timing"][-1]
    assert got[0].split(" --- ")[0] == want.split(" --- ")[0]
    assert got[0].split(" --- ")[2].split(":")[0] \
        == want.split(" --- ")[2].split(":")[0]


def test_rss():
    assert timing.rss_gb() > 0
    assert abs(timing.rss_gb() - jax_timing.rss_gb()) < 1.0


def test_dispatch_latency_probe_on_the_cpu():
    lat = timing.measure_dispatch_latency_s("cpu")
    assert 0 < lat < 5e-3
    # probed once a process: the same sample again
    assert timing.measure_dispatch_latency_s("cpu") == lat
    assert timing.nominal_dispatch_latency_s("cpu") == 1e-3


@pytest.mark.parametrize("lat", [1e-5, 4.9e-3, 5e-3, 0.03])
def test_class_rule_equals_jax(monkeypatch, lat):
    """Both packages map one measured latency to the same class."""
    monkeypatch.setattr(jax_timing, "measure_dispatch_latency_s",
                        lambda: lat)
    monkeypatch.setattr(timing, "measure_dispatch_latency_s",
                        lambda device=None: lat)
    assert timing.nominal_dispatch_latency_s("cpu") \
        == jax_timing.nominal_dispatch_latency_s()


def test_latency_probe_needs_a_card_or_the_cpu(monkeypatch):
    """No silent CPU: without a card the probe's default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.measure_dispatch_latency_s()


def test_device_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GDMIX_TPU_PROFILE", raising=False)
    out = tmp_path / "trace"
    with timing.device_profile(str(out)):
        torch.ones(64).cumsum(0).sum()
    traces = glob.glob(str(out / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert '"cat": "cpu_op"' in f.read()
    # GDMIX_TPU_PROFILE names the directory when no log_dir is given
    env_dir = tmp_path / "env"
    monkeypatch.setenv("GDMIX_TPU_PROFILE", str(env_dir))
    with timing.device_profile():
        torch.ones(8).sum()
    assert len(glob.glob(str(env_dir / "*.pt.trace.json"))) == 1


def test_device_profile_is_a_no_op_without_a_directory(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("GDMIX_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with timing.device_profile():
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(8).sum()
    assert os.listdir(tmp_path) == []


@pytest.fixture
def fresh_log(monkeypatch):
    log = timing._Log()
    monkeypatch.setattr(timing, "_LOG", log)
    return log


def _annotations(prof):
    return {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()}


def test_span_on_the_trace_clock(fresh_log):
    """A span's interval, converted by to_trace_ns, agrees with its
    annotation in the profiler's trace within 1 ms at both ends."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("re.clock-test"):
            time.sleep(0.02)
    (name, t0, t1), = timing.span_log()[0]
    start, end = _annotations(prof)[name]
    assert abs(timing.to_trace_ns(t0) - start) < 1_000_000
    assert abs(timing.to_trace_ns(t1) - end) < 1_000_000
    assert t1 - t0 >= 20_000_000


def test_span_without_a_profiler_enters_and_logs_nothing(monkeypatch,
                                                         fresh_log):
    def refused(name):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(timing._autograd_profiler, "record_function",
                        refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    with timing.span("lbfgs") as s:
        time.sleep(0.001)
    assert s.seconds >= 1e-3
    assert timing.span_log() == ([], 0)


def test_spans_nest(fresh_log):
    """Inner spans close first, lie inside the outer one, and each is an
    annotation inside its parent's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("re.outer") as outer:
            with timing.span("re.inner") as inner:
                with timing.span("re.leaf"):
                    pass
            with timing.span("re.second"):
                pass
    entries, dropped = timing.span_log()
    assert dropped == 0
    assert [n for n, _, _ in entries] == ["re.leaf", "re.inner",
                                          "re.second", "re.outer"]
    (_, a, b) = entries[-1]
    assert all(a <= t0 <= t1 <= b for _, t0, t1 in entries)
    assert inner.seconds <= outer.seconds
    notes = _annotations(prof)
    assert notes["re.outer"][0] <= notes["re.inner"][0] \
        <= notes["re.leaf"][0] <= notes["re.leaf"][1] \
        <= notes["re.inner"][1] <= notes["re.second"][0] \
        <= notes["re.second"][1] <= notes["re.outer"][1]


def test_the_log_is_a_ring_that_counts_its_drops(monkeypatch):
    monkeypatch.setattr(timing, "_LOG", timing._Log(capacity=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            with timing.span(f"re.{i}"):
                pass
    entries, dropped = timing.span_log()
    assert [n for n, _, _ in entries] == ["re.3", "re.4", "re.5", "re.6"]
    assert dropped == 3
    assert timing.RING == 65536


def test_phase_is_a_span(caplog, fresh_log):
    """Under a profiler a phase is logged as a span too; its log line
    reads the span's seconds."""
    with caplog.at_level(logging.INFO, logger="gdmix_tpu_torch.util.timing"):
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.phase("re.phase-test") as ph:
                time.sleep(0.005)
    (name, t0, t1), = timing.span_log()[0]
    assert name == "re.phase-test" and ph.seconds == (t1 - t0) / 1e9
    line, = [r.message for r in caplog.records if name in r.message]
    assert line.split(" --- ")[1] == f"{ph.seconds:.3f} seconds"
