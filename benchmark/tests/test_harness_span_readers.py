"""The per-layer metrics that read the program's own spans
(benchmark/program_spans.py and its five readers) on a hand-made context:
the window's selection, the shares and per-funcall times, the device's
idle time inside the marshal, and no number where the log dropped spans
of the window or the program keeps no log."""
import json

import pytest

from benchmark import harness as h
from benchmark.tests.small import run_small
from gdmix_tpu_torch.util import timing

FLEET = ("re_bucketize_share.fleet", "re_upload_share.fleet",
         "re_idle_in_marshal.fleet")
CRITEO = ("fe_lbfgs_host_ms_per_funcall.criteo",
          "fe_objective_host_ms_per_funcall.criteo")
OFFSET = 1_700_000_000_000_000_000     # the trace's clock, less perf's
S = 1_000_000_000                      # a second in nanoseconds


def _ctx(log, dropped=0, ops=(), busy_s=1.0, funcalls=None,
         monkeypatch=None):
    """A context whose window is [10 s, 20 s] on perf_counter, with two
    fits of 4 s, the program's log `log` and a trace of `ops`."""
    monkeypatch.setattr(timing, "span_log", lambda: (list(log), dropped))
    monkeypatch.setattr(timing, "to_trace_ns", lambda t: t + OFFSET)
    spans = h.Spans()
    spans.items += [("fit", 11.0, 15.0), ("fit", 15.0, 19.0),
                    ("window", 10.0, 20.0)]
    if funcalls is not None:
        spans.add("fit.funcalls", funcalls)
    trace = dict(ops=[(n, s + OFFSET, d, "re.launch") for n, s, d in ops],
                 busy_s=busy_s, window_s=10.0)
    return dict(stage=None, spans=spans, trace=trace, units=2,
                window_s=10.0)


def _read(name, ctx):
    return h.reader(name)(ctx)


def test_shares_of_the_fits_read_the_window_only(monkeypatch):
    log = [("re.bucketize", 11 * S, 12 * S),           # 1 s
           ("re.bucketize", 15 * S, 17 * S),           # 2 s
           ("re.upload", 12 * S, 12 * S + S // 2),     # 0.5 s
           # started before the window and after it: not read
           ("re.bucketize", 9 * S, 11 * S),
           ("re.upload", 21 * S, 22 * S)]
    ctx = _ctx(log, monkeypatch=monkeypatch)
    assert _read("re_bucketize_share.fleet", ctx) == pytest.approx(37.5)
    assert _read("re_upload_share.fleet", ctx) == pytest.approx(6.25)


def test_idle_inside_the_marshal(monkeypatch):
    """Each marshal span less the union of the device's operations that
    overlap it, over the window's idle seconds (10 s less 1 s busy)."""
    log = [("re.marshal_dispatch", 11 * S, 14 * S),
           ("re.marshal_dispatch", 15 * S, 16 * S),
           ("re.marshal_dispatch", 5 * S, 6 * S)]      # before the window
    ops = [("a", 12 * S, S // 2),            # inside the first: 0.5 s
           ("b", 12 * S + S // 4, S // 2),   # overlaps a: +0.25 s
           ("c", 13 * S + S // 2, S),        # half inside: 0.5 s
           ("d", 14 * S + S // 2, S // 4),   # between the two: none
           ("e", 5 * S, S)]                  # outside both
    ctx = _ctx(log, ops=ops, busy_s=1.0, monkeypatch=monkeypatch)
    idle = (3.0 - 1.25) + 1.0
    assert _read("re_idle_in_marshal.fleet", ctx) == pytest.approx(
        100.0 * idle / 9.0)
    # no device operation at all in the trace (a CPU run): no number
    ctx["trace"]["busy_s"] = 0.0
    assert _read("re_idle_in_marshal.fleet", ctx) is None
    ctx["trace"] = None
    assert _read("re_idle_in_marshal.fleet", ctx) is None


def test_host_ms_per_funcall(monkeypatch):
    log = [("lbfgs.objective", 12 * S, 12 * S + 100_000_000),
           ("lbfgs.objective", 13 * S, 13 * S + 200_000_000),
           ("lbfgs.fetch", 14 * S, 14 * S + 50_000_000),
           ("lbfgs", 11 * S, 14 * S + 60_000_000),
           ("lbfgs.objective", 25 * S, 26 * S)]        # after the window
    ctx = _ctx(log, funcalls=3, monkeypatch=monkeypatch)
    assert _read("fe_objective_host_ms_per_funcall.criteo", ctx) \
        == pytest.approx(100.0)
    assert _read("fe_lbfgs_host_ms_per_funcall.criteo", ctx) \
        == pytest.approx((3060.0 - 300.0 - 50.0) / 3)
    # no funcalls counted: no number
    ctx["spans"].counters.clear()
    assert _read("fe_lbfgs_host_ms_per_funcall.criteo", ctx) is None


@pytest.mark.parametrize("oldest_end", [9 * S, 10 * S + 1])
def test_a_drop_that_may_reach_the_window_gives_no_number(monkeypatch,
                                                          oldest_end):
    """Dropped spans closed before the oldest kept one: where that one
    closed inside the window, a dropped span may have started there, and
    no reader gives a number; where it closed before, every reader
    does."""
    log = [("re.bucketize", 8 * S, oldest_end),
           ("re.bucketize", 11 * S, 12 * S), ("re.upload", 12 * S, 13 * S),
           ("re.marshal_dispatch", 11 * S, 13 * S),
           ("lbfgs.objective", 12 * S, 13 * S),
           ("lbfgs.fetch", 13 * S, 14 * S), ("lbfgs", 11 * S, 14 * S)]
    ctx = _ctx(log, dropped=5, ops=[("a", 12 * S, S)], funcalls=2,
               monkeypatch=monkeypatch)
    got = {m: _read(m, ctx) for m in FLEET + CRITEO}
    if oldest_end > 10 * S:
        assert got == {m: None for m in FLEET + CRITEO}
    else:
        assert all(v is not None for v in got.values()), got


def test_a_program_without_the_recorder_gives_no_number(monkeypatch):
    """The parent of the recorder: its timing module has no span_log, and
    every reader returns None without raising."""
    ctx = _ctx([], funcalls=2, monkeypatch=monkeypatch)
    monkeypatch.delattr(timing, "span_log")
    assert {m: _read(m, ctx) for m in FLEET + CRITEO} \
        == {m: None for m in FLEET + CRITEO}


def test_the_manifest_lists_each_reader_for_its_cell():
    m = h.manifest()
    for names, cell in ((FLEET, "lr-movielens.re-fleet"),
                        (CRITEO, "lr-criteo.fe-fit")):
        got = {x["name"] for x in h.cell_metrics(m, cell, "per_layer")}
        assert set(names) <= got
        for name in names:
            assert callable(h.reader(name))


@pytest.mark.parametrize("cell,names", [
    ("lr-movielens.re-fleet", FLEET[:2]),
    ("lr-criteo.fe-fit", CRITEO)])
def test_a_traced_cpu_run_reports_the_program_counters(monkeypatch, cell,
                                                       names):
    """A traced tiny run on the CPU reads the program's spans: the shares
    and per-funcall times come out, and the idle share inside the marshal
    does not (a CPU trace holds no device operation)."""
    monkeypatch.setattr(timing, "_LOG", timing._Log())
    code, line = run_small(monkeypatch, cell, traced=True)
    assert code == 0
    got = json.loads(line)
    assert got["correct"] is True
    for name in names:
        assert got["metrics"][name]["value"] > 0, name
    assert "re_idle_in_marshal.fleet" not in got["metrics"]
    if cell == "lr-movielens.re-fleet":
        md = got["metrics"]["re_marshal_share.fleet"]["value"]
        assert sum(got["metrics"][n]["value"] for n in names) <= md + 1
