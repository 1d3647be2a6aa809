"""The port's spans inside the program (util/timing.span), on the CPU under
a CPU profiler: the random-effect model's host plane (fit_groups: the
marshal split into bucketize, upload and launch; the fetches and the
collection; the merge), its sharded plane and scoring, and the L-BFGS
loop's objective calls and host reads. Each span is logged and annotated
only while the profiler records, and last_fit_phases keeps its keys."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gdmix_tpu_torch.models.random_effect_lr as port_re
from gdmix_tpu_torch.ops.lbfgs import lbfgs, lbfgs_batched
from gdmix_tpu_torch.parallel.mesh import get_mesh
from gdmix_tpu_torch.util import timing
from test_random_effect_lr import _make_groups, _write_dataset
from test_sharded_re import _groups_to_records
from test_torch_random_effect import _torch_model
from test_torch_sharded_re import _flat, _port_records

_HOST_PHASES = {
    "re.marshal_dispatch": ("re.bucketize", "re.upload", "re.launch"),
    "re.solve_fetch_collect": ("re.fetch", "re.collect"),
    "re.merge": (),
}
_SHARDED_PHASES = ("factorize", "host_prep", "route", "plan_warm",
                   "dispatch", "fetch_collect")


@pytest.fixture(autouse=True)
def _fresh_log(monkeypatch):
    """Each test reads a log of its own."""
    monkeypatch.setattr(timing, "_LOG", timing._Log())
    torch.set_num_threads(2)


def _profiled(fn):
    """(fn(), the logged spans, the trace's annotations as (name, start,
    end)) of fn run under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    entries, dropped = timing.span_log()
    assert dropped == 0
    notes = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, entries, notes


def _named(entries, name):
    return [(a, b) for n, a, b in entries if n == name]


def _model(tmp_path, groups, **over):
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    return _torch_model(md_file, train_dir, feature_file,
                        str(tmp_path / "m"), **over)


@pytest.mark.parametrize("form", ["flat", "groups"])
def test_fit_groups_spans_nest_in_the_three_phases(tmp_path, form):
    """Every span of the host plane is logged and annotated; each lies in
    its phase, the phase's spans sum to no more than the phase, and
    last_fit_phases is the phases' seconds under its three keys."""
    groups, _ = _make_groups(num_entities=30, seed=4)
    model, schema = _model(tmp_path, groups)
    data = _flat(groups, np.arange(len(groups))) if form == "flat" \
        else groups
    _, entries, notes = _profiled(lambda: model.fit_groups(data, {}, schema))
    assert set(model.last_fit_phases) == {
        "marshal_dispatch", "solve_fetch_collect", "merge"}
    for phase, subs in _HOST_PHASES.items():
        (a, b), = _named(entries, phase)
        assert model.last_fit_phases[phase[3:]] == (b - a) / 1e9
        for sub in subs:
            spans = _named(entries, sub)
            assert spans, sub
            assert all(a <= s and e <= b for s, e in spans), sub
        assert sum(e - s for sub in subs
                   for s, e in _named(entries, sub)) <= b - a
    # either form packed on the device: the plan, pass 1 and a pack a
    # tier, and one upload of the flat columns
    n_launch = len(_named(entries, "re.launch"))
    assert n_launch == len(_named(entries, "re.collect")) > 0
    assert len(_named(entries, "re.bucketize")) == n_launch + 2
    assert len(_named(entries, "re.upload")) == 1
    # the trace holds each logged span as an annotation of its name
    logged = sorted(n for n, _, _ in entries)
    assert sorted(n for n, _, _ in notes if n.startswith("re.")) == logged


@pytest.mark.parametrize("plane", ["host", "sharded"])
def test_re_fetch_spans_count_the_fetches(tmp_path, monkeypatch, plane):
    """One `re.fetch` span a call of _fetch, the model's one device→host
    path."""
    groups, _ = _make_groups(num_entities=17, seed=6)
    model, schema = _model(tmp_path, groups, re_mode=plane)
    calls = []
    inner = port_re.RandomEffectLRModel._fetch

    def counted(self, t):
        calls.append(1)
        return inner(self, t)
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_fetch", counted)
    monkeypatch.setattr(port_re, "get_mesh",
                        lambda device=None: get_mesh([torch.device("cpu")]
                                                     * 2))
    fg = _flat(groups, np.arange(len(groups)))
    _, entries, _ = _profiled(lambda: model.fit_flat(fg, {}, schema))
    assert model.last_fit_plane == plane
    assert len(calls) > 0
    assert len(_named(entries, "re.fetch")) == len(calls)


@pytest.mark.parametrize("sweep", [1, 2])
def test_sharded_plane_spans_and_phase_keys(tmp_path, monkeypatch, sweep):
    """fit_flat on the sharded plane: `re.factorize`, then the five phases
    one after another, each logged, and last_fit_phases with the same
    keys and seconds; on the second sweep through the sweep cache too."""
    groups, _ = _make_groups(num_entities=21, seed=8)
    model, schema = _model(tmp_path, groups, re_mode="sharded")
    monkeypatch.setattr(port_re, "get_mesh",
                        lambda device=None: get_mesh([torch.device("cpu")]
                                                     * 4))
    fg = _flat(groups, np.arange(len(groups)))
    cache = {}
    for _ in range(sweep - 1):
        model.fit_flat(fg, {}, schema, device_cache=cache)
    _, entries, _ = _profiled(
        lambda: model.fit_flat(fg, {}, schema, device_cache=cache))
    assert model.last_fit_plane == "sharded"
    assert model.static_upload_count == 1
    assert list(model.last_fit_phases) == list(_SHARDED_PHASES)
    ends = []
    for phase in _SHARDED_PHASES:
        (a, b), = _named(entries, f"re.{phase}")
        assert model.last_fit_phases[phase] == (b - a) / 1e9
        ends.append((a, b))
    # one after another, none overlapping
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(ends, ends[1:]))


def test_score_records_spans(tmp_path):
    """score_records: the entity ids' factorization, then the join."""
    groups, _ = _make_groups(num_entities=11, seed=2)
    model, schema = _model(tmp_path, groups)
    models = model.fit_groups(groups, {}, schema)
    data = _port_records(_groups_to_records(groups))
    out, entries, _ = _profiled(
        lambda: model.score_records(data, models, schema))
    assert len(out["total"]) == data.num_samples
    assert [n for n, _, _ in entries] == ["re.score.factorize",
                                          "re.score.join"]
    (a0, b0), (a1, b1) = [(a, b) for _, a, b in entries]
    assert b0 <= a1


def _problem(batched: bool):
    """A small logistic objective (one problem or three lanes) and its
    call count."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(3, 40, 6, generator=g, dtype=torch.float64)
    y = (torch.rand(3, 40, generator=g) < 0.5).to(torch.float64)
    calls = []

    def fun(w):
        calls.append(1)
        wb = w if batched else w[None]
        z = torch.einsum("bnd,bd->bn", X[:wb.shape[0]], wb)
        f = (torch.nn.functional.softplus(z) - y[:wb.shape[0]] * z).sum(1) \
            + 0.5 * (wb * wb).sum(1)
        p = torch.sigmoid(z) - y[:wb.shape[0]]
        gr = torch.einsum("bnd,bn->bd", X[:wb.shape[0]], p) + wb
        return (f, gr) if batched else (f[0], gr[0])
    return fun, calls


@pytest.mark.parametrize("batched", [False, True])
def test_lbfgs_spans(batched):
    """One `lbfgs` span a call, one `lbfgs.objective` a call of the
    objective (the funcalls, for the one problem), one `lbfgs.fetch` a
    host sync, every one of them inside the call's span."""
    fun, calls = _problem(batched)
    x0 = torch.zeros((3, 6) if batched else 6, dtype=torch.float64)
    solve = lbfgs_batched if batched else lbfgs
    res, entries, _ = _profiled(lambda: solve(fun, x0, maxiter=30))
    (a, b), = _named(entries, "lbfgs")
    objective = _named(entries, "lbfgs.objective")
    fetch = _named(entries, "lbfgs.fetch")
    assert len(objective) == len(calls) > 1
    if not batched:
        assert len(objective) == res.num_funcalls
    assert len(fetch) == res.host_syncs > 1
    assert all(a <= s and e <= b for s, e in objective + fetch)
