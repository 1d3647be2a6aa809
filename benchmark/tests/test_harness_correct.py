"""`correct` on tiny cells on the CPU: the program's run passes; the
control (the reference a precision step down, in the program's place)
fails; and a run with the timed path broken underneath fails, once for
each fault the cell can have (a single-card cell has no exchange between
cards to leave out), and for a fit that stops early."""
import json

import pytest
import torch

from benchmark import harness as h
from benchmark.compare import judge
from benchmark.tests.small import run_small, small_cell

CELLS = ["lr-movielens.re-fleet", "lr-criteo.fe-fit"]


def _correct(monkeypatch, cell):
    code, line = run_small(monkeypatch, cell)
    assert code == 0
    return json.loads(line)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(monkeypatch, cell):
    c = small_cell(cell)
    st = h.kind(c["kind"]).Stage(c, 2 ** 31 + 3, torch.device("cpu"),
                                 h.Spans())
    st.setup()
    st.run_unit()
    st.release()
    ok, rows = judge(st.check(), c["limits"])
    assert ok, rows
    ok, rows = judge(st.control(), c["limits"])
    assert not ok, rows


def _fleet_unchanged(monkeypatch):
    from gdmix_tpu_torch.models import random_effect_lr as m
    sel = m.RandomEffectLRModel._select_solver

    def select(self, u_cap, B, n_cap):
        rung, solve = sel(self, u_cap, B, n_cap)

        def stuck(a):
            theta, var, conv = solve(a)
            return a["theta0"].clone(), var, conv
        return rung, stuck
    monkeypatch.setattr(m.RandomEffectLRModel, "_select_solver", select)


def _fleet_half(monkeypatch):
    from gdmix_tpu_torch.models import random_effect_lr as m
    from gdmix_tpu_torch.data.bucketing import FlatGroups
    fit = m.RandomEffectLRModel.fit_flat

    def half(self, fg, w, p, device_cache=None):
        k = len(fg) // 2
        n = int(fg.counts[:k].sum())
        cut = FlatGroups(entity_ids=fg.entity_ids[:k], counts=fg.counts[:k],
                         columns={c: v[:n] for c, v in fg.columns.items()},
                         indices=fg.indices[:n], values=fg.values[:n],
                         rec_nnz=fg.rec_nnz[:n])
        return fit(self, cut, w, p, device_cache)
    monkeypatch.setattr(m.RandomEffectLRModel, "fit_flat", half)


def _fleet_altered(monkeypatch):
    from gdmix_tpu_torch.models import random_effect_lr as m
    collect = m.RandomEffectLRModel._collect_bucket_table

    def altered(self, bucket, theta, variance):
        t = collect(self, bucket, theta, variance)
        t.icpt[len(t.icpt) // 2] += 0.05
        return t
    monkeypatch.setattr(m.RandomEffectLRModel, "_collect_bucket_table",
                        altered)


def _fe_unchanged(monkeypatch):
    from gdmix_tpu_torch.models import fixed_effect_lr as m
    lbfgs = m.lbfgs

    def stuck(fun, x0, **kw):
        return lbfgs(fun, x0, **kw)._replace(x=x0)
    monkeypatch.setattr(m, "lbfgs", stuck)


def _fe_half(monkeypatch):
    from gdmix_tpu_torch.models import fixed_effect_lr as m
    obj = m.FixedEffectLRModel._objective_fun

    def half(self, batch, aux=None):
        k = batch.labels.shape[0] // 2
        return obj(self, type(batch)(*[t[:k] for t in batch]), None)
    monkeypatch.setattr(m.FixedEffectLRModel, "_objective_fun", half)


def _fe_altered(monkeypatch):
    from gdmix_tpu_torch.models import fixed_effect_lr as m
    thr = m.threshold_coefficients

    def altered(x, tau):
        out = thr(x, tau)
        out[-1] += 0.05
        return out
    monkeypatch.setattr(m, "threshold_coefficients", altered)


def _fe_stopped_early(monkeypatch):
    """The timed fit stops after three iterations; set-up's first steps,
    which take at most three, are left as they are."""
    from gdmix_tpu_torch.models import fixed_effect_lr as m
    lbfgs = m.lbfgs

    def early(fun, x0, **kw):
        kw["maxiter"] = min(kw.get("maxiter", 100), 3)
        return lbfgs(fun, x0, **kw)
    monkeypatch.setattr(m, "lbfgs", early)


FAULTS = [("lr-movielens.re-fleet", _fleet_unchanged),
          ("lr-movielens.re-fleet", _fleet_half),
          ("lr-movielens.re-fleet", _fleet_altered),
          ("lr-criteo.fe-fit", _fe_unchanged),
          ("lr-criteo.fe-fit", _fe_half),
          ("lr-criteo.fe-fit", _fe_altered),
          ("lr-criteo.fe-fit", _fe_stopped_early)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    line = _correct(monkeypatch, cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    """One short run of the fleet cell through the command, on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "lr-movielens.re-fleet", "--seed", "7", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=h.ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
