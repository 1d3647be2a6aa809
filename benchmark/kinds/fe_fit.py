"""A fixed-effect stage: the whole fit, from x₀ = 0 to the configuration's
stopping rule, through FixedEffectLRModel, over and over, for the window.

The batch is made on the card from the seed. The fit goes through
FixedEffectLRModel._fit_batch, the method fit_data runs once its host
columns are on the card (fit_data itself would first build the batch as
host arrays). The device copy of the batch and the hot/cold split stay
built from set-up, as a multi-sweep job's device cache keeps them.

Unit: one fit. End to end: `fe_fit_s`, the window over the fits completed.

`correct`, as for training: set-up drives the same model object, through
the same call, for its first one, two and three L-BFGS iterations (which
also warms every kernel the window runs), and the plain reference
(reference/fe_objective.py, reference/lbfgs.py, float64, the same batch)
follows those three and goes on to the configuration's stopping rule:
  step_loss_gap  max over the three of |F(x_prog) − F(x_ref)| / |F(x_ref)|,
                 F the reference's float64 objective;
  step_norm_gap  max over steps 1 and 3 and over the two leaves (weights,
                 intercept) of the gap between the norms of the program's
                 and the reference's change from x₀, against the larger of
                 that leaf's and the median leaf's reference norm;
and of the last timed fit, the answer the window produced:
  fit_loss_gap   |F(x_prog) − F(x_ref)| / |F(x_ref)|, x_ref the reference's
                 answer after the same iterations;
  reported_loss  |f_prog − F(x_prog)| / |F(x_prog)|, the final loss the
                 program reports against the reference's value of its
                 answer.
The control is the reference a step below float32: the objective is
gathers, scatters and row sums, no matrix product, so bfloat16 operands
(float32 sums), not TF32.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import costs, gen, program
from benchmark.reference.fe_objective import Objective
from benchmark.reference.lbfgs import lbfgs


STEPS = (1, 2, 3)
# a fit stopped after this many iterations: the faults the fit's numbers
# are read against (benchmark.control)
STOPS = (3, 50, 90)

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stage:
    unit = "fit"

    def __init__(self, cell: dict, seed: int, device, spans):
        self.cell, self.cfg = cell, cell["cfg"]
        self.seed, self.device, self.spans = seed, device, spans
        self.times = {}         # set-up's parts, seconds
        self.width = self.cfg["fixed_effect"]["width"]
        self.fits = []
        self.unit_log = []      # each timed fit's L-BFGS counts

    def setup(self):
        t, c = self.cell, self.cfg
        t0 = time.perf_counter()
        traffic = dict(t, rows=c["rows"], numeric=c["numeric_fields"],
                       categorical=c["categorical_fields"])
        self.data = gen.criteo_rows(traffic, self.width, self.seed,
                                    self.device)
        self.n = self.data.labels.shape[0]
        self.tmp = tempfile.mkdtemp(prefix="gdx_benchmark_")
        self.model, self.params = program.fe_model(c, self.tmp, self.device)
        self.batch = program.sparse_batch(self.data)
        self.uid = np.arange(self.n, dtype=np.int64)
        self.cache = {}
        _sync(self.device)
        t1 = time.perf_counter()
        aux = self.model.build_hybrid_aux_for(self.batch, self.cache)
        _sync(self.device)
        t2 = time.perf_counter()
        self.split = None if aux is None else dict(
            hot=int(aux.hot_ids.shape[0]), cold=int(aux.cold_idx.shape[0]))
        # the first steps, through the window's own call: they warm every
        # kernel, and the reference follows them
        mp = self.model.model_params
        full = mp.num_of_lbfgs_iterations
        self.steps = []
        try:
            for k in STEPS:
                mp.num_of_lbfgs_iterations = k
                self.steps.append(self._fit().copy())
        finally:
            mp.num_of_lbfgs_iterations = full
        self.times = {"inputs": round(t1 - t0, 3), "split": round(t2 - t1, 3),
                      "first_steps": round(time.perf_counter() - t2, 3),
                      "grad_mode": self.model._grad_mode(),
                      "split_sizes": self.split}
        if self.device.type == "cuda":
            self.times["peak_after_setup"] = torch.cuda.max_memory_allocated(
                self.device)

    def _fit(self):
        """One fit from x₀ = 0; its coefficients."""
        self.coef = self.model._fit_batch(self.batch, self.uid, self.n,
                                          device_cache=self.cache)
        return self.coef

    def run_unit(self):
        traced = self.spans.traced
        if traced:
            inner = self.model._objective_fun

            def spanned(batch, aux=None):
                fun = inner(batch, aux)

                def call(x):
                    with self.spans.span("fit.objective"):
                        return fun(x)
                return call
            self.model._objective_fun = spanned
        try:
            with self.spans.span("fit"):
                self._fit()
            lf = dict(self.model.last_fit)
        finally:
            if traced:
                del self.model._objective_fun
        self.fits.append(lf)
        self.unit_log.append({k: lf[k] for k in (
            "iterations", "funcalls", "converged", "line_search_failed")})
        for k in ("funcalls", "host_syncs", "iterations"):
            self.spans.add(f"fit.{k}", lf[k])

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"fe_fit_s": window_s / units}

    def after_window(self, traced: bool):
        """Nothing: the fits' counters are taken in every fit."""

    def release(self):
        self.last = self.fits[-1]
        self.model = self.batch = self.cache = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _objective(self, low: bool, rows=None):
        """The plain objective over the batch, or over its first `rows`
        rows."""
        d, c = self.data, self.cfg
        cut = slice(None, rows)
        return Objective(d.indices[cut], d.values[cut], d.labels[cut],
                         d.weights[cut], d.offsets[cut], self.width,
                         c["l2_reg_weight"], fixed=c["numeric_fields"],
                         low=low)

    def _lbfgs(self, obj, maxiter: int, snapshots=()):
        c = self.cfg
        return lbfgs(obj, torch.zeros(self.width + 1, dtype=obj.dtype,
                                      device=self.device),
                     m=c["num_of_lbfgs_curvature_pairs"],
                     ftol=c["lbfgs_tolerance"], pgtol=c["lbfgs_pgtol"],
                     maxiter=maxiter, snapshots=snapshots)

    def _thresholded(self, x: torch.Tensor) -> torch.Tensor:
        """x with every |x| ≤ sparsity_threshold zeroed, as the program
        leaves its answer."""
        x = x.to(torch.float64)
        return torch.where(x.abs() <= self.cfg["sparsity_threshold"],
                           torch.zeros_like(x), x)

    @staticmethod
    def _norm_gap(x, xr) -> float:
        """The worst leaf's (weights, intercept) gap between the norms of x
        and xr, against the larger of that leaf's and the median leaf's
        norm in xr."""
        leaves = [(x[:-1], xr[:-1]), (x[-1:], xr[-1:])]
        refn = [float(torch.linalg.norm(b)) for _, b in leaves]
        med = float(np.median(refn))
        return max(abs(float(torch.linalg.norm(a)) - rn) / max(rn, med)
                   for (a, _), rn in zip(leaves, refn))

    def _steps(self, xs) -> dict:
        """The step numbers of iterates `xs` (after STEPS iterations)
        against the reference's."""
        F = self.obj
        loss = max(abs(float(F(x)[0]) - fr) / abs(fr)
                   for x, fr in zip(xs, self.f_ref))
        norm = max(self._norm_gap(xs[k], self.x_ref[k])
                   for k in (0, len(STEPS) - 1))
        return {"step_loss_gap": loss, "step_norm_gap": norm}

    def _fit_loss_gap(self, x) -> float:
        """The relative gap of F at answer x from F at the reference's."""
        return abs(float(self.obj(x)[0]) - self.f_fit) / abs(self.f_fit)

    def _reported_loss(self, f: float, x) -> float:
        """The relative gap of a reported loss f from F at answer x."""
        fx = float(self.obj(x)[0])
        return abs(f - fx) / abs(fx)

    def _numbers(self, xs, x, f: float) -> dict:
        """The compared numbers of iterates `xs` after STEPS iterations,
        of the answer x and of the loss f reported for it."""
        return dict(self._steps(xs), fit_loss_gap=self._fit_loss_gap(x),
                    reported_loss=self._reported_loss(f, x))

    def _host(self, coef):
        return torch.as_tensor(coef, dtype=torch.float64,
                               device=self.device)

    def check(self):
        self.obj = self._objective(low=False)
        res = self._lbfgs(self.obj, self.cfg["num_of_lbfgs_iterations"],
                          snapshots=STEPS + STOPS)
        self.ref_calls = res["funcalls"]
        self.stops = {k: self._thresholded(res["snapshots"][k])
                      for k in STOPS}
        self.x_ref = [self._thresholded(res["snapshots"][k]) for k in STEPS]
        self.f_ref = [float(self.obj(x)[0]) for x in self.x_ref]
        self.x_fit = self._thresholded(res["x"])
        self.f_fit = float(self.obj(self.x_fit)[0])
        return self._numbers([self._host(c) for c in self.steps],
                             self._host(self.coef), float(self.last["f"]))

    def control(self) -> dict:
        """The compared numbers of the control (the reference with
        bfloat16 operands, in the program's place, to the same stopping
        rule); after check()."""
        obj = self._objective(low=True)
        res = self._lbfgs(obj, self.cfg["num_of_lbfgs_iterations"],
                          snapshots=STEPS)
        xf = self._thresholded(res["x"])
        return self._numbers([self._thresholded(res["snapshots"][k])
                              for k in STEPS], xf, float(obj(xf)[0]))

    def faults(self) -> dict:
        """The step and fit numbers of faults planted in the reference put
        in the program's place, after check(): the state left unchanged
        (x₀ throughout); half of the batch left out (the reference fitted
        to the first half of the rows); the answer altered where it is
        produced (the intercept moved by 0.05); and the fit stopped after
        each of STOPS iterations."""
        full = self.cfg["num_of_lbfgs_iterations"]
        x0 = torch.zeros_like(self.x_fit)
        out = {"unchanged": self._numbers([x0] * len(STEPS), x0,
                                          float(self.obj(x0)[0]))}
        half = self._objective(low=False, rows=self.n // 2)
        res = self._lbfgs(half, full, snapshots=STEPS)
        xh = self._thresholded(res["x"])
        out["half_batch"] = self._numbers(
            [self._thresholded(res["snapshots"][k]) for k in STEPS], xh,
            float(half(xh)[0]))
        del half
        bump = torch.zeros_like(x0)
        bump[-1] = 0.05
        out["altered"] = self._numbers([x + bump for x in self.x_ref],
                                       self.x_fit + bump, self.f_fit)
        for k, x in self.stops.items():
            out[f"stop_at_{k}"] = {"fit_loss_gap": self._fit_loss_gap(x)}
        return out

    def counted_work(self):
        """(flops, bytes) of one fit: the funcalls the reference needed,
        each over every entry."""
        k = self.data.indices.shape[1]
        calls = float(self.ref_calls)
        return (calls * costs.funcall_flops(self.n, k),
                calls * costs.funcall_bytes(self.n, k, self.width))
