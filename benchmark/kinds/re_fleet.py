"""A random-effect coordinate's training stage: every entity of a partition
fitted through RandomEffectLRModel.fit_flat from θ₀ = 0 (the first
sweep's stage), over and over, for the window.

Unit: one fit of the whole partition. End to end: `re_models_per_s`, the
entities of every fit completed over all the window's time.

`correct`: the last timed fit's every model against the plain per-entity
Newton (reference/re_newton.py) in float64 on the same rows:
  theta_gap           the widest threshold-aware coefficient gap over
                      entities with both labels (a finite optimum);
  unconverged_excess  the most entities any timed fit left unconverged,
                      less the reference's count;
  missing_models      entities without a model, in any timed fit.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import compare, costs, gen, program
from benchmark.reference.re_newton import solve_entities


class Stage:
    unit = "fit"

    def __init__(self, cell: dict, seed: int, device, spans):
        self.cell, self.cfg = cell, cell["cfg"]
        self.coord = next(c for c in self.cfg["random_effects"]
                          if c["name"] == cell["coordinate"])
        self.seed, self.device, self.spans = seed, device, spans
        self.times = {}         # set-up's parts, seconds
        self.fits = []          # (n_conv, n_real) of each timed fit
        self.unit_log = []      # each timed fit's phases
        self.table = None

    # ---------------------------------------------------------- set-up --
    def setup(self):
        t0 = time.perf_counter()
        self.data = gen.re_fleet(self.cell, self.coord["width"], self.seed)
        d = self.data
        self.E = len(d.counts)
        ids = np.arange(self.E).astype(str).astype(object)
        self.fg = program.flat_groups(ids, d.counts, d.labels, d.offsets,
                                      d.indices, d.values, d.nnz)
        self.tmp = tempfile.mkdtemp(prefix="gdx_benchmark_")
        self.model, self.params = program.re_model(
            self.cfg, self.coord, self.tmp, self.device)
        t1 = time.perf_counter()
        self.model.fit_flat(self.fg, {}, self.params)   # warm: every shape
        self.times = {"inputs": round(t1 - t0, 3),
                      "warm_fit": round(time.perf_counter() - t1, 3)}

    # ---------------------------------------------------------- window --
    def run_unit(self):
        with self.spans.span("fit"):
            self.table = self.model.fit_flat(self.fg, {}, self.params)
        m = self.model
        self.fits.append(m.last_fit_converged)
        self.spans.add("fit.marshal_dispatch",
                       m.last_fit_phases.get("marshal_dispatch", 0.0))
        self.unit_log.append({k: round(v, 3)
                              for k, v in m.last_fit_phases.items()})

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"re_models_per_s": units * self.E / window_s}

    # ------------------------------------------------- after the window --
    def after_window(self, traced: bool):
        """Traced runs: one more fit with its host syncs counted (outside
        the window: the sync debug mode slows what it watches)."""
        if traced:
            from benchmark.syncs import count_syncs
            _, lines = count_syncs(
                lambda: self.model.fit_flat(self.fg, {}, self.params),
                self.device)
            self.spans.counters["syncs_per_fit"] = float(sum(lines.values()))
            self.spans.counters["sync_lines"] = lines

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False):
        d, c = self.data, self.cfg
        return solve_entities(
            d.counts, d.labels, d.offsets, d.indices, d.values, d.nnz,
            self.coord["width"], lam=c["l2_reg_weight"],
            regularize_bias=c["regularize_bias"],
            maxiter=c["num_of_lbfgs_iterations"], ftol=c["lbfgs_tolerance"],
            pgtol=c["lbfgs_pgtol"], device=self.device, tf32=tf32)

    def numbers(self, theta: np.ndarray, ref, unconverged: int) -> dict:
        """The compared numbers of models `theta` [E, 1 + width] against
        the reference's solve `ref`."""
        tau = self.cfg["sparsity_threshold"]
        gap = compare.thresholded_gap(theta, ref.theta, tau).max(1)
        return {
            "theta_gap": float(gap[ref.mixed].max(initial=0.0)),
            "unconverged_excess": float(unconverged
                                        - int((~ref.converged).sum())),
        }

    def check(self):
        """The compared numbers of the last timed fit."""
        ref = self.reference()
        theta = program.dense_models(self.table, self.E,
                                     self.coord["width"])
        worst = max(n_real - n_conv for n_conv, n_real in self.fits)
        out = self.numbers(theta, ref, worst)
        out["missing_models"] = float(max(
            self.E - n_real for _, n_real in self.fits)
            + (self.E - len(self.table)))
        self.ref = ref
        return out

    def control(self) -> dict:
        """The compared numbers of the control (the reference in TF32, in
        the program's place) against the reference; after check()."""
        ctl = self.reference(tf32=True)
        return self.numbers(ctl.theta, self.ref,
                            int((~ctl.converged).sum()))

    # ------------------------------------------------------ counted work --
    def counted_work(self):
        """(flops, bytes) of one fit: each entity's solve in the Newton
        iterations the reference needed, at the entity's own rows and dim
        (its distinct features and the intercept)."""
        d, w = self.data, self.coord["width"] + 1
        ent = np.repeat(np.arange(self.E, dtype=np.int64), d.counts)
        live = np.arange(d.indices.shape[1])[None, :] < d.nnz[:, None]
        keys = np.unique((ent[:, None] * w + d.indices)[live])
        dims = np.bincount(keys // w, minlength=self.E) + 1.0
        n = d.counts.astype(np.float64)
        it = self.ref.iterations.astype(np.float64)
        return (float((it * costs.newton_iteration_flops(n, dims)).sum()),
                float(costs.newton_solve_bytes(n, dims).sum()))
