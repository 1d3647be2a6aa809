"""L-BFGS with a strong-Wolfe line search and scipy-compatible stopping.

Port of gdmix_tpu/ops/lbfgs.py:lbfgs, the solver of the fixed-effect fit
(it replaces the reference's scipy.optimize.fmin_l_bfgs_b,
linkedin/gdmix:gdmix-trainer/src/gdmix/models/custom/
fixed_effect_lr_lbfgs_model.py:635-643). The JAX package runs the loop inside
`lax.while_loop` on the device; here the loop runs on the host over device
tensors. Every decision the JAX loop takes on a device scalar is one host
sync here, and the result counts them (`host_syncs`): one per objective
call (its value and directional derivative come back together), one for the
descent test of each iteration and one for its curvature pair and stopping
test. A CUDA graph of the whole loop is later work (ROADMAP A.4).

Both loops are spans of util/timing: `lbfgs` the whole call,
`lbfgs.objective` each call of `fun` (taken on this side of the call, so a
caller's span inside `fun` stays the innermost over its work) and
`lbfgs.fetch` each host read of device scalars. What `lbfgs` holds beyond
the other two is the loop's own host work.

The steps are the JAX package's, one for one:

  * two-loop recursion over the m newest curvature pairs, gamma-scaled
    initial Hessian; a direction that is not a descent direction restarts
    as −g;
  * strong-Wolfe line search (bracket + zoom with quadratic interpolation
    and a bisection safeguard, Nocedal & Wright alg. 3.5/3.6) in one loop of
    at most `maxls` trials, with the same transitions;
  * a pair enters the history only if sᵀy > 1e-10·yᵀy;
  * stopping as fmin_l_bfgs_b: ‖g‖∞ ≤ pgtol, or
    (f_k − f_{k+1}) ≤ ftol·max(|f_k|, |f_{k+1}|, 1).

Scalars (step sizes, f, the Wolfe tests) are Python floats: the decisions
of a float64 solve equal the JAX package's; a float32 solve takes them in
float64.

`lbfgs_batched` is the random-effect form, `vmap(lbfgs)` of
gdmix_tpu/ops/lbfgs.py:288: B independent problems in lockstep over [B]
lanes, every per-lane scalar a [B] tensor in the problem's type. A lane's
state moves only while its own loop condition holds, which is what vmap's
masked `while_loop` does, so each lane takes the decisions the single
problem would. The host reads "is any lane live" once per iteration and
once per line-search trial (`host_syncs`).

Why two loops and not `lbfgs` as the B = 1 lane of `lbfgs_batched`: the
two take their decisions in different precisions, and each matches its
own caller in the JAX package. The FE solve is one problem whose scalars
reach the host anyway (each objective call's value and slope, the pair
test), so its Armijo, curvature and ftol tests run on Python floats, in
float64. At the FE bench's size a float32 objective is ~3.5e6, where
float32 steps by 0.25, while ftol·|f| is 3.5e-6: taken in float32, the
ftol test and the Armijo test f_a ≤ f0 + c1·α·gd0 would compare numbers
float32 cannot tell apart. The batched form has no host float per lane; its tests
are [B] tensors in the lanes' type, as under vmap, which the RE rungs'
parity with the JAX package needs. Both loops hold the same steps, listed
above; a change to one is a change to both, and the tests pin each to its
JAX counterpart iteration for iteration.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch

from gdmix_tpu_torch.util.timing import span

_C1 = 1e-4   # sufficient-decrease (Armijo)
_C2 = 0.9    # curvature


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: float
    g: torch.Tensor
    num_iterations: int
    num_funcalls: int
    converged: bool            # stopped by ftol/pgtol (not maxiter)
    line_search_failed: bool
    host_syncs: int            # device→host scalar fetches the loop took


class _Counter:
    def __init__(self):
        self.syncs = 0

    def fetch(self, *scalars: torch.Tensor) -> List[float]:
        """One device→host copy of several scalars."""
        self.syncs += 1
        with span("lbfgs.fetch"):
            return torch.stack([s.reshape(()).to(torch.float64)
                                for s in scalars]).tolist()

    def any(self, flags: torch.Tensor) -> bool:
        """One device→host read of whether any of `flags` holds."""
        self.syncs += 1
        with span("lbfgs.fetch"):
            return bool(flags.any())


def _call(fun, x):
    """fun(x), an `lbfgs.objective` span."""
    with span("lbfgs.objective"):
        return fun(x)


def _strong_wolfe(fun, x, f0: float, g0, d, gd0: float, max_steps: int,
                  sync: _Counter):
    """Strong-Wolfe line search along d from x. Returns
    (alpha, f, g, nfev, failed); `fun` returns (value, grad)."""
    def phi(alpha):
        f, g = _call(fun, x + alpha * d)
        f_a, g_a = sync.fetch(f, torch.dot(g, d))
        return f_a, g, g_a

    step = 1.0
    lo, f_lo, g_lo = 0.0, f0, gd0
    hi, f_hi = 0.0, f0
    bracketed = False
    best, f_best, grad_best = 0.0, f0, g0
    i = nfev = 0
    done = False
    while not done and i < max_steps:
        a = step
        f_a, grad_a, g_a = phi(a)
        nfev += 1

        armijo_fail = f_a > f0 + _C1 * a * gd0
        not_lower = i > 0 and f_a >= f_lo
        wolfe_ok = abs(g_a) <= -_C2 * gd0
        pos_slope = g_a >= 0
        accept = not armijo_fail and wolfe_ok

        in_zoom = bracketed
        # bracketing phase: enter zoom with (lo, hi = a) or (lo = a, hi = lo),
        # or extend the step
        enter_hi_a = not in_zoom and (armijo_fail or not_lower)
        enter_lo_a = (not in_zoom and not enter_hi_a and not accept
                      and pos_slope)
        extend = (not in_zoom and not enter_hi_a and not enter_lo_a
                  and not accept)
        # zoom phase: hi := a; or lo := a (flip: hi := lo first)
        shrink_hi = in_zoom and (armijo_fail or f_a >= f_lo)
        flip = (in_zoom and not shrink_hi and not accept
                and g_a * (hi - lo) >= 0)
        advance = in_zoom and not shrink_hi and not accept

        new_bracketed = in_zoom or enter_hi_a or enter_lo_a

        # `lo` also tracks the PREVIOUS trial point while bracketing
        lo_moves = enter_lo_a or advance or extend
        if enter_hi_a or shrink_hi:
            hi, f_hi = a, f_a
        elif enter_lo_a or flip:
            hi, f_hi = lo, f_lo
        if lo_moves:
            lo, f_lo, g_lo = a, f_a, g_a

        # next trial: quadratic interpolation from (lo, f_lo, g_lo) and
        # (hi, f_hi), kept to the middle 80% of the bracket, else bisection
        denom = 2.0 * (f_hi - f_lo - g_lo * (hi - lo))
        quad = lo - g_lo * (hi - lo) ** 2 / (1.0 if denom == 0 else denom)
        mid = 0.5 * (lo + hi)
        lo_hi_min, lo_hi_max = min(lo, hi), max(lo, hi)
        margin = 0.1 * (lo_hi_max - lo_hi_min)
        quad_ok = (denom != 0 and lo_hi_min + margin < quad
                   < lo_hi_max - margin)
        zoom_step = quad if quad_ok else mid
        step = zoom_step if new_bracketed else min(2.0 * a, 1e10)

        # bracket too small → give up (accept lo)
        tiny = (lo_hi_max - lo_hi_min) <= 1e-14 * max(lo_hi_max, 1.0)
        done = accept or (new_bracketed and tiny)
        if accept or f_a < f_best:
            best, f_best, grad_best = a, f_a, grad_a
        bracketed = new_bracketed
        i += 1

    # failure: nothing decreased f
    if best == 0.0 or f_best > f0:
        return 0.0, f0, g0, nfev, True
    return best, f_best, grad_best, nfev, False


def _two_loop(g, S: List[torch.Tensor], Y: List[torch.Tensor],
              rho: List[float], gamma: float):
    """Two-loop recursion r ≈ H·g over the history (oldest first). The JAX
    package keeps a fixed ring of m slots whose empty ones (rho = 0)
    contribute nothing; the list holds only the filled ones."""
    q = g
    alphas = [0.0] * len(rho)
    for i in reversed(range(len(rho))):       # newest → oldest
        alphas[i] = rho[i] * torch.dot(S[i], q)
        q = q - alphas[i] * Y[i]
    r = gamma * q
    for i in range(len(rho)):                 # oldest → newest
        beta = rho[i] * torch.dot(Y[i], r)
        r = r + S[i] * (alphas[i] - beta)
    return r


def lbfgs(fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
          x0: torch.Tensor,
          *,
          m: int = 10,
          ftol: float = 1e-12,
          pgtol: float = 1e-5,
          maxiter: int = 100,
          maxls: int = 25) -> LBFGSResult:
    """Minimize fun (returning (value, grad) tensors) from x0.

    ftol is the relative-f stopping tolerance — the reference's
    `lbfgs_tolerance` (factr·eps in scipy terms). pgtol matches
    fmin_l_bfgs_b's default 1e-5."""
    with span("lbfgs"):
        sync = _Counter()
        x = x0
        f_t, g = _call(fun, x0)
        f, gmax = sync.fetch(f_t, torch.max(torch.abs(g)))
        S: List[torch.Tensor] = []
        Y: List[torch.Tensor] = []
        rho: List[float] = []
        gamma = 1.0
        k, nfev = 0, 1
        converged, ls_failed = gmax <= pgtol, False
        while k < maxiter and not converged and not ls_failed:
            direction = -_two_loop(g, S, Y, rho, gamma)
            gd, gg = sync.fetch(torch.dot(g, direction), torch.dot(g, g))
            if gd >= 0:   # not a descent direction (numerical breakdown)
                direction, gd = -g, -gg

            alpha, f_new, g_new, ls_nfev, ls_failed = _strong_wolfe(
                fun, x, f, g, direction, gd, maxls, sync)

            x_new = x + alpha * direction
            s_vec = x_new - x
            y_vec = g_new - g
            sy, yy, gmax = sync.fetch(torch.dot(s_vec, y_vec),
                                      torch.dot(y_vec, y_vec),
                                      torch.max(torch.abs(g_new)))
            if sy > 1e-10 * yy:   # ring buffer: drop the oldest, append
                S.append(s_vec)
                Y.append(y_vec)
                rho.append(1.0 / (1.0 if sy == 0 else sy))
                if len(rho) > m:
                    del S[0], Y[0], rho[0]
                gamma = sy / max(yy, 1e-30)

            rel = max(abs(f), abs(f_new), 1.0)
            converged = (f - f_new) <= ftol * rel or gmax <= pgtol
            x, f, g = x_new, f_new, g_new
            k += 1
            nfev += ls_nfev
        return LBFGSResult(x=x, f=f, g=g, num_iterations=k, num_funcalls=nfev,
                           converged=converged, line_search_failed=ls_failed,
                           host_syncs=sync.syncs)


class LBFGSBatchResult(NamedTuple):
    x: torch.Tensor                   # [B, dim]
    f: torch.Tensor                   # [B]
    g: torch.Tensor                   # [B, dim]
    num_iterations: torch.Tensor      # [B] int32
    num_funcalls: torch.Tensor        # [B] int32
    converged: torch.Tensor           # [B] bool: stopped by ftol/pgtol
    line_search_failed: torch.Tensor  # [B] bool
    host_syncs: int                   # "any lane live" reads by the host


def _two_loop_batched(g, S, Y, rho, gamma):
    """Two-loop recursion r ≈ H·g per lane over a ring of m slots
    (S, Y [B, m, dim], rho [B, m], oldest first); empty slots have
    rho == 0 and contribute nothing."""
    m = rho.shape[1]
    q = g
    alphas = [None] * m
    for idx in reversed(range(m)):            # newest → oldest
        alphas[idx] = rho[:, idx] * torch.sum(S[:, idx] * q, dim=1)
        q = q - alphas[idx][:, None] * Y[:, idx]
    r = gamma[:, None] * q
    for i in range(m):                        # oldest → newest
        beta = rho[:, i] * torch.sum(Y[:, i] * r, dim=1)
        r = r + S[:, i] * (alphas[i] - beta)[:, None]
    return r


def _strong_wolfe_batched(fun, x, f0, g0, d, gd0, max_steps: int, live,
                          sync: _Counter):
    """The strong-Wolfe search of `_strong_wolfe` on every lane at once;
    lanes outside `live` take no trial that counts. Returns
    (alpha, f, g, nfev, failed), each per lane."""
    B = x.shape[0]
    dt, dev = x.dtype, x.device
    zero = torch.zeros(B, dtype=dt, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    step = torch.ones(B, dtype=dt, device=dev)
    lo, f_lo, g_lo = zero, f0, gd0
    hi, f_hi = zero, f0
    bracketed, done = false, false
    best, f_best, grad_best = zero, f0, g0
    i = torch.zeros(B, dtype=torch.int32, device=dev)
    while True:
        run = live & ~done & (i < max_steps)
        if not sync.any(run):
            break
        a = step
        f_a, grad_a = _call(fun, x + a[:, None] * d)
        g_a = torch.sum(grad_a * d, dim=1)

        armijo_fail = f_a > f0 + _C1 * a * gd0
        not_lower = (i > 0) & (f_a >= f_lo)
        wolfe_ok = g_a.abs() <= -_C2 * gd0
        pos_slope = g_a >= 0
        accept = ~armijo_fail & wolfe_ok

        in_zoom = bracketed
        # bracketing phase: enter zoom with (lo, hi = a) or (lo = a,
        # hi = lo), or extend the step
        enter_hi_a = ~in_zoom & (armijo_fail | not_lower)
        enter_lo_a = ~in_zoom & ~enter_hi_a & ~accept & pos_slope
        extend = ~in_zoom & ~enter_hi_a & ~enter_lo_a & ~accept
        # zoom phase: hi := a; or lo := a (flip: hi := lo first)
        shrink_hi = in_zoom & (armijo_fail | (f_a >= f_lo))
        flip = in_zoom & ~shrink_hi & ~accept & (g_a * (hi - lo) >= 0)
        advance = in_zoom & ~shrink_hi & ~accept
        new_bracketed = in_zoom | enter_hi_a | enter_lo_a

        # `lo` also tracks the PREVIOUS trial point while bracketing
        lo_moves = enter_lo_a | advance | extend
        to_a = enter_hi_a | shrink_hi
        to_lo = enter_lo_a | flip
        n_hi = torch.where(to_a, a, torch.where(to_lo, lo, hi))
        n_f_hi = torch.where(to_a, f_a, torch.where(to_lo, f_lo, f_hi))
        n_lo = torch.where(lo_moves, a, lo)
        n_f_lo = torch.where(lo_moves, f_a, f_lo)
        n_g_lo = torch.where(lo_moves, g_a, g_lo)

        # next trial: quadratic interpolation from (lo, f_lo, g_lo) and
        # (hi, f_hi), kept to the middle 80% of the bracket, else bisection
        denom = 2.0 * (n_f_hi - n_f_lo - n_g_lo * (n_hi - n_lo))
        quad = n_lo - n_g_lo * (n_hi - n_lo) ** 2 / torch.where(
            denom == 0, torch.ones_like(denom), denom)
        mid = 0.5 * (n_lo + n_hi)
        lo_hi_min = torch.minimum(n_lo, n_hi)
        lo_hi_max = torch.maximum(n_lo, n_hi)
        margin = 0.1 * (lo_hi_max - lo_hi_min)
        quad_ok = ((denom != 0) & (quad > lo_hi_min + margin)
                   & (quad < lo_hi_max - margin))
        zoom_step = torch.where(quad_ok, quad, mid)
        next_step = torch.where(new_bracketed, zoom_step,
                                torch.clamp_max(2.0 * a, 1e10))

        # bracket too small → give up (accept lo)
        tiny = (lo_hi_max - lo_hi_min) <= 1e-14 * torch.clamp_min(lo_hi_max,
                                                                   1.0)
        better = accept | (f_a < f_best)

        def upd(new, old):
            cond = run if new.dim() == 1 else run[:, None]
            return torch.where(cond, new, old)
        best, f_best, grad_best = (upd(torch.where(better, a, best), best),
                                   upd(torch.where(better, f_a, f_best),
                                       f_best),
                                   upd(torch.where(better[:, None], grad_a,
                                                   grad_best), grad_best))
        lo, f_lo, g_lo = upd(n_lo, lo), upd(n_f_lo, f_lo), upd(n_g_lo, g_lo)
        hi, f_hi = upd(n_hi, hi), upd(n_f_hi, f_hi)
        bracketed = upd(new_bracketed, bracketed)
        done = upd(accept | (new_bracketed & tiny), done)
        step = upd(next_step, step)
        i = torch.where(run, i + 1, i)

    # failure: nothing decreased f
    failed = (best == 0.0) | (f_best > f0)
    alpha = torch.where(failed, zero, best)
    f_new = torch.where(failed, f0, f_best)
    g_new = torch.where(failed[:, None], g0, grad_best)
    return alpha, f_new, g_new, i, failed


def lbfgs_batched(fun: Callable[[torch.Tensor],
                                Tuple[torch.Tensor, torch.Tensor]],
                  x0: torch.Tensor,
                  *,
                  m: int = 10,
                  ftol: float = 1e-12,
                  pgtol: float = 1e-5,
                  maxiter: int = 100,
                  maxls: int = 25) -> LBFGSBatchResult:
    """Minimize B independent problems from x0 [B, dim]; `fun` maps
    [B, dim] to (values [B], grads [B, dim]), one problem per row. The steps
    are `lbfgs`'s, lane by lane; converged lanes are frozen while the others
    go on."""
    with span("lbfgs"):
        B, dim = x0.shape
        dt, dev = x0.dtype, x0.device
        sync = _Counter()
        f, g = _call(fun, x0)
        x = x0
        S = torch.zeros(B, m, dim, dtype=dt, device=dev)
        Y = torch.zeros(B, m, dim, dtype=dt, device=dev)
        rho = torch.zeros(B, m, dtype=dt, device=dev)
        gamma = torch.ones(B, dtype=dt, device=dev)
        k = torch.zeros(B, dtype=torch.int32, device=dev)
        nfev = torch.ones(B, dtype=torch.int32, device=dev)
        converged = g.abs().amax(dim=1) <= pgtol
        ls_failed = torch.zeros(B, dtype=torch.bool, device=dev)
        while True:
            live = (k < maxiter) & ~converged & ~ls_failed
            if not sync.any(live):
                break
            direction = -_two_loop_batched(g, S, Y, rho, gamma)
            gd = torch.sum(g * direction, dim=1)
            # not a descent direction (numerical breakdown): restart with -g
            bad = gd >= 0
            direction = torch.where(bad[:, None], -g, direction)
            gd = torch.where(bad, -torch.sum(g * g, dim=1), gd)

            alpha, f_new, g_new, ls_nfev, ls_fail = _strong_wolfe_batched(
                fun, x, f, g, direction, gd, maxls, live, sync)

            x_new = x + alpha[:, None] * direction
            s_vec = x_new - x
            y_vec = g_new - g
            sy = torch.sum(s_vec * y_vec, dim=1)
            yy = torch.sum(y_vec * y_vec, dim=1)
            # ring buffer: drop the oldest, append the newest (if the pair is
            # good); only live lanes move
            push = live & (sy > 1e-10 * yy)
            S = torch.where(push[:, None, None],
                            torch.cat([S[:, 1:], s_vec[:, None]], dim=1), S)
            Y = torch.where(push[:, None, None],
                            torch.cat([Y[:, 1:], y_vec[:, None]], dim=1), Y)
            rho = torch.where(push[:, None], torch.cat(
                [rho[:, 1:], (1.0 / torch.where(sy == 0, torch.ones_like(sy),
                                                sy))[:, None]], dim=1), rho)
            gamma = torch.where(push, sy / torch.clamp_min(yy, 1e-30), gamma)

            rel = torch.clamp_min(torch.maximum(f.abs(), f_new.abs()), 1.0)
            conv = ((f - f_new <= ftol * rel)
                    | (g_new.abs().amax(dim=1) <= pgtol))
            x = torch.where(live[:, None], x_new, x)
            f = torch.where(live, f_new, f)
            g = torch.where(live[:, None], g_new, g)
            converged = torch.where(live, conv, converged)
            ls_failed = torch.where(live, ls_fail, ls_failed)
            k = torch.where(live, k + 1, k)
            nfev = torch.where(live, nfev + ls_nfev, nfev)
        return LBFGSBatchResult(x=x, f=f, g=g, num_iterations=k,
                                num_funcalls=nfev, converged=converged,
                                line_search_failed=ls_failed,
                                host_syncs=sync.syncs)
