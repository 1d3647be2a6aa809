"""Plain L-BFGS with a strong-Wolfe line search and scipy-compatible
stopping, the solver GDMix's fixed effect states (the reference trainer's
scipy.optimize.fmin_l_bfgs_b): the m newest curvature pairs, a
gamma-scaled initial Hessian, a direction that is not a descent direction
restarts as −g; the line search of Nocedal & Wright (algorithms 3.5 and
3.6: bracketing, then zoom by quadratic interpolation with a bisection
safeguard) in at most `maxls` trials; a pair enters only if sᵀy >
1e-10·yᵀy; stop when ‖g‖∞ ≤ pgtol or (f_k − f_{k+1}) ≤ ftol·max(|f_k|,
|f_{k+1}|, 1). Scalars are Python floats (float64).

`snapshots`: iteration counts at which to keep a copy of x, so one run
gives the iterate after as many iterations as the program took; past the
iteration it stopped at, x is where it stopped."""
from __future__ import annotations

from typing import Dict, List

import torch

_C1, _C2 = 1e-4, 0.9


def _line_search(fun, x, f0, g0, d, gd0, maxls):
    step, lo, f_lo, g_lo, hi, f_hi = 1.0, 0.0, f0, gd0, 0.0, f0
    bracketed = False
    best, f_best, grad_best = 0.0, f0, g0
    nfev = 0
    for i in range(maxls):
        a = step
        fa_t, grad_a = fun(x + a * d)
        f_a, g_a = float(fa_t), float(torch.dot(grad_a, d))
        nfev += 1
        armijo_fail = f_a > f0 + _C1 * a * gd0
        not_lower = i > 0 and f_a >= f_lo
        accept = not armijo_fail and abs(g_a) <= -_C2 * gd0
        if not bracketed:
            enter_hi = armijo_fail or not_lower
            enter_lo = not enter_hi and not accept and g_a >= 0
            if enter_hi:
                hi, f_hi = a, f_a
            elif enter_lo:
                hi, f_hi = lo, f_lo
            if enter_lo or not (enter_hi or accept):
                lo, f_lo, g_lo = a, f_a, g_a
            new_bracketed = enter_hi or enter_lo
        else:
            shrink = armijo_fail or f_a >= f_lo
            if shrink:
                hi, f_hi = a, f_a
            elif not accept:
                if g_a * (hi - lo) >= 0:
                    hi, f_hi = lo, f_lo
                lo, f_lo, g_lo = a, f_a, g_a
            new_bracketed = True
        denom = 2.0 * (f_hi - f_lo - g_lo * (hi - lo))
        quad = lo - g_lo * (hi - lo) ** 2 / (1.0 if denom == 0 else denom)
        lo_b, hi_b = min(lo, hi), max(lo, hi)
        margin = 0.1 * (hi_b - lo_b)
        quad_ok = denom != 0 and lo_b + margin < quad < hi_b - margin
        step = ((quad if quad_ok else 0.5 * (lo + hi)) if new_bracketed
                else min(2.0 * a, 1e10))
        tiny = (hi_b - lo_b) <= 1e-14 * max(hi_b, 1.0)
        if accept or f_a < f_best:
            best, f_best, grad_best = a, f_a, grad_a
        bracketed = new_bracketed
        if accept or (new_bracketed and tiny):
            break
    if best == 0.0 or f_best > f0:
        return 0.0, f0, g0, nfev, True
    return best, f_best, grad_best, nfev, False


def lbfgs(fun, x0: torch.Tensor, *, m: int, ftol: float, pgtol: float,
          maxiter: int, maxls: int = 25, snapshots=()):
    """Minimise fun (returning (value, grad)) from x0. Returns a dict:
    x, f, iterations, funcalls, and {k: x after k iterations} for each k
    of `snapshots` reached."""
    x = x0
    f_t, g = fun(x0)
    f = float(f_t)
    S: List[torch.Tensor] = []
    Y: List[torch.Tensor] = []
    rho: List[float] = []
    gamma, k, nfev = 1.0, 0, 1
    keep: Dict[int, torch.Tensor] = {0: x0.clone()} if 0 in snapshots else {}
    done = float(g.abs().max()) <= pgtol
    while k < maxiter and not done:
        q, alphas = g, [0.0] * len(rho)
        for i in reversed(range(len(rho))):
            alphas[i] = rho[i] * float(torch.dot(S[i], q))
            q = q - alphas[i] * Y[i]
        r = gamma * q
        for i in range(len(rho)):
            r = r + S[i] * (alphas[i] - rho[i] * float(torch.dot(Y[i], r)))
        d = -r
        gd = float(torch.dot(g, d))
        if gd >= 0:
            d, gd = -g, -float(torch.dot(g, g))
        alpha, f_new, g_new, ls_nfev, failed = _line_search(
            fun, x, f, g, d, gd, maxls)
        x_new = x + alpha * d
        s, y = x_new - x, g_new - g
        sy, yy = float(torch.dot(s, y)), float(torch.dot(y, y))
        if sy > 1e-10 * yy:
            S.append(s)
            Y.append(y)
            rho.append(1.0 / (1.0 if sy == 0 else sy))
            if len(rho) > m:
                del S[0], Y[0], rho[0]
            gamma = sy / max(yy, 1e-30)
        rel = max(abs(f), abs(f_new), 1.0)
        done = ((f - f_new) <= ftol * rel
                or float(g_new.abs().max()) <= pgtol or failed)
        x, f, g = x_new, f_new, g_new
        k += 1
        nfev += ls_nfev
        if k in snapshots:
            keep[k] = x.clone()
    for j in snapshots:          # a solver that stopped stays where it is
        if j > k:
            keep[j] = x.clone()
    return dict(x=x, f=f, iterations=k, funcalls=nfev, snapshots=keep)
