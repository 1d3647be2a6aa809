"""Fused damped-Newton solves for batched tiny logistic models (float32).

Port of gdmix_tpu/ops/pallas/newton_lanes.py. Two forms, gated as there by
whether an entity's X is small (n · d8 ≤ 1024, d8 = dim rounded up to 8):

1. `newton_full` — the whole solve in one launch (csrc/newton_lanes.cu,
   `newton_full_kernel`): one warp per entity, X resident in shared memory
   across every iteration, each entity stopping on its own.
2. `newton_fgd` — one Newton iteration (f, scaled gradient, step) per launch
   with X streamed through shared memory; the outer loop and the Armijo
   line search stay in PyTorch (`_newton_loop`), as they stay in XLA in the
   JAX package. That loop reads `done.all()` on the host once per iteration
   and once per line-search trial.

Beside each kernel is its plain PyTorch version (batch-major, any float
type): `newton_full_plain` and `newton_fgd_plain`. A wrapper takes the plain
version only for a CPU tensor; for a CUDA tensor it launches its kernel or
raises. Both versions share the iteration semantics of the JAX lanes path
and of ops/newton.py: Armijo backtracking (c1 = 1e-4, at most 20 halvings),
converged lanes frozen, a lane whose line search fails is done.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.device import pad_to_multiple
from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops.linsolve import gj_solve_plain

MAX_DIM = 64       # the lanes path's ceiling (dim above → batch-major Newton)
FULL_MAX_ELEMS = 1024   # n · d8 gate between the full and per-iteration forms
_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 20
_DAMP_EPS = 1e-6


def _lam_vec(dim: int, lam: float, unreg_bias: bool, like: torch.Tensor):
    v = torch.full((dim,), float(lam), dtype=like.dtype, device=like.device)
    if unreg_bias:
        v[0] = 0.0
    return v


def _f_value(X, y, w, off, inv_n, lam_vec, th):
    """Objective alone (line-search trials): z recomputed from X."""
    z = torch.einsum("bnd,bd->bn", X, th) + off
    bce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    reg = 0.5 * torch.sum(lam_vec * th * th, dim=1)
    return (torch.sum(w * bce, dim=1) + reg) * inv_n


def newton_fgd_plain(X, y, w, off, cnt, th, *, lam: float, unreg_bias: bool):
    """One Newton iteration's (f [B], g_scaled [B, dim], δ [B, dim]) at θ:
    the plain version of the `newton_fgd` kernel, any float type.
    A = (XᵀDX + diag λ)/n + diag(ε·(1 + |diag|)), δ = A⁻¹·g_scaled, as
    _damped_gj_solve (gdmix_tpu/ops/pallas/newton_lanes.py:101-134)."""
    dim = X.shape[2]
    lam_vec = _lam_vec(dim, lam, unreg_bias, X)
    inv_n = 1.0 / torch.clamp_min(cnt, 1.0)                     # [B]
    z = torch.einsum("bnd,bd->bn", X, th) + off
    p = torch.sigmoid(z)
    bce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    r = w * (p - y)
    dv = w * p * (1 - p)
    reg = 0.5 * torch.sum(lam_vec * th * th, dim=1)
    f = (torch.sum(w * bce, dim=1) + reg) * inv_n
    g_scaled = (torch.einsum("bnd,bn->bd", X, r) + lam_vec * th) \
        * inv_n[:, None]
    H = torch.einsum("bnk,bnl->bkl", X, X * dv[:, :, None])
    A = (H + torch.diag(lam_vec)) * inv_n[:, None, None]
    diag = torch.diagonal(A, dim1=1, dim2=2)
    A = A + torch.diag_embed(_DAMP_EPS * (1.0 + diag.abs()))
    return f, g_scaled, gj_solve_plain(A, g_scaled)


def _newton_loop(fgd, theta0, X, y, w, off, cnt, *, lam, unreg_bias,
                 maxiter, ftol, pgtol):
    """Damped Newton with the line search in plain PyTorch around `fgd`
    (θ → f, g_scaled, δ). Returns (θ, converged, iterations)."""
    B, _, dim = X.shape
    lam_vec = _lam_vec(dim, lam, unreg_bias, X)
    inv_n = 1.0 / torch.clamp_min(cnt, 1.0)
    th = theta0
    f, g, delta = fgd(th)
    done = g.abs().amax(dim=1) <= pgtol
    iters = torch.zeros(B, dtype=torch.int32, device=X.device)
    k = 0
    while k < maxiter and not bool(done.all()):
        gdot = torch.sum(g * delta, dim=1)
        step = torch.ones_like(f)
        accepted = torch.zeros_like(done)
        f_new = f
        i = 0
        while i < _MAX_BACKTRACKS and not bool((accepted | done).all()):
            f_trial = _f_value(X, y, w, off, inv_n, lam_vec,
                               th - step[:, None] * delta)
            ok = f_trial <= f - _ARMIJO_C1 * step * gdot
            newly = ok & ~accepted
            f_new = torch.where(newly, f_trial, f_new)
            step = torch.where(accepted | newly, step, step * 0.5)
            accepted = accepted | newly
            i += 1
        move = accepted & ~done
        th = torch.where(move[:, None], th - step[:, None] * delta, th)
        f_next = torch.where(move, f_new, f)
        _, g, delta = fgd(th)
        gmax = g.abs().amax(dim=1)
        rel = torch.clamp_min(torch.maximum(f.abs(), f_next.abs()), 1.0)
        conv = (gmax <= pgtol) | (f - f_next <= ftol * rel)
        iters = torch.where(done, iters, iters + 1)
        done = done | conv | ~accepted
        f = f_next
        k += 1
    return th, done, iters


def newton_full_plain(theta0, X, y, w, off, cnt, *, lam: float,
                      unreg_bias: bool, maxiter: int, ftol: float,
                      pgtol: float):
    """The plain version of the `newton_full` kernel, any float type:
    (θ [B, dim], converged [B] bool, iterations [B] int32)."""
    fgd = lambda th: newton_fgd_plain(X, y, w, off, cnt, th, lam=lam,
                                      unreg_bias=unreg_bias)
    return _newton_loop(fgd, theta0, X, y, w, off, cnt, lam=lam,
                        unreg_bias=unreg_bias, maxiter=maxiter, ftol=ftol,
                        pgtol=pgtol)


def _check_inputs(what, X, y, w, off, cnt, th):
    """The kernels index every array from X's [B, n, dim]: anything else
    would be read out of bounds, so it is refused here."""
    _cuda.require_cuda(what, X, y, w, off, cnt, th)
    B, n, dim = X.shape
    if dim > MAX_DIM:
        raise ValueError(f"{what}: dim {dim} > {MAX_DIM}")
    want = ((B, n), (B, n), (B, n), (B,), (B, dim))
    got = tuple(tuple(t.shape) for t in (y, w, off, cnt, th))
    if got != want:
        raise ValueError(f"{what}: shapes {got} for X {(B, n, dim)}; "
                         f"expected {want}")


def newton_full(theta0, X, y, w, off, cnt, *, lam: float, unreg_bias: bool,
                maxiter: int, ftol: float, pgtol: float):
    """The whole damped-Newton solve of every entity: θ0 [B, dim],
    X [B, n, dim], y/w/off [B, n], cnt [B] → (θ, converged, iterations).
    CUDA: float32, dim ≤ MAX_DIM and n · d8 ≤ FULL_MAX_ELEMS."""
    if X.device.type == "cpu":
        return newton_full_plain(theta0, X, y, w, off, cnt, lam=lam,
                                 unreg_bias=unreg_bias, maxiter=maxiter,
                                 ftol=ftol, pgtol=pgtol)
    _check_inputs("newton_full", X, y, w, off, cnt, theta0)
    B, n, dim = X.shape
    if n * pad_to_multiple(dim, 8) > FULL_MAX_ELEMS:
        raise ValueError(f"newton_full: n·d8 = {n}·{pad_to_multiple(dim, 8)}"
                         f" > {FULL_MAX_ELEMS}; use newton_fgd")
    th = torch.empty_like(theta0)
    conv = torch.empty(B, dtype=torch.bool, device=X.device)
    iters = torch.empty(B, dtype=torch.int32, device=X.device)
    if B == 0:
        return th, conv, iters
    lib = _cuda.load("newton_lanes")
    fn = lib.gdx_newton_full
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(X.device):
        err = fn(*(_cuda.ptr(t) for t in (X, y, w, off, cnt, theta0, th,
                                          conv, iters)),
                 B, n, dim, float(lam), int(unreg_bias), int(maxiter),
                 float(ftol), float(pgtol), _cuda.stream_of(X))
    _cuda.check(lib, err, "newton_full")
    newton_full.launches += 1
    return th, conv, iters


newton_full.launches = 0


def newton_fgd(X, y, w, off, cnt, th, *, lam: float, unreg_bias: bool):
    """One Newton iteration at θ: (f [B], g_scaled [B, dim], δ [B, dim]).
    CUDA: float32, dim ≤ MAX_DIM, any n."""
    if X.device.type == "cpu":
        return newton_fgd_plain(X, y, w, off, cnt, th, lam=lam,
                                unreg_bias=unreg_bias)
    _check_inputs("newton_fgd", X, y, w, off, cnt, th)
    B, n, dim = X.shape
    f = torch.empty(B, dtype=X.dtype, device=X.device)
    g = torch.empty_like(th)
    delta = torch.empty_like(th)
    if B == 0:
        return f, g, delta
    lib = _cuda.load("newton_lanes")
    fn = lib.gdx_newton_fgd
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(X.device):
        err = fn(*(_cuda.ptr(t) for t in (X, y, w, off, cnt, th, f, g,
                                          delta)),
                 B, n, dim, float(lam), int(unreg_bias), _cuda.stream_of(X))
    _cuda.check(lib, err, "newton_fgd")
    newton_fgd.launches += 1
    return f, g, delta


newton_fgd.launches = 0


def newton_lr_batch_lanes(theta0, X, labels, weights, offsets, counts, *,
                          l2_reg_weight: float, unreg_bias: bool,
                          maxiter: int, ftol: float, pgtol: float):
    """The JAX lanes path's signature and result (ops/newton.NewtonResult)
    on batch-major inputs, computed in float32 (θ is returned in θ0's type).
    `unreg_bias`: the l2 mask is ones with a 0 at coordinate 0 (True) or
    all ones (False)."""
    from gdmix_tpu_torch.ops.newton import NewtonResult

    f32 = torch.float32
    B, n, dim = X.shape
    lam = float(l2_reg_weight)
    X32 = X.to(f32).contiguous()
    y, w, off = (t.to(f32).contiguous() for t in (labels, weights, offsets))
    cnt = torch.clamp_min(counts.to(f32), 1.0).contiguous()
    th0 = theta0.to(f32).contiguous()
    if n * pad_to_multiple(dim, 8) <= FULL_MAX_ELEMS:
        th, conv, iters = newton_full(th0, X32, y, w, off, cnt, lam=lam,
                                      unreg_bias=unreg_bias, maxiter=maxiter,
                                      ftol=ftol, pgtol=pgtol)
    else:
        fgd = lambda t: newton_fgd(X32, y, w, off, cnt, t.contiguous(),
                                   lam=lam, unreg_bias=unreg_bias)
        th, conv, iters = _newton_loop(fgd, th0, X32, y, w, off, cnt,
                                       lam=lam, unreg_bias=unreg_bias,
                                       maxiter=maxiter, ftol=ftol,
                                       pgtol=pgtol)
    return NewtonResult(theta=th.to(theta0.dtype), converged=conv,
                        num_iterations=iters)
