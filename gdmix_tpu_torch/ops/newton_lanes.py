"""Whole damped-Newton solves for batched tiny logistic models (float32).

Port of gdmix_tpu/ops/pallas/newton_lanes.py. On a card both of its kernels
become whole solves, one launch per bucket (csrc/newton_lanes.cu):

1. `newton_full` (K1, `_newton_full_kernel`): one warp per entity, X and
   the solve's state in shared memory for the whole solve.
2. `newton_block` (K2, `_fgd_kernel`, which computed one iteration per
   launch and left the line search to the host): one block of four warps
   per entity, the whole loop with its line search in the kernel; X in
   shared memory while it fits the block's opt-in, read again from device
   memory in chunks on each pass past it.

`lanes_form(n, dim)` picks the form from the shape alone, before any
launch: the warp form while four entities' shared memory leaves
WARP_FORM_MIN_WARPS warps resident per SM, the block form past that, the
streamed block form past the opt-in. Both take dim ≤ MAX_DIM (past it the
batch-major Newton of ops/newton.py runs).

Beside the kernels is their plain PyTorch version (batch-major, any float
type), `newton_full_plain`: the loop `_newton_loop` around one iteration,
`newton_fgd_plain`. A wrapper takes it only for a CPU tensor; for a CUDA
tensor it launches its kernel or raises. The loop reads `done.all()` on the
host once per iteration and once per line-search trial and counts those
reads in `newton_lr_batch_lanes.host_syncs`; the kernels read nothing back
inside a solve. Both share the iteration semantics of the JAX lanes path
and of ops/newton.py: Armijo backtracking (c1 = 1e-4, at most 20 halvings),
converged lanes frozen, a lane whose line search fails is done.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops.linsolve import gj_solve_plain

MAX_DIM = 64       # the lanes path's ceiling (dim above → batch-major Newton)
_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 20
_DAMP_EPS = 1e-6

# The card's shared memory (sm_90): what a block may opt into, one SM's
# whole, and what the runtime keeps of it for each resident block
SMEM_OPTIN_BYTES = 232_448
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024
# the warp form's four entities a block must leave this many warps resident
# on an SM (three blocks): its solve is a chain of dependent shared-memory
# steps, whose latency only other resident warps hide. On one H100, dim 25,
# the warp form took 4-5% less time than the block form at 12 warps an SM
# (n = 128) and 1.8 times as long at 4 (n = 256): chip_smoke.py
# _gate_crossover
WARP_FORM_MIN_WARPS = 12
_THREADS = 128                 # every block of both forms: four warps
_BLOCK_WARPS = 4               # warps of one entity in newton_block
_STREAM_ROWS = 256             # rows of X per chunk in the streamed form
FORMS = ("warp", "block", "stream")
WARP_FORM_BLOCK_BYTES = (SM_SMEM_BYTES // (WARP_FORM_MIN_WARPS
                                           * 32 // _THREADS)
                         - BLOCK_RESERVED_BYTES)


def _align4(x: int) -> int:
    return (x + 3) & ~3


def _group_floats(n: int, dim: int, warps: int, stream: bool) -> int:
    """Floats of shared memory one entity's warp (warps = 1) or block
    (warps = 4) uses: the arithmetic of csrc/newton_lanes.cu make_layout."""
    D4 = (dim + 4) // 4          # at least one padding row (row dim)
    d4, ldx = 4 * D4, 4 * (D4 | 1)
    tiles = (D4 * (D4 + 1) // 2 + 31) // 32
    rows = min(n, _STREAM_ROWS) if stream else n
    floats = rows * ldx + 2 * _align4(rows) + 6 * d4
    if not stream:
        floats += 5 * _align4(n)
    if warps > 1:
        floats += 4 + warps * d4 + (warps - 1) * tiles * 16 * 32
    return floats


def form_smem_bytes(form: str, n: int, dim: int) -> int:
    """Dynamic shared memory of one block of `form` at (n, dim)."""
    if form == "warp":
        return 4 * (_THREADS // 32) * _group_floats(n, dim, 1, False)
    return 4 * _group_floats(n, dim, _BLOCK_WARPS, form == "stream")


def lanes_form(n: int, dim: int) -> str:
    """The form a bucket of entities with n rows and dim coefficients takes
    on a card: "warp" (newton_full) while its block leaves
    WARP_FORM_MIN_WARPS warps resident per SM, "block" (newton_block, X in
    shared memory) while one entity fits the opt-in, else "stream". A pure
    function of the shape; dim past MAX_DIM is refused."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"lanes path: dim {dim} not in [1, {MAX_DIM}]")
    if n < 1:
        raise ValueError(f"lanes path: n {n} < 1")
    if form_smem_bytes("warp", n, dim) <= WARP_FORM_BLOCK_BYTES:
        return "warp"
    if form_smem_bytes("block", n, dim) <= SMEM_OPTIN_BYTES:
        return "block"
    return "stream"


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
    """One Newton iteration's (f [B], g_scaled [B, dim], δ [B, dim]) at θ,
    any float type: the iteration of the plain version.
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


def _host_done(done: torch.Tensor) -> bool:
    newton_lr_batch_lanes.host_syncs += 1
    return bool(done.all())


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
    while k < maxiter and not _host_done(done):
        gdot = torch.sum(g * delta, dim=1)
        step = torch.ones_like(f)
        accepted = torch.zeros_like(done)
        f_new = f
        i = 0
        while i < _MAX_BACKTRACKS and not _host_done(accepted | done):
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
    """The plain version of both kernels, any float type:
    (θ [B, dim], converged [B] bool, iterations [B] int32)."""
    fgd = lambda th: newton_fgd_plain(X, y, w, off, cnt, th, lam=lam,
                                      unreg_bias=unreg_bias)
    return _newton_loop(fgd, theta0, X, y, w, off, cnt, lam=lam,
                        unreg_bias=unreg_bias, maxiter=maxiter, ftol=ftol,
                        pgtol=pgtol)


_lib_checked = False


def _lib() -> ctypes.CDLL:
    """The kernels' library, typed; at first load its layout is held to
    `_group_floats` (the gate's budget arithmetic)."""
    global _lib_checked
    lib = _cuda.load("newton_lanes")
    if not _lib_checked:
        ptrs = [ctypes.c_void_p] * 9
        scal = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
        lib.gdx_newton_full.argtypes = ptrs + scal
        lib.gdx_newton_block.argtypes = (ptrs + [ctypes.c_void_p] * 2
                                         + [ctypes.c_int] + scal)
        for fn in (lib.gdx_newton_full, lib.gdx_newton_block,
                   lib.gdx_newton_group_floats):
            fn.restype = ctypes.c_int
        lib.gdx_newton_group_floats.argtypes = [ctypes.c_int] * 3
        for form, (warps, stream) in enumerate(((1, False),
                                                (_BLOCK_WARPS, False),
                                                (_BLOCK_WARPS, True))):
            for n in (1, 7, 8, 64, 300, 2048):
                for dim in (1, 5, 25, 33, 64):
                    got = lib.gdx_newton_group_floats(form, n, dim)
                    want = _group_floats(n, dim, warps, stream)
                    if got != want:
                        raise RuntimeError(
                            f"newton_lanes layout: form {form} n {n} dim "
                            f"{dim}: library {got}, wrapper {want}")
        _lib_checked = True
    return lib


def _check_inputs(what, X, y, w, off, cnt, th):
    """The kernels index every array from X's [B, n, dim]: anything else
    would be read out of bounds, so it is refused here."""
    _cuda.require_cuda(what, X, y, w, off, cnt, th)
    B, n, dim = X.shape
    form = lanes_form(n, dim)
    want = ((B, n), (B, n), (B, n), (B,), (B, dim))
    got = tuple(tuple(t.shape) for t in (y, w, off, cnt, th))
    if got != want:
        raise ValueError(f"{what}: shapes {got} for X {(B, n, dim)}; "
                         f"expected {want}")
    return form


def _outputs(theta0, B):
    return (torch.empty_like(theta0),
            torch.empty(B, dtype=torch.bool, device=theta0.device),
            torch.empty(B, dtype=torch.int32, device=theta0.device))


def newton_full(theta0, X, y, w, off, cnt, *, lam: float, unreg_bias: bool,
                maxiter: int, ftol: float, pgtol: float):
    """The whole damped-Newton solve of every entity, one warp each:
    θ0 [B, dim], X [B, n, dim], y/w/off [B, n], cnt [B] →
    (θ, converged, iterations). CUDA: float32 and lanes_form(n, dim) ==
    "warp"; other shapes raise (newton_block takes them)."""
    if X.device.type == "cpu":
        return newton_full_plain(theta0, X, y, w, off, cnt, lam=lam,
                                 unreg_bias=unreg_bias, maxiter=maxiter,
                                 ftol=ftol, pgtol=pgtol)
    form = _check_inputs("newton_full", X, y, w, off, cnt, theta0)
    B, n, dim = X.shape
    if form != "warp":
        raise ValueError(f"newton_full: n {n}, dim {dim} take the {form} "
                         f"form; use newton_block")
    th, conv, iters = _outputs(theta0, B)
    if B == 0:
        return th, conv, iters
    lib = _lib()
    with _cuda.on_card(X) as stream:
        err = lib.gdx_newton_full(
            *(_cuda.ptr(t) for t in (X, y, w, off, cnt, theta0, th, conv,
                                     iters)),
            B, n, dim, float(lam), int(unreg_bias), int(maxiter),
            float(ftol), float(pgtol), stream)
    _cuda.check(lib, err, "newton_full")
    newton_full.launches += 1
    return th, conv, iters


newton_full.launches = 0


def newton_block(theta0, X, y, w, off, cnt, *, lam: float, unreg_bias: bool,
                 maxiter: int, ftol: float, pgtol: float):
    """The whole damped-Newton solve of every entity, one block of four
    warps each; arguments and result as newton_full. CUDA: float32,
    dim ≤ MAX_DIM, any n: X in shared memory while one entity fits the
    opt-in, streamed from device memory past it."""
    if X.device.type == "cpu":
        return newton_full_plain(theta0, X, y, w, off, cnt, lam=lam,
                                 unreg_bias=unreg_bias, maxiter=maxiter,
                                 ftol=ftol, pgtol=pgtol)
    form = _check_inputs("newton_block", X, y, w, off, cnt, theta0)
    B, n, dim = X.shape
    th, conv, iters = _outputs(theta0, B)
    if B == 0:
        return th, conv, iters
    streamed = form == "stream"
    zu = (torch.empty(2, B, n, dtype=X.dtype, device=X.device) if streamed
          else None)
    lib = _lib()
    with _cuda.on_card(X) as stream:
        err = lib.gdx_newton_block(
            *(_cuda.ptr(t) for t in (X, y, w, off, cnt, theta0, th, conv,
                                     iters)),
            None if zu is None else _cuda.ptr(zu[0]),
            None if zu is None else _cuda.ptr(zu[1]), int(streamed),
            B, n, dim, float(lam), int(unreg_bias), int(maxiter),
            float(ftol), float(pgtol), stream)
    _cuda.check(lib, err, "newton_block")
    newton_block.launches += 1
    return th, conv, iters


newton_block.launches = 0


def newton_lr_batch_lanes(theta0, X, labels, weights, offsets, counts, *,
                          l2_reg_weight: float, unreg_bias: bool,
                          maxiter: int, ftol: float, pgtol: float):
    """The JAX lanes path's signature and result (ops/newton.NewtonResult)
    on batch-major inputs, computed in float32 (θ is returned in θ0's type):
    one launch of the form `lanes_form` picks. `unreg_bias`: the l2 mask is
    ones with a 0 at coordinate 0 (True) or all ones (False)."""
    from gdmix_tpu_torch.ops.newton import NewtonResult

    f32 = torch.float32
    B, n, dim = X.shape
    X32 = X.to(f32).contiguous()
    y, w, off = (t.to(f32).contiguous() for t in (labels, weights, offsets))
    cnt = torch.clamp_min(counts.to(f32), 1.0).contiguous()
    th0 = theta0.to(f32).contiguous()
    solve = newton_full if lanes_form(n, dim) == "warp" else newton_block
    th, conv, iters = solve(th0, X32, y, w, off, cnt,
                            lam=float(l2_reg_weight), unreg_bias=unreg_bias,
                            maxiter=maxiter, ftol=ftol, pgtol=pgtol)
    return NewtonResult(theta=th.to(theta0.dtype), converged=conv,
                        num_iterations=iters)


newton_lr_batch_lanes.host_syncs = 0
