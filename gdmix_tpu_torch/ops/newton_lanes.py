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

Both also solve over a lane list that only the card knows: `lanes`, the
entities in the order to solve them, and `n_lanes`, how many to solve.
That is phase 2 of two-phase Newton (gdmix_tpu/models/random_effect_lr.py:
235-294 _newton_two_phase_solver), `newton_two_phase_lanes`.
Phase 1 solves every shard of a tier for `phase1_iters` iterations; the
cut (`two_phase_shard_lanes`) orders the whole tier's lanes stragglers
first (`two_phase_order`), takes the smallest ladder prefix that holds the
tier's stragglers (`prefix_size_on_card`), as the JAX solver does over its
sharded array, and hands each shard the lanes of that prefix it owns and
their count; phase 2 solves each shard's list from phase 1's θ. Two
launches a shard, no host read. A bucket of the host plane is a tier of
one shard.

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
import functools

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


def prefix_size(n_unconverged: int, B: int) -> int:
    """Two-phase Newton's phase-2 prefix for n_unconverged stragglers in a
    bucket of B: the smallest of the ladder 64, 128, … (< B) and B that
    holds them (the JAX solver's searchsorted over its `sizes`). 64, or B
    below 64, when none is left. The host's form; prefix_size_on_card
    computes it where the count stays on its device."""
    p = 64
    while p < n_unconverged and p < B:
        p *= 2
    return min(p, B)


@functools.lru_cache(maxsize=64)
def _ladder(B: int, device: torch.device) -> torch.Tensor:
    """The JAX solver's `sizes` for a bucket of B on `device`, int32: 64,
    128, … (< B), then B. Made there by a kernel (no upload) and kept: a
    fit's tiers take a few sizes, and each two-phase dispatch would
    otherwise launch four small kernels more to make them."""
    steps, p = 1, 64
    while p < B:
        steps, p = steps + 1, p * 2
    return torch.clamp_max(64 * 2 ** torch.arange(
        steps, dtype=torch.int32, device=device), B)


def prefix_size_on_card(n_unconverged: torch.Tensor, B: int):
    """prefix_size of a count [1] int32 that stays on its device, as [1]
    int32 there: the JAX solver's searchsorted over its ladder. No host
    read and no upload."""
    sizes = _ladder(B, n_unconverged.device)
    return sizes[torch.searchsorted(sizes, n_unconverged)]


def two_phase_order(converged: torch.Tensor):
    """(order [..., B] int32, n_unconverged [..., 1] int32) on converged's
    device, along its last axis: the entities with the stragglers first,
    each part in index order (`torch.argsort(converged, stable=True)`, as
    the JAX solver orders them), and the stragglers' count. A stable
    partition by two prefix sums and a scatter: nothing is read back to
    the host."""
    B = converged.shape[-1]
    un = ~converged
    rank_un = torch.cumsum(un, -1, dtype=torch.int32)
    n_un = (rank_un[..., -1:] if B else
            torch.zeros(converged.shape[:-1] + (1,), dtype=torch.int32,
                        device=converged.device))
    index = torch.arange(B, dtype=torch.int32, device=converged.device)
    # a converged entity goes after every straggler, at its rank among the
    # converged: its index less the stragglers before it
    pos = torch.where(un, rank_un - 1, n_un + index - rank_un)
    order = torch.empty_like(pos).scatter_(
        -1, pos.long(), index.expand(pos.shape).contiguous())
    return order, n_un


def two_phase_shard_lanes(converged, b_cap: int):
    """The phase-2 cut of one tier of the entity-sharded plane, on the
    card. `converged`: each shard's phase-1 flags, [b_cap] bool on its own
    device; the tier's slot s·b_cap + i is shard s's lane i
    (parallel/entity_sharding.py shard_rows). The whole tier is cut as the
    JAX solver cuts its sharded array: its lanes stragglers first, the
    smallest ladder prefix over its P·b_cap lanes that holds all its
    stragglers. Returns (order [P·b_cap] int32, n_unconverged [1] int32):
    the tier's, on the first shard's device; and for each shard
    (lanes [b_cap] int32, n_lanes [1] int32) on its own device: its lanes
    in the tier's order as its own slots, the first n_lanes of them inside
    the prefix. No host read.

    The prefix holds every straggler, then the tier's first converged
    lanes in slot order, which is shard-major; and a shard's lanes in the
    tier's order are its own stragglers first (two_phase_order of its
    flags). So a shard's count is its stragglers plus the converged lanes
    the prefix takes from it."""
    P = len(converged)
    flat = (converged[0] if P == 1 else
            torch.cat([c.to(converged[0].device) for c in converged]))
    order, n_un = two_phase_order(flat)
    prefix = prefix_size_on_card(n_un, P * b_cap)
    if P == 1:
        # one shard: its list is the tier's order, its count the prefix
        return order, n_un, [(order, prefix)]
    lanes, un = two_phase_order(flat.view(P, b_cap))      # [P, b_cap], [P, 1]
    conv = b_cap - un
    before = torch.cumsum(conv, 0, dtype=torch.int32) - conv
    taken = torch.minimum(torch.clamp_min(prefix - n_un - before, 0), conv)
    n_lanes = un + taken
    return order, n_un, [(lanes[s].to(c.device), n_lanes[s].to(c.device))
                         for s, c in enumerate(converged)]


def _lanes_plain(theta0, X, y, w, off, cnt, lanes, n_lanes, **kw):
    """newton_full_plain over a lane list: lanes[:n_lanes] solved, the
    others left at θ0 (one host read of the count, the plain version's)."""
    newton_lr_batch_lanes.host_syncs += 1
    pre = lanes[:int(n_lanes.reshape(-1)[0])].long()
    th, conv, iters = _lane_outputs(theta0)
    th[pre], conv[pre], iters[pre] = newton_full_plain(
        theta0[pre], X[pre], y[pre], w[pre], off[pre], cnt[pre], **kw)
    return th, conv, iters


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
                      pgtol: float, lanes=None, n_lanes=None):
    """The plain version of both kernels, any float type:
    (θ [B, dim], converged [B] bool, iterations [B] int32). With a lane
    list (`lanes` [B], `n_lanes` [1], int32) only the entities
    lanes[:n_lanes] are solved; every other entity keeps θ0, counts as
    converged (phase 1 converged all but the prefix's) and took 0
    iterations."""
    if lanes is not None:
        return _lanes_plain(theta0, X, y, w, off, cnt, lanes, n_lanes,
                            lam=lam, unreg_bias=unreg_bias, maxiter=maxiter,
                            ftol=ftol, pgtol=pgtol)
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
        # + LANES, NLANES; newton_block also ZS, US before them and
        # `streamed` after
        lib.gdx_newton_full.argtypes = ptrs + [ctypes.c_void_p] * 2 + scal
        lib.gdx_newton_block.argtypes = (ptrs + [ctypes.c_void_p] * 4
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


def _check_inputs(what, X, y, w, off, cnt, th, lanes=None, n_lanes=None):
    """The kernels index every array from X's [B, n, dim], and a lane
    list's entries as entities: anything else would be read out of bounds,
    so it is refused here. A lane list is both of `lanes` [B] and
    `n_lanes` [1], int32 on X's card, or neither."""
    _cuda.require_cuda(what, X, y, w, off, cnt, th)
    B, n, dim = X.shape
    form = lanes_form(n, dim)
    want = ((B, n), (B, n), (B, n), (B,), (B, dim))
    got = tuple(tuple(t.shape) for t in (y, w, off, cnt, th))
    if got != want:
        raise ValueError(f"{what}: shapes {got} for X {(B, n, dim)}; "
                         f"expected {want}")
    if (lanes is None) != (n_lanes is None):
        raise ValueError(f"{what}: lanes and n_lanes go together")
    if lanes is not None:
        _cuda.require_cuda(what, lanes, n_lanes, dtypes=(torch.int32,))
        if lanes.device != X.device or n_lanes.device != X.device:
            raise ValueError(f"{what}: the lane list is on {lanes.device}/"
                             f"{n_lanes.device}, X on {X.device}")
        if tuple(lanes.shape) != (B,) or tuple(n_lanes.shape) != (1,):
            raise ValueError(f"{what}: lanes {tuple(lanes.shape)}, "
                             f"n_lanes {tuple(n_lanes.shape)}; expected "
                             f"({B},) and one count (1,)")
    return form


def _outputs(theta0, B):
    return (torch.empty_like(theta0),
            torch.empty(B, dtype=torch.bool, device=theta0.device),
            torch.empty(B, dtype=torch.int32, device=theta0.device))


def _lane_outputs(theta0):
    """The outputs of a solve over a lane list, as the entities it does
    not solve keep them: θ0, converged, 0 iterations."""
    B = theta0.shape[0]
    return (theta0.clone(),
            torch.ones(B, dtype=torch.bool, device=theta0.device),
            torch.zeros(B, dtype=torch.int32, device=theta0.device))


def _lane_ptrs(lanes, n_lanes):
    return ((None, None) if lanes is None
            else (_cuda.ptr(lanes), _cuda.ptr(n_lanes)))


def newton_full(theta0, X, y, w, off, cnt, *, lam: float, unreg_bias: bool,
                maxiter: int, ftol: float, pgtol: float, lanes=None,
                n_lanes=None):
    """The whole damped-Newton solve of every entity, one warp each:
    θ0 [B, dim], X [B, n, dim], y/w/off [B, n], cnt [B] →
    (θ, converged, iterations); over a lane list (`lanes`, `n_lanes`) as
    newton_full_plain. CUDA: float32 and
    lanes_form(n, dim) == "warp"; other shapes raise (newton_block takes
    them)."""
    if X.device.type == "cpu":
        return newton_full_plain(theta0, X, y, w, off, cnt, lam=lam,
                                 unreg_bias=unreg_bias, maxiter=maxiter,
                                 ftol=ftol, pgtol=pgtol, lanes=lanes,
                                 n_lanes=n_lanes)
    form = _check_inputs("newton_full", X, y, w, off, cnt, theta0, lanes,
                         n_lanes)
    B, n, dim = X.shape
    if form != "warp":
        raise ValueError(f"newton_full: n {n}, dim {dim} take the {form} "
                         f"form; use newton_block")
    th, conv, iters = (_outputs(theta0, B) if lanes is None
                       else _lane_outputs(theta0))
    if B == 0:
        return th, conv, iters
    lib = _lib()
    with _cuda.on_card(X) as stream:
        err = lib.gdx_newton_full(
            *(_cuda.ptr(t) for t in (X, y, w, off, cnt, theta0, th, conv,
                                     iters)),
            *_lane_ptrs(lanes, n_lanes), B, n, dim, float(lam),
            int(unreg_bias), int(maxiter), float(ftol), float(pgtol), stream)
    _cuda.check(lib, err, "newton_full")
    newton_full.launches += 1
    return th, conv, iters


newton_full.launches = 0


def newton_block(theta0, X, y, w, off, cnt, *, lam: float, unreg_bias: bool,
                 maxiter: int, ftol: float, pgtol: float, lanes=None,
                 n_lanes=None):
    """The whole damped-Newton solve of every entity, one block of four
    warps each; arguments and result as newton_full. CUDA: float32,
    dim ≤ MAX_DIM, any n: X in shared memory while one entity fits the
    opt-in, streamed from device memory past it."""
    if X.device.type == "cpu":
        return newton_full_plain(theta0, X, y, w, off, cnt, lam=lam,
                                 unreg_bias=unreg_bias, maxiter=maxiter,
                                 ftol=ftol, pgtol=pgtol, lanes=lanes,
                                 n_lanes=n_lanes)
    form = _check_inputs("newton_block", X, y, w, off, cnt, theta0, lanes,
                         n_lanes)
    B, n, dim = X.shape
    th, conv, iters = (_outputs(theta0, B) if lanes is None
                       else _lane_outputs(theta0))
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
            None if zu is None else _cuda.ptr(zu[1]),
            *_lane_ptrs(lanes, n_lanes), int(streamed),
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


def newton_two_phase_lanes(shards, *, l2_reg_weight: float,
                           unreg_bias: bool, phase1_iters: int, maxiter: int,
                           ftol: float, pgtol: float):
    """Two-phase Newton (the JAX package's _newton_two_phase_solver) on
    the lanes path, float32, θ in θ0's type, over one tier's shards: each
    a (θ0, X, labels, weights, offsets, counts) of the same shape, on its
    own device (a bucket of the host plane is a tier of one shard). Phase
    1 solves every shard for `phase1_iters` iterations;
    two_phase_shard_lanes cuts the tier on the card; phase 2 solves each
    shard's lanes of the prefix from phase 1's θ for `maxiter`. Two
    launches a shard of the form `lanes_form` picks; the lane lists and
    their counts never leave the card. Returns one
    ops/newton.TwoPhaseResult a shard, with the tier's order and straggler
    count: a lane solved again took phase 1's iterations plus phase 2's."""
    from gdmix_tpu_torch.ops.newton import TwoPhaseResult

    f32 = torch.float32
    kw = dict(lam=float(l2_reg_weight), unreg_bias=unreg_bias, ftol=ftol,
              pgtol=pgtol)
    staged, first = [], []
    for theta0, X, labels, weights, offsets, counts in shards:
        _, n, dim = X.shape
        solve = newton_full if lanes_form(n, dim) == "warp" else newton_block
        args = (X.to(f32).contiguous(),
                *(t.to(f32).contiguous() for t in (labels, weights, offsets)),
                torch.clamp_min(counts.to(f32), 1.0).contiguous())
        staged.append((solve, args))
        first.append(solve(theta0.to(f32).contiguous(), *args,
                           maxiter=phase1_iters, **kw))
    order, n_un, lists = two_phase_shard_lanes(
        [conv for _, conv, _ in first], shards[0][1].shape[0])
    out = []
    for shard, (solve, args), (th1, _, iters1), (lanes, n_lanes) in zip(
            shards, staged, first, lists):
        th, conv, iters2 = solve(th1, *args, maxiter=maxiter, lanes=lanes,
                                 n_lanes=n_lanes, **kw)
        out.append(TwoPhaseResult(theta=th.to(shard[0].dtype), converged=conv,
                                  num_iterations=iters1 + iters2,
                                  order=order, n_unconverged=n_un))
    return out
