"""Batched solves of small damped SPD systems: the Newton hot ops.

Port of gdmix_tpu/ops/pallas/linsolve.py: `spd_solve_batched` (one
right-hand side, the primal Newton's step) and `spd_solve_batched_mrhs`
(r right-hand sides, the dual Newton's n×n kernel system). On a CUDA tensor
each is the hand-written kernel of csrc/ldlt_solve.cu: a panel-blocked,
unpivoted LDLᵀ factorisation and two substitutions, one block per system,
the packed lower triangle in shared memory, or in a device-memory workspace
once it outgrows the 227 KB a block may opt into. On a CPU tensor each is
the plain PyTorch version below, the TPU kernels' unpivoted Gauss–Jordan
elimination written as batched tensor ops. `ldlt_solve_plain` repeats the
kernel's own arithmetic, for the tests and the on-card check.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda

SMEM_OPTIN = 232_448   # bytes of shared memory a block may opt into (sm_90)


def gj_solve_mrhs_plain(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """X = A⁻¹·R by unpivoted Gauss–Jordan: A [B, d, d], R [B, d, r], any
    float type; A must be (damped) SPD. The row updates of
    gdmix_tpu/ops/pallas/linsolve.py:110-120, batch-major."""
    A = A.clone()
    R = R.clone()
    d = A.shape[-1]
    for j in range(d):
        inv_p = 1.0 / A[:, j, j]                                # [B]
        row_j = A[:, j, :] * inv_p[:, None]                     # [B, d]
        rj = R[:, j, :] * inv_p[:, None]                        # [B, r]
        factor = A[:, :, j].clone()                             # [B, d]
        factor[:, j] = 0.0
        A -= factor[:, :, None] * row_j[:, None, :]
        R -= factor[:, :, None] * rj[:, None, :]
        A[:, j, :] = row_j
        R[:, j, :] = rj
    return R


def gj_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹·b for A [B, d, d], b [B, d]: the one-column case (the row
    updates of gdmix_tpu/ops/pallas/linsolve.py:33-44)."""
    return gj_solve_mrhs_plain(A, b[..., None])[..., 0]


NB = 16   # the kernel's panel width (kNB in csrc/ldlt_solve.cu)


def ldlt_solve_plain(H: torch.Tensor, R: torch.Tensor,
                     nb: int = NB) -> torch.Tensor:
    """X = H⁻¹·R by the kernel's panel-blocked, unpivoted LDLᵀ: H [B, d, d]
    damped SPD, R [B, d, r]. Per panel of nb columns: the diagonal block
    right-looking column by column with the forward substitution of its
    right-hand sides, W21 = A21·L11⁻ᵀ, L21 = W21·D1⁻¹, then A22 −= L21·W21ᵀ
    and Y2 −= L21·Y1; then Y /= D and the back substitution panel by panel
    from the last. Only the lower triangle of A is read."""
    A, Y = H.clone(), R.clone()
    d = A.shape[-1]
    for j0 in range(0, d, nb):
        j1 = min(j0 + nb, d)
        for j in range(j0, j1):
            w = A[:, j + 1:j1, j].clone()
            l = w * (1.0 / A[:, j, j, None])
            A[:, j + 1:j1, j + 1:j1] -= l[:, :, None] * w[:, None, :]
            A[:, j + 1:j1, j] = l
        for k in range(j0, j1):
            Y[:, k + 1:j1] -= A[:, k + 1:j1, k, None] * Y[:, k, None, :]
        W = A[:, j1:, j0:j1].clone()
        for m in range(1, j1 - j0):
            W[:, :, m] -= (W[:, :, :m] * A[:, None, j0 + m, j0:j0 + m]).sum(-1)
        dinv = 1.0 / torch.diagonal(A, dim1=1, dim2=2)[:, j0:j1]
        L = W * dinv[:, None, :]
        A[:, j1:, j0:j1] = L
        Y[:, j1:] -= L @ Y[:, j0:j1]
        A[:, j1:, j1:] -= L @ W.mT
    Y /= torch.diagonal(A, dim1=1, dim2=2)[:, :, None]
    for j0 in reversed(range(0, d, nb)):
        j1 = min(j0 + nb, d)
        for k in reversed(range(j0 + 1, j1)):
            Y[:, j0:k] -= A[:, k, j0:k, None] * Y[:, k, None, :]
        Y[:, :j0] -= A[:, j0:j1, :j0].mT @ Y[:, j0:j1]
    return Y


def _workspace_elems(d: int, r: int) -> int:
    """Elements the kernel keeps per system (its Layout): the packed lower
    triangle, the two [NB, d] panels and Y [d, r], each rounded up to 4."""
    r4 = lambda x: (x + 3) & ~3
    return r4(d * (d + 1) // 2) + 2 * NB * r4(d) + r4(d * r)


def _workspace(B: int, d: int, r: int, like: torch.Tensor):
    """None when a system (its arrays and the diagonal block's L11 and 1/D)
    fits a block's shared memory, else the device-memory workspace the
    kernel factors in."""
    elems = _workspace_elems(d, r) + NB * NB + NB
    if like.element_size() * elems <= SMEM_OPTIN:
        return None
    return torch.empty((B, _workspace_elems(d, r)), dtype=like.dtype,
                       device=like.device)


_lib = None


def _library() -> ctypes.CDLL:
    """csrc/ldlt_solve.cu's library, typed once when first loaded, and its
    storage layout checked then against _workspace_elems (d ≤ 400, r ≤ 3):
    each launch is then the launch alone."""
    global _lib
    if _lib is None:
        lib = _cuda.load("ldlt_solve")
        elems = lib.gdx_ldlt_workspace_elems
        elems.restype = ctypes.c_int64
        elems.argtypes = [ctypes.c_int, ctypes.c_int]
        for d in range(1, 401):
            for r in (1, 2, 3):
                if elems(d, r) != _workspace_elems(d, r):
                    raise RuntimeError(
                        f"spd solve: the kernel's layout differs from "
                        f"_workspace_elems at d={d}, r={r}")
        for fn in (lib.gdx_ldlt_solve_f32, lib.gdx_ldlt_solve_f64):
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(what: str, H: torch.Tensor, R: torch.Tensor, r: int):
    B, d = H.shape[0], H.shape[1]
    x = torch.empty_like(R)
    if B == 0:
        return x
    ws = _workspace(B, d, r, H)
    lib = _library()
    fn = (lib.gdx_ldlt_solve_f64 if H.dtype == torch.float64
          else lib.gdx_ldlt_solve_f32)
    with _cuda.on_card(H) as stream:
        err = fn(_cuda.ptr(H), _cuda.ptr(R), _cuda.ptr(x), B, d, r,
                 None if ws is None else _cuda.ptr(ws), stream)
    _cuda.check(lib, err, what)
    return x


def spd_solve_batched(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H·x = g for H [B, d, d], g [B, d] → x [B, d], with H damped
    SPD (no pivoting). The kernel on a CUDA tensor (float32 or float64, any
    d), the plain version on a CPU tensor."""
    if H.device.type == "cpu":
        return gj_solve_plain(H, g)
    B, d, _ = H.shape
    _cuda.require_cuda("spd_solve_batched", H, g,
                       dtypes=(torch.float32, torch.float64))
    if (g.dtype != H.dtype or tuple(H.shape) != (B, d, d)
            or tuple(g.shape) != (B, d)):
        raise ValueError(f"spd_solve_batched: H {tuple(H.shape)} {H.dtype}, "
                         f"g {tuple(g.shape)} {g.dtype}")
    x = _launch("spd_solve_batched", H, g, 1)
    spd_solve_batched.launches += 1
    return x


def spd_solve_batched_mrhs(H: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Solve H·X = R for H [B, n, n], R [B, n, r] → X [B, n, r], with H
    damped SPD (no pivoting). The kernel on a CUDA tensor (float32 or
    float64), the plain version on a CPU tensor."""
    if H.device.type == "cpu":
        return gj_solve_mrhs_plain(H, R)
    _cuda.require_cuda("spd_solve_batched_mrhs", H, R,
                       dtypes=(torch.float32, torch.float64))
    if (R.dtype != H.dtype or H.dim() != 3 or R.dim() != 3
            or H.shape[1] != H.shape[2] or R.shape[:2] != H.shape[:2]
            or R.shape[2] < 1):
        raise ValueError(f"spd_solve_batched_mrhs: H {tuple(H.shape)} "
                         f"{H.dtype}, R {tuple(R.shape)} {R.dtype}")
    x = _launch("spd_solve_batched_mrhs", H, R, R.shape[2])
    spd_solve_batched_mrhs.launches += 1
    return x


spd_solve_batched.launches = 0
spd_solve_batched_mrhs.launches = 0
