"""Batched solves of small damped SPD systems: the Newton hot ops.

Port of gdmix_tpu/ops/pallas/linsolve.py: `spd_solve_batched` (one
right-hand side, the primal Newton's step) and `spd_solve_batched_mrhs`
(r right-hand sides, the dual Newton's n×n kernel system). On a CUDA tensor
each is the hand-written kernel of csrc/linsolve.cu (one block per system;
the augmented matrix in shared memory, or in a global-memory workspace once
it outgrows the 227 KB a block may opt into); on a CPU tensor it is the
plain PyTorch version below, the same unpivoted Gauss–Jordan elimination
written as batched tensor ops.
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


def _workspace(B: int, d: int, r: int, like: torch.Tensor):
    """None when [H | R] fits a block's shared memory, else the
    global-memory workspace the kernel eliminates in."""
    stride = (d + r) | 1
    if like.element_size() * d * stride <= SMEM_OPTIN:
        return None
    return torch.empty((B, d, stride), dtype=like.dtype, device=like.device)


def _launch(what: str, H: torch.Tensor, R: torch.Tensor, r: int):
    B, d = H.shape[0], H.shape[1]
    x = torch.empty_like(R)
    if B == 0:
        return x
    ws = _workspace(B, d, r, H)
    lib = _cuda.load("linsolve")
    fn = (lib.gdx_spd_solve_f64 if H.dtype == torch.float64
          else lib.gdx_spd_solve_f32)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(H.device):
        err = fn(_cuda.ptr(H), _cuda.ptr(R), _cuda.ptr(x), B, d, r,
                 None if ws is None else _cuda.ptr(ws), _cuda.stream_of(H))
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
