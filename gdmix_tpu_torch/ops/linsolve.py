"""Batched solve of small damped SPD systems, the Newton hot op.

Port of gdmix_tpu/ops/pallas/linsolve.py:spd_solve_batched. On a CUDA
tensor the solve is the hand-written kernel of csrc/linsolve.cu (one block
per system, the augmented matrix in shared memory); on a CPU tensor it is
the plain PyTorch version below, the same unpivoted Gauss–Jordan
elimination written as batched tensor ops.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda

MAX_DIM = 128   # the primal Newton's ceiling (REParams.newton_max_dim)


def gj_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹·b by unpivoted Gauss–Jordan: A [B, d, d], b [B, d], any float
    type; A must be (damped) SPD. The row updates of
    gdmix_tpu/ops/pallas/linsolve.py:33-44, batch-major."""
    A = A.clone()
    b = b.clone()
    d = A.shape[-1]
    for j in range(d):
        inv_p = 1.0 / A[:, j, j]                                # [B]
        row_j = A[:, j, :] * inv_p[:, None]                     # [B, d]
        bj = b[:, j] * inv_p                                    # [B]
        factor = A[:, :, j].clone()                             # [B, d]
        factor[:, j] = 0.0
        A -= factor[:, :, None] * row_j[:, None, :]
        b -= factor * bj[:, None]
        A[:, j, :] = row_j
        b[:, j] = bj
    return b


def spd_solve_batched(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H·x = g for H [B, d, d], g [B, d] → x [B, d], with H damped
    SPD (no pivoting). The kernel on a CUDA tensor (float32 or float64,
    d ≤ MAX_DIM), the plain version on a CPU tensor."""
    if H.device.type == "cpu":
        return gj_solve_plain(H, g)
    B, d, _ = H.shape
    _cuda.require_cuda("spd_solve_batched", H, g,
                       dtypes=(torch.float32, torch.float64))
    if (g.dtype != H.dtype or tuple(H.shape) != (B, d, d)
            or tuple(g.shape) != (B, d) or d > MAX_DIM):
        raise ValueError(f"spd_solve_batched: H {tuple(H.shape)} {H.dtype}, "
                         f"g {tuple(g.shape)} {g.dtype}; d ≤ {MAX_DIM}")
    x = torch.empty_like(g)
    if B == 0:
        return x
    lib = _cuda.load("linsolve")
    fn = (lib.gdx_spd_solve_f64 if H.dtype == torch.float64
          else lib.gdx_spd_solve_f32)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(H.device):
        err = fn(_cuda.ptr(H), _cuda.ptr(g), _cuda.ptr(x), B, d,
                 _cuda.stream_of(H))
    _cuda.check(lib, err, "spd_solve_batched")
    spd_solve_batched.launches += 1
    return x


spd_solve_batched.launches = 0
