"""The hot side of the wide-D hybrid: one fused pass over the compact ids.

Port of gdmix_tpu/ops/pallas/fe_hybrid.py (`fe_hybrid_hot_pallas`). On a
CUDA tensor `fe_hybrid_hot` launches the hand-written kernel of
csrc/fe_hybrid.cu; on a CPU tensor it takes the plain PyTorch version beside
it. The wrapper counts its launches in `.launches`.

The kernel keeps the compact θ and the compact gradient privatised in a
block's shared memory while both fit the opt-in (2·A·sizeof(T) bytes: A up to
~28k in float32); past that, the same kernel reads θ and adds into the
gradient in device memory. The choice is made here by shape, as the SPD
solves choose their workspace.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops.linsolve import SMEM_OPTIN
from gdmix_tpu_torch.ops.logistic import stable_bce

_FLOATS = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# static shared memory of the kernel besides the two tables (the block sum)
_SMEM_RESERVE = 1024


def shared_form(hot: int, element_size: int) -> bool:
    """Whether the kernel keeps θc and the gradient in shared memory."""
    return 2 * hot * element_size + _SMEM_RESERVE <= SMEM_OPTIN


def fe_hybrid_hot_plain(theta_c, b, hot_idx, values, labels, weights,
                        offsets2, hot: int, linear: bool = False):
    """θc padded with a zero dump slot, a gather, the residual, and
    `index_add_` into [A+1]; returns (Σ weighted loss, g_hot [A], Σr,
    r [N])."""
    th = torch.cat([theta_c, theta_c.new_zeros(1)])
    idx = hot_idx.long()
    z = torch.sum(values * th[idx], dim=1) + offsets2 + b
    if linear:
        per, dz = (labels - z) ** 2, 2.0 * (z - labels)
    else:
        per, dz = stable_bce(z, labels), torch.sigmoid(z) - labels
    r = weights * dz
    g = theta_c.new_zeros(hot + 1).index_add_(
        0, idx.reshape(-1), (values * r[:, None]).reshape(-1))
    return torch.sum(weights * per), g[:hot], torch.sum(r), r


def fe_hybrid_hot(theta_c, b, hot_idx, values, labels, weights, offsets2,
                  hot: int, linear: bool = False):
    """Fused hot-side pass: (Σ weighted loss, g_hot [A], Σr, r [N]).

    theta_c: [A] compact hot coefficients (w[hot_ids]); b: the intercept, a
    0-d tensor or a number (0 when the model has none: Σr is then unused).
    hot_idx: [N, K] compact ids in [0, A]; A is the dump slot, where cold
    and padding entries point, and such entries are skipped. offsets2 must
    include the cold forward correction z_cold. Float32 or float64, one type
    throughout; no row padding (the kernel masks its own edge)."""
    if theta_c.device.type == "cpu":
        return fe_hybrid_hot_plain(theta_c, b, hot_idx, values, labels,
                                   weights, offsets2, hot, linear)
    what = "fe_hybrid_hot"
    floats = (theta_c, values, labels, weights, offsets2)
    _cuda.require_cuda(what, hot_idx, dtypes=(torch.int32,))
    _cuda.require_cuda(what, *floats, dtypes=_FLOATS)
    dtype, dev = theta_c.dtype, theta_c.device
    if any(t.dtype != dtype for t in floats) or any(
            t.device != dev for t in floats + (hot_idx,)):
        raise TypeError(f"{what}: every float input must be {dtype} on {dev}")
    n, k = hot_idx.shape
    if (tuple(theta_c.shape) != (hot,) or tuple(values.shape) != (n, k)
            or any(tuple(t.shape) != (n,)
                   for t in (labels, weights, offsets2))):
        raise ValueError(f"{what}: theta_c {tuple(theta_c.shape)} (A {hot}), "
                         f"hot_idx {tuple(hot_idx.shape)}, values "
                         f"{tuple(values.shape)}, labels/weights/offsets2 "
                         f"{[tuple(t.shape) for t in floats[2:]]}")
    b = torch.as_tensor(b, dtype=dtype, device=dev).reshape(1).contiguous()
    shared = shared_form(hot, theta_c.element_size())
    g = torch.zeros(hot, dtype=dtype, device=dev)
    r = torch.empty(n, dtype=dtype, device=dev)
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    lib = _cuda.load("fe_hybrid")
    fn = getattr(lib, f"gdx_fe_hybrid_hot_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(_cuda.ptr(hot_idx), _cuda.ptr(values), _cuda.ptr(labels),
                 _cuda.ptr(weights), _cuda.ptr(offsets2), _cuda.ptr(theta_c),
                 _cuda.ptr(b), n, k, hot, int(linear), int(shared),
                 _cuda.ptr(g), _cuda.ptr(r), _cuda.ptr(sums),
                 _cuda.stream_of(theta_c))
    _cuda.check(lib, err, what)
    fe_hybrid_hot.launches += 1
    return sums[0].to(dtype), g, sums[1].to(dtype), r


fe_hybrid_hot.launches = 0
