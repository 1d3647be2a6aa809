"""The fixed-effect data term: fused loss + gradient, and the flat
entry-space gather / scatter pair.

Port of the JAX package's FE Pallas kernels (ops/pallas/fe_grad.py,
fe_block.py, fe_gather.py: one fused sum; fe_flat.py: the gather/scatter
pair around an elementwise middle). On a CUDA tensor each wrapper launches
its hand-written kernel of csrc/fe_loss_grad.cu; on a CPU tensor it takes the
plain PyTorch version beside it (`fixed_effect_value_and_grad` with λ = 0,
or the gather / `index_add_` pair). Each wrapper counts its launches in
`.launches`.

All three return the DATA term only: the caller adds the L2 term once, as
the JAX package's `_objective_fun` does around its kernels.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops.logistic import (SparseBatch,
                                          fixed_effect_value_and_grad,
                                          stable_bce)

_FLOATS = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _max_blocks(device: torch.device) -> int:
    """Grid-stride blocks: eight 256-thread blocks per SM keep the card full
    while each block's one double atomic for the loss stays rare."""
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


def _fn(name: str, dtype: torch.dtype, argtypes):
    lib = _cuda.load("fe_loss_grad")
    fn = getattr(lib, f"gdx_fe_{name}_{_SUFFIX[dtype]}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(what, indices, floats):
    _cuda.require_cuda(what, indices, dtypes=(torch.int32,))
    _cuda.require_cuda(what, *floats, dtypes=_FLOATS)
    if len({t.dtype for t in floats}) != 1:
        raise TypeError(f"{what}: mixed float types "
                        f"{sorted({str(t.dtype) for t in floats})}")
    if len({t.device for t in (indices,) + tuple(floats)}) != 1:
        raise ValueError(f"{what}: tensors on more than one device")


# ------------------------------------------------------------------ fused --

def fe_loss_grad_plain(x, indices, values, labels, weights, offsets,
                       num_features: int, *, has_intercept: bool = True,
                       linear: bool = False):
    """(Σ weighted loss, grad[dim]) by gather + `index_add_`: the plain
    version of the fused kernel."""
    return fixed_effect_value_and_grad(
        x, SparseBatch(indices, values, offsets, labels, weights),
        num_features, has_intercept=has_intercept, regularize_bias=True,
        l2_reg_weight=0.0,
        model_type="linear_regression" if linear else "logistic_regression")


def fe_loss_grad_fused(x, indices, values, labels, weights, offsets,
                       num_features: int, *, has_intercept: bool = True,
                       linear: bool = False):
    """Fused data term over padded COO [N, K]: returns (Σ weighted loss,
    grad[dim]) with dim = num_features (+1, the intercept LAST, when
    has_intercept). Padding rows carry weight 0 and padding entries value 0;
    ids of non-zero entries must lie in [0, num_features)."""
    if x.device.type == "cpu":
        return fe_loss_grad_plain(x, indices, values, labels, weights,
                                  offsets, num_features,
                                  has_intercept=has_intercept, linear=linear)
    what = "fe_loss_grad_fused"
    _check_inputs(what, indices, (x, values, labels, weights, offsets))
    n, k = indices.shape
    dim = num_features + (1 if has_intercept else 0)
    if (tuple(values.shape) != (n, k) or tuple(x.shape) != (dim,)
            or any(tuple(t.shape) != (n,)
                   for t in (labels, weights, offsets))):
        raise ValueError(f"{what}: x {tuple(x.shape)} (dim {dim}), indices "
                         f"{tuple(indices.shape)}, values "
                         f"{tuple(values.shape)}, labels/weights/offsets "
                         f"{[tuple(t.shape) for t in (labels, weights, offsets)]}")
    grad = torch.zeros_like(x)
    sums = torch.zeros(2, dtype=torch.float64, device=x.device)
    lib, fn = _fn("fused", x.dtype, [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_cuda.ptr(indices), _cuda.ptr(values), _cuda.ptr(labels),
                 _cuda.ptr(weights), _cuda.ptr(offsets), _cuda.ptr(x), n, k,
                 num_features, int(has_intercept), int(linear),
                 _cuda.ptr(grad), _cuda.ptr(sums), _max_blocks(x.device),
                 _cuda.stream_of(x))
    _cuda.check(lib, err, what)
    fe_loss_grad_fused.launches += 1
    if has_intercept:
        grad[num_features] = sums[1]
    return sums[0].to(x.dtype), grad


fe_loss_grad_fused.launches = 0


# ------------------------------------------------------------ flat entries --

def fe_gather_entries_plain(theta_w, idx, val):
    return val * theta_w[idx.long()]


def fe_gather_entries(theta_w: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """out[e] = val[e]·θ[idx[e]] over the flat entry axis (idx, val [E])."""
    if theta_w.device.type == "cpu":
        return fe_gather_entries_plain(theta_w, idx, val)
    what = "fe_gather_entries"
    _check_inputs(what, idx, (theta_w, val))
    if idx.dim() != 1 or tuple(val.shape) != tuple(idx.shape):
        raise ValueError(f"{what}: idx {tuple(idx.shape)}, val "
                         f"{tuple(val.shape)}: both [E]")
    out = torch.empty_like(val)
    lib, fn = _fn("gather", val.dtype, [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(val.device):
        err = fn(_cuda.ptr(idx), _cuda.ptr(val), _cuda.ptr(theta_w),
                 idx.shape[0], _cuda.ptr(out), _max_blocks(val.device),
                 _cuda.stream_of(val))
    _cuda.check(lib, err, what)
    fe_gather_entries.launches += 1
    return out


fe_gather_entries.launches = 0


def fe_scatter_entries_plain(idx, ce, num_features):
    return torch.zeros(num_features, dtype=ce.dtype,
                       device=ce.device).index_add_(0, idx.long(), ce)


def fe_scatter_entries(idx: torch.Tensor, ce: torch.Tensor,
                       num_features: int) -> torch.Tensor:
    """g[idx[e]] += ce[e] over the flat entry axis → g [num_features]."""
    if ce.device.type == "cpu":
        return fe_scatter_entries_plain(idx, ce, num_features)
    what = "fe_scatter_entries"
    _check_inputs(what, idx, (ce,))
    if idx.dim() != 1 or tuple(ce.shape) != tuple(idx.shape):
        raise ValueError(f"{what}: idx {tuple(idx.shape)}, ce "
                         f"{tuple(ce.shape)}: both [E]")
    g = torch.zeros(num_features, dtype=ce.dtype, device=ce.device)
    lib, fn = _fn("scatter", ce.dtype, [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(ce.device):
        err = fn(_cuda.ptr(idx), _cuda.ptr(ce), idx.shape[0], _cuda.ptr(g),
                 _max_blocks(ce.device), _cuda.stream_of(ce))
    _cuda.check(lib, err, what)
    fe_scatter_entries.launches += 1
    return g


fe_scatter_entries.launches = 0


def fe_loss_grad_flat(x, indices, values, labels, weights, offsets,
                      num_features: int, *, linear: bool = False):
    """The data term through the flat pair (intercept LAST, required): the
    entry gather, the per-record middle in PyTorch (z, loss, residual, the
    entry contributions; gdmix_tpu/ops/pallas/fe_flat.py:225-233), then the
    entry scatter. Returns (Σ weighted loss, grad[D+1])."""
    n, k = indices.shape
    w_vec, b = x[:-1], x[-1]
    gathered = fe_gather_entries(w_vec, indices.reshape(-1),
                                 values.reshape(-1))
    z = torch.sum(gathered.reshape(n, k), dim=1) + offsets + b
    if linear:
        per, dz = (labels - z) ** 2, 2.0 * (z - labels)
    else:
        per, dz = stable_bce(z, labels), torch.sigmoid(z) - labels
    r = weights * dz
    ce = (values * r[:, None]).reshape(-1)
    g = fe_scatter_entries(indices.reshape(-1), ce, num_features)
    return torch.sum(weights * per), torch.cat([g, torch.sum(r)[None]])
