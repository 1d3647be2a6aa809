"""The fixed-effect data term: fused loss + gradient, and the flat
entry-space gather / scatter pair.

Port of the JAX package's FE Pallas kernels (ops/pallas/fe_grad.py,
fe_block.py, fe_gather.py: one fused sum; fe_flat.py: the gather/scatter
pair around an elementwise middle). On a CUDA tensor each wrapper launches
its hand-written kernel of csrc/fe_loss_grad.cu; on a CPU tensor it takes the
plain PyTorch version beside it (`fixed_effect_value_and_grad` with λ = 0,
or the gather / `index_add_` pair). Each wrapper counts its launches in
`.launches`; the fused one also by the path each took (`fe_pass.pass_shape`)
in `.path_launches`.

The fused kernel and the entry scatter keep a block-private gradient in
shared memory while the table fits the opt-in, and past it add into device
memory behind a shared-memory cache of recurring ids; `privatised_form`
chooses by shape, as the SPD solves choose their workspace.

All three return the DATA term only: the caller adds the L2 term once, as
the JAX package's `_objective_fun` does around its kernels.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops import fe_pass
from gdmix_tpu_torch.ops.linsolve import SMEM_OPTIN
from gdmix_tpu_torch.ops.logistic import (SparseBatch,
                                          fixed_effect_value_and_grad,
                                          stable_bce)

_FLOATS, _SUFFIX = fe_pass.FLOATS, fe_pass.SUFFIX
# the hashed table that finds the fused kernel's frequent ids: two int32
# arrays of HOT_BUCKETS and one of fe_pass.STRIP_IDS (kBuckets in
# csrc/fe_common.cuh; checked at the library's first load)
HOT_BUCKETS = 1024

# where the fused kernel keeps its gradient table (kDevice and kBlock in
# csrc/fe_common.cuh)
FORM_DEVICE, FORM_BLOCK = 0, 1


def privatised_form(num_features: int, element_size: int) -> int:
    """Where the fused kernel and the entry scatter keep the gradient
    while they add: FORM_BLOCK, a private copy in each block's shared
    memory, while the table fits the opt-in beside the strips and the
    hashed table; FORM_DEVICE, device memory, past that."""
    extra = (fe_pass.strip_bytes(element_size)
             + 4 * (2 * HOT_BUCKETS + fe_pass.STRIP_IDS))
    fits = (num_features * element_size + extra + fe_pass.SMEM_RESERVE
            <= SMEM_OPTIN)
    return FORM_BLOCK if fits else FORM_DEVICE


def inert_ids_to_zero(indices, values, weights):
    """The ids with those of inert entries (value 0, or a record of weight
    0) set to 0: the kernels never use such an id as an address, and the
    plain versions, which gather every id, are handed these."""
    live = (values != 0) & (weights != 0)[:, None]
    return torch.where(live, indices, torch.zeros_like(indices))


def _max_blocks(device: torch.device) -> int:
    """Grid-stride blocks: eight 256-thread blocks per SM keep the card full
    while each block's one double atomic for the loss stays rare."""
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "fused": [_P] * 6 + [ctypes.c_int64] + [_I] * 6 + [_P] * 4,
    "gather": [_P] * 3 + [ctypes.c_int64, _P, _I, _P],
    "scatter": [_P] * 2 + [ctypes.c_int64] + [_I] * 3 + [_P] * 3,
}


def _fn(name: str, dtype: torch.dtype):
    """(library, its entry point `name` for `dtype`); the library is typed,
    and its strips and buckets checked against the wrapper's byte budget,
    once, at its first use."""
    lib = _cuda.load("fe_loss_grad")
    if not getattr(lib, "_gdx_typed", False):
        lib.gdx_fe_strip_ids.restype = lib.gdx_fe_buckets.restype = _I
        got = (lib.gdx_fe_strip_ids(), lib.gdx_fe_buckets())
        want = (fe_pass.STRIP_IDS, HOT_BUCKETS)
        if got != want:
            raise RuntimeError(
                f"fe_loss_grad: the library has (strips, buckets) = {got}, "
                f"the wrapper budgets {want}")
        lib.gdx_fe_lane_group.argtypes, lib.gdx_fe_lane_group.restype = \
            [_I], _I
        fe_pass.check_lane_group(lib.gdx_fe_lane_group, "fe_loss_grad")
        for entry, argtypes in _ARGTYPES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"gdx_fe_{entry}_{suffix}")
                fn.argtypes, fn.restype = argtypes, _I
        lib._gdx_typed = True
    return lib, getattr(lib, f"gdx_fe_{name}_{_SUFFIX[dtype]}")


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
    what = "fe_loss_grad_fused"
    dim = num_features + (1 if has_intercept else 0)
    fe_pass.check_records(what, x, dim, indices, values,
                          (labels, weights, offsets))
    if x.device.type == "cpu":
        return fe_loss_grad_plain(x, inert_ids_to_zero(indices, values,
                                                       weights),
                                  values, labels, weights, offsets,
                                  num_features, has_intercept=has_intercept,
                                  linear=linear)
    n, k = indices.shape
    grad = torch.zeros_like(x)
    sums = torch.zeros(2, dtype=torch.float64, device=x.device)
    path = fe_pass.pass_shape(k, indices, values).path
    lib, fn = _fn("fused", x.dtype)
    with _cuda.on_card(x) as stream:
        err = fn(_cuda.ptr(indices), _cuda.ptr(values), _cuda.ptr(labels),
                 _cuda.ptr(weights), _cuda.ptr(offsets), _cuda.ptr(x), n, k,
                 num_features, int(has_intercept), int(linear),
                 privatised_form(num_features, x.element_size()),
                 int(path == "vector"), _cuda.ptr(grad), _cuda.ptr(sums),
                 stream, None)
    _cuda.check(lib, err, what)
    fe_loss_grad_fused.launches += 1
    fe_loss_grad_fused.path_launches[path] += 1
    if has_intercept:
        grad[num_features] = sums[1]
    return sums[0].to(x.dtype), grad


fe_loss_grad_fused.launches = 0
fe_loss_grad_fused.path_launches = {"vector": 0, "lanes": 0}


def fused_blocks_per_sm(num_features: int, dtype: torch.dtype, k: int) -> int:
    """Resident blocks per SM of the form `fe_loss_grad_fused` launches at
    this shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), on the
    current CUDA device; nothing is launched."""
    lib, fn = _fn("fused", dtype)
    out = ctypes.c_int(0)
    item = torch.empty((), dtype=dtype).element_size()
    err = fn(None, None, None, None, None, None, 0, k, num_features, 0, 0,
             privatised_form(num_features, item),
             int(fe_pass.vector_shape(k)), None, None, None,
             ctypes.byref(out))
    _cuda.check(lib, err, "fused_blocks_per_sm")
    return out.value


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
    lib, fn = _fn("gather", val.dtype)
    with _cuda.on_card(val) as stream:
        err = fn(_cuda.ptr(idx), _cuda.ptr(val), _cuda.ptr(theta_w),
                 idx.shape[0], _cuda.ptr(out), _max_blocks(val.device),
                 stream)
    _cuda.check(lib, err, what)
    fe_gather_entries.launches += 1
    return out


fe_gather_entries.launches = 0


def fe_scatter_entries_plain(idx, ce, num_features):
    return torch.zeros(num_features, dtype=ce.dtype,
                       device=ce.device).index_add_(0, idx.long(), ce)


def fe_scatter_entries(idx: torch.Tensor, ce: torch.Tensor,
                       num_features: int) -> torch.Tensor:
    """g[idx[e]] += ce[e] over the flat entry axis → g [num_features].
    Entries with ce 0 are inert (their ids are never used as an address);
    the ids of the others must lie in [0, num_features). On a card the
    kernel adds through the fused kernel's table, in the form
    `privatised_form` picks for num_features."""
    if ce.device.type == "cpu":
        return fe_scatter_entries_plain(idx, ce, num_features)
    what = "fe_scatter_entries"
    _check_inputs(what, idx, (ce,))
    if idx.dim() != 1 or tuple(ce.shape) != tuple(idx.shape):
        raise ValueError(f"{what}: idx {tuple(idx.shape)}, ce "
                         f"{tuple(ce.shape)}: both [E]")
    g = torch.zeros(num_features, dtype=ce.dtype, device=ce.device)
    lib, fn = _fn("scatter", ce.dtype)
    with _cuda.on_card(ce) as stream:
        err = fn(_cuda.ptr(idx), _cuda.ptr(ce), idx.shape[0], num_features,
                 privatised_form(num_features, ce.element_size()),
                 int(idx.data_ptr() % 16 == 0 and ce.data_ptr() % 16 == 0),
                 _cuda.ptr(g), stream, None)
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
