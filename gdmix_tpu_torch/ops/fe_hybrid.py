"""The hot side of the wide-D hybrid: one fused pass over the compact ids.

Port of gdmix_tpu/ops/pallas/fe_hybrid.py (`fe_hybrid_hot_pallas`). On a
CUDA tensor `fe_hybrid_hot` launches the hand-written kernel of
csrc/fe_hybrid.cu; on a CPU tensor it takes the plain PyTorch version beside
it. The wrapper counts its launches in `.launches`, and by the path each
took (`fe_pass.pass_shape`) in `.path_launches`.

The kernel keeps a block-private compact gradient in shared memory. The
table is tiered: the compact ids below S add into shared memory, S = A while
A·sizeof(T) fits the opt-in (A up to ~56k in float32) and what fits past
that, and the ids in [S, A) add in device memory. Compact ids are handed out
in descending order of count (ops/logistic.py `_hybrid_hot`), so the ids
past S are the rarest; the kernel also gives the STRIP_IDS most frequent ids
lane-private slots. `shared_tier` chooses S by shape, as the SPD solves
choose their workspace.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops import fe_pass
from gdmix_tpu_torch.ops.linsolve import SMEM_OPTIN
from gdmix_tpu_torch.ops.logistic import stable_bce

_SUFFIX = fe_pass.SUFFIX


def shared_tier(hot: int, element_size: int) -> int:
    """S: the compact ids below S add into shared memory, by what the
    opt-in holds beside the strips; S = A when the whole table fits."""
    budget = (SMEM_OPTIN - fe_pass.SMEM_RESERVE
              - fe_pass.strip_bytes(element_size))
    return min(hot, budget // element_size)


def _library():
    """The library, typed, and its strip width checked against the one
    `shared_tier` budgets for, once, at its first use."""
    lib = _cuda.load("fe_hybrid")
    if not getattr(lib, "_gdx_typed", False):
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"gdx_fe_hybrid_hot_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [
                ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        lib.gdx_fe_hybrid_strip_ids.restype = ctypes.c_int
        if lib.gdx_fe_hybrid_strip_ids() != fe_pass.STRIP_IDS:
            raise RuntimeError(
                f"fe_hybrid: the library's strip is "
                f"{lib.gdx_fe_hybrid_strip_ids()} ids wide, the wrapper "
                f"budgets {fe_pass.STRIP_IDS}")
        lib.gdx_fe_hybrid_lane_group.argtypes = [ctypes.c_int]
        lib.gdx_fe_hybrid_lane_group.restype = ctypes.c_int
        fe_pass.check_lane_group(lib.gdx_fe_hybrid_lane_group, "fe_hybrid")
        lib._gdx_typed = True
    return lib


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
    what = "fe_hybrid_hot"
    floats = (theta_c, values, labels, weights, offsets2)
    fe_pass.check_records(what, theta_c, hot, hot_idx, values, floats[2:])
    if theta_c.device.type == "cpu":
        # inert entries (value 0, or a record of weight 0) point at the
        # dump slot: the kernel never uses their ids as an address
        live = (values != 0) & (weights != 0)[:, None]
        return fe_hybrid_hot_plain(
            theta_c, b, torch.where(live, hot_idx,
                                    torch.full_like(hot_idx, hot)),
            values, labels, weights, offsets2, hot, linear)
    dtype, dev = theta_c.dtype, theta_c.device
    n, k = hot_idx.shape
    b = torch.as_tensor(b, dtype=dtype, device=dev).reshape(1).contiguous()
    tier = shared_tier(hot, theta_c.element_size())
    g = torch.zeros(hot, dtype=dtype, device=dev)
    r = torch.empty(n, dtype=dtype, device=dev)
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    path = fe_pass.pass_shape(k, hot_idx, values).path
    lib = _library()
    fn = getattr(lib, f"gdx_fe_hybrid_hot_{_SUFFIX[dtype]}")
    with _cuda.on_card(theta_c) as stream:
        err = fn(_cuda.ptr(hot_idx), _cuda.ptr(values), _cuda.ptr(labels),
                 _cuda.ptr(weights), _cuda.ptr(offsets2), _cuda.ptr(theta_c),
                 _cuda.ptr(b), n, k, hot, int(linear), tier,
                 int(path == "vector"), _cuda.ptr(g), _cuda.ptr(r),
                 _cuda.ptr(sums), stream, None)
    _cuda.check(lib, err, what)
    fe_hybrid_hot.launches += 1
    fe_hybrid_hot.path_launches[path] += 1
    return sums[0].to(dtype), g, sums[1].to(dtype), r


fe_hybrid_hot.launches = 0
fe_hybrid_hot.path_launches = {"vector": 0, "lanes": 0}


def hot_blocks_per_sm(hot: int, dtype: torch.dtype, k: int) -> int:
    """Resident blocks per SM of the form `fe_hybrid_hot` launches at this
    shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), on the current
    CUDA device; nothing is launched."""
    lib = _library()
    out = ctypes.c_int(0)
    tier = shared_tier(hot, torch.empty((), dtype=dtype).element_size())
    err = getattr(lib, f"gdx_fe_hybrid_hot_{_SUFFIX[dtype]}")(
        None, None, None, None, None, None, None, 0, k, hot, 0, tier,
        int(fe_pass.vector_shape(k)), None, None, None, None,
        ctypes.byref(out))
    _cuda.check(lib, err, "hot_blocks_per_sm")
    return out.value
