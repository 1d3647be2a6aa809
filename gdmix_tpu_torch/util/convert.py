"""Carry weights and solver inputs across from the JAX package, as numpy.

No function here imports `gdmix_tpu`: each takes numpy arrays (or objects
that expose them), so the tests can hand one prior to both trainers, one
bucket to both solvers and one set of deep-tower weights to both towers.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gdmix_tpu_torch.io.model_table import ModelTable


def model_table_from_numpy(ids, offs, coef_ids, coef_vals, icpt,
                           coef_vars=None, icpt_vars=None,
                           has_intercept: bool = True) -> ModelTable:
    """The port's ModelTable from the numpy columns of a ModelTable (the
    JAX package's columns are the same: ids [E], offs [E+1], coef_ids and
    coef_vals [nnz], icpt [E], optional variances)."""
    return ModelTable(
        ids=np.asarray(ids, dtype=object),
        offs=np.array(offs, dtype=np.int64),
        coef_ids=np.array(coef_ids, dtype=np.int64),
        coef_vals=np.array(coef_vals, dtype=np.float64),
        icpt=np.array(icpt, dtype=np.float64) if has_intercept else None,
        coef_vars=None if coef_vars is None else np.array(coef_vars,
                                                          np.float64),
        icpt_vars=(None if icpt_vars is None or not has_intercept
                   else np.array(icpt_vars, np.float64)))


def newton_inputs_from_numpy(bucket_arrays: Mapping[str, np.ndarray],
                             device, dtype) -> dict:
    """A bucket-array dict (indices, values, offsets, labels, weights,
    sample_count, theta0, or any of them) as tensors on `device`: indices
    int64, the rest in `dtype`."""
    out = {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
           for k, v in bucket_arrays.items() if k != "indices"}
    if "indices" in bucket_arrays:
        out["indices"] = torch.as_tensor(
            np.asarray(bucket_arrays["indices"]), dtype=torch.int64,
            device=device)
    return out


def fe_coefficients_from_numpy(coefficients, device, dtype) -> torch.Tensor:
    """A fixed-effect coefficient vector of the JAX package ([D+1] numpy,
    intercept LAST; [D] without an intercept) as the port's tensor. Both
    packages keep this layout, so nothing is reordered."""
    return torch.as_tensor(np.asarray(coefficients), dtype=dtype,
                           device=device)


def _dense(layer) -> tuple:
    """A flax Dense's (kernel [in, out], bias) as nn.Linear's (weight
    [out, in], bias)."""
    return (np.ascontiguousarray(np.asarray(layer["kernel"]).T),
            np.asarray(layer["bias"]))


def deep_tower_state_from_flax(params, *, ftr_ext: str, windows,
                               num_fields: int, num_layers: int) -> dict:
    """The port's _TextWideTower state_dict from the JAX package's flax
    parameter tree (numpy leaves, with or without the outer "params").

    flax names submodules in the order they are constructed, not called:
    field f's window i is Conv_{f·W+i}; field f's LSTM layer k is
    OptimizedLSTMCell_{f·L+k}; in transformer layer i, Dense_{2i} is the
    FFN's output projection (4u → u) and Dense_{2i+1} its expansion, and
    LayerNorm_{2i}, _{2i+1} follow attention and FFN; the head's two Dense
    layers come after the encoder's. A flax Conv kernel is (width, in, out),
    torch's (out, in, width). The LSTM cell's gates i, f, g, o are torch's
    order; flax keeps one bias per gate, on the hidden side, so bias_ih is
    0. Attention kernels are (u, heads, u/heads), its output (heads,
    u/heads, u)."""
    p = params.get("params", params)
    state = {"embed.weight": p["Embed_0"]["embedding"], "wide_w": p["wide_w"]}
    dense = 0
    if ftr_ext == "cnn":
        for i in range(num_fields * len(windows)):
            conv = p[f"Conv_{i}"]
            state[f"convs.{i}.weight"] = np.ascontiguousarray(
                np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
            state[f"convs.{i}.bias"] = conv["bias"]
    elif ftr_ext == "lstm":
        for f in range(num_fields):
            for k in range(num_layers):
                cell = p[f"OptimizedLSTMCell_{f * num_layers + k}"]
                pre = f"lstms.{f}."
                state[pre + f"weight_ih_l{k}"] = np.concatenate(
                    [np.asarray(cell[f"i{g}"]["kernel"]).T for g in "ifgo"])
                state[pre + f"weight_hh_l{k}"] = np.concatenate(
                    [np.asarray(cell[f"h{g}"]["kernel"]).T for g in "ifgo"])
                state[pre + f"bias_hh_l{k}"] = np.concatenate(
                    [np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"])
                state[pre + f"bias_ih_l{k}"] = np.zeros_like(
                    state[pre + f"bias_hh_l{k}"])
    else:
        if num_fields != 1:
            raise ValueError("ROADMAP C.11: one text column for "
                             f"{ftr_ext}")
        state["posemb"] = p["posemb"]
        for i in range(num_layers):
            att, pre = p[f"SelfAttention_{i}"], f"layers.{i}."
            units = np.asarray(att["query"]["kernel"]).shape[0]
            for name in ("query", "key", "value"):
                state[pre + name + ".weight"] = np.ascontiguousarray(
                    np.asarray(att[name]["kernel"]).reshape(units, -1).T)
                state[pre + name + ".bias"] = np.asarray(
                    att[name]["bias"]).reshape(-1)
            state[pre + "out.weight"] = np.ascontiguousarray(
                np.asarray(att["out"]["kernel"]).reshape(-1, units).T)
            state[pre + "out.bias"] = att["out"]["bias"]
            for j, norm in enumerate(("norm_att", "norm_ff")):
                ln = p[f"LayerNorm_{2 * i + j}"]
                state[pre + norm + ".scale"] = ln["scale"]
                state[pre + norm + ".bias"] = ln["bias"]
            for j, name in enumerate(("ff_out", "ff_in")):
                w, b = _dense(p[f"Dense_{2 * i + j}"])
                state[pre + name + ".weight"] = w
                state[pre + name + ".bias"] = b
        dense = 2 * num_layers
    for j, name in enumerate(("hidden", "logit")):
        w, b = _dense(p[f"Dense_{dense + j}"])
        state[name + ".weight"], state[name + ".bias"] = w, b
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
