"""Carry weights and solver inputs across from the JAX package, as numpy.

No function here imports `gdmix_tpu`: each takes numpy arrays (or objects
that expose them), so the tests can hand one prior to both trainers and one
bucket to both solvers.
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
