"""Coefficient utilities (reference gdmix/util/model_utils.py:4-12)."""
from __future__ import annotations

import numpy as np


def threshold_coefficients(coefficients: np.ndarray, threshold: float) -> np.ndarray:
    """Zero out coefficients with |x| <= threshold."""
    out = np.asarray(coefficients).copy()
    out[np.abs(out) <= threshold] = 0.0
    return out
