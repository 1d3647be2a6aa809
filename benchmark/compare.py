"""The comparisons that decide `correct`: each reduces the program's answer
and the reference's to one number, which the cell's traffic file holds to a
limit of its own."""
from __future__ import annotations

import numpy as np


def thresholded_gap(prog: np.ndarray, ref: np.ndarray, tau: float
                    ) -> np.ndarray:
    """Per-coefficient distance of the program's coefficients from the
    reference's, where the program zeroes every |θ| ≤ tau: |θp − θr| for a
    coefficient it kept, max(0, |θr| − tau) for one it zeroed (the least
    distance its answer allows)."""
    kept = prog != 0
    return np.where(kept, np.abs(prog - ref),
                    np.maximum(np.abs(ref) - tau, 0.0))


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= lim
        ok = ok and bool(good)
        rows.append((name, None if v is None else float(v), lim))
    return ok, rows
