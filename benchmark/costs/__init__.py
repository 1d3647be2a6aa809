"""The yardstick's arithmetic: the chip's published peaks, the least time
a piece of work can take on it, and the FLOPs and bytes each piece of work
needs, counted from its shapes and from the iterations the benchmark's own
plain reference needs (never from counts the program reports).

`bound_s` and `spd_solve_flops` are copies of chip_smoke.py's `_bound` and
`_spd_solve_flops`; `newton_iteration_flops` is the count chip_smoke.py
gives K1 an iteration.
"""
from __future__ import annotations

# NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s in
# float32 outside the tensor cores (and in float64 through the FP64 tensor
# cores), at the full power limit of 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}    # by element size in bytes


def bound_s(nbytes: float, flops: float, item: int = 4):
    """(least seconds, "bytes" or "operations"): the larger of moving
    `nbytes` at the memory rate and doing `flops` at the peak rate of an
    element of `item` bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[item]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd_solve_flops(d: int, r: int) -> float:
    """Flops that one d×d SPD system with r right-hand sides needs,
    whatever algorithm runs it: a Cholesky factorisation (d³/3) and a
    forward and a back substitution per column (d² each)."""
    return d ** 3 / 3 + 2 * d * d * r


def newton_iteration_flops(n: int, d: int) -> float:
    """One Newton iteration of an entity with n rows and dim d: the
    symmetric Hessian n·d·(d+1), the gradient, margins and line search
    ~6·n·d, and the d×d solve d³/3 + 2·d²."""
    return n * d * (d + 1) + 6 * n * d + spd_solve_flops(d, 1)


def newton_solve_bytes(n: int, d: int, item: int = 4) -> float:
    """The bytes an entity's whole solve must move, each read or written
    once: its [n, d] rows, labels, weights and offsets, and θ0 in; θ and
    its flag out."""
    return item * (n * d + 3 * n + 2 * d) + 1


def funcall_flops(rows: int, k: int) -> float:
    """One evaluation of a fixed-effect LR objective and its gradient over
    rows × k entries: two passes over the entries (the margins and the
    gradient, a multiply and an add each, 4·N·K) and the per-row loss and
    residual (~10 a row: exp, log1p, sigmoid, weight)."""
    return 4.0 * rows * k + 10.0 * rows


def funcall_bytes(rows: int, k: int, width: int, item: int = 4) -> float:
    """The bytes one funcall must move, each read or written once: ids
    (int32) and values of every entry, labels, weights and offsets of every
    row, the coefficients in and the gradient out."""
    return rows * k * (4 + item) + 3 * rows * item + 2 * (width + 1) * item
