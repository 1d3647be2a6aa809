"""The yardstick's arithmetic on hand-worked cases."""
import numpy as np

from benchmark import costs


def test_bound_takes_the_larger_side():
    t, by = costs.bound_s(3.35e12, 1.0)
    assert abs(t - 1.0) < 1e-12 and by == "bytes"
    t, by = costs.bound_s(1.0, 67e12 * 2)
    assert abs(t - 2.0) < 1e-12 and by == "operations"


def test_spd_solve_flops():
    # a Cholesky factorisation d³/3, a forward and a back solve d² each
    assert costs.spd_solve_flops(3, 1) == 9 + 18
    assert costs.spd_solve_flops(6, 2) == 72 + 144


def test_newton_iteration_on_a_tiny_tier():
    # n 2 rows, dim 3: Hessian 2·3·4 = 24, gradient and line search
    # 6·2·3 = 36, the solve 27
    assert costs.newton_iteration_flops(2, 3) == 87
    # a tier of two entities, (n, d, iterations) (2, 3, 4) and (5, 2, 3)
    n, d, it = np.array([2, 5.]), np.array([3, 2.]), np.array([4, 3.])
    per = costs.newton_iteration_flops(n, d)
    assert list(per) == [87, 5 * 2 * 3 + 60 + 8 / 3 + 8]
    assert (it * per).sum() == 4 * 87 + 3 * (30 + 60 + 8 / 3 + 8)
    # bytes, float32: rows, labels, weights, offsets, θ0 and θ, the flag
    assert costs.newton_solve_bytes(2, 3) == 4 * (6 + 6 + 6) + 1


def test_funcall_on_a_tiny_batch():
    # 2 rows of 3 entries: two passes, a multiply and an add each, and
    # ~10 a row for the loss
    assert costs.funcall_flops(2, 3) == 4 * 6 + 20
    # ids and values of 6 entries, 3 vectors of 2 rows, x in and g out
    assert costs.funcall_bytes(2, 3, 5) == 6 * 8 + 3 * 2 * 4 + 2 * 6 * 4
