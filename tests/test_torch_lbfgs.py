"""Port parity of L-BFGS: gdmix_tpu_torch.ops.lbfgs (a host loop over
tensors) against gdmix_tpu.ops.lbfgs (a lax.while_loop) in float64 on the
same objectives from the same start. The two take the same decisions, so
they must agree on the iteration and funcall counts and the stop flags, and
on x to 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.ops import logistic as jl
from gdmix_tpu.ops.lbfgs import lbfgs as jax_lbfgs
from gdmix_tpu_torch.ops import logistic as tl
from gdmix_tpu_torch.ops.lbfgs import lbfgs as torch_lbfgs

X_TOL = 1e-8


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _quadratic(seed=0, d=20):
    rng = np.random.RandomState(seed)
    Q = rng.randn(d, d)
    A = Q @ Q.T / d + np.diag(np.linspace(0.1, 10.0, d))
    b = rng.randn(d)

    def jfun(x):
        Ax = jnp.asarray(A) @ x
        return 0.5 * x @ Ax - jnp.asarray(b) @ x, Ax - jnp.asarray(b)

    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def tfun(x):
        Ax = At @ x
        return 0.5 * x @ Ax - bt @ x, Ax - bt
    return jfun, tfun, np.zeros(d)


def _logistic(seed=1, n=300, d=20, linear=False):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, (n, 4)).astype(np.int32)
    val = rng.randn(n, 4)
    z = val.sum(1)
    y = z + rng.randn(n) if linear else \
        (rng.rand(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    cols = (idx, val, 0.2 * rng.randn(n), y, rng.rand(n) + 0.5)
    kw = dict(has_intercept=True, regularize_bias=False, l2_reg_weight=0.5,
              model_type="linear_regression" if linear
              else "logistic_regression")
    jb = jl.SparseBatch(*(jnp.asarray(c) for c in cols))
    tb = tl.SparseBatch(*(torch.as_tensor(c) for c in cols))
    return (lambda x: jl.fixed_effect_value_and_grad(x, jb, d, **kw),
            lambda x: tl.fixed_effect_value_and_grad(x, tb, d, **kw),
            np.zeros(d + 1))


def _rosenbrock(d=6):
    """Curved valleys: the line search brackets and zooms."""
    def f(x, lib):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    def jfun(x):
        return jax.value_and_grad(lambda v: f(v, jnp))(x)

    def tfun(x):
        x = x.detach().requires_grad_(True)
        v = f(x, torch)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g
    return jfun, tfun, np.full(d, -1.2)


@pytest.mark.parametrize("problem,kw", [
    ("quadratic", dict(pgtol=1e-10, ftol=1e-14)),
    ("logistic", dict(pgtol=1e-10, ftol=1e-14)),
    ("linear", dict(pgtol=1e-10, ftol=1e-14, m=4)),
    ("rosenbrock", dict(pgtol=1e-8, ftol=1e-15, maxiter=200)),
    ("logistic", dict(pgtol=1e-12, ftol=0.0, maxiter=7)),   # maxiter stop
])
def test_lbfgs_matches_jax(problem, kw):
    jfun, tfun, x0 = {"quadratic": _quadratic,
                      "logistic": _logistic,
                      "linear": lambda: _logistic(linear=True),
                      "rosenbrock": _rosenbrock}[problem]()
    want = jax.jit(lambda x: jax_lbfgs(jfun, x, **kw))(jnp.asarray(x0))
    got = torch_lbfgs(tfun, torch.as_tensor(x0), **kw)
    assert got.num_iterations == int(want.num_iterations)
    assert got.num_funcalls == int(want.num_funcalls)
    assert got.converged == bool(want.converged)
    assert got.line_search_failed == bool(want.line_search_failed)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=X_TOL)
    np.testing.assert_allclose(got.f, float(want.f), rtol=1e-12, atol=1e-12)
    # one sync for the start, one per objective call after it, and two per
    # iteration (the descent test; the curvature pair and stopping test)
    assert got.host_syncs == got.num_funcalls + 2 * got.num_iterations
    if kw.get("maxiter") == 7:
        assert got.num_iterations == 7 and not got.converged


def test_converged_start_takes_no_step():
    _, tfun, x0 = _quadratic()
    A_opt = torch_lbfgs(tfun, torch.as_tensor(x0), pgtol=1e-12).x
    res = torch_lbfgs(tfun, A_opt, pgtol=1e-6)
    assert res.num_iterations == 0 and res.num_funcalls == 1
    assert res.converged and res.host_syncs == 1
