"""Port parity of L-BFGS: gdmix_tpu_torch.ops.lbfgs (a host loop over
tensors) against gdmix_tpu.ops.lbfgs (a lax.while_loop) in float64 on the
same objectives from the same start. The two take the same decisions, so
they must agree on the iteration and funcall counts and the stop flags, and
on x to 1e-8. The batched form (lockstep lanes) is held against JAX's
vmapped solver lane by lane, x to 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.ops import logistic as jl
from gdmix_tpu.ops.lbfgs import lbfgs as jax_lbfgs
from gdmix_tpu.ops.lbfgs import lbfgs_batched as jax_lbfgs_batched
from gdmix_tpu_torch.ops import logistic as tl
from gdmix_tpu_torch.ops.lbfgs import lbfgs as torch_lbfgs
from gdmix_tpu_torch.ops.lbfgs import lbfgs_batched as torch_lbfgs_batched

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


def _quadratic_lanes(B=7, d=9, seed=4):
    """B quadratics with different curvature spectra and start points."""
    rng = np.random.RandomState(seed)
    A = np.empty((B, d, d))
    for b in range(B):
        Q = rng.randn(d, d)
        A[b] = Q @ Q.T / d + np.diag(np.geomspace(0.2, 5.0 * (b + 1), d))
    c = rng.randn(B, d)
    x0 = rng.randn(B, d) * np.arange(B)[:, None]   # lane 0 starts at 0
    return A, c, x0


def _logistic_lanes(B=6, n=40, d=8, seed=5):
    """Per-lane dense logistic problems of different scales, one lane
    converged at its start (all-zero weights)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(B, n, d) * np.linspace(0.3, 2.0, B)[:, None, None]
    y = (rng.rand(B, n) < 0.5).astype(np.float64)
    w = rng.uniform(0.5, 1.5, (B, n))
    w[-1] = 0.0
    return X, y, w, rng.randn(B, d) * 0.2


# tolerances stop every lane above float64's rounding floor, where a Wolfe
# or stopping test can flip on the last bit of a sum taken in another order
@pytest.mark.parametrize("problem,kw", [
    ("quadratic", dict(pgtol=1e-7, ftol=1e-12)),
    ("quadratic", dict(pgtol=1e-12, ftol=0.0, maxiter=6, m=3)),
    ("logistic", dict(pgtol=1e-7, ftol=1e-11)),
    ("logistic", dict(pgtol=1e-6, ftol=1e-11, m=2, maxls=4)),
])
def test_lbfgs_batched_matches_jax(problem, kw):
    if problem == "quadratic":
        A, c, x0 = _quadratic_lanes()

        def jfun(x, e):
            Ax = e[0] @ x
            return 0.5 * x @ Ax - e[1] @ x, Ax - e[1]
        extra = (jnp.asarray(A), jnp.asarray(c))
        At, ct = torch.as_tensor(A), torch.as_tensor(c)

        def tfun(x):
            Ax = torch.einsum("bij,bj->bi", At, x)
            return 0.5 * torch.sum(x * Ax, 1) - torch.sum(ct * x, 1), Ax - ct
    else:
        X, y, w, x0 = _logistic_lanes()

        def jfun(x, e):
            z = e[0] @ x
            bce = jnp.maximum(z, 0) - z * e[1] + jnp.log1p(jnp.exp(-abs(z)))
            r = e[2] * (jax.nn.sigmoid(z) - e[1])
            return jnp.sum(e[2] * bce) + 0.25 * x @ x, e[0].T @ r + 0.5 * x
        extra = tuple(jnp.asarray(a) for a in (X, y, w))
        Xt, yt, wt = (torch.as_tensor(a) for a in (X, y, w))

        def tfun(x):
            z = torch.einsum("bnd,bd->bn", Xt, x)
            r = wt * (torch.sigmoid(z) - yt)
            return (torch.sum(wt * tl.stable_bce(z, yt), 1)
                    + 0.25 * torch.sum(x * x, 1),
                    torch.einsum("bnd,bn->bd", Xt, r) + 0.5 * x)
    want = jax.jit(lambda x0, e: jax_lbfgs_batched(
        jfun, x0, extra_args=e, **kw))(jnp.asarray(x0), extra)
    got = torch_lbfgs_batched(tfun, torch.as_tensor(x0), **kw)
    np.testing.assert_array_equal(got.num_iterations.numpy(),
                                  np.asarray(want.num_iterations))
    np.testing.assert_array_equal(got.num_funcalls.numpy(),
                                  np.asarray(want.num_funcalls))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.line_search_failed.numpy(),
                                  np.asarray(want.line_search_failed))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-10)
    its = got.num_iterations.numpy()
    if "maxiter" not in kw:                 # lanes stop at different points
        assert len(set(its.tolist())) > 1
    # the host reads "any lane live" once per iteration (plus the final
    # read) and once per line-search trial (plus each search's final read)
    k_max = int(its.max())
    assert got.host_syncs >= 1 + 2 * k_max + int(
        got.num_funcalls.numpy().max()) - 1
    assert got.host_syncs <= 1 + k_max * (2 + kw.get("maxls", 25))


def test_lbfgs_batched_lane_equals_single_problem():
    """Each lane of the lockstep solve is the single-problem solve."""
    A, c, x0 = _quadratic_lanes(B=4, d=6, seed=9)
    At, ct = torch.as_tensor(A), torch.as_tensor(c)

    def tfun(x):
        Ax = torch.einsum("bij,bj->bi", At, x)
        return 0.5 * torch.sum(x * Ax, 1) - torch.sum(ct * x, 1), Ax - ct
    got = torch_lbfgs_batched(tfun, torch.as_tensor(x0), pgtol=1e-7,
                              ftol=1e-12)
    for b in range(4):
        one = torch_lbfgs(lambda x: (0.5 * x @ (At[b] @ x) - ct[b] @ x,
                                     At[b] @ x - ct[b]),
                          torch.as_tensor(x0[b]), pgtol=1e-7, ftol=1e-12)
        assert int(got.num_iterations[b]) == one.num_iterations
        assert int(got.num_funcalls[b]) == one.num_funcalls
        np.testing.assert_allclose(got.x[b].numpy(), one.x.numpy(), rtol=0,
                                   atol=1e-10)
