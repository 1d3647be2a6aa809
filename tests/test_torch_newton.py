"""Port parity for the random-effect Newton solvers: gdmix_tpu_torch.ops
(newton — primal and sample-space dual —, dual_variance, newton_lanes)
against the JAX package on the same numpy inputs.
The port runs its plain PyTorch versions here (CPU tensors); the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gdmix_tpu.ops.newton import densify_bucket as jax_densify
from gdmix_tpu.ops.newton import dual_variance as jax_dual_variance
from gdmix_tpu.ops.newton import newton_lr_batch as jax_newton
from gdmix_tpu.ops.pallas.newton_lanes import _fgd_call
from gdmix_tpu.ops.pallas.newton_lanes import \
    newton_lr_batch_lanes as jax_lanes
from gdmix_tpu_torch.ops import newton_lanes
from gdmix_tpu_torch.ops.newton import (densify_bucket, dual_variance,
                                        newton_lr_batch)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _problem(B, n, dim, seed, dtype=np.float64):
    """Ragged per-entity problems with both classes in every entity's real
    rows (an all-one-class entity with an unregularized intercept has an
    unbounded optimum)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(B, n, dim - 1) * 0.8
    X = np.concatenate([np.ones((B, n, 1)), X], axis=-1)
    counts = rng.randint(2, n + 1, B)
    w = (np.arange(n)[None, :] < counts[:, None]) \
        * rng.uniform(0.5, 2.0, (B, n))
    off = rng.randn(B, n) * 0.3
    z = np.einsum("bnd,bd->bn", X, rng.randn(B, dim)) + off
    y = (rng.uniform(size=(B, n)) < 1 / (1 + np.exp(-z))).astype(np.float64)
    y[:, 0] = 1.0
    y[:, 1] = 0.0
    return tuple(a.astype(dtype) for a in (X, y, w, off, counts))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,n,dim,unreg", [(40, 8, 7, True),
                                           (64, 16, 25, False),
                                           (33, 32, 40, True)])
def test_newton_lr_batch_f64_matches_jax(B, n, dim, unreg):
    X, y, w, off, cnt = _problem(B, n, dim, seed=B)
    mask = np.ones(dim)
    if unreg:
        mask[0] = 0.0
    kw = dict(l2_reg_weight=0.7, maxiter=100, ftol=1e-14, pgtol=1e-9)
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_mask=jnp.asarray(mask), **kw)
    got = newton_lr_batch(*_torch(th0, X, y, w, off, cnt),
                          l2_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.num_iterations.numpy(),
                                  np.asarray(want.num_iterations))
    assert got.converged.all()


def _well_posed(X, w, cnt):
    """Entities whose unregularized intercept problem is well determined:
    at least 4 real rows (the f32 parity bound is stated on these, as the
    JAX package states its lanes-vs-batch-major bound)."""
    return cnt >= 4


# f32 plain K1 vs the JAX lanes kernel: measured max |Δθ| 2.1e-4 at these
# shapes (bound 5e-3, the JAX package's own lanes-vs-batch-major bound)
@pytest.mark.parametrize("B,n,dim,unreg", [(130, 8, 25, True),
                                           (64, 16, 25, False),
                                           (40, 32, 17, True)])
def test_newton_full_plain_f32_matches_pallas_interpret(B, n, dim, unreg):
    X, y, w, off, cnt = _problem(B, n, dim, seed=3 * B, dtype=np.float32)
    kw = dict(maxiter=100, ftol=1e-12, pgtol=1e-5)
    th0 = np.zeros((B, dim), np.float32)
    want = jax_lanes(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                     l2_reg_weight=1.0, unreg_bias=unreg, interpret=True,
                     **kw)
    th, conv, iters = newton_lanes.newton_full(
        *_torch(th0, X, y, w, off, cnt), lam=1.0, unreg_bias=unreg, **kw)
    assert th.dtype == torch.float32 and iters.dtype == torch.int32
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want.converged))
    ok = _well_posed(X, w, cnt) & conv.numpy()
    err = np.abs(th.numpy() - np.asarray(want.theta))[ok].max()
    assert err <= 5e-3, err


def test_newton_full_plain_f64_reaches_jax_optimum():
    """Plain K1 in float64 at a tight pgtol lands on the optimum the JAX
    batch-major solver finds in float64: the algorithm, apart from f32
    rounding."""
    B, n, dim = 48, 16, 13
    X, y, w, off, cnt = _problem(B, n, dim, seed=11)
    mask = np.ones(dim)
    mask[0] = 0.0
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_reg_weight=0.5, l2_mask=jnp.asarray(mask),
                      maxiter=100, ftol=1e-16, pgtol=1e-10)
    th, conv, _ = newton_lanes.newton_full_plain(
        *_torch(th0, X, y, w, off, cnt), lam=0.5, unreg_bias=True,
        maxiter=100, ftol=1e-16, pgtol=1e-10)
    assert conv.all()
    np.testing.assert_allclose(th.numpy(), np.asarray(want.theta), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("n,dim,unreg", [(64, 25, True), (512, 9, False)])
def test_newton_fgd_plain_matches_pallas_interpret(n, dim, unreg):
    """One iteration's (f, g_scaled, δ) against the JAX _fgd_kernel, fed
    its lanes-last layout (d padded to 8, B to 128)."""
    B = 128
    X, y, w, off, cnt = _problem(B, n, dim, seed=n, dtype=np.float32)
    th = (np.random.RandomState(1).randn(B, dim) * 0.3).astype(np.float32)
    d = dim + (-dim) % 8
    Xl = np.zeros((n, d, B), np.float32)
    Xl[:, :dim, :] = X.transpose(1, 2, 0)
    thl = np.zeros((d, B), np.float32)
    thl[:dim] = th.T
    call = _fgd_call(n, d, dim, B, 0.8, unreg, True)
    f, g, delta = call(jnp.asarray(Xl), jnp.asarray(y.T), jnp.asarray(w.T),
                       jnp.asarray(off.T), jnp.asarray(cnt[None, :]),
                       jnp.asarray(thl))
    got_f, got_g, got_d = newton_lanes.newton_fgd(
        *_torch(X, y, w, off, cnt, th), lam=0.8, unreg_bias=unreg)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(f)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(g)[:dim].T,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(delta)[:dim].T,
                               rtol=1e-3, atol=1e-4)


def test_lanes_dispatch_fgd_path_matches_jax():
    """n·d8 > 1024 routes newton_lr_batch_lanes through the per-iteration
    form (plain fgd on the CPU); same result as the JAX lanes path."""
    B, n, dim = 24, 64, 25
    X, y, w, off, cnt = _problem(B, n, dim, seed=5, dtype=np.float32)
    th0 = np.zeros((B, dim), np.float32)
    kw = dict(l2_reg_weight=1.0, unreg_bias=True, maxiter=60, ftol=1e-12,
              pgtol=1e-5)
    want = jax_lanes(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                     interpret=True, **kw)
    got = newton_lanes.newton_lr_batch_lanes(
        *_torch(th0, X, y, w, off, cnt), **kw)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=5e-3)


def test_densify_bucket_accumulates_duplicates():
    rng = np.random.RandomState(2)
    B, n, K, u_cap = 6, 5, 4, 7
    idx = rng.randint(0, u_cap, (B, n, K)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]           # every record repeats an index
    val = rng.randn(B, n, K)
    for has_icpt in (True, False):
        want = np.asarray(jax_densify(jnp.asarray(idx), jnp.asarray(val),
                                      u_cap, has_icpt))
        got = densify_bucket(torch.from_numpy(idx), torch.from_numpy(val),
                             u_cap, has_icpt).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
        off = 1 if has_icpt else 0
        j = idx[0, 0, 0]
        dup = sum(val[0, 0, k] for k in range(K) if idx[0, 0, k] == j)
        np.testing.assert_allclose(got[0, 0, off + j], dup, rtol=1e-14)


def _wide(B, n, dim, seed, pad_lanes=0):
    """Samples-per-entity < dim (the dual's regime), float64, with
    `pad_lanes` all-zero padding lanes at the end (weight 0, count 0)."""
    X, y, w, off, cnt = _problem(B, n, dim, seed)
    if pad_lanes:
        X[-pad_lanes:] = 0.0
        w[-pad_lanes:] = 0.0
        cnt[-pad_lanes:] = 0
    return X, y, w, off, cnt.astype(np.float64)


def _objective(theta, X, y, w, off, cnt, lam, mask):
    z = np.einsum("bnd,bd->bn", X, theta) + off
    bce = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
    return (np.sum(w * bce, 1) + 0.5 * lam * np.sum(mask * theta ** 2, 1)) \
        / np.maximum(cnt, 1.0)


# both sides solve the n×n system by Cholesky in float64: θ to 1e-8. At
# λ = 0 with n < dim the minimizer is not unique (the loss sees only Xθ)
# and the two land on different points of the flat valley: there the
# objective values must agree, to 1e-12
@pytest.mark.parametrize("lam,reg_bias", [(0.5, False), (0.0, False),
                                          (1.0, True)])
def test_dual_newton_f64_matches_jax(lam, reg_bias):
    B, n, dim = 12, 8, 21
    X, y, w, off, cnt = _wide(B, n, dim, seed=int(10 * lam) + 3,
                              pad_lanes=2)
    mask = np.ones(dim)
    if not reg_bias:
        mask[0] = 0.0
    kw = dict(l2_reg_weight=lam, maxiter=60, ftol=1e-14, pgtol=1e-10,
              dual=True)
    th0 = np.zeros((B, dim))
    want = jax_newton(*(jnp.asarray(a) for a in (th0, X, y, w, off, cnt)),
                      l2_mask=jnp.asarray(mask), **kw)
    got = newton_lr_batch(*_torch(th0, X, y, w, off, cnt),
                          l2_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.num_iterations.numpy(),
                                  np.asarray(want.num_iterations))
    if lam > 0:
        np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                                   rtol=0, atol=1e-8)
    else:
        np.testing.assert_allclose(
            _objective(got.theta.numpy(), X, y, w, off, cnt, lam, mask),
            _objective(np.asarray(want.theta), X, y, w, off, cnt, lam, mask),
            rtol=0, atol=1e-12)
    assert got.converged.all()
    assert (got.num_iterations.numpy()[-2:] == 0).all()   # padded lanes


def test_dual_newton_plain_kernel_solve_matches_cholesky(monkeypatch):
    """The dual step through K4's plain version (the solve a card runs for
    n ≤ 128) lands where the Cholesky route does."""
    from gdmix_tpu_torch.ops import newton as tn
    B, n, dim = 10, 6, 15
    X, y, w, off, cnt = _wide(B, n, dim, seed=8)
    mask = np.ones(dim)
    mask[0] = 0.0
    args = _torch(np.zeros((B, dim)), X, y, w, off, cnt)
    kw = dict(l2_reg_weight=0.8, l2_mask=torch.from_numpy(mask), maxiter=60,
              ftol=1e-14, pgtol=1e-10, dual=True)
    chol = newton_lr_batch(*args, **kw)
    calls = []

    def kernel_route(L, rhs):
        K = L @ L.mT
        calls.append(K.shape)
        return tn.spd_solve_batched_mrhs(K, rhs)
    monkeypatch.setattr(tn, "_cho_solve_batched", kernel_route)
    gj = newton_lr_batch(*args, **kw)
    assert calls and calls[0] == (B, n, n)
    np.testing.assert_allclose(gj.theta.numpy(), chol.theta.numpy(),
                               rtol=0, atol=1e-8)


# same sample-space formulas, Cholesky on both sides: 1e-10 relative
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("reg_bias", [False, True])
def test_dual_variance_matches_jax(full, reg_bias):
    B, n, dim = 6, 7, 16
    X, y, w, off, _ = _wide(B, n, dim, seed=7)
    theta = 0.3 * np.random.RandomState(11).randn(B, dim)
    mask = np.ones(dim)
    if not reg_bias:
        mask[0] = 0.0
    kw = dict(l2_reg_weight=0.7, full=full, epsilon=1e-9)
    want = np.asarray(jax_dual_variance(
        *(jnp.asarray(a) for a in (theta, X, y, w, off)),
        l2_mask=jnp.asarray(mask), **kw))
    got = dual_variance(*_torch(theta, X, y, w, off),
                        l2_mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert (got > 0).all()
