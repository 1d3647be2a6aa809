"""Port parity of the fixed-effect data term: gdmix_tpu_torch's plain FE
versions (the CPU side of ops/fe_loss_grad.py's wrappers) against the JAX
package's XLA objective and each of its FE Pallas kernels run in interpret
mode, as tests/test_fe_pallas_kernel.py runs them. Inputs are made from a
numpy seed and handed to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.ops import logistic as jl
from gdmix_tpu_torch.ops import fe_loss_grad as fe
from gdmix_tpu_torch.ops import logistic as tl

# float64 on both sides, same math, different summation order
F64_RTOL = 1e-12
# the JAX kernels compute in float32: the bound their own tests hold them to
# against the XLA objective (tests/test_fe_pallas_kernel.py)
KERNEL_LOSS_RTOL, KERNEL_GRAD_TOL = 1e-4, 1e-3

N, D, K = 1024, 300, 5


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _data(n=N, d=D, k=K, seed=0, linear=False, pad_rows=0):
    """Padded COO records: ~30% zero-valued entries, last `pad_rows` rows
    are padding (weight 0, value 0, arbitrary ids)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, (n, k)).astype(np.int32)
    val = rng.randn(n, k) * (rng.rand(n, k) < 0.7)
    y = rng.randn(n) if linear else (rng.rand(n) < 0.5).astype(np.float64)
    w = rng.rand(n) + 0.5
    off = 0.3 * rng.randn(n)
    if pad_rows:
        w[-pad_rows:] = 0.0
        val[-pad_rows:] = 0.0
    return dict(idx=idx, val=val, y=y, w=w, off=off,
                x=rng.randn(d + 1) * 0.2)


def _torch(a, dtype=torch.float64):
    return torch.as_tensor(a, dtype=torch.int32 if a.dtype == np.int32
                           else dtype)


def _port(dd, d=D, has_intercept=True, linear=False, fn=None,
          dtype=torch.float64):
    x = dd["x"] if has_intercept else dd["x"][:-1]
    fn = fn or fe.fe_loss_grad_fused
    kw = {} if fn is fe.fe_loss_grad_flat else dict(
        has_intercept=has_intercept)
    v, g = fn(_torch(x, dtype), _torch(dd["idx"]), _torch(dd["val"], dtype),
              _torch(dd["y"], dtype), _torch(dd["w"], dtype),
              _torch(dd["off"], dtype), d, linear=linear, **kw)
    return float(v), g.double().numpy()


def _jax_xla(dd, d=D, has_intercept=True, linear=False):
    x = dd["x"] if has_intercept else dd["x"][:-1]
    batch = jl.SparseBatch(*(jnp.asarray(dd[k])
                             for k in ("idx", "val", "off", "y", "w")))
    v, g = jl.fixed_effect_value_and_grad(
        jnp.asarray(x), batch, d, has_intercept=has_intercept,
        regularize_bias=True, l2_reg_weight=0.0,
        model_type="linear_regression" if linear else "logistic_regression")
    return float(v), np.asarray(g)


def _close(got, want, rtol_v, tol_g):
    (v, g), (v_ref, g_ref) = got, want
    np.testing.assert_allclose(v, v_ref, rtol=rtol_v)
    np.testing.assert_allclose(g, g_ref, rtol=tol_g,
                               atol=tol_g * np.abs(g_ref).max())


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("has_intercept", [True, False])
def test_plain_matches_jax_objective(linear, has_intercept):
    dd = _data(seed=1, linear=linear)
    _close(_port(dd, has_intercept=has_intercept, linear=linear),
           _jax_xla(dd, has_intercept=has_intercept, linear=linear),
           F64_RTOL, F64_RTOL)


def _jax_kernel(name, dd, linear):
    from gdmix_tpu.ops.pallas.fe_block import fe_loss_grad_block_pallas
    from gdmix_tpu.ops.pallas.fe_flat import fe_loss_grad_flat_pallas
    from gdmix_tpu.ops.pallas.fe_gather import fe_loss_grad_gather_pallas
    from gdmix_tpu.ops.pallas.fe_grad import fe_loss_grad_pallas
    kernels = {
        "fe_grad": (fe_loss_grad_pallas, {}),
        "fe_block": (fe_loss_grad_block_pallas,
                     dict(tile=1024, precision_name="high")),
        "fe_gather": (fe_loss_grad_gather_pallas,
                      dict(tile=512, precision_name="high")),
        "fe_flat": (fe_loss_grad_flat_pallas,
                    dict(tile=512, precision_name="high")),
    }
    fn, kw = kernels[name]
    v, g = fn(jnp.asarray(dd["x"], jnp.float32), jnp.asarray(dd["idx"]),
              jnp.asarray(dd["val"]), jnp.asarray(dd["y"]),
              jnp.asarray(dd["w"]), jnp.asarray(dd["off"]), D,
              linear=linear, interpret=True, **kw)
    return float(v), np.asarray(g, np.float64)


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("kernel",
                         ["fe_grad", "fe_block", "fe_gather", "fe_flat"])
def test_plain_matches_jax_pallas_kernels(kernel, linear):
    """K5–K11 in interpret mode against the port's fused plain version and
    its flat plain pair, both in float32 as the kernels compute."""
    dd = _data(seed=2, linear=linear, pad_rows=24)
    want = _jax_kernel(kernel, dd, linear)
    fused = _port(dd, linear=linear, dtype=torch.float32)
    flat = _port(dd, linear=linear, fn=fe.fe_loss_grad_flat,
                 dtype=torch.float32)
    _close(fused, want, KERNEL_LOSS_RTOL, KERNEL_GRAD_TOL)
    _close(flat, want, KERNEL_LOSS_RTOL, KERNEL_GRAD_TOL)


@pytest.mark.parametrize("linear", [False, True])
def test_flat_pair_equals_fused_plain(linear):
    dd = _data(seed=3, linear=linear)
    _close(_port(dd, linear=linear, fn=fe.fe_loss_grad_flat),
           _port(dd, linear=linear), F64_RTOL, F64_RTOL)


@pytest.mark.parametrize("fn", ["fused", "flat"])
def test_padding_rows_inert(fn):
    """Rows of weight 0 with value-0 entries (at any ids) change nothing:
    the padded batch gives the unpadded one's loss and gradient."""
    fn = {"fused": fe.fe_loss_grad_fused, "flat": fe.fe_loss_grad_flat}[fn]
    dd = _data(seed=4, pad_rows=300)
    head = {k: (v[:N - 300] if k != "x" else v) for k, v in dd.items()}
    _close(_port(dd, fn=fn), _port(head, fn=fn), F64_RTOL, F64_RTOL)
    _close(_port(dd, fn=fn), _jax_xla(head), F64_RTOL, F64_RTOL)


def test_intercept_only():
    """The intercept-only batch of FixedEffectLRModel._host_arrays: [n, 8]
    zero ids with value 0 and one dummy feature."""
    dd = _data(seed=5)
    dd.update(idx=np.zeros((N, 8), np.int32), val=np.zeros((N, 8)),
              x=np.array([0.0, 0.4]))
    for fn in (fe.fe_loss_grad_fused, fe.fe_loss_grad_flat):
        got = _port(dd, d=1, fn=fn)
        _close(got, _jax_xla(dd, d=1), F64_RTOL, F64_RTOL)
        assert got[1][0] == 0.0


@pytest.mark.parametrize("has_intercept", [True, False])
@pytest.mark.parametrize("at_end", [True, False])
def test_scorer_hessians_l2_match_jax(has_intercept, at_end):
    dd = _data(n=256, d=40, seed=6)
    theta = dd["x"][:41] if has_intercept else dd["x"][:40]
    jb = jl.SparseBatch(*(jnp.asarray(dd[k])
                          for k in ("idx", "val", "off", "y", "w")))
    tb = tl.SparseBatch(*(_torch(dd[k])
                          for k in ("idx", "val", "off", "y", "w")))
    kw = dict(has_intercept=has_intercept, intercept_at_end=at_end)
    pairs = [
        (tl.predict_logits(_torch(theta), tb, **kw),
         jl.predict_logits(jnp.asarray(theta), jb, **kw)),
        (tl.hessian_diag(_torch(theta), tb, 40, **kw),
         jl.hessian_diag(jnp.asarray(theta), jb, 40, **kw)),
        (tl.hessian_full(_torch(theta), tb, 40, **kw),
         jl.hessian_full(jnp.asarray(theta), jb, 40, **kw)),
    ]
    for reg_bias in (True, False):
        if reg_bias and not has_intercept:
            continue
        lw = dict(has_intercept=has_intercept, regularize_bias=reg_bias,
                  intercept_at_end=at_end)
        pairs += list(zip(tl.l2_value_and_grad(_torch(theta), 0.7, **lw),
                          jl.l2_value_and_grad(jnp.asarray(theta), 0.7,
                                               **lw)))
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=F64_RTOL,
                                   atol=F64_RTOL * np.abs(want).max())


def test_cpu_wrappers_take_the_plain_versions_without_counting():
    dd = _data(n=64, seed=7)
    before = (fe.fe_loss_grad_fused.launches, fe.fe_gather_entries.launches,
              fe.fe_scatter_entries.launches)
    _port(dd)
    _port(dd, fn=fe.fe_loss_grad_flat)
    assert (fe.fe_loss_grad_fused.launches, fe.fe_gather_entries.launches,
            fe.fe_scatter_entries.launches) == before
