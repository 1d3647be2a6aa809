"""Port parity: the batched SPD solves of gdmix_tpu_torch.ops.linsolve (their
plain PyTorch versions, which the wrappers take on a CPU tensor) against the
JAX package's Pallas solves in interpret mode, on the same numpy inputs."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gdmix_tpu.ops.pallas.linsolve import spd_solve_batched as jax_solve
from gdmix_tpu.ops.pallas.linsolve import \
    spd_solve_batched_mrhs as jax_solve_mrhs
from gdmix_tpu_torch.ops import linsolve
from gdmix_tpu_torch.ops.linsolve import (gj_solve_plain, spd_solve_batched,
                                          spd_solve_batched_mrhs)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _spd(B, d, seed, dtype):
    rng = np.random.RandomState(seed)
    Q = rng.randn(B, d, d)
    H = np.einsum("bij,bkj->bik", Q, Q) / d + np.eye(d)[None]
    return H.astype(dtype), rng.randn(B, d).astype(dtype)


# f64: both are the same unpivoted elimination, rounding-level apart;
# f32: the conditioning of H/d + I bounds the float32 error near 1e-5
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 2e-5)])
@pytest.mark.parametrize("B,d", [(4, 8), (130, 13), (256, 40)])
def test_plain_matches_pallas_interpret(B, d, dtype, tol):
    H, g = _spd(B, d, seed=B + d, dtype=dtype)
    want = np.asarray(jax_solve(jnp.asarray(H), jnp.asarray(g),
                                interpret=True))
    got = spd_solve_batched(torch.from_numpy(H), torch.from_numpy(g))
    assert got.dtype == torch.from_numpy(H).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_plain_matches_numpy_solve():
    H, g = _spd(64, 29, seed=7, dtype=np.float64)
    got = gj_solve_plain(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    want = np.linalg.solve(H, g[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_plain_leaves_inputs_untouched():
    H, g = _spd(8, 5, seed=1, dtype=np.float64)
    Ht, gt = torch.from_numpy(H.copy()), torch.from_numpy(g.copy())
    spd_solve_batched(Ht, gt)
    np.testing.assert_array_equal(Ht.numpy(), H)
    np.testing.assert_array_equal(gt.numpy(), g)


# K4's plain version: the (B, d, r) grid of tests/test_pallas_linsolve.py.
# f64: the same unpivoted elimination, rounding-level apart; f32: the
# conditioning of H/d + I bounds the float32 error well inside 1e-4
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-4)])
@pytest.mark.parametrize("B,d,r", [(4, 8, 2), (130, 13, 3), (200, 29, 2)])
def test_mrhs_plain_matches_pallas_interpret(B, d, r, dtype, tol):
    H, _ = _spd(B, d, seed=B + r, dtype=dtype)
    R = np.random.RandomState(d).randn(B, d, r).astype(dtype)
    want = np.asarray(jax_solve_mrhs(jnp.asarray(H), jnp.asarray(R),
                                     interpret=True))
    got = spd_solve_batched_mrhs(torch.from_numpy(H), torch.from_numpy(R))
    assert got.dtype == torch.from_numpy(H).dtype and got.shape == (B, d, r)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("d,r,item,fits", [
    (240, 1, 4, True), (241, 1, 4, False), (169, 1, 8, True),
    (170, 1, 8, False), (128, 2, 8, True), (256, 1, 4, False)])
def test_workspace_only_past_shared_memory(d, r, item, fits):
    """[H | R] goes to a global-memory workspace exactly when its
    odd-strided rows outgrow the 227 KB a block may opt into."""
    like = torch.empty(0, dtype=torch.float32 if item == 4
                       else torch.float64)
    ws = linsolve._workspace(3, d, r, like)
    assert (ws is None) == fits
    assert (item * d * ((d + r) | 1) <= linsolve.SMEM_OPTIN) == fits
    if ws is not None:
        assert ws.shape == (3, d, (d + r) | 1) and ws.dtype == like.dtype
