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
from gdmix_tpu_torch.ops.linsolve import (gj_solve_plain, ldlt_solve_plain,
                                          spd_solve_batched,
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
    (308, 1, 4, True), (309, 1, 4, False), (208, 1, 8, True),
    (209, 1, 8, False), (128, 2, 8, True), (256, 1, 8, False)])
def test_workspace_only_past_shared_memory(d, r, item, fits):
    """A system goes to a device-memory workspace exactly when its packed
    lower triangle, the two [NB, d] panels and Y [d, r] outgrow the 227 KB
    a block may opt into."""
    like = torch.empty(0, dtype=torch.float32 if item == 4
                       else torch.float64)
    ws = linsolve._workspace(3, d, r, like)
    assert (ws is None) == fits
    r4 = lambda x: (x + 3) // 4 * 4
    elems = r4(d * (d + 1) // 2) + 2 * linsolve.NB * r4(d) + r4(d * r)
    assert linsolve._workspace_elems(d, r) == elems
    assert (item * (elems + linsolve.NB * (linsolve.NB + 1))
            <= linsolve.SMEM_OPTIN) == fits
    if ws is not None:
        assert ws.shape == (3, elems) and ws.dtype == like.dtype


def _jax_solve(H, R):
    if R.shape[2] == 1:
        return np.asarray(jax_solve(jnp.asarray(H), jnp.asarray(R[..., 0]),
                                    interpret=True))[..., None]
    return np.asarray(jax_solve_mrhs(jnp.asarray(H), jnp.asarray(R),
                                     interpret=True))


# The kernel's panel-blocked LDLᵀ (its plain mirror) against the TPU
# kernels' Gauss–Jordan, at d that no panel width divides and across a
# panel boundary (37 at nb = 8). Tolerances as above: f64 both solves are
# rounding-level apart; f32 as the Gauss–Jordan tests of this file
@pytest.mark.parametrize("dtype,tol1,tolr", [(np.float64, 1e-10, 1e-10),
                                             (np.float32, 2e-5, 1e-4)])
@pytest.mark.parametrize("B,d,r,nb", [(130, 13, 1, 16), (64, 29, 2, 16),
                                      (40, 40, 3, 16), (32, 37, 2, 8),
                                      (16, 37, 1, 8), (8, 40, 3, 32)])
def test_ldlt_plain_matches_pallas_interpret(B, d, r, nb, dtype, tol1, tolr):
    H, _ = _spd(B, d, seed=B + d + r, dtype=dtype)
    R = np.random.RandomState(d + r).randn(B, d, r).astype(dtype)
    want = _jax_solve(H, R)
    got = ldlt_solve_plain(torch.from_numpy(H), torch.from_numpy(R), nb)
    assert got.dtype == torch.from_numpy(H).dtype and got.shape == (B, d, r)
    tol = tol1 if r == 1 else tolr
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_ldlt_plain_reads_only_the_lower_triangle():
    H, g = _spd(8, 21, seed=3, dtype=np.float64)
    Hl = np.tril(H) + np.triu(np.full_like(H, np.nan), 1)
    R = torch.from_numpy(g[..., None])
    got = ldlt_solve_plain(torch.from_numpy(Hl), R)
    np.testing.assert_allclose(got.numpy(),
                               ldlt_solve_plain(torch.from_numpy(H), R),
                               rtol=0, atol=0)


@pytest.mark.parametrize("d", [13, 29, 40])
def test_ldlt_plain_badly_conditioned_damped(d):
    """Eigenvalues over 1e-6…1e6 plus the primal Newton's own damping in
    float64, eps·(1 + |diag|) with eps = 1e-10 (ops/newton.py:94, :114-116):
    cond ≈ 2.4e11. Both solves stay finite. Two backward-stable solves may
    sit cond·ε apart here; these measure ≤ 1.2e-6 apart (each ≤ 1.9e-6
    from LAPACK's LU), so they must agree within 1e-5 relative, and LDLᵀ is
    no less accurate than Gauss–Jordan against that LU (within 10×). The
    residual max|H·x − R| / (max|H|·max|x|), which conditioning does not
    enlarge, measures ≤ 4e-16 for both: each must be within 1e-12."""
    rng = np.random.RandomState(d)
    B = 16
    V = np.linalg.qr(rng.randn(B, d, d))[0]
    H = np.einsum("bij,j,bkj->bik", V, np.logspace(-6, 6, d), V)
    H = (H + H.transpose(0, 2, 1)) / 2
    diag = np.arange(d)
    H[:, diag, diag] += 1e-10 * (1.0 + np.abs(H[:, diag, diag]))
    R = rng.randn(B, d, 2)
    want = _jax_solve(H, R)
    got = ldlt_solve_plain(torch.from_numpy(H), torch.from_numpy(R)).numpy()
    lu = np.linalg.solve(H, R)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = np.abs(lu).max()
    assert np.abs(got - want).max() / scale <= 1e-5
    assert (np.abs(got - lu).max()
            <= 10 * np.abs(want - lu).max() + 1e-14 * scale)
    for x in (got, want):
        resid = np.abs(np.einsum("bij,bjr->bir", H, x) - R).max()
        assert resid / (np.abs(H).max() * np.abs(x).max()) <= 1e-12
