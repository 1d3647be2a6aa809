"""The plain reference against independent arithmetic at tiny sizes."""
import numpy as np
import torch

from benchmark import gen
from benchmark.reference.fe_objective import Objective
from benchmark.reference.lbfgs import lbfgs
from benchmark.reference.precision import tf32_round
from benchmark.reference.re_newton import solve_entities

T = {"entities": 300, "pareto_a": 1.5, "count_lo": 2, "count_hi": 64,
     "genres_lo": 1, "genres_hi": 3, "year_lo": 0.92, "year_hi": 1.0,
     "user_sd": 1.5, "effect_sd": 0.5, "offset_sd": 0.1}


def _dense(d, e, width):
    starts = np.concatenate([[0], np.cumsum(d.counts)[:-1]])
    rows = np.arange(starts[e], starts[e] + d.counts[e])
    X = np.zeros((len(rows), width + 1))
    X[:, 0] = 1
    for r, row in enumerate(rows):
        for k in range(d.nnz[row]):
            X[r, 1 + d.indices[row, k]] += d.values[row, k]
    return X, d.labels[rows], d.offsets[rows]


def test_entity_optima_have_zero_gradient():
    d = gen.re_fleet(T, 20, 4)
    s = solve_entities(d.counts, d.labels, d.offsets, d.indices, d.values,
                       d.nnz, 20, lam=1.0, regularize_bias=False,
                       maxiter=100, ftol=1e-12, pgtol=1e-5,
                       device=torch.device("cpu"), block_rows=500)
    assert s.converged.all() and (s.iterations >= 1).all()
    mask = np.ones(21)
    mask[0] = 0
    for e in range(0, 300, 7):
        X, y, o = _dense(d, e, 20)
        p = 1 / (1 + np.exp(-(X @ s.theta[e] + o)))
        g = X.T @ (p - y) + mask * s.theta[e]
        if s.mixed[e]:
            assert np.abs(g).max() < 1e-8, (e, g)
        else:        # one label only: the intercept runs off; no optimum
            assert np.abs(g[1:]).max() < 1e-3
    big = solve_entities(d.counts, d.labels, d.offsets, d.indices, d.values,
                         d.nnz, 20, lam=1.0, regularize_bias=False,
                         maxiter=100, ftol=1e-12, pgtol=1e-5,
                         device=torch.device("cpu"))
    np.testing.assert_allclose(big.theta[s.mixed], s.theta[s.mixed],
                               atol=1e-9)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      3.0 + 3 * 2 ** -11], dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0, 1.0, 3.0 + 2 ** -9]
    assert tf32_round(x).tolist() == want


def test_fe_objective_and_lbfgs():
    g = torch.Generator().manual_seed(0)
    N, K, D, F = 400, 6, 50, 2
    idx = torch.randint(F, D, (N, K), generator=g, dtype=torch.int32)
    idx[:, :F] = torch.arange(F, dtype=torch.int32)
    val = torch.randn(N, K, generator=g)
    y = (torch.rand(N, generator=g) < 0.3).float()
    w, o = torch.ones(N), 0.1 * torch.randn(N, generator=g)
    obj = Objective(idx, val, y, w, o, D, 1.0, fixed=F, block_rows=64)
    X = torch.zeros(N, D, dtype=torch.float64).scatter_add_(
        1, idx.long(), val.double())
    x = 0.2 * torch.randn(D + 1, generator=g, dtype=torch.float64)
    z = X @ x[:-1] + x[-1] + o.double()
    yy = y.double()
    f = (torch.clamp_min(z, 0) - z * yy + torch.log1p(torch.exp(-z.abs()))
         ).sum() + 0.5 * (x[:-1] ** 2).sum()
    r = torch.sigmoid(z) - yy
    grad = torch.cat([X.T @ r + x[:-1], r.sum()[None]])
    fv, gv = obj(x)
    assert abs(float(fv - f)) < 1e-9
    assert float((gv - grad).abs().max()) < 1e-9
    res = lbfgs(obj, torch.zeros(D + 1, dtype=torch.float64), m=10,
                ftol=0.0, pgtol=1e-9, maxiter=200, snapshots=(1, 2))
    assert float(obj(res["x"])[1].abs().max()) < 1e-6
    assert set(res["snapshots"]) == {1, 2}
