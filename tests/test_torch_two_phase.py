"""Two-phase Newton with straggler compaction in the port against the JAX
package (gdmix_tpu/models/random_effect_lr.py:235-294
_newton_two_phase_solver, chosen at :887-893), on the CPU: the solver on
bucket arrays made from a numpy seed in float64, with the same lanes
solved again in every case of the prefix ladder; the lane-list form of
the K1/K2 source under tests/cuda_emu against its plain version; train()
on both planes; the gate; the bench and the prewarm tool with two-phase
on."""
import contextlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdmix_tpu.io.model_avro import load_sparse_models_from_avro
from gdmix_tpu.models import random_effect_lr as jax_re
from gdmix_tpu.ops.newton import newton_lr_batch as jax_newton
from gdmix_tpu_torch import bench
from gdmix_tpu_torch.models import random_effect_lr as port_re
from gdmix_tpu_torch.ops import newton_lanes as nl
from gdmix_tpu_torch.ops.newton import (densify_bucket, newton_lr_batch,
                                        newton_two_phase)
from gdmix_tpu_torch.parallel.mesh import get_mesh
from test_random_effect_lr import (_build_model, _ctx, _make_groups,
                                   _scipy_entity_oracle, _write_dataset)
from test_torch_newton import (_emulate, _problem, _torch,  # noqa: F401
                               _well_posed, newton_emulator)
from test_torch_pipeline import AUC_ATOL, _config_dict
from test_torch_pipeline import ml_data  # noqa: F401  (a fixture)
from test_torch_random_effect import _torch_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench as jax_bench  # noqa: E402  (the root bench.py)

_F64_TOL = 1e-8    # θ, float64 on both sides (test_torch_newton's bound)
_MODEL_TOL = 1e-7  # train() models: the JAX package's two-phase bound
_ORACLE_TOL = 2e-5  # against scipy (tests/test_random_effect_lr.py:598)
_F32_TOL = 5e-3    # float32 lanes against their plain version
# the solver's settings in (a): bias unregularised, λ 0.6, stop on the
# gradient alone (ftol 0, pgtol 1e-7), as the port's other float64 parity
# tests do (test_torch_random_effect._STOP_ON_GRADIENT): a stop at
# |g| ~1e-10 or a decrease of 1e-14 falls on rounding noise, where the two
# packages' sums stop a lane an iteration apart (~1e-8 in θ)
_KEY = dict(has_intercept=True, regularize_bias=False, lam=0.6, maxiter=200,
            ftol=0.0, pgtol=1e-7, m=10, variance_mode=None)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


# ---- (a) the solver against JAX's, every case of the ladder ---------------

def _bucket(B, n_cap, u_cap, n_cold, seed, warm_key=_KEY):
    """A bucket's solver arrays (float64, numpy): ragged entities over
    u_cap features, K = 3 entries a record, both classes in every entity.
    All but `n_cold` entities (chosen at random) start at their own
    optimum (solved with `warm_key`), so they pass the gradient test before
    any iteration; the cold ones start at 0 and stay stragglers through a
    few phase-1 iterations."""
    rng = np.random.RandomState(seed)
    K = 3
    counts = rng.randint(6, n_cap + 1, B)
    real = np.arange(n_cap)[None, :] < counts[:, None]
    idx = rng.randint(0, u_cap, (B, n_cap, K)).astype(np.int32)
    val = rng.randn(B, n_cap, K) * real[..., None]
    y = (rng.uniform(size=(B, n_cap)) < 0.5).astype(np.float64)
    y[:, 0], y[:, 1] = 1.0, 0.0
    a = dict(indices=idx, values=val, labels=y,
             weights=real * rng.uniform(0.5, 2.0, (B, n_cap)),
             offsets=rng.randn(B, n_cap) * 0.3 * real,
             sample_count=counts.astype(np.float64),
             theta0=np.zeros((B, u_cap + 1)))
    warm = port_re._newton_solver(u_cap, *warm_key.values())(_port(a))[0]
    cold = rng.choice(B, n_cold, replace=False)
    a["theta0"] = warm.numpy().copy()
    a["theta0"][cold] = 0.0
    return a


def _port(a):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}


_key = _KEY


@contextlib.contextmanager
def _jax_key(key):
    """_jax_order's solver settings are `key` inside the block."""
    global _key
    _key, old = key, _key
    try:
        yield
    finally:
        _key = old


def _jax_order(a, u_cap, phase1):
    """JAX's phase 1 on the bucket, then its order and prefix, as its
    solver computes them (random_effect_lr.py:257-289), with the solver
    settings of `_key` (_KEY unless _jax_key says otherwise)."""
    from gdmix_tpu.ops.newton import densify_bucket as jax_densify
    X = jax_densify(jnp.asarray(a["indices"]), jnp.asarray(a["values"]),
                    u_cap, True)
    mask = np.ones(u_cap + 1)
    mask[0] = 0.0
    res1 = jax_newton(jnp.asarray(a["theta0"]), X, jnp.asarray(a["labels"]),
                      jnp.asarray(a["weights"]), jnp.asarray(a["offsets"]),
                      jnp.asarray(a["sample_count"]),
                      l2_reg_weight=_key["lam"],
                      l2_mask=jnp.asarray(mask), maxiter=phase1,
                      ftol=_key["ftol"], pgtol=_key["pgtol"],
                      static_unreg_bias=True)
    B = X.shape[0]
    order = np.asarray(jnp.argsort(res1.converged))
    n_un = int(np.sum(~np.asarray(res1.converged)))
    sizes, s = [], 64
    while s < B:
        sizes.append(s)
        s *= 2
    sizes.append(B)
    P = sizes[int(np.searchsorted(np.asarray(sizes), n_un))]
    return order, n_un, P


# (B, phase-1 iterations, cold entities, the ladder case n_un must fall in)
_LADDER = [(65, 1, 65, "B"), (65, 2, 0, "0"), (200, 1, 40, "<=64"),
           (200, 3, 100, "65-128"), (300, 2, 300, "B"),
           (300, 3, 100, "65-128"), (300, 1, 0, "0"), (200, 2, 200, "B")]


@pytest.mark.parametrize("B,phase1,n_cold,case", _LADDER)
def test_solver_matches_jax_in_every_ladder_case(B, phase1, n_cold, case):
    """The port's _newton_two_phase_solver against JAX's on one bucket in
    float64: θ to 1e-8 and converged flags equal; the stragglers' count
    falls in the case asked for, and the port solves again the same lanes
    (its order[:P] is JAX's, P from the same ladder)."""
    u_cap = 6
    a = _bucket(B, 12, u_cap, n_cold, seed=B + phase1 + n_cold)
    key = tuple(_KEY.values())
    want = jax_re._newton_two_phase_solver(u_cap, *key, phase1)(
        {k: jnp.asarray(v) for k, v in a.items()})
    th, var, conv = port_re._newton_two_phase_solver(u_cap, *key, phase1)(
        _port(a))
    assert var is None
    np.testing.assert_allclose(th.numpy(), np.asarray(want[0]), rtol=0,
                               atol=_F64_TOL)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want[2]))
    assert conv.all()

    order, n_un, P = _jax_order(a, u_cap, phase1)
    assert {"0": n_un == 0, "<=64": 0 < n_un <= 64,
            "65-128": 64 < n_un <= 128, "B": P == B}[case], (n_un, P)
    t = _port(a)
    mask = torch.ones(u_cap + 1, dtype=torch.float64)
    mask[0] = 0.0
    [res] = newton_two_phase(
        [(t["theta0"],
          densify_bucket(t["indices"], t["values"], u_cap, True),
          t["labels"], t["weights"], t["offsets"], t["sample_count"])],
        l2_reg_weight=_KEY["lam"], l2_mask=mask, phase1_iters=phase1,
        maxiter=_KEY["maxiter"], ftol=_KEY["ftol"], pgtol=_KEY["pgtol"],
        static_unreg_bias=True)
    assert int(res.n_unconverged[0]) == n_un
    assert nl.prefix_size(n_un, B) == P
    np.testing.assert_array_equal(res.order.numpy()[:P], order[:P])
    np.testing.assert_array_equal(res.theta.numpy(), th.numpy())
    # a lane outside the prefix kept phase 1's θ: it was never touched
    X = densify_bucket(t["indices"], t["values"], u_cap, True)
    res1 = newton_lr_batch(t["theta0"], X, t["labels"], t["weights"],
                           t["offsets"], t["sample_count"],
                           l2_reg_weight=_KEY["lam"], l2_mask=mask,
                           maxiter=phase1, ftol=_KEY["ftol"],
                           pgtol=_KEY["pgtol"])
    rest = res.order.numpy()[P:].astype(np.int64)
    np.testing.assert_array_equal(res.theta.numpy()[rest],
                                  res1.theta.numpy()[rest])


# no gradient stop: every lane phase 2 solves again takes one iteration
# more at least, so which lanes the cut takes shows in the iteration
# counts. The warm entities start at |g| ≤ 1e-13, where that iteration
# moves them by rounding noise alone
_CUT_KEY = dict(_KEY, ftol=1e-6, pgtol=0.0)
_CUT_WARM = dict(_KEY, pgtol=1e-13)

# (shards, tier B, phase-1 iterations, cold entities, the ladder case)
_SHARDED_LADDER = [(2, 130, 2, 0, "0"), (2, 200, 1, 40, "<=64"),
                   (8, 200, 3, 100, "65-128"), (8, 320, 2, 320, "B"),
                   (8, 520, 1, 30, "<=64")]


@pytest.mark.parametrize("P,B,phase1,n_cold,case", _SHARDED_LADDER)
def test_sharded_solver_matches_jax_on_the_whole_tier(P, B, phase1, n_cold,
                                                      case):
    """The port's two-phase rung over a tier of P shards (solve.tier, each
    shard's B / P slots its own arrays) against JAX's solver on the whole
    tier's array in float64, decrease stop 1e-6: θ to 1e-8 and converged
    flags equal; the tier's order and straggler count are JAX's, the
    ladder case is the one asked for, and the lanes the shards solved
    again are JAX's order[:P], no more and no fewer."""
    u_cap = 6
    a = _bucket(B, 12, u_cap, n_cold, seed=P + B + phase1 + n_cold,
                warm_key=_CUT_WARM)
    key = tuple(_CUT_KEY.values())
    want = jax_re._newton_two_phase_solver(u_cap, *key, phase1)(
        {k: jnp.asarray(v) for k, v in a.items()})
    solve = port_re._newton_two_phase_solver(u_cap, *key, phase1)
    t = _port(a)
    got = solve.tier([{k: v.view(P, B // P, *v.shape[1:])[s]
                       for k, v in t.items()} for s in range(P)])
    assert all(var is None for _, var, _ in got)
    th = torch.cat([g[0] for g in got]).numpy()
    conv = torch.cat([g[2] for g in got]).numpy()
    np.testing.assert_allclose(th, np.asarray(want[0]), rtol=0,
                               atol=_F64_TOL)
    np.testing.assert_array_equal(conv, np.asarray(want[2]))

    mask = torch.ones(u_cap + 1, dtype=torch.float64)
    mask[0] = 0.0
    X = densify_bucket(t["indices"], t["values"], u_cap, True)
    cols = (t["theta0"], X, t["labels"], t["weights"], t["offsets"],
            t["sample_count"])
    res = newton_two_phase(
        [tuple(c.view(P, B // P, *c.shape[1:])[s] for c in cols)
         for s in range(P)], l2_reg_weight=_CUT_KEY["lam"], l2_mask=mask,
        phase1_iters=phase1, maxiter=_CUT_KEY["maxiter"],
        ftol=_CUT_KEY["ftol"], pgtol=_CUT_KEY["pgtol"],
        static_unreg_bias=True)
    np.testing.assert_array_equal(
        torch.cat([r.theta for r in res]).numpy(), th)
    with _jax_key(_CUT_KEY):
        order, n_un, pre = _jax_order(a, u_cap, phase1)
    assert {"0": n_un == 0, "<=64": 0 < n_un <= 64,
            "65-128": 64 < n_un <= 128, "B": pre == B}[case], (n_un, pre)
    for r in res:
        assert int(r.n_unconverged[0]) == n_un
        np.testing.assert_array_equal(r.order.numpy(), order)
    first = newton_lr_batch(*cols, l2_reg_weight=_CUT_KEY["lam"],
                            l2_mask=mask, maxiter=phase1,
                            ftol=_CUT_KEY["ftol"], pgtol=_CUT_KEY["pgtol"])
    again = torch.cat([r.num_iterations for r in res]) > first.num_iterations
    np.testing.assert_array_equal(np.flatnonzero(again.numpy()),
                                  np.sort(order[:pre]))


def _ladder_cut(flags, b_cap):
    """JAX's cut of a tier in numpy: its stable argsort of the flags and
    its ladder prefix, split by owning shard into local slots."""
    order = np.argsort(flags, kind="stable")
    n_un = int((~flags).sum())
    sizes, s = [], 64
    while s < flags.size:
        sizes.append(s)
        s *= 2
    sizes.append(flags.size)
    pre = order[:sizes[int(np.searchsorted(sizes, n_un))]]
    return order, n_un, [pre[pre // b_cap == s] - s * b_cap
                         for s in range(flags.size // b_cap)]


# (shards, b_cap, stragglers: how many and where)
_CUTS = [(1, 40, 0, "spread"), (1, 200, 50, "spread"), (1, 200, 100, "spread"),
         (1, 200, 200, "spread"), (2, 13, 0, "spread"), (2, 13, 26, "spread"),
         (2, 100, 60, "spread"), (2, 100, 70, "last"), (2, 100, 130, "spread"),
         (8, 13, 0, "spread"), (8, 13, 5, "first"), (8, 40, 64, "last"),
         (8, 40, 65, "spread"), (8, 40, 128, "first"), (8, 40, 129, "spread"),
         (8, 40, 320, "spread"), (8, 24, 3, "last")]


@pytest.mark.parametrize("P,b_cap,n_un,where", _CUTS)
def test_shard_lanes_are_the_jax_cut(P, b_cap, n_un, where):
    """two_phase_shard_lanes against JAX's cut of the concatenated flags
    (numpy's stable argsort and the ladder), integers equal: the tier's
    order and count, and for each shard its lanes of the prefix in prefix
    order, as local slots, and their count; the whole list is a
    permutation of its slots. Every ladder case (n_un 0, ≤ 64, 65–128, all
    of B_t), b_cap not a power of two, and shards that own no lane of the
    prefix (stragglers all on the first or the last shards)."""
    B = P * b_cap
    rng = np.random.RandomState(P * 1000 + b_cap + n_un)
    pick = {"spread": rng.permutation(B)[:n_un], "first": np.arange(n_un),
            "last": np.arange(B - n_un, B)}[where]
    flags = np.ones(B, bool)
    flags[pick] = False
    order, count, lists = nl.two_phase_shard_lanes(
        [torch.from_numpy(f) for f in flags.reshape(P, b_cap)], b_cap)
    want_order, want_n, want_lists = _ladder_cut(flags, b_cap)
    assert order.dtype == count.dtype == torch.int32 and count.shape == (1,)
    np.testing.assert_array_equal(order.numpy(), want_order)
    assert int(count[0]) == want_n == n_un
    assert len(lists) == P
    for (lanes, n_lanes), want in zip(lists, want_lists):
        assert lanes.dtype == n_lanes.dtype == torch.int32
        assert lanes.shape == (b_cap,) and n_lanes.shape == (1,)
        assert int(n_lanes[0]) == want.size
        np.testing.assert_array_equal(lanes.numpy()[:want.size], want)
        np.testing.assert_array_equal(np.sort(lanes.numpy()),
                                      np.arange(b_cap))
    if where != "spread" and n_un <= 64 < B:
        assert any(int(n[0]) == 0 for _, n in lists), "every shard took lanes"
    if P == 1:
        # one shard: two_phase_order's list and prefix_size's count
        o1, n1 = nl.two_phase_order(torch.from_numpy(flags))
        np.testing.assert_array_equal(lists[0][0].numpy(), o1.numpy())
        assert int(lists[0][1][0]) == nl.prefix_size(int(n1[0]), B)


def test_two_phase_order_is_a_stable_argsort():
    """two_phase_order is torch.argsort(converged, stable=True) and the
    stragglers' count, at sizes around a block of the scan."""
    rng = np.random.RandomState(0)
    for B in (0, 1, 5, 64, 65, 1000, 4097):
        conv = torch.from_numpy(rng.uniform(size=B) < 0.7)
        order, n_un = nl.two_phase_order(conv)
        assert order.dtype == n_un.dtype == torch.int32
        assert n_un.shape == (1,) and int(n_un[0]) == int((~conv).sum())
        np.testing.assert_array_equal(
            order.numpy(), torch.argsort(conv.to(torch.uint8),
                                         stable=True).numpy())
        # rows at once (the cut's per-shard form): each row on its own
        rows = torch.from_numpy(rng.uniform(size=(3, B)) < 0.7)
        order, n_un = nl.two_phase_order(rows)
        assert order.shape == (3, B) and n_un.shape == (3, 1)
        for r in range(3):
            o, n = nl.two_phase_order(rows[r])
            assert torch.equal(order[r], o) and torch.equal(n_un[r], n)


@pytest.mark.parametrize("B,n_un,P", [(10, 0, 10), (64, 64, 64),
                                      (65, 0, 64), (65, 64, 64),
                                      (65, 65, 65), (300, 129, 256),
                                      (300, 257, 300), (65536, 3, 64),
                                      (65536, 40000, 65536)])
def test_prefix_size_is_the_jax_ladder(B, n_un, P):
    sizes, s = [], 64
    while s < B:
        sizes.append(s)
        s *= 2
    sizes.append(B)
    assert sizes[int(np.searchsorted(sizes, n_un))] == P
    assert nl.prefix_size(n_un, B) == P
    on_card = nl.prefix_size_on_card(torch.tensor([n_un], dtype=torch.int32),
                                     B)
    assert on_card.dtype == torch.int32 and on_card.shape == (1,)
    assert int(on_card[0]) == P


def test_batch_major_two_phase_matches_lanes_plain_f32():
    """The batch-major two-phase (f32 on the CPU) and the lanes path's
    (newton_two_phase_lanes over the plain version) agree within the f32
    bound, pick the same prefix and count phase 1 + phase 2 iterations."""
    X, y, w, off, cnt = _problem(130, 8, 7, seed=3, dtype=np.float32)
    th0 = np.zeros((130, 7), np.float32)
    args = _torch(th0, X, y, w, off, cnt)
    kw = dict(l2_reg_weight=0.8, phase1_iters=1, maxiter=100, ftol=1e-12,
              pgtol=1e-5)
    mask = torch.ones(7)
    mask[0] = 0.0
    [bm] = newton_two_phase([args], l2_mask=mask, **kw)
    [ln] = nl.newton_two_phase_lanes([args], unreg_bias=True, **kw)
    assert int(bm.n_unconverged[0]) == int(ln.n_unconverged[0]) > 64
    np.testing.assert_array_equal(bm.order.numpy(), ln.order.numpy())
    np.testing.assert_array_equal(bm.converged.numpy(),
                                  ln.converged.numpy())
    ok = _well_posed(X, w, cnt)
    assert np.abs(bm.theta.numpy() - ln.theta.numpy())[ok].max() <= _F32_TOL
    one = newton_lr_batch(args[0], *args[1:], l2_reg_weight=0.8,
                          l2_mask=mask, maxiter=1, ftol=1e-12, pgtol=1e-5)
    assert (ln.num_iterations >= one.num_iterations).all()
    assert int(ln.num_iterations.max()) > 1


# ---- (b) the kernel source over a lane list, emulated ---------------------

_UNTOUCHED = (0x7fc0dead, 0xab, -12345)   # the harness's kUntouched*


# how many of the 70 lanes to solve: none; fewer than any ladder size, as
# a shard's own share of a tier's prefix may be; the ladder's 64 (the
# bucket's prefix for up to 64 stragglers); 66; all of them (B, the
# prefix past 64 stragglers)
@pytest.mark.parametrize("n_lanes", [0, 37, 64, 66, 70])
@pytest.mark.parametrize("form,n,dim", [(0, 8, 25), (1, 40, 9),
                                        (2, 300, 9)])
def test_kernel_lanes_emulated_matches_plain(newton_emulator, form, n, dim,
                                             n_lanes):
    """K1 (form 0) and K2 (1 resident, 2 streamed) from their CUDA source
    over the first n_lanes of a permuted lane list of 70 entities, against
    the plain version over the same list. Inside the count: models within
    the f32 bound, converged flags equal, iterations within 1. Past it: the
    kernel writes nothing (the harness's sentinel bits stay, bit for bit),
    and the plain version returns θ0, converged, 0 iterations."""
    B = 70
    X, y, w, off, cnt = _problem(B, n, dim, seed=form + n_lanes,
                                 dtype=np.float32)
    th0 = (np.random.RandomState(n_lanes).randn(B, dim) * 0.2).astype(
        np.float32)
    # most entities padding (count 0, weight 0, θ0 0: done at the gradient
    # test), 8 real ones spread through the list, 3 of them past slot 64
    lanes = np.random.RandomState(form).permutation(B).astype(np.int32)
    real = np.zeros(B, bool)
    real[lanes[[0, 9, 31, 50, 63, 64, 67, 69]]] = True
    X[~real], w[~real], cnt[~real], th0[~real] = 0.0, 0.0, 0.0, 0.0
    th, conv, iters = _emulate(newton_emulator, form,
                               (th0, X, y, w, off, cnt), lam=0.8, unreg=True,
                               lanes=lanes, n_lanes=n_lanes)
    conv = np.fromfile(newton_emulator / "conv.u8", np.uint8)
    want, wconv, witers = nl.newton_full_plain(
        *_torch(th0, X, y, w, off, cnt), lam=0.8, unreg_bias=True,
        maxiter=100, ftol=1e-12, pgtol=1e-5,
        lanes=torch.from_numpy(lanes),
        n_lanes=torch.tensor([n_lanes], dtype=torch.int32))
    pre, rest = lanes[:n_lanes], lanes[n_lanes:]
    np.testing.assert_array_equal(conv[pre].astype(bool), wconv.numpy()[pre])
    ok = pre[(_well_posed(X, w, cnt) | (cnt == 0))[pre] & wconv.numpy()[pre]]
    if ok.size:
        assert np.abs(th[ok] - want.numpy()[ok]).max() <= _F32_TOL
    if pre.size:
        assert np.abs(iters[pre] - witers.numpy()[pre]).max() <= 1
    assert (iters[pre][real[pre]] > 0).all()
    assert (th[rest].view(np.uint32) == _UNTOUCHED[0]).all()
    assert (conv[rest] == _UNTOUCHED[1]).all()
    assert (iters[rest] == _UNTOUCHED[2]).all()
    np.testing.assert_array_equal(want.numpy()[rest], th0[rest])
    assert wconv.numpy()[rest].all() and (witers.numpy()[rest] == 0).all()


def test_wrappers_refuse_a_bad_lane_list(monkeypatch):
    """The lane list's checks (_check_inputs, before any launch): CPU
    tensors are not the kernels'; past the device check, a list comes
    whole (lanes and their count) or not at all, with B lanes and one
    count of shape (1,)."""
    X, y, w, off, cnt = _torch(*_problem(4, 8, 5, seed=1, dtype=np.float32))
    th0 = torch.zeros(4, 5)
    lanes = torch.arange(4, dtype=torch.int32)
    n_lanes = torch.zeros(1, dtype=torch.int32)
    check = lambda *ln: nl._check_inputs("newton_full", X, y, w, off, cnt,
                                         th0, *ln)
    with pytest.raises(ValueError, match="expected CUDA"):
        check(lanes, n_lanes)
    monkeypatch.setattr(nl._cuda, "require_cuda", lambda *a, **k: None)
    assert check(lanes, n_lanes) == check() == "warp"
    with pytest.raises(ValueError, match="go together"):
        check(lanes, None)
    with pytest.raises(ValueError, match="go together"):
        check(None, n_lanes)
    with pytest.raises(ValueError, match="one count"):
        check(lanes[:3], n_lanes)
    with pytest.raises(ValueError, match="one count"):
        check(lanes, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="one count"):
        check(lanes, torch.zeros((), dtype=torch.int32))


# ---- (c) train() on both planes -------------------------------------------

def _trained(model, schema, md_file, train_dir, feature_file, tmp):
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp), schema)
    return load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"), feature_file)


def _assert_close(got, want, tol):
    assert set(got) == set(want) and len(want) > 0
    for eid in want:
        np.testing.assert_array_equal(got[eid].unique_global_indices,
                                      want[eid].unique_global_indices)
        np.testing.assert_allclose(got[eid].theta, want[eid].theta, rtol=0,
                                   atol=tol, err_msg=f"entity {eid}")


_TWO_PHASE = dict(newton_phase1_iters=2, batch_solver="newton")


def test_train_two_phase_matches_jax(tmp_path):
    """train() with newton_phase1_iters=2 on the fixture of
    tests/test_random_effect_lr.py:569 (90 entities, one bucket of 128 on
    the host plane of both packages, so two-phase): the port's models equal
    JAX's and the port's single-phase models to 1e-7, and five entities
    match the scipy oracle to 2e-5."""
    groups, dense = _make_groups(num_entities=90, seed=11)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    files = (md_file, train_dir, feature_file)
    jax_model, jax_schema = _build_model(*files, tmp_path / "jax",
                                         re_mode="host", **_TWO_PHASE)
    want = _trained(jax_model, jax_schema, *files, tmp_path / "jax")
    out = {}
    for tag, over in (("two", _TWO_PHASE),
                      ("one", dict(batch_solver="newton"))):
        model, schema = _torch_model(*files, str(tmp_path / tag / "models"),
                                     re_mode="host", **over)
        out[tag] = _trained(model, schema, *files, tmp_path / tag)
        assert model.last_fit_rungs == (
            {"newton_two_phase": 1} if tag == "two" else {"newton": 1})
        assert model.last_fit_converged == (90, 90)
    _assert_close(out["two"], want, _MODEL_TOL)
    _assert_close(out["two"], out["one"], _MODEL_TOL)
    for eid in list(dense)[:5]:
        X, y, offsets, weights = dense[eid]
        oracle = _scipy_entity_oracle(X, y, offsets, weights, 0.6,
                                      out["two"][eid].unique_global_indices)
        np.testing.assert_allclose(out["two"][eid].theta, oracle, rtol=0,
                                   atol=_ORACLE_TOL)


def test_train_two_phase_on_the_sharded_plane(tmp_path, monkeypatch):
    """The sharded plane with two-phase (400 entities: tiers past 64
    entities): at P = 1 against JAX's host plane with two-phase, and at
    P = 8 (a mesh of eight CPU entries, each shard ordering and cutting its
    own lanes) against the port's host plane single-phase, both to 1e-7."""
    groups, _ = _make_groups(num_entities=400, seed=12)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    files = (md_file, train_dir, feature_file)
    jax_model, jax_schema = _build_model(*files, tmp_path / "jax",
                                         re_mode="host", **_TWO_PHASE)
    want = _trained(jax_model, jax_schema, *files, tmp_path / "jax")
    host, schema = _torch_model(*files, str(tmp_path / "host" / "models"),
                                re_mode="host", batch_solver="newton")
    single = _trained(host, schema, *files, tmp_path / "host")
    for p in (1, 8):
        monkeypatch.setattr(port_re, "get_mesh", lambda device=None, p=p:
                            get_mesh([torch.device("cpu")] * p))
        model, schema = _torch_model(*files, str(tmp_path / f"p{p}/models"),
                                     re_mode="sharded", **_TWO_PHASE)
        got = _trained(model, schema, *files, tmp_path / f"p{p}")
        assert model.last_fit_plane == "sharded"
        assert model.last_fit_sharding["shards"] == p
        assert model.last_fit_rungs.get("newton_two_phase", 0) > 0
        assert model.last_fit_converged == (400, 400)
        _assert_close(got, want if p == 1 else single, _MODEL_TOL)


# (settings, bound) of the sharded two-phase fits against the JAX
# package's. With a loose decrease stop (1e-6, 1e-4; no gradient stop) a
# lane phase 1 stopped on it moves by up to ~1e-4 when the tier's prefix
# solves it again, so a cut other than JAX's shows. At the fixture's own
# tolerances (decrease 1e-14, gradient 1e-10) the stop falls on rounding
# noise: there the port's host plane already sits 1.1e-8 from JAX's, with
# two-phase and without, so it is held to the packages' model bound
_SHARDED_TWO_PHASE = [(dict(lbfgs_tolerance=0.0, lbfgs_pgtol=1e-7), 1e-8),
                      (dict(lbfgs_tolerance=1e-6, lbfgs_pgtol=0.0), 1e-8),
                      (dict(lbfgs_tolerance=1e-4, lbfgs_pgtol=0.0), 1e-8),
                      (dict(), _MODEL_TOL)]


@pytest.mark.parametrize("over,tol", _SHARDED_TWO_PHASE,
                         ids=["stop_on_gradient", "ftol_1e-6", "ftol_1e-4",
                              "fixture_tolerances"])
def test_sharded_two_phase_matches_jax_sharded(tmp_path, over, tol):
    """fit_records_sharded with two-phase at P = 8 (the port's mesh of
    eight cpu entries, JAX's on eight of its devices) on the 400-entity
    fixture, float64: the port's models equal JAX's, to 1e-8 where the
    stop is clear of rounding noise. The tier's prefix is cut across its
    shards in both packages, so the converged lanes solved again are the
    same ones."""
    from test_sharded_re import _groups_to_records
    from test_torch_sharded_re import (_assert_models_close, _cpu_mesh,
                                       _port_records)
    from gdmix_tpu.parallel.mesh import get_mesh as jax_get_mesh
    import jax
    groups, _ = _make_groups(num_entities=400, seed=12)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    files = (md_file, train_dir, feature_file)
    over = dict(_TWO_PHASE, **over)
    jm, jschema = _build_model(*files, tmp_path / "jax", **over)
    tm, tschema = _torch_model(*files, str(tmp_path / "torch"), **over)
    data = _groups_to_records(groups)
    got = tm.fit_records_sharded(_port_records(data), tschema,
                                 model_weights={}, mesh=_cpu_mesh(8))
    want = jm.fit_records_sharded(data, jschema, model_weights={},
                                  mesh=jax_get_mesh(jax.devices()[:8]))
    assert tm.last_fit_sharding["shards"] == 8
    assert tm.last_fit_rungs == {"newton_two_phase": 3}
    assert tm.last_fit_converged == (400, 400)
    _assert_models_close(got, want, tol)


# ---- (d) the gate ---------------------------------------------------------

def _jax_rung(model, u_cap, B, n_cap):
    """The rung JAX's _select_solver picks: its solvers are cached per key,
    so the one it returns is the same object as its factory's."""
    solve = model._select_solver(u_cap, B, n_cap)
    key = (u_cap, *model._solver_key())
    p = model.model_params
    for name, make in (
            ("newton_two_phase", lambda: jax_re._newton_two_phase_solver(
                *key, p.newton_phase1_iters)),
            ("newton", lambda: jax_re._newton_solver(*key)),
            ("newton_dual", lambda: jax_re._newton_dual_solver(*key)),
            ("lbfgs_dense", lambda: jax_re._lbfgs_dense_solver(*key)),
            ("lbfgs", lambda: jax_re._lbfgs_solver(*key))):
        if make() is solve:
            return name
    raise AssertionError("no JAX rung matched")


# (overrides, (u_cap, B, n_cap), the rung of both packages)
_GATE = [
    (dict(), (8, 128, 16), "newton_two_phase"),
    (dict(), (8, 65, 16), "newton_two_phase"),
    (dict(), (8, 64, 16), "newton"),
    (dict(random_effect_variance_mode="simple"), (8, 128, 16), "newton"),
    (dict(random_effect_variance_mode="full"), (8, 128, 16), "newton"),
    (dict(num_of_lbfgs_iterations=2), (8, 128, 16), "newton"),
    (dict(num_of_lbfgs_iterations=3), (8, 128, 16), "newton_two_phase"),
    (dict(newton_phase1_iters=0), (8, 128, 16), "newton"),
    (dict(batch_solver="lbfgs"), (8, 128, 16), "lbfgs_dense"),
    (dict(batch_solver="newton_dual"), (8, 128, 4), "newton_dual"),
    (dict(batch_solver="auto", newton_max_dim=4), (8, 128, 4),
     "newton_dual"),
    (dict(batch_solver="auto"), (8, 128, 16), "newton_two_phase"),
]


@pytest.mark.parametrize("over,shape,rung", _GATE)
def test_gate_picks_the_jax_rung(tmp_path, over, shape, rung):
    """JAX's gate (random_effect_lr.py:887-890): two-phase only on the
    Newton rung, newton_phase1_iters > 0, no variance, more iterations than
    phase 1's and B > 64. Each case picks the same rung in both packages."""
    groups, _ = _make_groups(num_entities=4, seed=0)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    files = (md_file, train_dir, feature_file)
    over = dict(_TWO_PHASE, **over)
    jax_model, _ = _build_model(*files, tmp_path / "jax", **over)
    port_model, _ = _torch_model(*files, str(tmp_path / "port"), **over)
    got, solve = port_model._select_solver(*shape)
    assert callable(solve)
    assert got == _jax_rung(jax_model, *shape) == rung


# ---- (e) the bench and the prewarm tool -----------------------------------

def _cli_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "GDMIX_TPU_COMPILE_CACHE"}
    env.update(extra, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return env


def test_bench_solves_two_phase_as_the_jax_bench(monkeypatch):
    """BENCH_PHASE1 = 2: the port's bucket solves of the primary (2,000
    entities) take two-phase where the JAX bench's rule does (newton,
    dim ≤ 128, B > 64) and land within the float32 bound of the JAX bench's
    two-phase solves; every entity converged in both."""
    from test_torch_bench import F32_TOL, _jax_solves
    monkeypatch.setattr(jax_bench, "PHASE1", 2)
    want = _jax_solves(jax_bench.make_workload(2000))
    assert all(c for _, c in want.values())
    buckets, arrays = bench.upload_buckets(bench.make_workload(2000),
                                           torch.device("cpu"))
    taken = []
    orig = bench._newton_two_phase_solver
    monkeypatch.setattr(bench, "_newton_two_phase_solver",
                        lambda *a: taken.append(a[-1]) or orig(*a))
    results = bench.solve_buckets(buckets, arrays, phase1=2)
    assert taken == [2] * sum(b.indices.shape[0] > 64 for b in buckets) > []
    assert bench.converged_share(buckets, results) == 1.0
    worst = 0.0
    for b, (theta, _) in zip(buckets, results):
        for i, e in enumerate(b.entity_ids):
            w = want[e][0]
            worst = max(worst, float(np.abs(theta[i, :len(w)].numpy()
                                            - w).max()))
    assert worst <= F32_TOL, worst


def test_bench_end_to_end_two_phase_on_the_cpu():
    """`BENCH_PHASE1=2 python -m gdmix_tpu_torch.bench --device cpu` at
    small sizes: its line, and every RE line converged 1.000."""
    from test_torch_bench import SMALL
    proc = subprocess.run(
        [sys.executable, "-m", "gdmix_tpu_torch.bench", "--device", "cpu"],
        cwd=ROOT, env=_cli_env(BENCH_PHASE1="2", **SMALL),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] > 0 and line["device"] == "cpu"
    conv = [c for c in proc.stderr.split("converged ")[1:]]
    assert len(conv) == 6 and all(c.startswith("1.000") for c in conv), \
        proc.stderr[-3000:]


@pytest.mark.parametrize("host_plane", [False, True])
def test_prewarm_two_phase_on_the_cpu(tmp_path, host_plane):
    """tools/prewarm.py --newton_phase1_iters 2 --device cpu: the ladder's
    two tiers of 80 entities (one bucket or two, as each plane plans them)
    fit by two-phase Newton alone on either plane, every model
    converged."""
    proc = subprocess.run(
        [sys.executable, "-m", "gdmix_tpu_torch.tools.prewarm", "--tiers",
         "8,16", "--entities_per_tier", "80", "--support", "8",
         "--num_features", "300", "--newton_phase1_iters", "2", "--device",
         "cpu"] + (["--host_plane"] if host_plane else []),
        cwd=ROOT, env=_cli_env(GDMIX_TPU_COMPILE_CACHE=str(tmp_path)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep = json.loads("{" + proc.stderr.rsplit("prewarm: {", 1)[1]
                     .splitlines()[0])
    assert set(rep["rungs"]) == {"newton_two_phase"}
    assert rep["models"] == 160 and rep["converged"] == [160, 160]
    assert rep["plane"] == ("host" if host_plane else "sharded")


# ---- (f) the trainer CLI and the in-memory pipeline ------------------------

def test_cli_trains_two_phase_as_jax(tmp_path):
    """`python -m gdmix_tpu_torch.gdmix --stage=random_effect
    --newton_phase1_iters=2` (in-process) on the 90-entity fixture writes
    JAX's two-phase models to 1e-7."""
    from gdmix_tpu_torch.gdmix import run as torch_cli
    groups, _ = _make_groups(num_entities=90, seed=11)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    active = os.path.join(train_dir, "active")
    part = os.path.join(active, "partitionId=0")
    os.makedirs(part)
    for f in os.listdir(active):
        if f.endswith(".tfrecord"):
            os.rename(os.path.join(active, f), os.path.join(part, f))
    plist = os.path.join(str(tmp_path), "partitionList.txt")
    with open(plist, "w") as f:
        f.write("0")
    model_dir = os.path.join(str(tmp_path), "cli_models")
    torch_cli([
        "--action=train", "--stage=random_effect",
        "--model_type=logistic_regression", "--label_column_name=response",
        "--uid_column_name=uid", "--weight_column_name=weight",
        "--prediction_score_column_name=predictionScore",
        f"--partition_list_file={plist}",
        f"--training_score_dir={tmp_path / 'cli_scores'}",
        f"--metadata_file={md_file}", f"--training_data_dir={train_dir}",
        "--feature_bag=per_entity", f"--feature_file={feature_file}",
        "--partition_entity=user_id", f"--output_model_dir={model_dir}",
        "--l2_reg_weight=0.6", "--regularize_bias=false", "--dtype=float64",
        "--lbfgs_tolerance=1e-14", "--lbfgs_pgtol=1e-10",
        "--num_of_lbfgs_iterations=500", "--sparsity_threshold=0.0",
        "--newton_phase1_iters=2", "--batch_solver=newton", "--re_mode=host",
        "--device=cpu"])
    jax_model, schema = _build_model(md_file, train_dir, feature_file,
                                     tmp_path / "jax", re_mode="host",
                                     **_TWO_PHASE)
    jax_model.train(part, None, md_file, jax_model.checkpoint_path,
                    _ctx(tmp_path / "jax"), schema)
    want, got = (load_sparse_models_from_avro(
        os.path.join(d, "part-00000.avro"), feature_file)
        for d in (jax_model.checkpoint_path, model_dir))
    _assert_close(got, want, _MODEL_TOL)


def test_in_memory_pipeline_two_phase(ml_data, tmp_path, monkeypatch):
    """`workflow.main --mode in_memory` with newton_phase1_iters = 2 on both
    RE coordinates (tests/test_torch_pipeline.py's fixture, two sweeps):
    on the host plane the RE fits take two-phase and the AUCs equal the
    JAX package's in-memory run's with the same config within that file's
    bound; `--re_mode sharded` (tiers of 64 entities or fewer here, so
    single-phase by the gate) climbs the same ladder."""
    import yaml
    from gdmix_tpu.workflow.config import WorkflowConfig as JaxConfig
    from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory as jax_run
    from gdmix_tpu_torch.workflow.main import main as torch_main
    rungs = []
    orig = port_re.RandomEffectLRModel._select_solver
    monkeypatch.setattr(port_re.RandomEffectLRModel, "_select_solver",
                        lambda self, *a: rungs.append(orig(self, *a)[0])
                        or orig(self, *a))

    def config(out):
        d = _config_dict(ml_data, str(out))
        for c in d["random_effect_config"].values():
            c.update(_TWO_PHASE)
        return d
    want = jax_run(JaxConfig.from_dict(config(tmp_path / "jax")),
                   num_sweeps=2, re_mode="host")
    for mode in ("host", "sharded"):
        cfg_path = str(tmp_path / f"{mode}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config(tmp_path / mode), f, sort_keys=False)
        got = torch_main(["--config_path", cfg_path, "--mode", "in_memory",
                          "--num_sweeps", "2", "--re_mode", mode,
                          "--device", "cpu"])
        assert got["global"] < got["per-user"]
        if mode == "host":
            assert "newton_two_phase" in rungs, rungs
            for name in want:
                assert abs(got[name] - want[name]) <= AUC_ATOL, \
                    (name, got[name], want[name])
        rungs.clear()
