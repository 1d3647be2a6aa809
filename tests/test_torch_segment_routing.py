"""On-device grouping and entity routing in the port (gdmix_tpu_torch/
ops/segment.py, parallel/routing.py, parallel/entity_sharding.py) against
the JAX package's on its 8 virtual CPU devices: the port's mesh is eight
`cpu` entries, one per JAX device. Integers must be equal, float64
payloads equal bit for bit. Ports tests/test_routing_segment.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gdmix_tpu.data.partitioner import assign_group_ids
from gdmix_tpu.ops import segment as jseg
from gdmix_tpu.parallel import entity_sharding as jes
from gdmix_tpu.parallel.mesh import get_mesh as jax_get_mesh
from gdmix_tpu.parallel.routing import route_to_entity_shards as jax_route
from gdmix_tpu_torch.ops import segment as tseg
from gdmix_tpu_torch.parallel import entity_sharding as tes
from gdmix_tpu_torch.parallel.mesh import Mesh, get_mesh
from gdmix_tpu_torch.parallel.routing import route_to_entity_shards

NUM_SHARDS = 8


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _cpu_mesh(p=NUM_SHARDS):
    return get_mesh([torch.device("cpu")] * p)


def _np(t):
    return np.asarray(t)


def _shards(a, p=NUM_SHARDS):
    """A host array as the port's per-shard tensors (row blocks)."""
    return [torch.as_tensor(b) for b in np.split(np.asarray(a), p)]


def _jax_sharded(mesh, a):
    spec = P("data", *([None] * (np.ndim(a) - 1)))
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def _cat(ts):
    return torch.cat(list(ts)).numpy()


def test_group_by_entity_device():
    """tests/test_routing_segment.py's case, on the port."""
    e = torch.tensor([5, 3, 5, 1, 3, 3, 7], dtype=torch.int64)
    segs = tseg.group_by_entity_device(e)
    assert int(segs.unique_count) == 4
    order = segs.order.numpy()
    assert list(e.numpy()[order]) == sorted(e.tolist())
    np.testing.assert_array_equal(segs.seg_counts.numpy()[:4], [1, 3, 2, 1])
    np.testing.assert_array_equal(segs.seg_entity.numpy()[:4], [1, 3, 5, 7])
    np.testing.assert_array_equal(segs.seg_starts.numpy()[:4], [0, 1, 4, 6])
    # stability: records of entity 3 keep their relative order (1, 4, 5)
    assert list(order[1:4]) == [1, 4, 5]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_group_by_entity_equals_jax(dtype):
    rng = np.random.RandomState(2)
    e = rng.randint(0, 40, 300).astype(dtype)
    e[::17] = tseg.ENTITY_SENTINEL
    want = jax.jit(jseg.group_by_entity_device)(jnp.asarray(e))
    got = tseg.group_by_entity_device(torch.as_tensor(e))
    for name in want._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)),
                                      err_msg=name)
    assert tseg.ENTITY_SENTINEL == int(jseg.ENTITY_SENTINEL)


@pytest.mark.parametrize("b_cap,n_cap", [(64, 16), (16, 4), (8, 32)])
def test_build_entity_blocks_equals_jax(b_cap, n_cap):
    """Blocks, slot entities and counts, and the records dropped to b_cap
    and n_cap, equal JAX's; the float64 payload bit for bit."""
    rng = np.random.RandomState(b_cap + n_cap)
    n = 256
    ent = rng.randint(0, 30, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    arrays = {"x": rng.randn(n, 3), "i": rng.randint(0, 9, (n, 2))
              .astype(np.int32), "y": rng.rand(n)}
    want = jax.jit(jseg.build_entity_blocks, static_argnums=(3, 4))(
        jnp.asarray(ent), {k: jnp.asarray(v) for k, v in arrays.items()},
        jnp.asarray(valid), b_cap, n_cap)
    got = tseg.build_entity_blocks(
        torch.as_tensor(ent), {k: torch.as_tensor(v)
                               for k, v in arrays.items()},
        torch.as_tensor(valid), b_cap, n_cap)
    for k in arrays:
        np.testing.assert_array_equal(got[0][k].numpy(), _np(want[0][k]),
                                      err_msg=k)
    for g, w, name in zip(got[1:], want[1:], ("slot_entity", "slot_count",
                                              "dropped")):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    if n_cap == 4:
        assert int(got[3]) > 0   # the cut drops records, as JAX's does


def test_per_entity_counts_and_group_ids_match_jax_and_host():
    rng = np.random.RandomState(0)
    e = rng.randint(0, 20, 200).astype(np.int64)
    uids = np.arange(200, dtype=np.int64)
    got = tseg.per_entity_sample_counts(torch.as_tensor(e)).numpy()
    np.testing.assert_array_equal(
        got, _np(jseg.per_entity_sample_counts(jnp.asarray(e))))
    _, inverse, c = np.unique(e, return_inverse=True, return_counts=True)
    np.testing.assert_array_equal(got, c[inverse])
    for lo, hi in ((None, None), (5, None), (None, 4), (5, 4)):
        dev = tseg.assign_group_ids_device(torch.as_tensor(e),
                                           torch.as_tensor(uids), lo, hi)
        want = _np(jseg.assign_group_ids_device(jnp.asarray(e),
                                                jnp.asarray(uids), lo, hi))
        host = assign_group_ids(e.astype(object).astype(str), uids, lo, hi)
        np.testing.assert_array_equal(dev.numpy(), want,
                                      err_msg=f"bounds {lo},{hi}")
        np.testing.assert_array_equal(dev.numpy(), host,
                                      err_msg=f"bounds {lo},{hi}")


def _route_both(n_per_shard, target, capacity, seed):
    rng = np.random.RandomState(seed)
    n = n_per_shard * NUM_SHARDS
    uid = np.arange(n, dtype=np.int64)
    payload = rng.randn(n, 3)
    jm = jax_get_mesh()
    want = jax_route(jm, {"uid": _jax_sharded(jm, uid),
                          "payload": _jax_sharded(jm, payload)},
                     _jax_sharded(jm, target), capacity=capacity)
    got = route_to_entity_shards(
        _cpu_mesh(), {"uid": _shards(uid), "payload": _shards(payload)},
        _shards(target), capacity)
    return uid, payload, want, got


def test_route_to_entity_shards_equals_jax():
    """Every record arrives once, on the shard owning it, and the routed
    arrays equal JAX's all_to_all slot for slot."""
    rng = np.random.RandomState(1)
    n_per = 64
    target = rng.randint(0, NUM_SHARDS, n_per * NUM_SHARDS).astype(np.int32)
    uid, payload, want, got = _route_both(n_per, target, 48, seed=1)
    for k in ("uid", "payload"):
        np.testing.assert_array_equal(_cat(got.arrays[k]),
                                      _np(want.arrays[k]), err_msg=k)
    np.testing.assert_array_equal(_cat(got.valid), _np(want.valid))
    np.testing.assert_array_equal(_cat(got.overflow), _np(want.overflow))
    assert int(_cat(got.overflow).sum()) == 0
    valid = _cat(got.valid)
    got_uid = _cat(got.arrays["uid"])
    np.testing.assert_array_equal(np.sort(got_uid[valid]), uid)
    slots = len(valid) // NUM_SHARDS
    for s in range(NUM_SHARDS):
        sl = slice(s * slots, (s + 1) * slots)
        assert (target[got_uid[sl][valid[sl]]] == s).all()
        np.testing.assert_array_equal(
            got.arrays["payload"][s].numpy()[valid[sl]],
            payload[got_uid[sl][valid[sl]]])


def test_route_overflow_reported():
    """Everything to shard 0 past its capacity: each shard keeps 8 of its
    16 records and reports the rest, as JAX's route does."""
    n_per = 16
    target = np.zeros(n_per * NUM_SHARDS, np.int32)
    _, _, want, got = _route_both(n_per, target, 8, seed=3)
    over = _cat(got.overflow)
    np.testing.assert_array_equal(over, _np(want.overflow))
    assert int(over.sum()) == n_per * NUM_SHARDS - 8 * NUM_SHARDS
    assert int(_cat(got.valid).sum()) == 8 * NUM_SHARDS
    np.testing.assert_array_equal(_cat(got.arrays["uid"]),
                                  _np(want.arrays["uid"]))


def test_route_on_one_shard_is_identity_of_packing():
    """P = 1: the exchange moves nothing; the slots are the records sorted
    by destination (all 0), so in their own order."""
    x = torch.arange(24, dtype=torch.float64).reshape(12, 2)
    got = route_to_entity_shards(_cpu_mesh(1), {"x": [x]},
                                 [torch.zeros(12, dtype=torch.int32)], 16)
    np.testing.assert_array_equal(got.arrays["x"][0][:12].numpy(), x.numpy())
    assert got.valid[0].sum() == 12 and int(got.overflow[0]) == 0


def test_route_and_bucket_and_capacities_equal_jax():
    """route_and_bucket and plan_capacities against JAX's on 13 entities of
    pareto-ish sizes over the 8 shards."""
    rng = np.random.RandomState(5)
    sizes = np.array([1, 2, 3, 5, 7, 9, 14, 17, 33, 40, 4, 6, 11])
    E = len(sizes)
    ent_idx = np.repeat(np.arange(E), sizes).astype(np.int32)
    rng.shuffle(ent_idx)
    n = len(ent_idx)
    n_pad = -(-n // (NUM_SHARDS * 8)) * NUM_SHARDS * 8
    owner_of_entity = (np.arange(E) % NUM_SHARDS).astype(np.int32)
    rows = n_pad // NUM_SHARDS
    ent_pad = np.concatenate([ent_idx, np.full(n_pad - n,
                                               tseg.ENTITY_SENTINEL,
                                               np.int32)])
    owner = np.concatenate([owner_of_entity[ent_idx],
                            np.arange(n_pad - n) % NUM_SHARDS]
                           ).astype(np.int32)
    want_caps = jes.plan_capacities(owner_of_entity, ent_idx, NUM_SHARDS,
                                    rows)
    got_caps = tes.plan_capacities(owner_of_entity, ent_idx, NUM_SHARDS,
                                   rows)
    assert got_caps == want_caps
    capacity = tes.plan_capacities(owner_of_entity, ent_pad.clip(0, E - 1),
                                   NUM_SHARDS, rows)[0]
    b_cap, n_cap = want_caps[1], 64
    x = rng.randn(n_pad, 2)
    jm = jax_get_mesh()
    want = jes.route_and_bucket(
        jm, {"x": _jax_sharded(jm, x)}, _jax_sharded(jm, ent_pad),
        _jax_sharded(jm, owner), capacity=capacity, b_cap=b_cap,
        n_cap=n_cap)
    mesh = _cpu_mesh()
    got = tes.route_and_bucket(
        mesh, {"x": tes.shard_rows(mesh, x)}, tes.shard_rows(mesh, ent_pad),
        tes.shard_rows(mesh, owner), capacity=capacity, b_cap=b_cap,
        n_cap=n_cap)
    np.testing.assert_array_equal(_cat(got.blocks["x"]),
                                  _np(want.blocks["x"]))
    np.testing.assert_array_equal(_cat(got.slot_entity),
                                  _np(want.slot_entity))
    np.testing.assert_array_equal(_cat(got.slot_count), _np(want.slot_count))
    np.testing.assert_array_equal(_cat(got.dropped), _np(want.dropped))
    assert int(_cat(got.dropped).sum()) == 0
    # every entity sits on its owner shard, in ascending order there
    se = [t.numpy() for t in got.slot_entity]
    for s in range(NUM_SHARDS):
        live = se[s][se[s] >= 0]
        np.testing.assert_array_equal(
            live, np.flatnonzero(owner_of_entity == s))


def test_mesh_defaults():
    """get_mesh: the CPU's one-entry mesh when the CPU is asked for; every
    visible card otherwise, raising without one; an explicit list as
    given."""
    assert get_mesh(device="cpu") == Mesh((torch.device("cpu"),))
    assert _cpu_mesh(3).size == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_mesh()
    with pytest.raises(ValueError, match="rows over"):
        tes.shard_rows(_cpu_mesh(3), np.zeros(4))
