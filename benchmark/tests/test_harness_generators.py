"""The benchmark's frozen copies draw what the program's generators draw."""
import numpy as np
import torch

from benchmark import gen


def test_draws_equal_the_bench_draws():
    from gdmix_tpu_torch.bench import _draws
    for args in [(60, 3, 24, 4, 2, 64, 1.5), (40, 1, 24, 4, 2, 2048, 1.2),
                 (30, 2, 512, 16, 32, 64, 1.5)]:
        ours, theirs = gen.draws(*args), _draws(*args)
        for a, b in zip(ours[1:], theirs[1:]):
            np.testing.assert_array_equal(a, b)


def test_fe_ids_equal_the_bench_ids():
    from gdmix_tpu_torch.bench import fe_ids
    u = torch.empty(5000, dtype=torch.float64).uniform_(
        1e-7, 1.0, generator=torch.Generator().manual_seed(3))
    for d, s in [(1000, 1.2), (1_000_000, 1.2), (5000, 1.0)]:
        assert torch.equal(gen.fe_ids(u, d, s), fe_ids(u, d, s))


def test_fleet_counts_are_the_bench_count_draw():
    t = {"entities": 400, "pareto_a": 1.5, "count_lo": 2, "count_hi": 64,
         "genres_lo": 1, "genres_hi": 3, "year_lo": 0.92, "year_hi": 1.0,
         "user_sd": 1.5, "effect_sd": 0.5, "offset_sd": 0.1}
    seed = 2 ** 31 + 99
    f = gen.re_fleet(t, 20, seed)
    want = gen.draws(400, gen.seed32(seed, 1), 24, 4, 2, 64, 1.5)[1]
    np.testing.assert_array_equal(f.counts, want)
    assert f.indices.shape == (f.counts.sum(), 4)
    live = np.arange(4)[None, :] < f.nnz[:, None]
    g = np.where(live[:, :3] & (f.values[:, :3] == 1.0), f.indices[:, :3], -1)
    for row, n in zip(g, f.nnz):          # distinct genres, then the date
        got = row[row >= 0]
        assert len(got) == n - 1 and len(set(got)) == n - 1
    date = f.values[np.arange(len(f.nnz)), f.nnz - 1]
    assert ((date >= 0.92) & (date < 1.0)).all()
    assert (f.indices[np.arange(len(f.nnz)), f.nnz - 1] == 19).all()
    again = gen.re_fleet(t, 20, seed)
    np.testing.assert_array_equal(again.labels, f.labels)


def test_criteo_rows_shape_and_fields():
    t = {"rows": 3000, "numeric": 13, "categorical": 26, "zipf_s": 1.2,
         "lognormal_sigma": 1.0, "effect_sd": 0.1, "intercept": -1.1,
         "block_rows": 1024}
    b = gen.criteo_rows(t, 100_000, 5, torch.device("cpu"))
    assert b.indices.shape == (3000, 39) and b.indices.dtype == torch.int32
    assert torch.equal(b.indices[:, :13],
                       torch.arange(13, dtype=torch.int32).expand(3000, 13))
    assert (b.indices[:, 13:] >= 13).all() and (b.indices < 100_000).all()
    assert (b.values > 0).all()
    # unit rows; the categorical fields share one value a row
    assert torch.allclose(b.values.norm(dim=1), torch.ones(3000), atol=1e-6)
    assert (b.values[:, 13:] == b.values[:, 13:14]).all()
    # Zipf: the first free id is the most frequent
    counts = torch.bincount(b.indices[:, 13:].reshape(-1).long())
    assert int(counts.argmax()) == 13
    again = gen.criteo_rows(t, 100_000, 5, torch.device("cpu"))
    assert torch.equal(again.labels, b.labels)
