"""The generator: Table 5's sizes, exact counts, determinism per seed, and
the same pattern for every seed."""
import numpy as np
import pytest
import torch

from mfbench import data, registry

TABLE5 = {"netflix": (480_189, 17_770, 99_000_000, 100, 0.05),
          "yahoomusic": (1_000_990, 624_961, 252_800_000, 100, 1.4)}
#: the data sets' published held-out ratings: Netflix's probe set, Yahoo!
#: Music's (KDD Cup 2011 Track 1) validation set
HELD_OUT = {"netflix": 1_408_395, "yahoomusic": 4_003_960}


def small(name="netflix", **kw):
    cfg = registry.config(name)
    cfg.update({"m": 400, "n": 90, "nnz": 9000, "test_nnz": 1000, "f": 8, **kw})
    return cfg


@pytest.mark.parametrize("name", sorted(TABLE5))
def test_configs_hold_table5(name):
    cfg = registry.config(name)
    assert (cfg["m"], cfg["n"], cfg["nnz"], cfg["f"], cfg["lam"]) == TABLE5[name]
    assert cfg["test_nnz"] == HELD_OUT[name]
    assert cfg["reduced"] == []
    for key in cfg["assumed"]:
        assert key in cfg


def _csr_ok(c: data.Csr, rows: int, cols: int):
    assert c.ptr[0] == 0 and np.all(np.diff(c.ptr) >= 0) and c.ptr.shape == (rows + 1,)
    assert c.cols.dtype == np.int32 and c.vals.dtype == np.float32
    assert c.cols.min() >= 0 and c.cols.max() < cols
    for u in range(rows):
        seg = c.cols[c.ptr[u]:c.ptr[u + 1]]
        assert np.all(np.diff(seg) > 0)         # sorted, no duplicate pair


def test_exact_counts_and_consistent_transpose():
    cfg = small()
    p = data.make_problem(cfg, 2**31 + 5, "cpu")
    assert p.r.nnz == cfg["nnz"] and p.test.nnz == cfg["test_nnz"]
    _csr_ok(p.r, cfg["m"], cfg["n"])
    _csr_ok(p.rt, cfg["n"], cfg["m"])
    _csr_ok(p.test, cfg["m"], cfg["n"])
    rows = np.repeat(np.arange(cfg["m"]), np.diff(p.r.ptr))
    fwd = set(zip(rows.tolist(), p.r.cols.tolist(), p.r.vals.tolist()))
    rows_t = np.repeat(np.arange(cfg["n"]), np.diff(p.rt.ptr))
    back = set(zip(p.rt.cols.tolist(), rows_t.tolist(), p.rt.vals.tolist()))
    assert fwd == back
    test_rows = np.repeat(np.arange(cfg["m"]), np.diff(p.test.ptr))
    assert not fwd & set(zip(test_rows.tolist(), p.test.cols.tolist(), p.test.vals.tolist()))
    assert p.x0.shape == (cfg["m"], cfg["f"]) and p.theta0.shape == (cfg["n"], cfg["f"])
    assert float(p.theta0.min()) >= 0 and float(p.theta0.max()) < cfg["init_scale"]


def test_same_seed_same_inputs():
    cfg = small()
    a, b = data.make_problem(cfg, 77, "cpu"), data.make_problem(cfg, 77, "cpu")
    for x, y in ((a.r, b.r), (a.rt, b.rt), (a.test, b.test)):
        assert np.array_equal(x.ptr, y.ptr) and np.array_equal(x.cols, y.cols)
        assert np.array_equal(x.vals, y.vals)
    assert torch.equal(a.theta0, b.theta0) and torch.equal(a.x0, b.x0)


def test_other_seed_same_pattern_other_values():
    cfg = small()
    a, b = data.make_problem(cfg, 1, "cpu"), data.make_problem(cfg, 2, "cpu")
    for x, y in ((a.r, b.r), (a.rt, b.rt), (a.test, b.test)):
        assert np.array_equal(x.ptr, y.ptr) and np.array_equal(x.cols, y.cols)
        assert not np.array_equal(x.vals, y.vals)
    assert not torch.equal(a.theta0, b.theta0)


def test_ratings_follow_the_planted_model():
    cfg = small(noise=0.0)
    p = data.make_problem(cfg, 9, "cpu")
    # noiseless ratings of a rank-f model with N(0, 1) factors over sqrt(f): unit variance
    assert 0.6 < float(np.std(p.r.vals)) < 1.4


def test_item_degrees_are_skewed():
    cfg = small()
    cfg.update(m=2000, n=500, nnz=60000)
    p = data.make_problem(cfg, 3, "cpu")
    deg = np.sort(np.diff(p.rt.ptr))[::-1]
    assert deg[0] > 10 * np.median(deg)


def test_large_seed_and_negative_seed():
    assert data.stream_seed(2**40 + 3, 1) != data.stream_seed(2**40 + 3, 2)
    with pytest.raises(ValueError):
        data.stream_seed(-1, 0)


def test_test_split_is_drawn_beside_the_training_ratings():
    small_split = data.make_problem(small(test_nnz=10), 6, "cpu")
    large_split = data.make_problem(small(test_nnz=3000), 6, "cpu")
    assert small_split.r.nnz == large_split.r.nnz == 9000
    assert (small_split.test.nnz, large_split.test.nnz) == (10, 3000)


def test_rating_scale_scales_the_ratings():
    cfg = small()
    a = data.make_problem(cfg, 4, "cpu")
    cfg["rating_scale"] = 38.0
    b = data.make_problem(cfg, 4, "cpu")
    assert np.allclose(b.r.vals, 38.0 * a.r.vals, rtol=1e-5, atol=1e-4)
