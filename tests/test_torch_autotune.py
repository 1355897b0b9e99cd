"""The port's layout autotuner (``repro_torch.core.autotune``) against the
reference's (``repro.core.autotune``), on the CPU.

The analytic sweep is numpy in both packages: every rung's price, every
candidate, the argmin, the cache keys (apart from the backend field) and
the ``"auto"`` layouts must be equal, and at p = 1 every price must equal
the port's own ``predicted_stream_stats`` of a store built at that rung
(tests/test_autotune.py's exactness claim).  Problem: that file's SPEC.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as r_at  # noqa: E402
from repro.core import partition as r_part  # noqa: E402
from repro.outofcore import store as r_store  # noqa: E402
from repro.outofcore.schedule import build_schedule as r_build_schedule  # noqa: E402
from repro.outofcore.schedule import predicted_stream_stats as r_stats  # noqa: E402
from repro.sgd import blocking as r_blocking  # noqa: E402
from repro.sparse import synth  # noqa: E402
from repro_torch.core import als as p_als  # noqa: E402
from repro_torch.core import autotune as p_at  # noqa: E402
from repro_torch.core import partition as p_part  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.outofcore import (TileStore, build_schedule,  # noqa: E402
                                   build_sgd_schedule, run_streaming_als)
from repro_torch.outofcore import store as p_store  # noqa: E402
from repro_torch.outofcore.schedule import predicted_stream_stats  # noqa: E402
from repro_torch.outofcore.sgd_driver import run_streaming_sgd  # noqa: E402
from repro_torch.sgd import SgdConfig  # noqa: E402
from repro_torch.sgd import blocking as p_blocking  # noqa: E402

SPEC = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
HBM = 1 << 22


def _problem(seed=0, alpha_user=0.0):
    return synth.make_synthetic_ratings(SPEC, seed=seed, alpha_user=alpha_user)[0]


@pytest.fixture(scope="module")
def r():
    return _problem()


def _plan_kw(store):
    return (dict(bin_fills=store.bin_fill_pairs()) if store.n_bins > 1
            else dict(fill=store.worst_fill))


def _port_store_bytes(r, q, cfg, p=1):
    """Ground truth: the port's store at that rung, its schedule's
    predicted streamed bytes per iteration."""
    store = p_store.RatingStore(r, q=q, p=p, k_multiple=cfg.k_multiple, n_bins=cfg.n_bins)
    plan = p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=p, q=q, n_data=2,
                           hbm_bytes=HBM, **_plan_kw(store))
    stats = predicted_stream_stats(store, build_schedule(plan, SPEC.m, SPEC.n, n_data=2),
                                   SPEC.f)
    return sum(stats["x_bytes"]) + sum(stats["t_bytes"])


def _ref_store_bytes(r, q, cfg, p):
    store = r_store.RatingStore(r, q=q, p=p, k_multiple=cfg.k_multiple, n_bins=cfg.n_bins)
    plan = r_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=p, q=q, n_data=2,
                           hbm_bytes=HBM, **_plan_kw(store))
    stats = r_stats(store, r_build_schedule(plan, SPEC.m, SPEC.n, n_data=2), SPEC.f)
    return sum(stats["x_bytes"]) + sum(stats["t_bytes"])


def _drop_backend(key):
    return key.rsplit("|", 1)[0]


# ---------------------------------------------------------------------------
# analytic pricing and the sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2])
def test_analytic_pricing_matches_reference_per_rung(r, p):
    """Every rung's price equals the reference's (every field, the per-bin
    pairs included), and the real store's predicted bytes: the port's
    store's, which at p = 2 (stacked bins) also equal the reference's."""
    ladder = p_at.als_ladder(8)
    assert [c.to_obj() for c in ladder] == [c.to_obj() for c in r_at.als_ladder(8)]
    deg_t = p_at._batch_item_degrees(r, 4)
    np.testing.assert_array_equal(deg_t, r_at._batch_item_degrees(r, 4))
    for cfg in ladder:
        mine = p_at.predicted_als_bytes(r, 4, cfg, p=p, f=SPEC.f)
        ref = r_at.predicted_als_bytes(r, 4, r_at.LayoutConfig(**cfg.to_obj()), p=p, f=SPEC.f)
        assert mine == ref, cfg
        assert p_at.predicted_als_bytes(r, 4, cfg, p=p, f=SPEC.f, deg_t=deg_t) == mine
        truth = _port_store_bytes(r, 4, cfg, p)
        assert mine["bytes"] == truth, cfg
        if p > 1:
            assert truth == _ref_store_bytes(r, 4, cfg, p), cfg
    if p > 1:
        assert p_at._model_shard_k(r, p, 8) == r_at._model_shard_k(r, p, 8)


@pytest.mark.parametrize("p", [1, 2])
def test_sweep_argmin_matches_reference(r, p):
    res = p_at.tune_als_layout(r, 4, p=p, f=SPEC.f)
    ref = r_at.tune_als_layout(r, 4, p=p, f=SPEC.f)
    assert (res.unit, res.mode, res.cache_hit) == ("bytes", "analytic", False)
    assert res.config.to_obj() == ref.config.to_obj()
    assert res.score == ref.score == min(c["score"] for c in res.candidates)
    assert res.candidates == ref.candidates
    assert _drop_backend(res.key) == _drop_backend(ref.key)
    assert res.config.n_bins > 1           # the skewed fixture rewards binning


def test_measured_mode_scores_seconds(r):
    """Measured mode times one real solve-X wave per rung in the
    ``autotune`` obs phase, on the device named (here the CPU)."""
    ladder = [p_at.LayoutConfig(n_bins=1), p_at.LayoutConfig(n_bins=2)]
    tr, reg = Tracer(), MetricsRegistry()
    res = p_at.tune_als_layout(r, 2, f=SPEC.f, ladder=ladder, mode="measured",
                               device="cpu", tracer=tr, registry=reg)
    assert res.unit == "seconds" and res.mode == "measured"
    secs = [c["seconds"] for c in res.candidates]
    assert len(secs) == 2 and all(s > 0 for s in secs)
    assert res.score == min(secs)
    assert [c["score"] for c in res.candidates] == \
        [c["score"] for c in r_at.tune_als_layout(r, 2, f=SPEC.f, ladder=[
            r_at.LayoutConfig(n_bins=1), r_at.LayoutConfig(n_bins=2)]).candidates]
    names = [e.name for e in tr.spans(cat="autotune")]
    assert names.count("autotune.measure_wave") == 2
    assert names.count("autotune.candidate") == 2
    with pytest.raises(ValueError, match="mode"):
        p_at.tune_als_layout(r, 2, mode="guessed")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p_at.tune_als_layout(r, 2, f=SPEC.f, ladder=ladder[:1], mode="measured")


# ---------------------------------------------------------------------------
# TuneCache contract
# ---------------------------------------------------------------------------

def test_cache_roundtrip_and_key_separation(r, tmp_path):
    path = str(tmp_path / "tune_cache.json")
    miss = p_at.tune_als_layout(r, 4, f=SPEC.f, cache=path)
    assert not miss.cache_hit
    hit = p_at.tune_als_layout(r, 4, f=SPEC.f, cache=path)
    assert hit.cache_hit
    assert (hit.config, hit.score, hit.key, hit.candidates) == \
        (miss.config, miss.score, miss.key, miss.candidates)
    other = p_at.tune_als_layout(r, 2, f=SPEC.f, cache=path)
    assert not other.cache_hit and other.key != miss.key
    with open(path) as fh:
        data = json.load(fh)
    assert data["schema"] == p_at.TUNECACHE_SCHEMA == r_at.TUNECACHE_SCHEMA
    entry = data["entries"][miss.key]
    assert entry["config"] == miss.config.to_obj()
    assert set(entry["provenance"]) == {"git_sha", "timestamp", "torch", "backend",
                                        "schema"}
    assert entry["provenance"]["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert miss.key.endswith("|" + entry["provenance"]["backend"])
    cache = p_at.TuneCache(path)
    cache.invalidate(miss.key)
    assert p_at.tune_als_layout(r, 4, f=SPEC.f, cache=cache).cache_hit is False
    cache.invalidate()
    assert len(p_at.TuneCache(path)) == 0


def test_cache_keys_equal_the_references(r):
    """Keys bucket shapes to powers of two and fingerprint the degree skew,
    as the reference's do; only the backend field is the port's own."""
    deg = r.cnt[:r.m]
    flat = np.full_like(deg, max(int(deg.mean()), 1))
    cases = [("als", r.m, r.n_cols, r.nnz, deg, dict(q=4)),
             ("als", r.m + 3, r.n_cols, r.nnz + 40, deg, dict(q=4)),
             ("als", 2 * r.m, r.n_cols, r.nnz, deg, dict(q=4)),
             ("als", r.m, r.n_cols, 2 * r.nnz, deg, dict(q=4)),
             ("als", r.m, r.n_cols, r.nnz, flat, dict(q=4)),
             ("sgd", r.m, r.n_cols, r.nnz, deg, dict(q=4, k_multiple=16)),
             ("plan", r.m, r.n_cols, r.nnz, np.zeros(5), dict(p=2, q=8))]
    keys = []
    for solver, m, n, nnz, d, kw in cases:
        mine = p_at.tune_key(solver, m, n, nnz, d, **kw)
        ref = r_at.tune_key(solver, m, n, nnz, d, **kw)
        assert _drop_backend(mine) == _drop_backend(ref)
        assert p_at.tune_key(solver, m, n, nnz, d, backend="tpu", **kw) == \
            r_at.tune_key(solver, m, n, nnz, d, backend="tpu", **kw)
        keys.append(mine)
    assert keys[1] == keys[0]                       # minor drift hits
    assert len({keys[0], *keys[2:]}) == len(keys) - 1   # scale, skew, solver miss
    for d in (deg, flat, np.zeros(3), np.array([1, 1, 50])):
        assert p_at.skew_signature(d) == r_at.skew_signature(d)


def test_cache_ignores_foreign_schema_and_reads_the_references(r, tmp_path):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"schema": "somebody/else-v9", "entries": {"k": {}}}))
    cache = p_at.TuneCache(str(path))
    assert len(cache) == 0                          # a miss, not an error
    cache.put("k2", {"config": p_at.LayoutConfig().to_obj(), "score": 1})
    assert json.loads(path.read_text())["schema"] == p_at.TUNECACHE_SCHEMA
    # one schema: the reference's winner is a hit for the port on its key
    shared = str(tmp_path / "shared.json")
    ref = r_at.tune_als_layout(r, 4, f=SPEC.f, cache=shared)
    entry = r_at.TuneCache(shared).get(ref.key)
    key = p_at.tune_key("als", r.m, r.n_cols, r.nnz, r.cnt, q=4)
    p_at.TuneCache(shared).put(key, entry)
    hit = p_at.tune_als_layout(r, 4, f=SPEC.f, cache=shared)
    assert hit.cache_hit and hit.config.to_obj() == ref.config.to_obj()
    assert r_at.TuneCache(shared).get(ref.key) == entry


# ---------------------------------------------------------------------------
# "auto" wiring: store / planner / SGD grid / ledgers
# ---------------------------------------------------------------------------

def test_store_auto_equals_explicit_best_and_reference(r):
    cache = p_at.TuneCache(None)
    res = p_at.tune_als_layout(r, 4, cache=cache)         # the store's default f=16
    store = p_store.RatingStore(r, q=4, n_bins="auto", tune_cache=cache)
    assert store.tune is not None and store.tune["cache_hit"] is True
    assert store.tune["config"] == res.config.to_obj() and store.tune["key"] == res.key
    explicit = p_store.RatingStore(r, q=4, n_bins=res.config.n_bins,
                                   k_multiple=res.config.k_multiple)
    assert explicit.tune is None
    assert store.n_bins == explicit.n_bins
    assert store.bin_fill_pairs() == explicit.bin_fill_pairs()
    ref = r_store.RatingStore(r, q=4, n_bins="auto")
    assert (store.n_bins, store.bin_fill_pairs()) == (ref.n_bins, ref.bin_fill_pairs())
    fresh = p_store.RatingStore(r, q=4, n_bins="auto")
    assert fresh.tune["cache_hit"] is False
    assert {k: v for k, v in fresh.tune.items() if k != "key"} == \
        {k: v for k, v in ref.tune.items() if k != "key"}
    assert _drop_backend(fresh.tune["key"]) == _drop_backend(ref.tune["key"])


def test_plan_for_auto_prices_the_references_bin_fills(r):
    deg = np.asarray(r.cnt[:r.m])
    mine = p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, 1, 4, n_data=2, hbm_bytes=HBM,
                           auto=True, degrees=deg)
    ref = r_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, 1, 4, n_data=2, hbm_bytes=HBM,
                          auto=True, degrees=deg)
    assert mine.describe() == ref.describe() and mine.terms == ref.terms
    res = p_at.tune_plan_fills(SPEC.m, SPEC.n, r.nnz, SPEC.f, 1, 4, degrees=deg)
    rres = r_at.tune_plan_fills(SPEC.m, SPEC.n, r.nnz, SPEC.f, 1, 4, degrees=deg)
    assert res.candidates == rres.candidates and res.config == \
        p_at.LayoutConfig.from_obj(rres.config.to_obj())
    pairs = next(c["bin_fills"] for c in res.candidates if c["config"] == res.config.to_obj())
    manual = p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, 1, 4, n_data=2, hbm_bytes=HBM,
                             bin_fills=pairs)
    assert mine.terms == manual.terms
    with pytest.raises(ValueError, match="degrees"):
        p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, 1, 4, hbm_bytes=HBM, auto=True)


def test_sgd_auto_grid_equals_the_references(tmp_path):
    """``per_tile_k="auto"`` picks the fewest dispatched slots, builds the
    reference's grid bit for bit, stamps the decision, and rebuilds the
    same grid from a cache hit."""
    r = _problem(alpha_user=1.2)                          # skew both axes
    cache = str(tmp_path / "cache.json")
    grid = p_blocking.block_ell(r, 4, per_tile_k="auto", tune_cache=cache)
    ref = r_blocking.block_ell(r, 4, per_tile_k="auto")
    for k in ("idx", "val", "cnt", "tile_K", "user_perm"):
        np.testing.assert_array_equal(getattr(grid, k), getattr(ref, k))
    assert {k: v for k, v in grid.tune.items() if k != "key"} == \
        {k: v for k, v in ref.tune.items() if k != "key"}
    slots = {(ptk, ds): p_blocking.block_ell(r, 4, per_tile_k=ptk, degree_sort=ds).padded_slots
             for ptk, ds in p_at.SGD_LADDER}
    assert grid.padded_slots == min(slots.values()) == grid.tune["score"]
    assert p_at.LayoutConfig.from_obj(grid.tune["config"]).per_tile_k
    again = p_blocking.block_ell(r, 4, per_tile_k="auto", tune_cache=cache)
    assert again.tune["cache_hit"] is True and again.tune["config"] == grid.tune["config"]
    for k in ("idx", "val", "cnt", "tile_K", "user_perm"):
        np.testing.assert_array_equal(getattr(again, k), getattr(grid, k))
    assert p_blocking.block_ell(r, 4).tune is None


def test_drivers_record_the_decision_in_the_ledger(r):
    store = p_store.RatingStore(r, q=4, n_bins="auto")
    acc_eps = SPEC.n * (SPEC.f * SPEC.f + 3 * SPEC.f + 1) * 4
    plan = p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=1, q=4, n_data=2, eps=acc_eps,
                           buffers=4, hbm_bytes=HBM, **_plan_kw(store))
    sched = build_schedule(plan, SPEC.m, SPEC.n, n_data=2)
    cfg = p_als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=1, device="cpu")
    _, _, tel = run_streaming_als(store, sched, cfg)
    assert tel.ledger["run"]["autotune"] == store.tune
    assert all(rec["ok"] for rec in tel.ledger["records"])
    grid = p_blocking.block_ell(_problem(alpha_user=1.2), 4, per_tile_k="auto")
    scfg = SgdConfig(f=SPEC.f, lam=SPEC.lam, epochs=1, device="cpu")
    _, _, tel = run_streaming_sgd(TileStore(grid), build_sgd_schedule(grid, SPEC.f, n_workers=2),
                                  scfg)
    assert tel.ledger["run"]["autotune"] == grid.tune
    assert all(rec["ok"] for rec in tel.ledger["records"])
