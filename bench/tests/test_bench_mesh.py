"""The four-card SU-ALS cell (``yahoomusic.als_mesh4``) on four CPU cells at
a tiny size, with the program's plain path: sound, it reads ``correct``
and reports its metrics; with a fault of the mesh underneath, it does not.

The faults only a mesh can have: a step that returns its state
unchanged; one column shard's ratings dropped where they are placed on
the cells; one cell's partial Hermitian left out of the reduction."""
import json
import time

import pytest
import torch

from mfbench import registry

CELL = "yahoomusic.als_mesh4"
CONFIG = registry.workload(CELL)["config"]
NEW = ("reduce_ms.mesh", "reduce_link_share.mesh", "card_busy_spread.mesh", "als_mfu.mesh")


def tiny_config():
    cfg = registry.config(CONFIG)
    cfg.update(m=500, n=120, nnz=16000, test_nnz=1800, f=8, n_bins=4, batch_rows=64)
    return cfg


def tiny_limits():
    """The cell's limits at the tiny size.  The train RMSE gap is a sum of
    independent float32 rounding errors of the predictions over the
    ratings, so its share of the RMSE shrinks as 1/sqrt(nnz): the limit
    set at the cell's 252.8 M ratings grows by sqrt(252.8 M / 16,000)
    here (the seed below reads 1.1e-8 against 3.8e-8).  The others hold
    as set."""
    limits = registry.limits(CELL)
    limits["train_rmse_gap"] *= (registry.config(CONFIG)["nnz"]
                                 / tiny_config()["nnz"]) ** 0.5
    return limits


def run_tiny(bench_run, trace=False, workload=CELL, config=None):
    torch.set_num_threads(2)
    return bench_run.run_cell(workload, 2**31 + 107, 0.3, trace, [torch.device("cpu")] * 4,
                              config=config or tiny_config(), limits=tiny_limits(),
                              t_start=time.perf_counter())


def test_cell_is_declared_on_four_cards():
    spec = registry.benchmark()
    wl = registry.workload(CELL, spec)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("yahoomusic_mesh4", "als_mesh4", 4)
    # the deployment runs the yahoomusic data set number for number, on its
    # own cards: four, p 4 column shards, q 1
    cfg, data_set = registry.config(CONFIG), registry.config("yahoomusic")
    assert {k: cfg[k] for k in data_set if k not in ("name", "source", "paper",
                                                     "guarantees")} == \
        {k: v for k, v in data_set.items() if k not in ("name", "source", "paper",
                                                         "guarantees")}
    assert (cfg["cards"], cfg["p"], cfg["q"]) == (wl["chips"], 4, 1)
    assert cfg["source"] != data_set["source"] and cfg["reduced"] == []
    traffic = registry.traffic("als_mesh4")
    assert registry.driver(traffic["solver"]).__name__ == "mfbench.su_als_cell"
    names = {m["name"] for m in registry.metrics_for(CELL, "per_layer", spec)}
    assert names == {"layout_s", "herm_roofline", "solve_roofline", "objective_ms.als",
                     "device_idle.als", *NEW}
    assert {m["name"] for m in registry.metrics_for(CELL, "end_to_end", spec)} == \
        {"setup_s", "als_iter_ms", "peak_mem_GiB"}
    assert traffic["scheme"] == "two_phase"


@pytest.mark.parametrize("key, value", [("cards", 2), ("p", 2), ("q", 2)])
def test_a_mesh_the_configuration_does_not_deploy_is_refused(bench_run, key, value):
    cfg = tiny_config()
    cfg[key] = value
    with pytest.raises(ValueError, match="the configuration deploys"):
        run_tiny(bench_run, config=cfg)


def test_a_scheme_the_mesh_does_not_give_is_refused(bench_run, monkeypatch):
    traffic = dict(registry.traffic("als_mesh4"), scheme="one_phase")
    monkeypatch.setattr(registry, "traffic", lambda name: traffic)
    with pytest.raises(ValueError, match="the traffic asks for one_phase"):
        run_tiny(bench_run)


def test_sound_run_is_correct(bench_run):
    res = run_tiny(bench_run)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "als_iter_ms", "peak_mem_GiB"}
    assert set(res["checks"]) == {"backward_error", "train_rmse_gap"}
    assert set(registry.limits(CELL)) == set(res["checks"])


def test_traced_run_reports_its_layer_metrics(bench_run):
    res = run_tiny(bench_run, trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert {"layout_s", "herm_roofline", "solve_roofline", "objective_ms.als",
            "device_idle.als", "reduce_ms.mesh", "reduce_link_share.mesh"} <= set(got)
    assert got["reduce_ms.mesh"]["value"] > 0 and got["reduce_link_share.mesh"]["value"] > 0
    # four cells' peaks in the denominator: a quarter of one card's share
    assert 0 < got["als_mfu.mesh"]["value"] < 100
    # the CPU has no cards, so no card's busy share
    assert "card_busy_spread.mesh" not in got


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_outside_their_cell(name):
    one_card = {"solver": "als", "steps": 3, "window_s": 1.0, "spans": {"layout": 1.0},
                "calls": {"fused_herm": [(1.0, 1e9, 1e9)], "batch_solve": [(1.0, 1e9, 1e9)],
                          "objective": [1.0]},
                "device": {"busy_s": 0.5, "window_s": 1.0, "card_busy_s": {0: 0.5, 1: 0.2}}}
    assert registry.metric_reader(name)(one_card) is None
    assert registry.metric_reader(name)({"solver": "sgd", "steps": 3, "calls": {},
                                         "device": one_card["device"]}) is None


def test_card_busy_spread_is_points_of_the_window():
    ctx = {"mesh": {"cards": 4, "reduce_ms": [], "reduce_bytes": []},
           "device": {"busy_s": 0.5, "window_s": 2.0,
                      "card_busy_s": {0: 1.8, 1: 1.0, 2: 1.2, 3: 1.1}}}
    assert registry.metric_reader("card_busy_spread.mesh")(ctx) == pytest.approx(40.0)


def test_mesh_mfu_divides_by_every_card():
    ctx = {"solver": "als", "steps": 2, "window_s": 1.0, "step_ops": 67e12 * 0.1,
           "mesh": {"cards": 4, "reduce_ms": [], "reduce_bytes": []}}
    # 6.7 TFLOP a 0.5 s step is 13.4 TFLOP/s, 5 % of four cards' 268
    assert registry.metric_reader("als_mfu.mesh")(ctx) == pytest.approx(5.0)
    assert registry.metric_reader("als_mfu")(ctx) == pytest.approx(20.0)


def test_link_share_counts_bytes_per_card():
    ctx = {"mesh": {"cards": 4, "reduce_ms": [10.0, 10.0], "reduce_bytes": [3.6e9, 5.4e9]},
           "steps": 2}
    # 9e9 bytes over 4 cards at 450e9 B/s is 5 ms of the 20 ms measured
    assert registry.metric_reader("reduce_link_share.mesh")(ctx) == pytest.approx(25.0)
    assert registry.metric_reader("reduce_ms.mesh")(ctx) == pytest.approx(10.0)


def _unchanged(monkeypatch, su_als, coll):
    orig, first = su_als.mesh_half, {}

    def half(fixed, side, *a, **k):
        if id(side) not in first:
            first[id(side)] = orig(fixed, side, *a, **k)
        return first[id(side)]
    monkeypatch.setattr(su_als, "mesh_half", half)


def _shard_dropped(monkeypatch, su_als, coll):
    orig = su_als.place_side

    def place(layout, mesh):
        side = orig(layout, mesh)
        p = su_als.mesh_axes(mesh)[1]
        for blocks in side.blocks:
            for c in range(1, len(blocks), p):
                idx, val, cnt = blocks[c]
                blocks[c] = (idx, val, torch.zeros_like(cnt))
        return side
    monkeypatch.setattr(su_als, "place_side", place)


def _partial_left_out(monkeypatch, su_als, coll):
    orig = coll.two_level_reduce_scatter

    def reduce(parts, *a, **k):
        return orig(list(parts[:-1]) + [torch.zeros_like(parts[-1])], *a, **k)
    monkeypatch.setattr(coll, "two_level_reduce_scatter", reduce)


@pytest.mark.parametrize("fault", [_unchanged, _shard_dropped, _partial_left_out],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(bench_run, monkeypatch, fault):
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import su_als
    fault(monkeypatch, su_als, coll)
    res = run_tiny(bench_run)
    assert not res["correct"], res["checks"]


def test_a_peer_copy_is_put_on_the_card_that_runs_it(monkeypatch):
    """The chrome trace names a copy between cards by ``inDevice``; the
    cell's profile reduction books it there, not on the home card."""
    from mfbench import su_als_cell

    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 100,
               "args": {"device": 0}},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy PtoP", "ts": 200, "dur": 300,
               "args": {"fromDevice": 2, "inDevice": 2, "toDevice": 3}}]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": events}, fh)

    class Window:
        prof, t0, t1, cards = Prof(), 0.0, 1.0, [0, 1, 2, 3]

    got = su_als_cell._reduce_profile(Window())
    assert got["card_busy_s"] == pytest.approx({0: 100e-6, 1: 0.0, 2: 300e-6, 3: 0.0})
