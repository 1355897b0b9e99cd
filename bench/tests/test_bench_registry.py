"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix and per-layer metric found by name."""
import json
import re

import pytest

from mfbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = registry.benchmark()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert NAME.match(entry["name"])
    cfg = registry.config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]


LIMITS = {"als": {"backward_error", "train_rmse_gap", "test_rmse_gap"},
          "sgd": {"x_epoch_gap", "theta_epoch_gap", "test_rmse_gap"}}


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_limits_found_by_name(entry):
    solver = registry.traffic(entry["traffic"])["solver"]
    limits = registry.limits(entry["name"])
    assert set(limits) == LIMITS[solver]
    assert all(0 < v < 1 for v in limits.values())


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_workload_found_by_name(entry):
    assert NAME.match(entry["name"]) and entry["chips"] in (1, 4)
    assert registry.workload(entry["name"]) == entry
    assert registry.traffic(entry["traffic"])["solver"]
    assert registry.config(entry["config"])
    kinds = {m["name"] for m in registry.metrics_for(entry["name"], "end_to_end")}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert registry.metrics_for(entry["name"], "per_layer")


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"] for m in SPEC["end_to_end"]}
        assert metric["moves"] in e2e and metric["layer"]
        for wl in metric.get("workloads", []):
            assert metric["moves"] in {m["name"] for m in registry.metrics_for(wl, "end_to_end")}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_reader_found_by_name_and_silent_without_data(metric):
    read = registry.metric_reader(metric["name"])
    empty = {"solver": None, "spans": {}, "calls": {}, "steps": 0, "window_s": 0.0,
             "device": None}
    assert read(empty) is None


def test_readers_on_a_synthetic_trace():
    ctx = {"solver": "als", "spans": {"layout": 2.5}, "steps": 4, "window_s": 2.0,
           "step_ops": 67e12 * 0.05,
           "calls": {"fused_herm": [(100.0, 67e12 * 0.05, 1.0)] * 2,
                     "batch_solve": [(50.0, 1.0, 3.35e12 * 0.025)],
                     "objective": [10.0, 30.0]},
           "device": {"busy_s": 0.9, "window_s": 1.0}}
    got = {m["name"]: registry.metric_reader(m["name"])(ctx) for m in SPEC["per_layer"]}
    assert got["layout_s"] == 2.5
    assert got["herm_roofline"] == pytest.approx(50.0)
    assert got["solve_roofline"] == pytest.approx(50.0)
    assert got["als_mfu"] == pytest.approx(10.0)
    assert got["objective_ms.als"] == pytest.approx(10.0)
    assert got["device_idle.als"] == pytest.approx(10.0)


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_driver_found_by_solver_name(entry):
    solver = registry.traffic(entry["traffic"])["solver"]
    driver = registry.driver(solver)
    assert driver.__name__ == f"mfbench.{solver}_cell" and callable(driver.run)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.workload("no_such.cell")
    with pytest.raises(KeyError):
        registry.config("no_such_config")
    with pytest.raises(KeyError):
        registry.driver("no_such_solver")
