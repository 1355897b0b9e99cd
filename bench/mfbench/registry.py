"""Finds a cell's configuration, traffic mix and per-layer metric readers
by the names ``BENCHMARK.json`` gives them.

A later change adds a configuration, a traffic mix, a cell's limits, a
metric or a solver's driver as a new file (``bench/configs/<name>.json``,
``bench/traffic/<name>.json``, ``bench/limits/<workload>.json``,
``bench/metrics/<name>.py``, ``bench/mfbench/<solver>_cell.py``) plus its
entry in ``BENCHMARK.json``; nothing here needs an edit for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _entry(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(name: str, spec: dict | None = None) -> dict:
    return _entry((spec or benchmark())["workloads"], name, "workload")


def config(name: str, spec: dict | None = None) -> dict:
    """The configuration file named by BENCHMARK.json's ``configs`` entry."""
    entry = _entry((spec or benchmark())["configs"], name, "configuration")
    with open(ROOT / entry["file"]) as fh:
        return json.load(fh)


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def driver(solver: str):
    """The driver of a traffic mix's ``solver``: ``mfbench/<solver>_cell.py``,
    whose ``run(cfg, traffic, seed, seconds, trace, devices, t_start)`` runs
    one cell.

    ``devices`` are the cell's ``chips`` cards, ``cuda:0`` onwards (one CPU
    device in the tests); ``devices[0]`` is the home card, where the
    ratings are made, and a driver that spreads its work hands the list
    on (a mesh: ``repro_torch.launch.mesh.make_mesh(..., devices=...)``).
    It measures through a :class:`mfbench.window.Window` over ``devices``
    and returns ``e2e`` (the end-to-end values), ``ctx`` (what the
    per-layer readers read; a traced run's ``ctx["device"]`` is the
    profiler's :func:`mfbench.devtrace.reduce_trace`), ``numbers`` (what
    ``correct`` compares), ``attempted``, ``failed`` and ``peaks``
    (``Window.peaks``: each card's set-up and window peaks), from which
    the result counts the cards the run used."""
    if not (BENCH / "mfbench" / f"{solver}_cell.py").is_file():
        raise KeyError(f"no driver mfbench/{solver}_cell.py for solver {solver!r}")
    return importlib.import_module(f"mfbench.{solver}_cell")


def limits(workload_name: str) -> dict:
    """The limits of the numbers that decide a cell's ``correct``, from
    ``bench/limits/<workload>.json`` ({} when the cell has none yet)."""
    path = BENCH / "limits" / f"{workload_name}.json"
    if not path.is_file():
        return {}
    with open(path) as fh:
        return {k: v["limit"] for k, v in json.load(fh)["numbers"].items()}


def metrics_for(workload_name: str, kind: str, spec: dict | None = None) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    whose ``workloads`` list it, and those with no such list."""
    return [m for m in (spec or benchmark())[kind]
            if "workloads" not in m or workload_name in m["workloads"]]


def metric_reader(name: str):
    """``read(ctx)`` of ``bench/metrics/<name>.py``: the metric's value from
    what the traced run collected, or None where it finds nothing."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
