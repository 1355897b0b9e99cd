"""Runs one benchmark cell of the PyTorch/CUDA port and prints its result.

    python3 bench/run.py --workload netflix.als --seed 7 --seconds 10 --trace 0

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are looked up by name in ``BENCHMARK.json``.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the same numbers are the last lines of standard error.  Without a CUDA
card, or without the program beside the benchmark, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in the process that
#: prints a result: JAX and the port's reference package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths() -> None:
    """The program from the checkout's ``src/``; every kernel cache of the
    run at a fixed path inside the checkout."""
    sys.path.insert(0, str(ROOT / "src"))
    cache = BENCH / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the reference
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def check_numbers(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, device,
             spec: dict | None = None, config: dict | None = None,
             limits: dict | None = None, t_start: float = T_START) -> dict:
    """Everything of a run but the look for a card: the cell's driver, its
    metrics, and the comparison.  ``config`` and ``limits`` replace the
    cell's own (tests run a cell at a tiny size).  Returns the result
    object."""
    from mfbench import registry

    spec = spec or registry.benchmark()
    wl = registry.workload(workload_name, spec)
    cfg = config or registry.config(wl["config"], spec)
    traffic = registry.traffic(wl["traffic"])
    driver = registry.driver(traffic["solver"])
    out = driver.run(cfg, traffic, seed, seconds, trace, device, t_start)

    metrics = {}
    if trace:
        for m in registry.metrics_for(workload_name, "per_layer", spec):
            value = registry.metric_reader(m["name"])(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.metrics_for(workload_name, "end_to_end", spec):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    correct, checks = check_numbers(
        out["numbers"], registry.limits(workload_name) if limits is None else limits)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": None, "count": 1,
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        dt = out["ctx"]["device"]
        result["device"].update(busy_s=dt["busy_s"], window_s=dt["window_s"])
        result["breakdown"] = {"device_ops": dt["device_ops"], "idle_gaps": dt["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()

    import torch
    from mfbench import registry

    spec = registry.benchmark()
    chips = int(registry.workload(args.workload, spec)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here when the program is not beside the benchmark)

    device = torch.device("cuda", 0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, spec)
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}: no JAX, and not the reference package",
              file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["device"]["power_limit_w"] = power_limit_w()
    checks = result.pop("checks")
    result["checks"] = checks       # last key of the line
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
