"""Runs one benchmark cell of the PyTorch/CUDA port and prints its result.

    python3 bench/run.py --workload netflix.als --seed 7 --seconds 10 --trace 0

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are looked up by name in ``BENCHMARK.json``.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the same numbers are the last lines of standard error.  The cell runs on
the ``chips`` cards that ``BENCHMARK.json`` gives it, ``cuda:0`` onwards,
and ``device`` reports the cards the run used (``count``), their shared
name and the fullest card's peak; each card's peaks go to standard error.
Without as many CUDA cards, or without the program beside the benchmark,
it exits non-zero and prints no result.
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


def power_limit_w(cards: list[int]) -> float | None:
    """The lowest power limit among ``cards``, in watts, as ``nvidia-smi``
    reads each (None where one cannot be read)."""
    limits = []
    try:
        for card in cards:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                 "-i", str(card)], capture_output=True, text=True, timeout=30, check=True).stdout
            limits.append(float(out.strip().splitlines()[0]))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
    return min(limits, default=None)


class MixedCards(Exception):
    """The cards a run used do not share one name."""


def describe_cards(cards: list[int]) -> dict:
    """``kind``, the name the cards share, and ``power_limit_w``, the
    lowest of their limits."""
    import torch
    names = sorted({torch.cuda.get_device_name(c) for c in cards})
    if len(names) != 1:
        raise MixedCards(f"the cards {cards} the run used are named {names}")
    return {"kind": names[0], "power_limit_w": power_limit_w(cards)}


def check_numbers(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, devices: list,
             spec: dict | None = None, config: dict | None = None,
             limits: dict | None = None, t_start: float = T_START) -> dict:
    """Everything of a run but the look for cards: the cell's driver on
    ``devices`` (``devices[0]`` the home card), its metrics, and the
    comparison.  ``config`` and ``limits`` replace the cell's own (tests
    run a cell at a tiny size).  Returns the result object; on CUDA cards
    its ``device`` is described by :func:`describe_cards`."""
    from mfbench import registry
    from mfbench.window import log, used_cards

    spec = spec or registry.benchmark()
    wl = registry.workload(workload_name, spec)
    cfg = config or registry.config(wl["config"], spec)
    traffic = registry.traffic(wl["traffic"])
    driver = registry.driver(traffic["solver"])
    out = driver.run(cfg, traffic, seed, seconds, trace, devices, t_start)

    # the cards the run used, and the mean busy time over them
    peaks = out["peaks"]
    dt = out["ctx"]["device"] if trace else None
    used = used_cards(peaks, dt["card_busy_s"] if trace else None)
    if trace:
        busy = [dt["card_busy_s"][c] for c in used]
        dt["busy_s"] = sum(busy) / len(busy) if busy else 0.0
    for card, (setup_peak, window_peak) in peaks.items():
        note = f", busy {dt['card_busy_s'].get(card, 0.0)!r} s" if trace else ""
        log(f"card {card}: set-up peak {setup_peak} B, window peak {window_peak} B{note}"
            f"{'' if card in used else ', not used'}")

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
    home = devices[0]
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if home.type == "cuda" else home.type,
                         "kind": None, "count": len(used),
                         "memory_peak_bytes": max((max(p) for p in peaks.values()), default=0)}}
    if trace:
        result["device"].update(busy_s=dt["busy_s"], window_s=dt["window_s"])
        result["breakdown"] = {"device_ops": dt["device_ops"], "idle_gaps": dt["idle_gaps"]}
    if home.type == "cuda":
        result["device"].update(describe_cards(used or [home.index]))
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

    devices = [torch.device("cuda", i) for i in range(chips)]
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), devices,
                          spec)
    except MixedCards as exc:
        print(exc, file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}: no JAX, and not the reference package",
              file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
