"""Bench history: append every emission to a provenance-stamped JSONL.

``benchmarks_torch/run.py`` calls :func:`append_history` for every module
whose ``run()`` returned JSON records, so ``BENCH_torch_HISTORY.jsonl``
accumulates one line per (bench, run) with enough provenance to compare
like with like::

    {"schema": "repro.obs/bench-history-v1",
     "provenance": {"git_sha": ..., "timestamp": ..., "backend": ...,
                    "device_count": ..., "torch": ..., "cuda": ...,
                    "gpu": ..., "power_limit": ..., "quick": ...},
     "bench": "bench_huge", "records": [...]}

The schema is the reference's, so ``python -m repro_torch.obs.regress
--history BENCH_torch_HISTORY.jsonl`` reads the file: newest entry against
a rolling baseline of prior entries with the same (bench, quick, backend,
device_count) — deterministic byte/count metrics exact, times warn-only.

The same provenance dict is also stamped INTO each emitted JSON record
(``record["provenance"]``) so a BENCH_torch_*.json file is self-describing
without its history line.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess

HISTORY_SCHEMA = "repro.obs/bench-history-v1"   # mirror of repro_torch.obs.regress


def _run(cmd: list[str], cwd: str) -> str:
    """``cmd``'s standard output, stripped; "" when it cannot run."""
    try:
        return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def provenance(quick: bool = False, device: str | None = None) -> dict:
    """Where/when/what of this bench process.  ``backend`` is the type of
    ``device`` (the benches' ``--device``; the card when it is None and
    one is present), so a CPU run never joins the card's baseline.  Every
    field degrades to a sentinel rather than raising — benches must run in
    a bare checkout (no git), without ``nvidia-smi`` and without a card."""
    here = os.path.dirname(os.path.abspath(__file__))
    prov = {
        "git_sha": _run(["git", "rev-parse", "HEAD"], here) or "unknown",
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "quick": bool(quick),
        "backend": "unknown",
        "device_count": 0,
        "torch": "unknown",
        "cuda": "unknown",
        "gpu": "unknown",
        "power_limit": "unknown",
    }
    try:
        import torch

        prov["torch"] = torch.__version__
        prov["cuda"] = torch.version.cuda or "none"
        on_card = torch.cuda.is_available()
        backend = (torch.device(device).type if device is not None
                   else "cuda" if on_card else "cpu")
        prov["backend"] = backend
        prov["device_count"] = (torch.cuda.device_count()
                                if on_card and backend == "cuda" else 0)
    except Exception:               # a broken install still gets its line
        pass
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], here)
    if smi:
        name, _, limit = smi.splitlines()[0].partition(",")
        prov["gpu"] = name.strip() or "unknown"
        prov["power_limit"] = limit.strip() or "unknown"
    return prov


def stamp(records: list[dict], prov: dict) -> list[dict]:
    """Attach the provenance dict to every emitted JSON record, in place."""
    for rec in records:
        rec["provenance"] = prov
    return records


def append_history(path: str, bench: str, records: list[dict],
                   prov: dict) -> None:
    """Append one history line for ``bench``'s emission."""
    entry = {"schema": HISTORY_SCHEMA, "provenance": prov,
             "bench": bench, "records": records}
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
