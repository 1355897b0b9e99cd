"""Tables of the port's dry-run and roofline records (the reference's
``benchmarks/report.py``): the same rows and columns, the H100 deployment's
mesh names, and the dry-run's peak from its meta working set.

    python benchmarks_torch/report.py [all|dryrun|roofline]
"""
from __future__ import annotations

import glob
import json
import os

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DRY = os.path.join(ROOT, "experiments_torch", "dryrun")
ROOF = os.path.join(ROOT, "experiments_torch", "roofline")

ARCH_ORDER = ["musicgen-medium", "qwen1.5-4b", "phi3-mini-3.8b",
              "mistral-large-123b", "qwen3-4b", "olmoe-1b-7b",
              "moonshot-v1-16b-a3b", "recurrentgemma-2b", "rwkv6-7b",
              "internvl2-26b", "cumf-als"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "netflix", "hugewiki", "facebook_f100"]
MESH_NAMES = {False: "32x8", True: "2x32x8"}


def _load(d):
    recs = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        with open(f) as fh:
            recs[os.path.basename(f)[:-5]] = json.load(fh)
    return recs


def gib(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(directory: str = None) -> str:
    recs = _load(directory or DRY)
    lines = [
        "| arch | shape | mesh | status | peak GiB (meta, one layer) | live-set GiB | fits | GFLOP/cell | coll. wire GiB/cell |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mp, tagsuf in ((False, "sp"), (True, "mp")):
                key = (f"{arch}_{shape}_{tagsuf}" if arch != "cumf-als"
                       else f"als_{shape}_{tagsuf}")
                r = recs.get(key)
                if r is None:
                    continue
                mesh = MESH_NAMES[mp]
                if r.get("status") == "skip":
                    lines.append(f"| {arch} | {shape} | {mesh} | SKIP"
                                 f" | — | — | — | — | — |")
                    continue
                if r.get("status") != "ok":
                    lines.append(f"| {arch} | {shape} | {mesh} | ERROR"
                                 f" | — | — | — | — | — |")
                    continue
                m = r["memory"]
                live = m.get("live_set_estimate_bytes",
                             m["peak_estimate_bytes"])
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok "
                    f"| {gib(m['peak_estimate_bytes'])} "
                    f"| {gib(live)} "
                    f"| {'Y' if m.get('fits') else 'N'} "
                    f"| {r['cost']['flops'] / 1e9:.0f} "
                    f"| {r['collectives']['total_bytes'] / 2**30:.2f} |")
    return "\n".join(lines)


def roofline_table(suffix="", directory: str = None) -> str:
    recs = _load(directory or ROOF)
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | MODEL/counted flops | roofline step s | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get(f"{arch}_{shape}{suffix}")
            if r is None or r.get("status") != "ok":
                if r is not None and r.get("status") == "skip":
                    lines.append(f"| {arch} | {shape} | SKIP | | | | | | |")
                continue
            t = r["terms_s"]
            lines.append(
                f"| {arch} | {shape} "
                f"| {t['compute_s']:.4f} | {t['memory_s']:.4f} "
                f"| {t['collective_s']:.4f} "
                f"| {r['dominant'].replace('_s', '')} "
                f"| {r['useful_ratio']:.2f} "
                f"| {r['roofline_step_s']:.4f} "
                f"| {r['mfu_upper_bound']:.2f} |")
    return "\n".join(lines)


def summary_stats(directory: str = None):
    recs = _load(directory or DRY)
    ok = skip = err = nofit = 0
    for r in recs.values():
        s = r.get("status")
        if s == "skip":
            skip += 1
        elif s == "ok":
            if r["memory"].get("fits"):
                ok += 1
            else:
                nofit += 1
        else:
            err += 1
    return {"ok": ok, "skip": skip, "error": err, "nofit": nofit}


if __name__ == "__main__":
    import sys
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "dryrun"):
        print("## Dry-run table\n")
        print(dryrun_table())
        print("\nsummary:", summary_stats())
    if which in ("all", "roofline"):
        print("\n## Roofline table (single-pod)\n")
        print(roofline_table())
