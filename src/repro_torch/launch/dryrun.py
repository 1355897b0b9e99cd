"""Dry-run: lay every (arch x shape x mesh) cell out on the H100
deployment's meta cells and cost it, without a card (the reference's
``launch/dryrun.py``).

For each cell this shows, without hardware:

- the layout is coherent: every argument leaf's spec splits its dims over
  the mesh (``distributed.sharding``), and the step's units run through
  the mesh forward on those layouts (``launch/units.py``);
- what a cell holds and whether it fits the 80 GB of its card;
- the flops and collectives the roofline (``benchmarks_torch/roofline.py``)
  reads.

Memory, per cell on a card of its own (``memory``):

- ``argument_bytes``: the cell's blocks of the parameters, the optimizer
  state or the cache, and the inputs (``launch.builders.io_bytes``);
- ``output_bytes`` and ``alias_bytes``: what the step returns, the
  arguments it writes in place included (the decode cache, the train
  state), and those in-place bytes;
- ``working_set_bytes``: the peak of the storage one layer unit creates,
  a cell's share (the largest over the block kinds; an ALS wave's over the
  whole wave);
- ``peak_estimate_bytes`` = arguments + outputs - aliased + one working
  set, ``live_set_estimate_bytes`` = arguments + outputs - aliased + 2 x
  the working set (the reference's formula); ``fits`` when the live set is
  under 80e9.

``memory["device"]`` gives the same for one device that holds every cell
of the mesh, as meta cells share the meta device and a cut mesh's cells
share one card: each argument and output once, the working set over all
cells.

Artifacts land in ``experiments_torch/dryrun/<cell>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --als netflix
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Optional

from repro_torch.launch import builders, units
from repro_torch.launch.mesh import HBM_BYTES, Mesh, make_production_mesh
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import phase

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
                            "experiments_torch", "dryrun")


def _memory(io: dict, ws_cell: int, ws_device: int) -> dict:
    c, d = io["cell"], io["device"]
    base = c["argument"] + c["output"] - c["alias"]
    mem = {"argument_bytes": c["argument"], "output_bytes": c["output"],
           "alias_bytes": c["alias"], "working_set_bytes": int(ws_cell),
           "peak_estimate_bytes": int(base + ws_cell),
           "live_set_estimate_bytes": int(base + 2 * ws_cell),
           "hbm_budget_bytes": HBM_BYTES}
    mem["fits"] = bool(mem["live_set_estimate_bytes"] < HBM_BYTES)
    dbase = d["argument"] + d["output"] - d["alias"]
    mem["device"] = {"argument_bytes": d["argument"], "output_bytes": d["output"],
                     "alias_bytes": d["alias"], "working_set_bytes": int(ws_device),
                     "peak_estimate_bytes": int(dbase + ws_device),
                     "live_set_estimate_bytes": int(dbase + 2 * ws_device)}
    return mem


def _head(arch: str, shape: str, mesh: Mesh, meta: dict) -> dict:
    return {"arch": arch, "shape": shape, "mesh": list(mesh.devices.shape),
            "axes": list(mesh.axis_names), "meta": meta}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             opts: Optional[builders.CellOpts] = None, *, spec=None, shape=None,
             mesh: Optional[Mesh] = None) -> dict:
    """The dry-run record of one LM cell on the deployment mesh (or
    ``mesh``); ``spec`` / ``shape`` stand in for the registry's."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    opts = opts or builders.CellOpts()
    reg = MetricsRegistry()
    with phase("dryrun.build", cat="build", registry=reg, arch=arch_id, shape=shape_name):
        cell = builders.build_cell(arch_id, shape_name, mesh, opts, spec=spec, shape=shape)
    rec = _head(arch_id, shape_name, mesh, cell.meta)
    if cell.fn is None:
        rec["status"] = "skip"
        return rec
    spec = spec or builders.registry.get_arch(arch_id)
    shape = shape or builders.SHAPES[shape_name]
    with phase("dryrun.units", cat="units", registry=reg, arch=arch_id, shape=shape_name):
        io = builders.io_bytes(cell)
        cost = units.cost_cell(spec, shape, mesh, opts)
    ph = reg.phase_seconds()
    ws_dev = cost["unit_peak_bytes"] * cell.io["mesh"].size // cost["unit_cells"]
    rec.update({
        "status": "ok",
        "build_s": round(ph["build"], 2),
        "units_s": round(ph["units"], 2),
        "memory": _memory(io, cost["working_set_bytes"], ws_dev),
        "cost": {"flops": cost["flops"], "flops_by_dtype": cost["flops_by_dtype"],
                 "bytes_accessed": float(io["cell"]["argument"] + io["cell"]["output"])},
        "collectives": cost["collectives"],
    })
    return rec


def run_als_cell(als_name: str, multi_pod: bool = False, scheme: str = "two_phase", *,
                 mesh: Optional[Mesh] = None, m_wave: Optional[int] = None) -> dict:
    """The dry-run record of one SU-ALS update-X wave (``--als``).  The
    wave runs on the mesh with its data axis cut to 1, one data shard's
    rows (every data shard does the same work)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    reg = MetricsRegistry()
    with phase("dryrun.build", cat="build", registry=reg, als=als_name, scheme=scheme):
        cell = builders.build_als_cell(als_name, mesh, scheme=scheme, m_wave=m_wave)
    rec = _head("cumf-als", als_name, mesh, cell.meta)
    q = mesh.shape["data"]
    um = units.unit_mesh(mesh, cut=("data",))
    with phase("dryrun.units", cat="units", registry=reg, als=als_name, scheme=scheme):
        io = builders.io_bytes(cell)
        wave = cell if q == 1 else builders.build_als_cell(
            als_name, um, scheme=scheme, m_wave=cell.meta["m_wave"] // q)
        m = units.measure(wave.fn, wave.args, um.size, dict(mesh.shape))
    ph = reg.phase_seconds()
    rec.update({
        "status": "ok",
        "build_s": round(ph["build"], 2),
        "units_s": round(ph["units"], 2),
        "memory": _memory(io, m["peak_bytes"] // um.size, m["peak_bytes"] * q),
        "cost": {"flops": m["flops"] / um.size,
                 "flops_by_dtype": {k: v / um.size for k, v in m["flops_by_dtype"].items()},
                 "bytes_accessed": float(io["cell"]["argument"] + io["cell"]["output"])},
        "collectives": m["collectives"].summary(),
    })
    return rec


def _save(rec: dict, tag: str, out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    fits = rec.get("memory", {}).get("fits")
    live = rec.get("memory", {}).get("live_set_estimate_bytes")
    print(f"[dryrun] {tag}: {rec.get('status')}"
          + (f" fits={fits} live_set={live / 2**30:.2f} GiB" if fits is not None else ""),
          flush=True)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--als")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--fused-loss", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact is already ok/skip")
    ap.add_argument("--out", default=None, help=f"artifact directory (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES

    pods = []
    if args.multi_pod or not args.single_pod:
        pods.append(True)
    if args.single_pod or not args.multi_pod:
        pods.insert(0, False)
    opts = builders.CellOpts(causal_skip=args.causal_skip, fused_loss=args.fused_loss)
    out_dir = args.out or ARTIFACT_DIR

    if args.als:
        failures = 0
        for mp in pods:
            tag = f"als_{args.als}_{'mp' if mp else 'sp'}"
            try:
                rec = run_als_cell(args.als, mp)
                failures += not rec["memory"]["fits"]
            except Exception:
                rec = {"arch": "cumf-als", "shape": args.als, "status": "error",
                       "trace": traceback.format_exc()}
                failures += 1
            _save(rec, tag, out_dir)
        print(f"[dryrun] done, failures={failures}")
        return 1 if failures else 0
    if args.all:
        cells = [(a, s) for a in registry.list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("need --arch/--shape, --als, or --all")

    failures = 0
    for arch_id, shape_name in cells:
        for mp in pods:
            tag = f"{arch_id}_{shape_name}_{'mp' if mp else 'sp'}"
            path = os.path.join(out_dir, f"{tag}.json")
            if args.resume and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") == "skip" or (
                        prev.get("status") == "ok" and prev.get("memory", {}).get("fits")):
                    print(f"[dryrun] {tag}: cached ok", flush=True)
                    continue
            try:
                rec = run_cell(arch_id, shape_name, mp, opts)
                if rec.get("status") == "ok" and not rec["memory"]["fits"]:
                    failures += 1
            except Exception:
                rec = {"arch": arch_id, "shape": shape_name, "status": "error",
                       "trace": traceback.format_exc()}
                failures += 1
            _save(rec, tag, out_dir)
    print(f"[dryrun] done, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
