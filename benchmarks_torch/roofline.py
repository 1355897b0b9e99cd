"""Roofline of the port's steps on the single-pod H100 deployment, data=32
x model=8 (the reference's ``benchmarks/roofline.py``, which also costs
its single-pod mesh only).

Methodology:

- a cell is costed by units (``repro_torch.launch.units``): one layer of
  each kind, the embedding and the head, each run on meta cells at its
  true per-cell shapes and multiplied by its trip count (layers x
  microbatches).  A unit runs on one data group of the mesh (the data
  axes cut to 1), every cell of which does the same work;
- flops per cell are ``FlopCounterMode``'s count (its formulas: matrix
  products and attention; elementwise work counts nothing, so
  ``useful_ratio`` is not XLA's HLO ratio), split by the dtype of the
  product's operands;
- collective bytes per cell are the port's own collectives, each counted
  where it runs (``distributed.collectives.counting``) and priced by the
  ring formulas of the reference's ``parse_collectives``, per mesh axis;
- memory traffic is ``analytic_bytes``, the reference's first-order model
  of the streams a step must move, copied as it is.

Terms (per training or serving step, seconds, per cell):
  compute    = bf16 product flops / 989.4e12 + float32 product flops / 67e12
               (the chunked attention's tiles are float32, as the reference's)
  memory     = analytic bytes / 3.35e12 (HBM3)
  collective = each axis's wire bytes / its link: "model" over NVLink
               (450e9 B/s each way), "data" and "pod" over one 400 Gb/s
               InfiniBand port a card (50e9 B/s); a group over several
               axes goes at its slowest link

The ALS cells (``--als``) are costed from the dry-run's wave: compute and
memory by the useful work and the bytes of the expected nonzeros a cell (a
kernel skips padded slots), collectives as counted.

Usage::

    python benchmarks_torch/roofline.py --arch phi3-mini-3.8b --shape train_4k
    python benchmarks_torch/roofline.py --all [--resume]
    python benchmarks_torch/roofline.py --als netflix

It needs no card: every cell is laid out on meta cells.  Records land in
``experiments_torch/roofline/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import builders, units  # noqa: E402
from repro_torch.launch.mesh import (AXIS_BW, HBM_BW, PEAK_BF16_FLOPS,  # noqa: E402
                                     PEAK_FP32_FLOPS, make_production_mesh)
from repro_torch.launch.units import decode_units, fwd_units, train_units  # noqa: E402,F401
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import phase  # noqa: E402

ARTIFACT_DIR = os.path.join(_ROOT, "experiments_torch", "roofline")


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (global, per step)
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D-convention flops (causal-aware attention), true (unpadded)
    architecture — the 'useful work' numerator of the HLO ratio."""
    from repro_torch.models.transformer import layer_pattern
    B, S = shape.batch, shape.seq
    if shape.kind == "decode":
        tokens = B
    else:
        tokens = B * S
    n_mat = cfg.active_params_count() - cfg.vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 0)   # head matmul counts once
    fwd = 2.0 * n_mat * tokens

    for kind in layer_pattern(cfg):
        if kind == "attn":
            w = cfg.sliding_window
            if shape.kind == "decode":
                ctx = min(w, S) if w else S
                fwd += 4.0 * B * cfg.n_heads * cfg.d_head * ctx
            else:
                ctx = (min(w, S) if w else S / 2.0)
                fwd += 4.0 * B * S * cfg.n_heads * cfg.d_head * ctx
        elif kind == "rwkv":
            fwd += 3.0 * tokens * cfg.d_model * 64    # WKV state update
        elif kind == "rglru":
            fwd += 8.0 * tokens * (cfg.d_rnn or cfg.d_model)
    if shape.kind == "train":
        return 3.0 * fwd
    return fwd


def analytic_bytes(spec, shape: ShapeConfig, mb: int, n_chips: int) -> float:
    """First-order per-device HBM traffic per step (the reference's model,
    copied as it is).

    This model counts the streams that must touch HBM: parameter reads
    (per microbatch, fwd+bwd), optimizer state sweeps, residual/activation
    traffic, KV/cache reads, and the logits tensor.
    """
    from repro_torch.models.transformer import layer_pattern
    cfg = spec.model
    B, S = shape.batch, shape.seq
    P = cfg.params_count()
    L = cfg.n_layers
    d = cfg.d_model

    if shape.kind == "train":
        toks_dev = B * S / n_chips
        toks_mb_dev = toks_dev / mb  # noqa: F841
        param_stream = 2 * mb * (P * 2) * 2 / n_chips * n_chips  # gathered:
        # each device materializes the full bf16 params per microbatch
        # (fwd + bwd) under FSDP — the all-gather writes them to local HBM
        # and the matmuls read them back:
        param_stream = 2 * 2 * mb * (P * 2)
        opt_bytes = 12 if spec.opt == "adamw" else 4.5
        opt_stream = 2 * opt_bytes * P / n_chips + 2 * 4 * P / n_chips
        act_stream = 2.5 * 12 * toks_dev * d * 2 * L
        attn_stream = 0.0
        for kind in layer_pattern(cfg):
            if kind == "attn":
                ctx = min(cfg.sliding_window or S, S)
                # KV re-read per q-chunk (chunk 512) over fwd+bwd+remat
                attn_stream += 2.5 * (toks_dev / 512) * ctx * \
                    cfg.n_kv * cfg.d_head * 2 * 2
        logit_stream = 3 * 2.5 * toks_dev * cfg.vocab / 16 * 2
        return (param_stream + opt_stream + act_stream + attn_stream
                + logit_stream)

    if shape.kind == "prefill":
        toks_dev = B * S / n_chips
        param_stream = P * 2 / 16          # TP-sharded weights, read once
        act_stream = 8 * toks_dev * d * 2 * L
        attn_stream = 0.0
        for kind in layer_pattern(cfg):
            if kind == "attn":
                ctx = min(cfg.sliding_window or S, S)
                attn_stream += (toks_dev / 512) * ctx * cfg.n_kv \
                    * cfg.d_head * 2 * 2
        return param_stream + act_stream + attn_stream

    # decode: weight + cache streams dominate
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, B, S, torch.bfloat16, device="meta")
    cache_bytes = sum(leaf.numel() * leaf.element_size() for leaf in T.tree_leaves(cache))
    param_stream = P * 2 / 16
    return param_stream + cache_bytes / n_chips + 10 * B * d * 2 * L / n_chips


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

def compute_seconds(flops_by_dtype: dict) -> float:
    """bf16 (and fp16) products at the tensor cores' dense peak, the rest at
    the float32 peak."""
    return sum(v / (PEAK_BF16_FLOPS if k in ("bfloat16", "float16") else PEAK_FP32_FLOPS)
               for k, v in flops_by_dtype.items())


def link_seconds(bytes_by_axis: dict) -> dict:
    """Each axis group's wire bytes over its slowest link."""
    out = {}
    for key, b in bytes_by_axis.items():
        axes = [a for a in key.split("+") if a in AXIS_BW]
        out[key] = b / min((AXIS_BW[a] for a in axes), default=min(AXIS_BW.values()))
    return out


def bound_on_one_device(flops_by_dtype: dict, nbytes: float) -> dict:
    """The least time one card could take for work of these flops whose
    inputs and outputs are ``nbytes`` (each read or written once): the
    larger of the compute and the memory term, seconds."""
    terms = {"compute_s": compute_seconds(flops_by_dtype), "memory_s": nbytes / HBM_BW}
    return {"terms_s": terms, "bound_s": max(terms.values()),
            "dominant": max(terms, key=terms.get)}


def _record(arch, shape_name, mesh, flops_by_dtype, bytes_, analytic, colls, mf,
            per_unit) -> dict:
    n_chips = mesh.devices.size
    flops = sum(flops_by_dtype.values())
    coll_s = link_seconds(colls["bytes_by_axis"])
    terms = {"compute_s": compute_seconds(flops_by_dtype), "memory_s": analytic / HBM_BW,
             "collective_s": sum(coll_s.values())}
    dominant = max(terms, key=terms.get)
    step = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "status": "ok", "chips": n_chips,
        "mesh": list(mesh.devices.shape), "axes": list(mesh.axis_names),
        "hlo_flops_per_device": flops,
        "flops_by_dtype": flops_by_dtype,
        "hlo_bytes_per_device": bytes_,
        "analytic_bytes_per_device": analytic,
        "memory_s_hlo_unfused": bytes_ / HBM_BW,
        "collective_bytes_per_device": colls["total_bytes"],
        "collective_bytes_by_axis": colls["bytes_by_axis"],
        "collective_s_by_axis": coll_s,
        "model_flops_global": mf,
        "useful_ratio": mf / max(flops * n_chips, 1.0),
        "terms_s": terms,
        "dominant": dominant,
        "roofline_step_s": step,
        "mfu_upper_bound": mf / (n_chips * PEAK_BF16_FLOPS * step) if step else 0.0,
        "units": per_unit,
    }


def _suffix(opts: builders.CellOpts) -> str:
    return "_opt" if (opts.causal_skip or opts.fused_loss or opts.tp1) else ""


def _save(rec: dict, name: str, out_dir=None) -> None:
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
        json.dump(rec, fh, indent=1)


def roofline_cell(arch_id: str, shape_name: str,
                  opts: builders.CellOpts = builders.CellOpts(), save: bool = True, *,
                  spec=None, shape=None, mesh=None, out_dir=None) -> dict:
    """The roofline record of one LM cell on the single-pod deployment mesh
    (or ``mesh``); ``spec`` / ``shape`` stand in for the registry's."""
    mesh = mesh or make_production_mesh()
    spec = spec or registry.get_arch(arch_id)
    shape = shape or SHAPES[shape_name]
    if spec.skip_reason(shape):
        return {"arch": arch_id, "shape": shape_name, "status": "skip",
                "reason": spec.skip_reason(shape)}
    reg = MetricsRegistry()
    with phase("roofline.units", cat="units", registry=reg, arch=arch_id, shape=shape_name):
        cost = units.cost_cell(spec, shape, mesh, opts)
    n_chips = mesh.devices.size
    mb = max(1, min(opts.microbatch or spec.microbatch,
                    shape.batch // builders.dp_size(mesh))) if shape.kind == "train" else 1
    rec = _record(arch_id, shape_name, mesh, cost["flops_by_dtype"], cost["bytes"],
                  analytic_bytes(spec, shape, mb, n_chips), cost["collectives"],
                  model_flops(spec.model, shape), cost["units"])
    rec["units_s"] = round(reg.phase_seconds()["units"], 2)
    if save:
        _save(rec, f"{arch_id}_{shape_name}{_suffix(opts)}", out_dir)
    return rec


def als_useful_flops(nnz: float, rows: float, f: int) -> float:
    """The Hermitians' and the solves' useful flops: nnz (f (f + 1) + 2 f)
    (the lower triangle of each theta theta^T and theta r, accumulated)
    and rows (f^3 / 3 + 2 f^2) (a Cholesky factorisation and two
    triangular solves)."""
    return nnz * (f * (f + 1) + 2 * f) + rows * (f ** 3 / 3 + 2 * f * f)


def als_min_bytes(nnz: float, theta_rows: float, rows: float, shards: int, f: int) -> float:
    """The bytes a wave must move: each nonzero's index and value, the
    theta rows, each row's count a column shard, read once; the solved
    rows written once."""
    return nnz * 8 + theta_rows * f * 4 + rows * shards * 4 + rows * f * 4


def als_roofline_cell(als_name: str, save: bool = True, *, out_dir=None) -> dict:
    """The roofline of one SU-ALS update-X wave a cell on the single-pod
    deployment mesh, from the dry-run's
    record (``launch.dryrun.run_als_cell``): compute and memory from the
    wave's expected nonzeros a cell (:func:`als_useful_flops`,
    :func:`als_min_bytes`), collectives as counted."""
    from repro_torch.configs.cumf_als import ALS_SHAPES
    from repro_torch.launch import dryrun

    d = dryrun.run_als_cell(als_name)
    meta, spec = d["meta"], ALS_SHAPES[als_name].spec
    cells = meta["q"] * meta["p"]
    nnz = spec.nnz * min(1.0, meta["m_wave"] / spec.m) / cells
    useful = als_useful_flops(nnz, meta["m_wave"] / cells, meta["f"])
    nbytes = als_min_bytes(nnz, -(-spec.n // meta["p"]), meta["m_wave"] / meta["q"], 1,
                           meta["f"])
    mesh = make_production_mesh()
    rec = _record("cumf-als", als_name, mesh, {"float32": useful}, d["cost"]["bytes_accessed"],
                  nbytes, d["collectives"], useful * mesh.devices.size, [])
    rec["counted_flops_per_device"] = d["cost"]["flops"]
    rec["nnz_per_device"] = nnz
    if save:
        _save(rec, f"als_{als_name}", out_dir)
    return rec


def _print(rec: dict, seconds: float) -> None:
    if rec["status"] != "ok":
        print(f"[roofline] {rec['arch']} {rec['shape']}: skip", flush=True)
        return
    t = rec["terms_s"]
    print(f"[roofline] {rec['arch']} {rec['shape']}: comp={t['compute_s']:.4f}s "
          f"mem={t['memory_s']:.4f}s coll={t['collective_s']:.4f}s dom={rec['dominant']} "
          f"useful={rec['useful_ratio']:.2f} ({seconds:.0f}s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--als")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--fused-loss", action="store_true")
    ap.add_argument("--tp1", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None, help=f"record directory (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)

    if args.als:
        reg = MetricsRegistry()
        with phase("roofline.als", cat="als", registry=reg, als=args.als):
            rec = als_roofline_cell(args.als, out_dir=args.out)
        _print(rec, reg.phase_seconds()["als"])
        return 0
    opts = builders.CellOpts(causal_skip=args.causal_skip, fused_loss=args.fused_loss,
                             tp1=args.tp1)
    if args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.all:
        cells = [(a, s) for a in registry.list_archs() for s in SHAPES]
    else:
        ap.error("need --arch/--shape, --als, or --all")
    errors = 0
    out_dir = args.out or ARTIFACT_DIR
    for arch_id, shape_name in cells:
        path = os.path.join(out_dir, f"{arch_id}_{shape_name}{_suffix(opts)}.json")
        if args.resume and os.path.exists(path):
            print(f"[roofline] {arch_id} {shape_name}: cached", flush=True)
            continue
        reg = MetricsRegistry()
        try:
            with phase("roofline.cell", cat="cell", registry=reg, arch=arch_id, shape=shape_name):
                rec = roofline_cell(arch_id, shape_name, opts, out_dir=out_dir)
            _print(rec, reg.phase_seconds()["cell"])
        except Exception:
            print(f"[roofline] {arch_id} {shape_name}: ERROR", flush=True)
            traceback.print_exc()
            errors += 1
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
