"""End-to-end driver: ALS matrix factorization at (scaled) Netflix size,
with q-batching, checkpointing, and restart — the paper's workload, on the
card (the port of ``examples/train_als_netflix.py``).

    PYTHONPATH=src python examples_torch/train_als_netflix.py          # the card
    PYTHONPATH=src python examples_torch/train_als_netflix.py --small  # seconds
    PYTHONPATH=src python examples_torch/train_als_netflix.py --small --device cpu

The default run factorizes m=122880 x n=17770 with f=32 (6 M ratings; pass
--full for the true 480k-row Netflix shape at f=100 as in the paper).
Kills mid-run resume from the latest checkpoint automatically.  Every run
goes to ``--device`` (default ``cuda``): the configs then take the port's
kernel mode, and a kernel that fails to build or launch fails the run.
``--device cpu`` runs the plain PyTorch versions.  At exit the script
prints each kernel wrapper's launch count over the run.

``--out-of-core`` switches to the §4.4 wave-streaming driver: the rating
matrix stays host-resident (both orientations), the plan is priced against
a ``--device-mb`` budget that forces a waves >= 2 plan, and each wave
double-buffers its shards while the previous one computes, checkpointing
per wave.  On the card the allocator's peak is printed beside the meter's:

    PYTHONPATH=src python examples_torch/train_als_netflix.py --small \
        --out-of-core --device-mb 8

Solver selection (``--solver {als,sgd,hybrid}``):

- ``als``    (default) — the paper's memory-optimized ALS: each sweep is a
  closed-form fused-Hermitian + batched-Cholesky solve.
- ``sgd``    — CuMF_SGD-style blocked batch-Hogwild SGD on a ``--g`` x
  ``--g`` block grid, the g conflict-free diagonal block-sets per epoch
  (``--sgd-lr``, cosine by default).
- ``hybrid`` — ALS warm start (``--iters`` sweeps) then SGD refinement
  (``--epochs``) on the same ratings.

``--out-of-core`` composes with every solver: ``als`` streams R row slices
and R^T shards (``run_streaming_als``), ``sgd`` streams diagonal-set tile
waves of up to ``--n-data`` tiles (``run_streaming_sgd``), ``hybrid``
streams both in sequence (``run_streaming_hybrid``).

``--mesh DATA,MODEL`` (requires ``--out-of-core``) runs the waves on a
``(data, model)`` mesh of cells: theta as p = MODEL shards, solve-X waves
through SU-ALS, the accumulate-Theta partials combined by the topology-
aware reduction; ``sgd``/``hybrid`` send one tile of a wave to each cell.
Each cell gets its own card and fewer cards than cells raises, unless
``--mesh-device DEV`` puts every cell on the one device ``DEV``:

    PYTHONPATH=src python examples_torch/train_als_netflix.py --small \
        --out-of-core --mesh 2,2 --mesh-device cuda:0 --device-mb 8
    PYTHONPATH=src python examples_torch/train_als_netflix.py --small \
        --out-of-core --mesh 2,2 --mesh-device cpu --device cpu --device-mb 8

Cells that share a card run one after another, so such a run checks the
path and counts its launches but measures no scaling.
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import als as als_mod
from repro_torch.core.partition import plan_for, plan_partitions
from repro_torch.obs import kernel_launches
from repro_torch.sparse import synth

#: every kernel of the port, by the name chip_smoke.py reports
KERNELS = ("fused_herm", "batch_solve", "sgd_tile", "herm_hbm_accum")
#: NVIDIA H100 SXM data sheet: 80 GB of HBM3 — the eq. (8) plan's budget
#: when the run is on the CPU and there is no card to ask
H100_HBM_BYTES = 80 * 10**9


def launch_counts() -> dict:
    counts = kernel_launches()
    return {name: counts.get(name, 0) for name in KERNELS}


def _build_mesh(args):
    """--mesh DATA,MODEL -> (Mesh, p); (None, 1) when not requested."""
    if not getattr(args, "mesh", None):
        return None, 1
    from repro_torch.launch.mesh import make_mesh

    d, p = (int(x) for x in args.mesh.split(","))
    if args.mesh_device:
        devices = [args.mesh_device] * (d * p)
    else:
        ndev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if ndev < d * p:
            raise SystemExit(
                f"--mesh {args.mesh} needs {d * p} cards but only {ndev} "
                f"visible; pass --mesh-device cuda:0 (or cpu) to put every "
                f"cell on one device")
        devices = None
    args.n_data = d                # the data axis IS the wave width
    mesh = make_mesh((d, p), ("data", "model"), devices=devices)
    print(f"mesh: data={d} x model={p}: {mesh.describe()}")
    return mesh, p


def _tune_cache(args):
    """--autotune: a persistent TuneCache under the checkpoint dir, so a
    restarted run reuses the sweep's winner instead of re-sweeping."""
    if not getattr(args, "autotune", False):
        return None
    os.makedirs(args.ckpt, exist_ok=True)
    return os.path.join(args.ckpt, "tune_cache.json")


def _als_store_and_schedule(spec, r, args, p=1):
    """Capped-capacity ALS wave plan: store + schedule (shared with hybrid)."""
    from repro_torch.core.partition import streaming_acc_bytes
    from repro_torch.outofcore import (RatingStore, build_schedule,
                                       required_capacity_bytes)

    cap = args.device_mb << 20
    if p == 1:
        plan = plan_partitions(spec.m, spec.n, r.nnz, spec.f, hbm_bytes=cap,
                               n_data=args.n_data, fill=r.fill, eps=cap // 8)
    if p > 1 or plan.waves < 2:   # force waves >= 2 (and the requested p)
        plan = plan_for(spec.m, spec.n, r.nnz, spec.f, p=p,
                        q=2 * args.n_data, n_data=args.n_data,
                        hbm_bytes=cap, fill=r.fill, eps=cap // 8, buffers=4)

    if spec.n % p:
        raise SystemExit(f"n={spec.n} is not divisible by the model axis "
                         f"size p={p}; pick a p that divides n")
    n_bins = "auto" if args.autotune else 1
    store = RatingStore(r, q=plan.q, p=p, n_bins=n_bins,
                        tune_cache=_tune_cache(args))
    if store.tune is not None:
        print(f"autotune: n_bins={store.n_bins} "
              f"k_multiple={store.tune['config']['k_multiple']} "
              f"predicted {store.tune['score']} {store.tune['unit']}/iter "
              f"(cache_{'hit' if store.tune['cache_hit'] else 'miss'})")
    # re-cost the chosen (p, q) with the store's real padding fills and the
    # double-buffer count (depth=2 queued + loader-held + consumed): that
    # total is the budget the meter reports against.  p > 1 prices the
    # Hermitian accumulators as their own p-sharded term; a binned store
    # prices its per-bin pairs instead of the scalar worst fill.
    fill_kw = (dict(bin_fills=store.bin_fill_pairs()) if store.n_bins > 1
               else dict(fill=store.worst_fill))
    if p > 1:
        plan = plan_for(spec.m, spec.n, r.nnz, spec.f, p=p, q=plan.q,
                        n_data=args.n_data, hbm_bytes=cap,
                        eps=cap // 8, buffers=4,
                        acc_bytes=streaming_acc_bytes(spec.n, spec.f),
                        **fill_kw)
    else:
        acc_eps = spec.n * (spec.f * spec.f + 3 * spec.f + 1) * 4
        plan = plan_for(spec.m, spec.n, r.nnz, spec.f, p=plan.p, q=plan.q,
                        n_data=args.n_data, hbm_bytes=cap,
                        eps=acc_eps, buffers=4, **fill_kw)
    print(f"out-of-core plan: {plan.describe()}")
    sched = build_schedule(plan, spec.m, spec.n, n_data=args.n_data)
    need = required_capacity_bytes(store, sched, spec.f)
    print(f"schedule: {sched.describe()} "
          f"(driver needs {need / 2**20:.1f}MiB/device)")
    return store, sched


def _sgd_tiles_and_schedule(spec, r, args):
    """Tile-wave plan: --n-data workers stream the g x g grid against the
    --device-mb budget."""
    from repro_torch.outofcore import (TileStore, build_sgd_schedule,
                                       sgd_required_capacity_bytes)
    from repro_torch.sgd import block_ell

    grid = block_ell(r, g=args.g,
                     per_tile_k="auto" if args.autotune else False,
                     tune_cache=_tune_cache(args))
    if grid.tune is not None:
        print(f"autotune: per_tile_k={grid.tune['config']['per_tile_k']} "
              f"degree_sort={grid.tune['config']['degree_sort']} "
              f"({grid.tune['score']} dispatched slots, "
              f"cache_{'hit' if grid.tune['cache_hit'] else 'miss'})")
    print(f"block grid: g={grid.g} mb={grid.mb} nb={grid.nb} K={grid.K} "
          f"fill={grid.fill:.2f}x")
    cap = args.device_mb << 20
    need = sgd_required_capacity_bytes(grid.mb, grid.nb, grid.K, spec.f)
    if need > cap:
        print(f"WARNING: one worker's tile pipeline needs "
              f"{need/2**20:.1f}MiB > --device-mb {args.device_mb}MiB; "
              f"raise --device-mb or --g (smaller tiles)")
    sched = build_sgd_schedule(grid, spec.f, n_workers=args.n_data,
                               capacity_bytes=cap)
    print(f"schedule: {sched.describe()} "
          f"(driver needs {need/2**20:.1f}MiB/worker)")
    return TileStore(grid), sched


def _tel_summary(tel, ckpt):
    return (f"done in {tel.wall_seconds:.1f}s; resumed_from_step="
            f"{tel.resumed_from_step}; peak {tel.peak_bytes/2**20:.1f}MiB of "
            f"{tel.capacity_bytes/2**20:.1f}MiB budget; "
            f"{tel.bytes_streamed/2**20:.1f}MiB streamed over {tel.waves_run} "
            f"waves; checkpoints in {ckpt}")


def _emit_ledger(tel, args):
    """--ledger OUT.json: serialize the run's plan-vs-actual ledger and
    print the rendered report (the same text `python -m
    repro_torch.obs.report` produces from the file)."""
    if not getattr(args, "ledger", None):
        return
    from repro_torch.obs.report import render_ledger

    with open(args.ledger, "w") as f:
        json.dump(tel.ledger, f, indent=2)
    print(f"ledger: {len(tel.ledger['records'])} plan-vs-actual records "
          f"-> {args.ledger}")
    print(render_ledger(tel.ledger))


def run_out_of_core(spec, r, rte, args):
    """Wave-streaming path, all solvers (see the module docstring)."""
    rtest = als_mod.ell_triplet(rte, args.device)
    mesh, p = _build_mesh(args)

    if args.solver == "als":
        from repro_torch.outofcore import run_streaming_als
        store, sched = _als_store_and_schedule(spec, r, args, p=p)
        cfg = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=args.iters,
                                batch_rows=16_384, device=args.device)

        def progress(it, rec):
            print(f"iter {it+1:2d}  "
                  f"test_rmse={rec.get('test_rmse', float('nan')):.4f}  "
                  f"waves={rec['waves_run']}  "
                  f"peak={rec['peak_bytes']/2**20:.1f}MiB", flush=True)

        # solver-scoped ckpt dir: the streaming tree (factors + Hermitian
        # accumulators) is shaped differently from the in-core ALS one
        ckpt = os.path.join(args.ckpt, "oc_als")
        _, _, tel = run_streaming_als(store, sched, cfg, ckpt_dir=ckpt,
                                      test_eval=rtest, mesh=mesh,
                                      callback=progress)
        print(_tel_summary(tel, ckpt))
        if mesh is not None:
            print(f"reduction {tel.topology}: "
                  f"{tel.reduce_fast_bytes/2**20:.2f}MiB fast-link, "
                  f"{tel.reduce_slow_bytes/2**20:.2f}MiB slow-link")
        _emit_ledger(tel, args)
        return

    def progress(_state, rec):
        tag = rec.get("phase", args.solver)
        step = rec.get("epoch", rec.get("iteration"))
        print(f"{tag} {step:3d}  "
              f"test_rmse={rec.get('test_rmse', float('nan')):.4f}  "
              f"waves={rec.get('waves_run', '-')}  "
              f"peak={rec.get('peak_bytes', 0)/2**20:.1f}MiB", flush=True)

    sgd_cfg_kw = dict(f=spec.f, lam=spec.lam, lr=args.sgd_lr,
                      epochs=args.epochs, schedule=args.schedule,
                      device=args.device)
    # solver-scoped ckpt dir: the trees differ per solver (see run_sgd)
    ckpt = os.path.join(args.ckpt, "oc_" + args.solver)
    if args.solver == "sgd":
        from repro_torch.outofcore import run_streaming_sgd
        from repro_torch.sgd import SgdConfig
        tiles, sched = _sgd_tiles_and_schedule(spec, r, args)
        _, _, tel = run_streaming_sgd(tiles, sched, SgdConfig(**sgd_cfg_kw),
                                      ckpt_dir=ckpt, test_eval=rtest,
                                      mesh=mesh, callback=progress)
        print(_tel_summary(tel, ckpt))
    else:                       # hybrid: both phases stream
        from repro_torch.sgd import SgdConfig, run_streaming_hybrid
        store, als_sched = _als_store_and_schedule(spec, r, args, p=p)
        tiles, sgd_sched = _sgd_tiles_and_schedule(spec, r, args)
        warm = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=args.iters,
                                 batch_rows=16_384, device=args.device)
        _, _, tel = run_streaming_hybrid(
            store, als_sched, tiles, sgd_sched, warm, SgdConfig(**sgd_cfg_kw),
            ckpt_dir=ckpt, test_eval=rtest, mesh=mesh, callback=progress)
        print("[hybrid] " + _tel_summary(tel, ckpt))
        for name, part in sorted(tel.phases.items()):
            print(f"  [{name}] " + _tel_summary(part, ckpt))
    _emit_ledger(tel, args)


def run_sgd(spec, r, rt, rte, args):
    """Blocked batch-Hogwild SGD / ALS->SGD hybrid (see module docstring)."""
    from repro_torch.sgd import SgdConfig, block_ell, hybrid_train, sgd_train

    grid = block_ell(r, g=args.g,
                     per_tile_k="auto" if args.autotune else False,
                     tune_cache=_tune_cache(args))
    if grid.tune is not None:
        print(f"autotune: per_tile_k={grid.tune['config']['per_tile_k']} "
              f"degree_sort={grid.tune['config']['degree_sort']} "
              f"({grid.tune['score']} dispatched slots)")
    print(f"block grid: g={grid.g} mb={grid.mb} nb={grid.nb} K={grid.K} "
          f"fill={grid.fill:.2f}x")
    sgd_cfg = SgdConfig(f=spec.f, lam=spec.lam, lr=args.sgd_lr,
                        epochs=args.epochs, schedule=args.schedule,
                        device=args.device)
    # solver-scoped checkpoint dir: the ALS / out-of-core paths write
    # differently-shaped trees into args.ckpt, and resuming a finished
    # run must not be misread as a fresh one
    ckpt = os.path.join(args.ckpt, args.solver)
    rtest = als_mod.ell_triplet(rte, args.device)
    last = [time.perf_counter()]

    def progress(_state, rec):
        # the RMSE evaluation before the callback waits for the card
        now = time.perf_counter()
        tag = rec.get("phase", "sgd")
        step = rec.get("epoch", rec.get("iteration"))
        lr = f"  lr={rec['lr']:.4f}" if "lr" in rec else ""
        print(f"{tag} {step:3d}  "
              f"test_rmse={rec.get('test_rmse', float('nan')):.4f}{lr}  "
              f"({now - last[0]:.3f}s)", flush=True)
        last[0] = now

    t0 = time.perf_counter()
    if args.solver == "hybrid":
        warm = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=args.iters,
                                 batch_rows=16_384, device=args.device)
        rr = als_mod.ell_triplet(r, args.device)
        rtt = als_mod.ell_triplet(rt, args.device)
        _, hist = hybrid_train(rr, rtt, grid, warm, sgd_cfg, test=rtest,
                               ckpt_dir=ckpt, callback=progress)
    else:
        _, hist = sgd_train(grid, sgd_cfg, test=rtest, ckpt_dir=ckpt,
                            callback=progress)
    final = (f"final test_rmse={hist[-1]['test_rmse']:.4f}" if hist
             else f"already complete at epoch {sgd_cfg.epochs} (resume)")
    print(f"done in {time.perf_counter()-t0:.1f}s; {final}; checkpoints in {ckpt}")


def run_incore_als(spec, r, rt, rte, args):
    """The in-core paper loop: full-matrix ALS sweeps with checkpointing."""
    from repro_torch.core.objective import rmse_padded

    dev = resolve_device(args.device)
    cfg = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=1,
                            batch_rows=16_384, device=args.device)
    mgr = CheckpointManager(args.ckpt, keep=2)
    state, start = mgr.restore_or_init(
        {"x": torch.zeros((r.m, spec.f), device=dev),
         "theta": torch.zeros((rt.m, spec.f), device=dev)},
        lambda: None)
    if start:
        print(f"resuming from checkpoint at iteration {start}")
        st = als_mod.AlsState(x=state["x"], theta=state["theta"],
                              iteration=start)
    else:
        st = als_mod.als_init(r.m, rt.m, cfg)

    rr, rtt, rtest = (als_mod.ell_triplet(e, dev) for e in (r, rt, rte))
    for it in range(start, args.iters):
        t0 = time.perf_counter()
        st = als_mod.als_iteration(st, rr, rtt, cfg)
        rmse = float(rmse_padded(st.x, st.theta, *rtest))   # waits for the card
        print(f"iter {it+1:2d}  test_rmse={rmse:.4f}  "
              f"({time.perf_counter()-t0:.3f}s)", flush=True)
        mgr.save(it + 1, {"x": np.array(st.x.cpu()),       # async (paper §4.4)
                          "theta": np.array(st.theta.cpu())})
    mgr.wait()
    print(f"done; checkpoints in {args.ckpt}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--solver", choices=("als", "sgd", "hybrid"),
                    default="als", help="see module docstring")
    ap.add_argument("--epochs", type=int, default=30,
                    help="SGD epochs (sgd / hybrid solvers)")
    ap.add_argument("--sgd-lr", type=float, default=0.15)
    ap.add_argument("--schedule", default="cosine",
                    choices=("constant", "inverse_time", "cosine"))
    ap.add_argument("--g", type=int, default=4,
                    help="block-grid side for the SGD solvers")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "cumf_ckpt"))
    ap.add_argument("--autotune", action="store_true",
                    help="pick the layout knobs (ALS n_bins/k_multiple, "
                         "SGD per_tile_k/degree_sort) by the cuMF Alg.-2 "
                         "sweep (repro_torch.core.autotune); the winner is "
                         "cached under --ckpt (see TUNING.md)")
    ap.add_argument("--out-of-core", action="store_true",
                    help="stream waves through a capped device budget")
    ap.add_argument("--device-mb", type=int, default=64,
                    help="device budget the --out-of-core plan is priced "
                         "against")
    ap.add_argument("--n-data", type=int, default=2,
                    help="data-axis size (batches per wave)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="run the --out-of-core waves on a (data, model) "
                         "mesh of cells, e.g. --mesh 2,2 (p=2 theta shards "
                         "+ topology-aware reduction); overrides --n-data "
                         "with the data-axis size")
    ap.add_argument("--mesh-device", default=None, metavar="DEV",
                    help="with --mesh: put every cell on the one device DEV "
                         "(e.g. cuda:0, or cpu) instead of one card a cell")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run uses (default: the card); "
                         "'cpu' runs the plain PyTorch versions")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record obs spans for the whole run and write a "
                         "Chrome-trace/Perfetto JSON file (load it at "
                         "ui.perfetto.dev); on the in-core paths each span "
                         "carries device_ms and its clock: 'device' for the "
                         "spans timed by CUDA events, 'host' for the rest "
                         "(step spans, phases, every span on the CPU); "
                         "--out-of-core keeps the host clock")
    ap.add_argument("--ledger", default=None, metavar="OUT.json",
                    help="with --out-of-core: write the run's plan-vs-"
                         "actual ledger (predicted vs measured peaks, "
                         "streamed/reduce bytes, fill waste) and print the "
                         "repro_torch.obs.report rendering")
    args = ap.parse_args(argv)
    if args.ledger and not args.out_of_core:
        ap.error("--ledger requires --out-of-core (only the streaming "
                 "drivers emit plan-vs-actual ledgers)")
    if args.mesh and not args.out_of_core:
        # checked here, not in _build_mesh: the in-core paths never reach
        # _build_mesh, and silently ignoring --mesh would let a user think
        # they measured the mesh path
        ap.error("--mesh requires --out-of-core (the in-core paths use "
                 "their own sharding entry points)")
    if args.mesh_device and not args.mesh:
        ap.error("--mesh-device requires --mesh")
    dev = resolve_device(args.device)            # raises without a GPU
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if args.full:
        spec = synth.SynthSpec("netflix", 480_189, 17_770, 99_000_000,
                               100, 0.05)
    elif args.small:
        spec = synth.SynthSpec("netflix-small", 8_192, 2_048, 400_000,
                               16, 0.05)
    else:
        spec = synth.SynthSpec("netflix-scaled", 122_880, 17_770,
                               6_000_000, 32, 0.05)

    plan = plan_partitions(spec.m, spec.n, spec.nnz, spec.f,
                           hbm_bytes=None if dev.type == "cuda" else H100_HBM_BYTES)
    print(f"partition plan (eq. 8): {plan.describe()}")

    from repro_torch.obs import Tracer, set_tracer, write_trace
    # the streaming paths keep the host clock: their prefetch copies run on
    # a side stream, and a timing event beside them is unmeasured there
    tracer = Tracer(device_clock=not args.out_of_core) if args.trace else None
    # the drivers pick the tracer up via current_tracer; the previous one
    # comes back when the run ends (main may run in-process, repeatedly)
    prev = set_tracer(tracer) if tracer is not None else None
    before = launch_counts()
    try:
        t0 = time.perf_counter()
        r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=0, noise=0.1)
        print(f"synthesized {r.nnz} ratings in {time.perf_counter()-t0:.1f}s "
              f"(K={r.K}, fill={r.fill:.2f}x)")
        if args.out_of_core:
            del rt              # the streaming store cuts its own R^T batches
            run_out_of_core(spec, r, rte, args)
        elif args.solver != "als":
            run_sgd(spec, r, rt, rte, args)
        else:
            run_incore_als(spec, r, rt, rte, args)
        if dev.type == "cuda":   # the real peak; an out-of-core summary has the meter's
            print(f"allocator peak over the run "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}MiB on {dev}")
    finally:
        if tracer is not None:
            set_tracer(prev)
            write_trace(args.trace, tracer)
            print(f"trace: {len(tracer.events)} events -> {args.trace} "
                  f"(load at ui.perfetto.dev)")
    after = launch_counts()
    print("kernel launches: " + json.dumps(
        {k: after[k] - before[k] for k in KERNELS}))


if __name__ == "__main__":
    main()
