"""ALS vs SGD vs hybrid: epochs/sec and RMSE-vs-time (CuMF_SGD's Fig. 7
protocol — "time to RMSE", not per-iteration flops) on the scaled
planted-Netflix recipe, on the card.

Each solver runs to convergence-ish on identical data; every epoch (ALS
iteration / SGD epoch) appends a (cumulative seconds, test RMSE) point,
read after the epoch's RMSE evaluation has waited for the card.  A fourth
``sgd_stream`` row runs the same SGD recipe through the out-of-core
tile-wave driver at a capped capacity (waves >= 2 per diagonal set).  The
``sgd_stream_skew`` / ``sgd_stream_binned`` pair reruns that streaming
recipe on power-law *users*: the uniform grid as its own baseline vs
degree-sorted per-tile-K tiles, which must cut fill waste >= 1.5x at the
same RMSE.  The ``sgd_stream_mesh`` row shards the tile waves one tile a
cell over a (data=4, model=2) mesh whose eight cells share ``device``.
The records land in BENCH_torch_sgd.json via ``run.py``; ``run(quick=True)``
shrinks the problem and epoch counts.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.backend import resolve_device
from repro_torch.core import als as als_mod
from repro_torch.outofcore import (FactorStore, TileStore, build_sgd_schedule,
                                   run_streaming_sgd)
from repro_torch.sgd import SgdConfig, block_ell, hybrid_train, sgd_train
from repro_torch.sgd.hybrid import sgd_state_from_als
from repro_torch.sparse import synth

from benchmarks_torch.common import emit, sync

JSON_OUT = "BENCH_torch_sgd.json"


def _timed_curve(device):
    """A callback capturing (cumulative seconds, test rmse) per epoch."""
    t0 = time.perf_counter()
    points: list[dict] = []

    def cb(_state, rec):
        sync(device)
        points.append({"t": time.perf_counter() - t0,
                       "rmse": rec.get("test_rmse")})

    return points, cb


def _stream_fields(sched, tel) -> dict:
    return dict(waves_per_epoch=sched.waves_per_epoch,
                capacity_bytes=tel.capacity_bytes,
                peak_bytes=tel.peak_bytes,
                bytes_streamed=tel.bytes_streamed,
                padded_slots=tel.padded_slots,
                nnz_streamed=tel.nnz_streamed,
                fill_waste_ratio=round(tel.fill_waste_ratio, 6),
                wall_seconds=tel.wall_seconds,
                phase_seconds={k: round(v, 4)
                               for k, v in tel.phase_seconds.items()})


def _require(cond: bool, what) -> None:
    if not cond:
        raise RuntimeError(f"bench_sgd check failed: {what}")


def run(quick: bool = False, device: str = "cuda"):
    dev = str(resolve_device(device))
    if quick:
        spec = synth.SynthSpec("netflix-micro", m=512, n=128, nnz=20_000,
                               f=8, lam=0.05)
        als_iters, sgd_epochs, hyb_epochs = 3, 8, 6
    else:
        spec = synth.SynthSpec("netflix-mini", m=1536, n=256, nnz=90_000,
                               f=16, lam=0.05)
        als_iters, sgd_epochs, hyb_epochs = 8, 40, 24
    r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=3, noise=0.1)
    rr, rtt, rtest = (als_mod.ell_triplet(e, dev) for e in (r, rt, rte))
    grid = block_ell(r, g=4)

    records = []

    def record(solver, points, epochs, **extra):
        total = points[-1]["t"] if points else 0.0
        rec = {
            "solver": solver, "m": spec.m, "n": spec.n, "nnz": r.nnz,
            "f": spec.f, "g": grid.g, "epochs": epochs,
            "final_rmse": points[-1]["rmse"] if points else None,
            "epochs_per_sec": epochs / total if total else None,
            "curve": points, **extra,
        }
        records.append(rec)
        emit(f"sgd_vs_als_{solver}", total / max(epochs, 1) * 1e6,
             f"final_rmse={rec['final_rmse']:.4f};"
             f"epochs_per_sec={rec['epochs_per_sec']:.2f}")
        return rec

    als_cfg = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=als_iters, device=dev)
    points, cb = _timed_curve(dev)
    als_mod.als_train(rr, rtt, r.m, rt.m, als_cfg, test=rtest, callback=cb)
    record("als", points, als_cfg.iters)

    sgd_cfg = SgdConfig(f=spec.f, lam=spec.lam, lr=0.15, epochs=sgd_epochs,
                        schedule="cosine", seed=1, device=dev)
    points, cb = _timed_curve(dev)
    sgd_train(grid, sgd_cfg, test=rtest, callback=cb)
    record("sgd", points, sgd_cfg.epochs)

    warm_cfg = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=2, device=dev)
    ref_cfg = SgdConfig(f=spec.f, lam=spec.lam, lr=0.15, epochs=hyb_epochs,
                        schedule="cosine", seed=1, device=dev)
    points, cb = _timed_curve(dev)   # hybrid_train forwards cb to both phases
    hybrid_train(rr, rtt, grid, warm_cfg, ref_cfg, test=rtest, callback=cb)
    record("hybrid", points, warm_cfg.iters + ref_cfg.epochs)

    # capped-capacity streaming row: same SGD recipe through the tile-wave
    # driver, 2 workers -> 2 waves per diagonal set
    sched = build_sgd_schedule(grid, spec.f, n_workers=2)
    points, cb = _timed_curve(dev)
    _, _, tel = run_streaming_sgd(TileStore(grid), sched, sgd_cfg, test_eval=rtest,
                                  callback=cb)
    rec = record("sgd_stream", points, sgd_cfg.epochs, **_stream_fields(sched, tel))
    _require(rec["peak_bytes"] <= rec["capacity_bytes"], rec)

    # degree-binned streaming pair on power-law *users*: the uniform layout
    # as its own baseline, then degree-sorted per-tile-K tiles, both
    # refining the SAME ALS warm start, so the layouts are compared at
    # their converged plateau: >= 1.5x less fill waste at the same RMSE
    skew_r, skew_rt, skew_rte, _ = synth.make_synthetic_ratings(
        spec, seed=3, noise=0.1, alpha_user=1.2)
    skew_rr, skew_rtt, skew_rtest = (
        als_mod.ell_triplet(e, dev) for e in (skew_r, skew_rt, skew_rte))
    warm_state, _ = als_mod.als_train(
        skew_rr, skew_rtt, skew_r.m, skew_rt.m,
        als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=4, device=dev))
    skew_cfg = SgdConfig(f=spec.f, lam=spec.lam, lr=0.05,
                         epochs=sgd_cfg.epochs, schedule="cosine", seed=1,
                         device=dev)

    def stream_skew(solver, **grid_kw):
        sgrid = block_ell(skew_r, g=4, **grid_kw)
        ssched = build_sgd_schedule(sgrid, spec.f, n_workers=2)
        st0 = sgd_state_from_als(warm_state, sgrid)
        warm = FactorStore.from_arrays(st0.x.cpu().numpy(), st0.theta.cpu().numpy())
        points, cb = _timed_curve(dev)
        _, _, stel = run_streaming_sgd(TileStore(sgrid), ssched, skew_cfg,
                                       factors=warm, test_eval=skew_rtest,
                                       callback=cb)
        return record(solver, points, skew_cfg.epochs,
                      per_tile_k=sgrid.tile_K is not None,
                      degree_sorted=sgrid.user_perm is not None,
                      **_stream_fields(ssched, stel))

    urec = stream_skew("sgd_stream_skew")
    brec = stream_skew("sgd_stream_binned", per_tile_k=True, degree_sort=True)
    brec["fill_waste_vs_uniform"] = round(
        urec["fill_waste_ratio"] / brec["fill_waste_ratio"], 4)
    _require(brec["fill_waste_vs_uniform"] >= 1.5,
             (urec["fill_waste_ratio"], brec["fill_waste_ratio"]))
    _require(brec["peak_bytes"] <= brec["capacity_bytes"], brec)
    _require(brec["final_rmse"] <= urec["final_rmse"] * 1.02,
             (brec["final_rmse"], urec["final_rmse"]))
    emit("sgd_binned_fill_win", 0.0,
         f"fill_waste {urec['fill_waste_ratio']:.3f} -> "
         f"{brec['fill_waste_ratio']:.3f} "
         f"({brec['fill_waste_vs_uniform']:.2f}x, per_tile_k+degree_sort)")

    # mesh row: the same tile waves sharded one tile a cell over a (data,
    # model) mesh whose cells all sit on ``device``
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
    points, cb = _timed_curve(dev)
    _, _, mtel = run_streaming_sgd(TileStore(grid), sched, sgd_cfg,
                                   test_eval=rtest, mesh=mesh, callback=cb)
    mrec = record("sgd_stream_mesh", points, sgd_cfg.epochs,
                  mesh_shape={"data": 4, "model": 2},
                  mesh_device=str(mesh.home),
                  **_stream_fields(sched, mtel))
    _require(mrec["peak_bytes"] <= mrec["capacity_bytes"], mrec)
    _require(abs(mrec["final_rmse"] - rec["final_rmse"]) < 1e-3,
             (mrec["final_rmse"], rec["final_rmse"]))
    return records


if __name__ == "__main__":
    run()
