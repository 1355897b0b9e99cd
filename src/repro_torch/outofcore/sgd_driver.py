"""Streaming SGD driver: execute a tile-wave schedule end to end — the
port's copy of the reference's ``repro/outofcore/sgd_driver.py``.

CuMF_SGD's block grid carries the same out-of-core property as the ALS
waves (cuMF §3.3): a (user-block, item-block) tile only ever touches its
two factor blocks, so an epoch streams tiles through a fixed device budget
instead of holding the grid resident.  Per epoch the driver:

- permutes the diagonal-set order with ``sgd.train.epoch_set_order`` (the
  order the in-core epoch uses, keyed on ``(cfg.seed, epoch)``, so the
  streaming trajectory is the in-core one and resume is bit-exact);
- walks the epoch's ``TileWave`` list, uploading each wave's tile triplets
  ahead of time through ``data.prefetch.Prefetcher`` (pinned staging, a
  side CUDA stream).  Factor blocks are deliberately NOT prefetched:
  consecutive waves of different sets share blocks, so a block read ahead
  of the previous wave's writeback would be stale — they are fetched
  synchronously at consume time (they are O(f) per row; the O(K) rating
  payload is what the preload hides);
- sweeps each same-K group of the wave's tiles (a uniform grid has one
  group, the whole wave; a per-tile-K grid a few) and writes the updated
  blocks straight back to the host ``FactorStore``.  The tiles of a wave
  are disjoint in both factors, so the groups may run one after another.
  In mode ``"kernel"`` a group's factor blocks are stacked into
  ``x_w [t*mb, f]`` and ``th_w [t*nb, f]``, tile k's item ids shifted by
  ``k*nb`` (the in-core ``build_set_plans`` numbering, restricted to the
  group), a ``SlotPlan`` built on the device from the uploaded triplet,
  and ``sgd_tile_planned_`` run in place: one kernel launch per group on
  the card.  Mode ``"ref"`` runs the stacked plain sweep
  ``sgd.train.sgd_tiles_update``;
- commits resumable state (factors + global wave step) through
  ``checkpoint.CheckpointManager`` after every wave, so a killed run
  restarts mid-epoch.

The plan is built at consume time, on the device, from the triplet the
prefetcher uploaded: the streamed bytes stay exactly those the schedule
prices (``predicted_sgd_stream_stats``), and a plan built by the host
worker would add to the worker's load, which already sets the streaming
pace.  Neither the plan's bytes nor its build's transient memory are in
``sgd_required_capacity_bytes``' model (nor the reference's); a caller
measures them with the allocator.

``MemoryMeter`` models one simulated worker of the wave (payloads divide by
the wave's tile count), as the reference's does, so the ledgers of the two
packages compare.  The reference's ``vmem/sgd_tile_pallas`` record has no
counterpart: the CUDA kernel uses no dynamic shared memory
(``kernels/budgets.py``).

With ``mesh`` set (a ``launch.mesh.Mesh`` with a data axis and at least
one more) each wave's tiles go one to a cell over the joint
``("data", "model", "pod")`` axes — CuMF_SGD's workers made concrete —
and each cell sweeps its tile on its own device: its own slot plan and
one planned kernel launch (mode ``"kernel"``), or the stacked plain sweep
of one tile (``"ref"``).  The wave's triplets are preloaded to the mesh's
home device and each cell takes its tile from there (a view on a shared
card, a peer copy on another).  Cells without a tile (a ragged wave) do
nothing, where the reference sweeps an empty tile.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.objective import rmse_padded
from repro_torch.data.prefetch import Prefetcher
from repro_torch.kernels.sgd_update import build_plan, sgd_tile_planned_
from repro_torch.obs.ledger import Ledger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import current_tracer, phase
from repro_torch.outofcore.runtime import (MemoryMeter, StreamTelemetry,
                                           WaveCheckpointer)
from repro_torch.outofcore.schedule import (SgdEpochSchedule,
                                            predicted_sgd_stream_stats,
                                            sgd_required_capacity_bytes)
from repro_torch.outofcore.store import FactorStore, TileStore, triplet_nbytes
from repro_torch.sgd.train import (SgdConfig, epoch_lr, epoch_set_order,
                                   sgd_init, sgd_tiles_update)

__all__ = ["run_streaming_sgd", "wave_plan"]


def _stack(arrays: list) -> np.ndarray:
    """The tiles' arrays stacked on a new leading axis; one tile's is a
    view (the prefetcher's staging is then the only host copy)."""
    return arrays[0][None] if len(arrays) == 1 else np.stack(arrays)


def wave_plan(idx: torch.Tensor, val: torch.Tensor, cnt: torch.Tensor, nb: int):
    """The ``SlotPlan`` of a stack of t disjoint tiles (``idx [t, mb, K]``
    block-local item ids, ``val``, ``cnt [t, mb]``): tile k's row u is row
    ``k*mb + u`` of the stacked x block and its item v row ``k*nb + v`` of
    the stacked theta block.  Built on the tensors' device."""
    t, mb, K = idx.shape
    offs = (torch.arange(t, dtype=idx.dtype, device=idx.device) * nb)[:, None, None]
    return build_plan((idx + offs).reshape(t * mb, K), val.reshape(t * mb, K),
                      cnt.reshape(t * mb))


def run_streaming_sgd(
    tiles: TileStore,
    sched: SgdEpochSchedule,
    cfg: SgdConfig,
    *,
    factors: Optional[FactorStore] = None,
    ckpt_dir: Optional[str] = None,
    keep: int = 3,
    prefetch_depth: int = 2,
    train_eval=None,                 # (idx, val, cnt) for per-epoch RMSE
    test_eval=None,
    fail_after_waves: Optional[int] = None,
    mesh=None,
    callback=None,
    tracer=None,
    registry=None,
) -> tuple[FactorStore, List[dict], StreamTelemetry]:
    """Run ``cfg.epochs`` streaming SGD epochs of ``sched`` over ``tiles``
    on ``cfg.device``.

    Returns (factor store, per-epoch history, telemetry) — the protocol of
    ``run_streaming_als``.  With ``ckpt_dir`` set the run resumes from the
    latest committed wave; ``factors`` seeds a warm start (the hybrid path,
    or the reference's injected factors) and defaults to ``sgd_init`` at
    the grid's shape.  ``train_eval`` / ``test_eval`` are global-coordinate
    (idx, val, cnt) triplets on the device.

    Observability mirrors the ALS driver: the run wraps in a ``driver``
    phase, each epoch in an ``epoch`` phase, each consumed wave in one
    ``solve`` span (which ends when the wave's updated blocks are back on
    the host, so it covers the wave's device work), commits in
    ``checkpoint`` spans, and every count goes through ``registry``
    (created when not passed); ``tracer`` defaults to the process-wide one.
    The telemetry carries the plan-vs-actual ledger on the reference's
    schema and record names, less ``vmem/sgd_tile_pallas``.
    """
    if (tiles.g, tiles.mb, tiles.nb, tiles.K) != (sched.g, sched.mb, sched.nb, sched.K):
        raise ValueError("TileStore and SgdEpochSchedule were built for different grids")
    if cfg.f != sched.f:
        raise ValueError(f"SgdConfig f={cfg.f} but the schedule has f={sched.f}")
    cells = None
    if mesh is None:
        dev = resolve_device(cfg.device)
    else:
        joint = tuple(a for a in ("data", "model", "pod") if a in mesh.axis_names)
        if "data" not in joint or len(joint) < 2:
            raise ValueError(f"mesh needs a data axis and one more, got {mesh.axis_names}")
        # the reference's P(joint) order: data-major over the joint axes
        order = [mesh.axis_names.index(a) for a in joint]
        cells = list(np.transpose(mesh.devices, order).reshape(-1))
        if sched.n_workers > len(cells):
            raise ValueError(f"schedule wants {sched.n_workers} workers, mesh has "
                             f"{len(cells)} cells")
        dev = mesh.home
    g, mb, nb, f = sched.g, sched.mb, sched.nb, cfg.f
    wpe = sched.waves_per_epoch
    fac_bytes = (mb + nb) * f * 4          # one worker's two factor blocks

    meter = MemoryMeter()
    tracer = tracer if tracer is not None else current_tracer()
    reg = registry if registry is not None else MetricsRegistry()

    mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
    start_step = 0
    if mgr is not None:
        tree, start_step = mgr.restore_or_init(
            {"x": np.zeros((g * mb, f), np.float32),
             "theta": np.zeros((g * nb, f), np.float32)}, lambda: None)
        if start_step:
            factors = FactorStore.from_arrays(tree["x"], tree["theta"])
    reg.gauge("resumed_from_step").set(start_step)
    if factors is None:
        # drawn on the host: the run never holds the whole factors on the card
        st = sgd_init(tiles.grid, dataclasses.replace(cfg, device="cpu"))
        factors = FactorStore.from_arrays(st.x, st.theta)
    if factors.x.shape != (g * mb, f) or factors.theta.shape != (g * nb, f):
        raise ValueError(f"factors {factors.x.shape}, {factors.theta.shape} do not fit "
                         f"the grid (g={g}, mb={mb}, nb={nb}, f={f})")

    ckpt = WaveCheckpointer(mgr, fail_after_waves, tracer=tracer, registry=reg)

    def _save(step: int):
        # snapshot copies: the manager commits async while later waves keep
        # mutating the live factor arrays
        ckpt.save(step, lambda: {"x": factors.x.copy(),
                                 "theta": factors.theta.copy()})

    def _blocks(side: str, ids, rows: int) -> np.ndarray:
        arr = factors.factor(side)
        return np.stack([arr[b * rows:(b + 1) * rows] for b in ids])

    def _sweep(lr: float, ii, jj, idx, val, cnt):
        """The group's tiles (user blocks ``ii``, item blocks ``jj``) swept
        on the device their triplets lie on, from the host store's current
        blocks; returns the updated blocks ``[t, mb, f]``, ``[t, nb, f]`` as
        numpy and the bytes fetched."""
        t = len(ii)
        # the plan first: its build's temporaries are freed before the
        # factor blocks come onto the card
        plan = wave_plan(idx, val, cnt, nb) if cfg.mode == "kernel" else None
        x_host, th_host = _blocks("x", ii, mb), _blocks("theta", jj, nb)
        x_w = torch.from_numpy(x_host).to(idx.device)
        th_w = torch.from_numpy(th_host).to(idx.device)
        if plan is not None:
            x_w, th_w = x_w.reshape(t * mb, f), th_w.reshape(t * nb, f)
            sgd_tile_planned_(x_w, th_w, plan, lr, cfg.lam)
        else:
            x_w, th_w = sgd_tiles_update(x_w, th_w, idx, val, cnt, lr, cfg.lam)
        return (x_w.cpu().numpy().reshape(t, mb, f), th_w.cpu().numpy().reshape(t, nb, f),
                x_host.nbytes + th_host.nbytes)

    # Plan side of the ledger: per-tile [g, g] bytes/slots/nnz matrices
    # (constant entries on a uniform grid, per-tile K when binned), summed
    # over exactly the waves each epoch will execute.
    pst = predicted_sgd_stream_stats(tiles, sched)
    pred = {"bytes": 0, "slots": 0, "nnz": 0}

    def _epoch(ep: int, first_wave: int):
        lr = epoch_lr(cfg, ep)
        order = np.asarray(epoch_set_order(cfg.seed, ep, g))
        waves = sched.epoch_waves(order)[first_wave:]
        for wave in waves:
            for key in pred:
                pred[key] += sum(int(pst[f"tile_{key}"][i][j]) for i, j in wave.tiles)

        def gen():
            for wave in waves:
                yield wave, [tiles.tile_triplet(i, j) for i, j in wave.tiles]

        def put(item):
            wave, trips = item
            payload = sum(triplet_nbytes(t) for t in trips)
            # one (simulated) worker holds ONE tile of the wave
            meter.alloc(f"tilewave{wave.index}", payload // len(trips))
            reg.counter("padded_slots").inc(sum(t[0].size for t in trips))
            reg.counter("nnz_streamed").inc(sum(int(t[2].sum()) for t in trips))
            # same-K tiles stack into one group: a uniform grid's wave is
            # one group, a per-tile-K grid's a few ladder groups
            groups = []
            for k_t in sorted({t[0].shape[-1] for t in trips}):
                sel = tuple(c for c, t in enumerate(trips) if t[0].shape[-1] == k_t)
                groups.append((sel,) + tuple(_stack([trips[c][a] for c in sel])
                                             for a in range(3)))
            return wave, groups, payload

        with Prefetcher(gen(), depth=prefetch_depth, put=put, device=dev,
                        tracer=tracer, registry=reg) as pf:
            for wave, groups, payload in pf:
                t = len(wave.tiles)
                fetched = 0
                with phase("sgd.wave", cat="solve", tracer=tracer,
                           registry=reg, wave=wave.index, epoch=ep + 1,
                           tiles=t, bytes=payload):
                    # factor blocks: a synchronous fetch AFTER the previous
                    # wave's writeback (see the module doc)
                    meter.alloc(f"fac_in{wave.index}", fac_bytes)
                    meter.alloc(f"fac_out{wave.index}", fac_bytes)
                    for sel, idx, val, cnt in groups:
                        # one sweep of the group, or on a mesh one per tile,
                        # on the cell the tile's place in the wave gives it
                        parts = ([(sel, (idx, val, cnt))] if cells is None else
                                 [((c,), tuple(a[k:k + 1].to(cells[c]) for a in (idx, val, cnt)))
                                  for k, c in enumerate(sel)])
                        for part, trip in parts:
                            ii = [wave.tiles[c][0] for c in part]
                            jj = [wave.tiles[c][1] for c in part]
                            x_np, t_np, nbytes = _sweep(lr, ii, jj, *trip)
                            fetched += nbytes
                            for k, (i, j) in enumerate(zip(ii, jj)):
                                factors.write_slice("x", i * mb, (i + 1) * mb, x_np[k])
                                factors.write_slice("theta", j * nb, (j + 1) * nb, t_np[k])
                    meter.free(f"fac_out{wave.index}")
                    meter.free(f"fac_in{wave.index}")
                    meter.free(f"tilewave{wave.index}")
                reg.counter("waves_run").inc()
                reg.counter("batches_loaded").inc(t)
                reg.counter("bytes_streamed").inc(payload + fetched)
                _save(ep * wpe + wave.index + 1)

    history: List[dict] = []
    m, n = tiles.m, tiles.n
    ep0 = start_step // wpe
    with phase("sgd.stream", cat="driver", tracer=tracer, registry=reg,
               epochs=cfg.epochs, waves_per_epoch=wpe):
        for ep in range(ep0, cfg.epochs):
            ph0 = reg.phase_seconds()
            with phase("sgd.epoch", cat="epoch", tracer=tracer,
                       registry=reg, epoch=ep + 1):
                _epoch(ep, first_wave=start_step % wpe if ep == ep0 else 0)
            ph1 = reg.phase_seconds()
            rec = {"epoch": ep + 1, "lr": epoch_lr(cfg, ep),
                   "waves_run": int(reg.counter("waves_run").value),
                   "peak_bytes": meter.peak_bytes,
                   "phase_seconds": {
                       cat: s - ph0.get(cat, 0.0)
                       for cat, s in ph1.items()
                       if s - ph0.get(cat, 0.0) > 0.0}}
            if train_eval is not None or test_eval is not None:
                # degree-sorted grids store X rows permuted; evaluation is
                # in original user coordinates
                x_rows = (factors.x[tiles.grid.user_inv] if tiles.grid.user_perm is not None
                          else factors.x[:m])
                x_dev = torch.from_numpy(np.ascontiguousarray(x_rows)).to(dev)
                t_dev = torch.from_numpy(factors.theta[:n]).to(dev)
                if test_eval is not None:
                    rec["test_rmse"] = float(rmse_padded(x_dev, t_dev, *test_eval))
                if train_eval is not None:
                    rec["train_rmse"] = float(rmse_padded(x_dev, t_dev, *train_eval))
                del x_dev, t_dev
            history.append(rec)
            if callback is not None:
                callback(factors, rec)
        if mgr is not None:
            mgr.wait()
    reg.gauge("peak_bytes").set(meter.peak_bytes)

    # Close the loop: the schedule's predictions vs the meters.
    meas_slots = int(reg.counter("padded_slots").value)
    meas_nnz = int(reg.counter("nnz_streamed").value)
    meas_ratio = meas_slots / meas_nnz if meas_nnz else 0.0
    led = Ledger(solver="sgd", mesh=mesh is not None, g=g, mb=mb, nb=nb,
                 f=f, n_workers=sched.n_workers,
                 epochs=cfg.epochs - ep0, mode=cfg.mode,
                 per_tile_k=tiles.grid.tile_K is not None,
                 degree_sorted=tiles.grid.user_perm is not None,
                 autotune=getattr(tiles.grid, "tune", None),
                 resumed_from_step=start_step, device=str(dev),
                 phase_seconds=reg.phase_seconds())
    led.record("peak_device_bytes", sched.capacity_bytes, meter.peak_bytes,
               unit="bytes", check="le")
    led.record("modeled_peak_bytes",
               sgd_required_capacity_bytes(mb, nb, sched.K, f,
                                           prefetch_depth=prefetch_depth),
               meter.peak_bytes, unit="bytes", check="le")
    led.record("bytes_streamed", pred["bytes"],
               int(reg.counter("bytes_streamed").value), unit="bytes")
    led.record("padded_slots", pred["slots"], meas_slots, unit="slots")
    led.record("nnz_streamed", pred["nnz"], meas_nnz, unit="ratings")
    led.record("fill_waste_ratio",
               pred["slots"] / pred["nnz"] if pred["nnz"] else 0.0,
               meas_ratio, unit="ratio", check="rel", rel_tol=1e-9)
    led.record("worst_fill_bound", tiles.grid.fill, meas_ratio,
               unit="ratio", check="le")

    return factors, history, StreamTelemetry.from_registry(
        reg, capacity_bytes=sched.capacity_bytes, ledger=led.to_obj())
