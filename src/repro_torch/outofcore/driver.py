"""Streaming ALS driver: execute a wave schedule end to end (§4.4) — the
port's copy of the reference's ``repro/outofcore/driver.py``.

Per iteration the driver runs the two halves of the schedule:

- **solve-X**: Theta resident on the card; each wave's R row slice is
  preloaded host->device by ``data.prefetch.Prefetcher`` (pinned staging,
  a side CUDA stream) while the current wave solves its X rows
  (``core.als.update_rows``, or per degree bin on a binned store); the
  solved rows are written back to the host ``FactorStore``.
- **accumulate-Theta**: the A/B/c Hermitian accumulators resident; each
  wave streams its batches' R^T column shards with the freshly solved X
  slices and adds each batch's partial Hermitians into the accumulators in
  place (``core.als.partial_herm``; on a binned store per bin, each bin's
  rows ``index_add_``-ed: the rows of a batch's bins are distinct, so
  every row receives one addition, as in the reference's ``A + A_j``, and
  the sum is deterministic on the card).  After the last wave the
  accumulated systems are solved in place (``core.als.solve_accumulated_``:
  the empty rows' identity goes into the spent accumulator, so the solve
  adds no ``[n, f, f]`` tensor to the half's footprint).

The host waits for the card once per wave, inside the wave's ``solve``
span, so the span covers the wave's device work: at the ``.cpu()`` of
the solved rows (where the reference has its ``np.asarray``), and on the
accumulate side, whose waves return nothing to the host until the last,
at a stream synchronise.

Every wave completion checkpoints the full resumable state (factors +
accumulators + global step) through ``checkpoint.CheckpointManager``, so a
killed run restarts mid-iteration — the paper's §4.4 fault tolerance at
wave rather than iteration granularity.  The restored accumulators are
float32, as in the reference, and the kernels are bit-equal on reruns, so
a resumed run reaches the uninterrupted run's factors exactly.

A ``MemoryMeter`` tracks the *modelled device* footprint the planner's
eq. (8) budget prices (wave payloads divided by ``n_data``, the fixed
factor and the accumulators in full) — the reference's model, so the
ledgers of the two packages compare.  What the card's caching allocator
really holds is not metered here; a caller reads it from
``torch.cuda.max_memory_allocated``.

**Mesh streaming** (``mesh=`` set, a ``launch.mesh.Mesh``): the same
schedule runs on a (data, model) mesh of cells, the paper's data x model
parallelism, driven from this one host program:

- the solve-X half dispatches each wave through
  ``distributed.su_als.make_wave_update_fn`` (per cell a partial
  Hermitian from its theta shard, a reduce-scatter over the column cells,
  the owned slice's solve, a gather); the wave's triplet is preloaded to
  the mesh's home device and each cell takes its block (a view on a shared
  card, a peer copy on another);
- theta lives as ``p`` model shards, and the meter prices one cell: its
  ``[n/p, f]`` shard plus its column block of the wave's R slice;
- the accumulate-Theta half computes per-(data, model) partial Hermitians
  (``make_wave_herm_fn``) with no reduction across cells: each data shard
  accumulates its own partials across waves, in float64 on the host as
  the reference does, and the half ends with
  ``distributed.reduce.topology_reduce`` — the paper's Fig. 5b
  ring-then-tree schedule, bit-equal to the flat all-reduce — before each
  model shard solves and writes back its own theta rows.  The checkpoint
  carries those per-shard f64 partials, so a resumed run replays the
  reduction from the same summands.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import als as als_mod
from repro_torch.core.objective import rmse_padded
from repro_torch.data.prefetch import Prefetcher
from repro_torch.distributed import reduce as dreduce
from repro_torch.distributed.su_als import (column_groups, make_wave_herm_fn,
                                            make_wave_update_fn, mesh_axes,
                                            shard_rows)
from repro_torch.kernels.budgets import BUDGETS, footprint_bytes
from repro_torch.obs.ledger import Ledger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import current_tracer, phase
from repro_torch.outofcore.runtime import (MemoryMeter, SimulatedFailure,
                                           StreamTelemetry, WaveCheckpointer)
from repro_torch.outofcore.schedule import (IterationSchedule,
                                            predicted_stream_stats,
                                            required_capacity_bytes)
from repro_torch.outofcore.store import (FactorStore, RatingStore,
                                         binned_nbytes, triplet_nbytes)

__all__ = ["MemoryMeter", "SimulatedFailure", "StreamTelemetry",
           "run_streaming_als"]


def _zeros_ckpt_tree(m_pad: int, n: int, f: int, n_dev: int = 0) -> dict:
    """Checkpoint structure.  The acc leaves are committed EMPTY (zero rows)
    by solve-X-half saves — restore never reads them there — and are
    replaced with the live accumulators by mid-accumulate-half saves: the
    f32 sums, or, on the mesh path (``n_dev`` > 0), the per-data-shard
    float64 partials, so a resume replays the topology-aware reduction
    bit-exactly from the same summands."""
    acc_dt = np.float64 if n_dev else np.float32
    lead = (n_dev,) if n_dev else ()
    return {
        "x": np.zeros((m_pad, f), np.float32),
        "theta": np.zeros((n, f), np.float32),
        "a_acc": np.zeros(lead + (0, f, f), acc_dt),
        "b_acc": np.zeros(lead + (0, f), acc_dt),
        "c_acc": np.zeros(lead + (0,), acc_dt),
    }


class _HostOnly(NamedTuple):
    """A payload part the prefetcher leaves on the host (a leaf it does not
    walk): the stacked bins' scatter maps."""
    items: list


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_bins(binned) -> list:
    """The non-empty bins of a BinnedELL as ``((idx, val, cnt), rows)``
    host arrays — what the prefetcher uploads, in the form of
    ``core.als._device_bins``."""
    return [((b.idx, b.val, b.cnt), np.asarray(rows, np.int64))
            for b, rows in zip(binned.bins, binned.rows) if b.m]


def run_streaming_als(
    ratings: RatingStore,
    sched: IterationSchedule,
    cfg: als_mod.AlsConfig,
    *,
    factors: Optional[FactorStore] = None,
    ckpt_dir: Optional[str] = None,
    keep: int = 3,
    prefetch_depth: int = 2,
    train_eval=None,                 # (idx, val, cnt) for per-iteration RMSE
    test_eval=None,
    fail_after_waves: Optional[int] = None,
    mesh=None,
    topology=None,
    callback=None,
    tracer=None,
    registry=None,
) -> tuple[FactorStore, List[dict], StreamTelemetry]:
    """Run ``cfg.iters`` streaming ALS iterations of ``sched`` over ``ratings``
    on ``cfg.device``, or on the cells of ``mesh``.

    Returns (factor store, per-iteration history, telemetry).  With
    ``ckpt_dir`` set the run resumes from the latest committed wave.
    ``factors`` injects the initial factors (e.g. the reference's); without
    it they come from ``als_init``.  ``train_eval`` / ``test_eval`` are
    (idx, val, cnt) triplets on the device.

    Observability: the whole run (``driver``), each iteration/half, one
    ``solve`` span per wave, ``checkpoint`` per commit, ``prefetch`` (the
    consumer's stall) and ``prefetch_load`` (the worker's load, overlapped)
    — all through ``registry`` (one is created when not passed).
    ``tracer`` defaults to the process-wide tracer.  The telemetry carries
    the plan-vs-actual ledger, on the reference's schema and record names,
    except that the kernels' budget records are ``smem/fused_herm`` and
    ``smem/batch_solve`` (shared memory on the card, not VMEM).

    With ``mesh`` set (axes ``("data", "model")``, sizes matching
    ``sched.n_data`` and ``sched.p``; a ``p > 1`` store) every wave runs on
    the mesh's cells and theta is handled as p model shards; ``topology``
    is the ``distributed.reduce.DeviceTopology`` of the data axis for the
    accumulate half's reduction (default: fast domains of 2, the paper's
    2-GPUs-per-PCIe-switch machine).  A binned mesh store streams its
    theta half from the batch-uniform stacked bins (``rt_stacked``), one
    ``wave_herm`` call per bin, the partials scattered on the host through
    each stack's ``items`` map; its solve-X half keeps the uniform mesh
    layout.  Payloads go to the mesh's home device (the first cell's),
    where the ledger's ``device`` says the run took place.
    """
    if (ratings.m_pad, ratings.n, ratings.q) != (sched.m_pad, sched.n, sched.plan.q):
        raise ValueError("RatingStore and IterationSchedule were built for "
                         "different shapes")
    f = cfg.f
    m_pad, n, n_data = sched.m_pad, sched.n, sched.n_data
    W = len(sched.waves)
    wpi = sched.waves_per_iteration            # 2 * W checkpoint steps/iter
    n_bins = ratings.n_bins
    binned = n_bins > 1
    stacked = ratings.rt_stacked is not None
    if mesh is None:
        if stacked or sched.p != 1:
            raise ValueError("a p > 1 store or schedule streams on a mesh; pass mesh=")
        dev = resolve_device(cfg.device)
        p, topo, n_dev = 1, None, 0
    else:
        dev = mesh.home
        mesh_n_data, p = mesh_axes(mesh)
        if mesh_n_data != n_data:
            raise ValueError(f"mesh data axis {mesh_n_data} != schedule n_data {n_data}")
        if not p == sched.p == ratings.p:
            raise ValueError(f"mesh p={p}, schedule p={sched.p}, store p={ratings.p}")
        if binned and not stacked:
            raise ValueError("mesh streaming of a binned store needs batch-uniform "
                             "bins; build the RatingStore with p > 1")
        topo = topology or dreduce.linear_topology(n_data, group_size=2)
        if topo.n_devices != n_data:
            raise ValueError(f"{topo.describe()} does not cover {n_data} data shards")
        # per-reduce link traffic is a pure function of the payload size
        # and the topology: priced once here, measured in the ledger
        topo_traffic = dreduce.reduce_traffic(n * (f * f + f + 1) * 4, topo)
        wave_update = make_wave_update_fn(mesh, cfg.lam, mode=cfg.mode)
        wave_herm = make_wave_herm_fn(mesh, cfg.lam, mode=cfg.mode)
        n_dev = n_data
    topo_desc = topo.describe() if topo is not None else ""

    meter = MemoryMeter()
    tracer = tracer if tracer is not None else current_tracer()
    reg = registry if registry is not None else MetricsRegistry()

    def prefetcher(gen, put):
        return Prefetcher(gen, depth=prefetch_depth, put=put, device=dev,
                          tracer=tracer, registry=reg)

    mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
    acc_restored = None
    start_step = 0
    if mgr is not None:
        tree, start_step = mgr.restore_or_init(
            _zeros_ckpt_tree(m_pad, n, f, n_dev), lambda: None)
        if start_step:
            factors = FactorStore.from_arrays(tree["x"], tree["theta"])
            if start_step % wpi > W:       # killed mid-accumulate-Theta
                acc_restored = (tree["a_acc"], tree["b_acc"], tree["c_acc"])
    reg.gauge("resumed_from_step").set(start_step)
    if factors is None:
        # drawn on the host: the run never holds the whole factors on the card
        st = als_mod.als_init(ratings.m, n, dataclasses.replace(cfg, device="cpu"))
        x0 = np.zeros((m_pad, f), np.float32)
        x0[:ratings.m] = st.x.cpu().numpy()
        factors = FactorStore.from_arrays(x0, st.theta)

    ckpt = WaveCheckpointer(mgr, fail_after_waves,
                            tracer=tracer, registry=reg)

    def _save(step: int, acc=None):
        def tree_fn():
            tree = _zeros_ckpt_tree(m_pad, n, f, n_dev)
            # snapshot copies: the manager commits async while later waves
            # keep mutating the live factor arrays and accumulators
            tree["x"], tree["theta"] = factors.x.copy(), factors.theta.copy()
            if acc is not None:
                tree["a_acc"] = np.array(_numpy(acc[0]), tree["a_acc"].dtype)
                tree["b_acc"] = np.array(_numpy(acc[1]), tree["b_acc"].dtype)
                tree["c_acc"] = np.array(_numpy(acc[2]), tree["c_acc"].dtype)
            return tree
        ckpt.save(step, tree_fn)

    def _fixed_theta():
        meter.alloc("fixed_theta", factors.theta.nbytes)
        return torch.from_numpy(factors.theta).to(dev)

    def _accumulators(acc0):
        meter.alloc("acc", n * (f * f + f + 1) * 4)
        if acc0 is not None:
            return tuple(torch.from_numpy(np.array(a, np.float32)).to(dev)
                         for a in acc0)
        return (torch.zeros((n, f, f), dtype=torch.float32, device=dev),
                torch.zeros((n, f), dtype=torch.float32, device=dev),
                torch.zeros((n,), dtype=torch.float32, device=dev))

    def _finish_theta(A, B, c):
        meter.alloc("theta_out", n * f * 4)
        # the accumulators are spent: solve them in place
        factors.write_slice("theta", 0, n,
                            als_mod.solve_accumulated_(A, B, c, cfg))
        meter.free("theta_out")

    # ------------------------------------------------------------------
    # solve-X half: stream R row slices, solve rows, write back.
    # ------------------------------------------------------------------
    def _x_half(it: int, first_wave: int):
        theta_dev = _fixed_theta()
        scratch = (sched.waves[0].rows * (f * f + 2 * f) * 4) // n_data

        def put(wave):
            if binned:
                cut = ratings.x_slice_binned(wave.row_start, wave.row_stop)
                payload = _host_bins(cut)
                nb, slots, nz = binned_nbytes(cut), cut.padded_slots, cut.nnz
            else:
                payload = ratings.x_slice_triplet(wave.row_start, wave.row_stop)
                nb = triplet_nbytes(payload)
                slots, nz = payload[0].size, int(payload[2].sum())
            # per-device share: each device on the axis takes ONE batch of
            # the wave (a ragged last wave has fewer batches than n_data)
            meter.alloc(f"xwave{wave.index}", nb // len(wave.batches))
            reg.counter("padded_slots").inc(slots)
            reg.counter("nnz_streamed").inc(nz)
            reg.counter("x_padded_slots").inc(slots)
            reg.counter("x_nnz_streamed").inc(nz)
            return wave, payload, nb

        try:
            with prefetcher(iter(sched.waves[first_wave:]), put) as pf:
                for wave, payload, nb in pf:
                    with phase("als.wave_x", cat="solve", tracer=tracer,
                               registry=reg, wave=wave.index,
                               iteration=it + 1, bytes=nb,
                               **({"bins": n_bins} if binned else {})):
                        meter.alloc("x_scratch", scratch)
                        if binned:
                            rows = als_mod._update_factor_bins(
                                theta_dev, payload, wave.rows, cfg)
                        else:
                            rows = als_mod.update_rows(theta_dev, *payload, cfg)
                        meter.free("x_scratch")
                        factors.write_slice("x", wave.row_start,
                                            wave.row_stop, rows)
                    meter.free(f"xwave{wave.index}")
                    reg.counter("waves_run").inc()
                    reg.counter("batches_loaded").inc(len(wave.batches))
                    reg.counter("bytes_streamed").inc(nb)
                    _save(it * wpi + wave.index + 1)
        finally:
            meter.free("fixed_theta")

    # ------------------------------------------------------------------
    # accumulate-Theta half: stream R^T shards + X slices, accumulate in
    # place, solve after the last wave.
    # ------------------------------------------------------------------
    def _theta_half(it: int, first_wave: int, acc0=None):
        A, B, c = _accumulators(acc0)

        def gen():
            for wave in sched.waves[first_wave:]:
                payload = [
                    (b, ratings.theta_batch_binned(b.index) if binned
                     else ratings.theta_batch_triplet(b.index),
                     factors.read_slice("x", b.row_start, b.row_stop))
                    for b in wave.batches]
                yield wave, payload

        def put(item):
            wave, payload = item
            if binned:
                nb = sum(binned_nbytes(bell) + x.nbytes for _, bell, x in payload)
                slots = sum(int(bell.padded_slots) for _, bell, _x in payload)
                nz = sum(int(bell.nnz) for _, bell, _x in payload)
                host = [(_host_bins(bell), x) for _, bell, x in payload]
            else:
                nb = sum(triplet_nbytes(t) + x.nbytes for _, t, x in payload)
                slots = sum(t[0].size for _, t, _x in payload)
                nz = sum(int(t[2].sum()) for _, t, _x in payload)
                host = [(t, x) for _, t, x in payload]
            # each simulated device holds ONE batch's shard + X slice
            meter.alloc(f"twave{wave.index}", nb // len(payload))
            reg.counter("padded_slots").inc(slots)
            reg.counter("nnz_streamed").inc(nz)
            reg.counter("t_padded_slots").inc(slots)
            reg.counter("t_nnz_streamed").inc(nz)
            return wave, host, nb

        try:
            with prefetcher(gen(), put) as pf:
                for wave, payload, nb in pf:
                    last = wave.index == W - 1
                    with phase("als.wave_theta", cat="solve", tracer=tracer,
                               registry=reg, wave=wave.index,
                               iteration=it + 1, bytes=nb,
                               **({"bins": n_bins} if binned else {})):
                        for shard, x_dev in payload:
                            if binned:
                                for (idx, val, cnt), rows in shard:
                                    Ab, Bb = als_mod.partial_herm(
                                        x_dev, idx, val, cnt, cfg)
                                    A.index_add_(0, rows, Ab)
                                    B.index_add_(0, rows, Bb)
                                    c.index_add_(0, rows, cnt.to(torch.float32))
                                    del Ab, Bb
                            else:
                                idx, val, cnt = shard
                                Aj, Bj = als_mod.partial_herm(x_dev, idx, val, cnt, cfg)
                                A += Aj
                                B += Bj
                                c += cnt.to(torch.float32)
                                del Aj, Bj
                        meter.free(f"twave{wave.index}")
                        if last:
                            _finish_theta(A, B, c)
                        elif dev.type == "cuda":
                            # the span ends when the card has added the
                            # wave's partials, so it times them
                            torch.cuda.current_stream(dev).synchronize()
                    reg.counter("waves_run").inc()
                    reg.counter("batches_loaded").inc(len(payload))
                    reg.counter("bytes_streamed").inc(nb)
                    _save(it * wpi + W + wave.index + 1,
                          acc=None if last else (A, B, c))
        finally:
            meter.free("acc")

    # ------------------------------------------------------------------
    # Mesh halves: the same waves on the (data, model) cells, theta as p
    # shards and a host-scheduled reduction of the partials.
    # ------------------------------------------------------------------
    def _x_half_mesh(it: int, first_wave: int):
        theta_dev = shard_rows(torch.from_numpy(factors.theta).to(dev), mesh)
        meter.alloc("fixed_theta", factors.theta.nbytes // p)   # one shard
        full_rows = sched.waves[0].rows          # n_data * rows per batch
        scratch = (full_rows * (f * f + 2 * f) * 4) // n_data

        def put(wave):
            idx, val, cnt = ratings.x_slice_mesh_triplet(wave.row_start, wave.row_stop)
            nb = int(idx.nbytes + val.nbytes + cnt.nbytes)
            # per-cell share: one batch's rows x one model column block
            meter.alloc(f"xwave{wave.index}", nb // (len(wave.batches) * p))
            reg.counter("padded_slots").inc(idx.size)
            reg.counter("nnz_streamed").inc(int(cnt.sum()))
            reg.counter("x_padded_slots").inc(idx.size)
            reg.counter("x_nnz_streamed").inc(int(cnt.sum()))
            pad = full_rows - idx.shape[0]
            if pad:      # ragged last wave: empty rows solve to x_u = 0
                idx = np.pad(idx, ((0, pad), (0, 0)))
                val = np.pad(val, ((0, pad), (0, 0)))
                cnt = np.pad(cnt, ((0, pad), (0, 0)))
            return wave, (idx, val, cnt), nb

        try:
            with prefetcher(iter(sched.waves[first_wave:]), put) as pf:
                for wave, (idx, val, cnt), nb in pf:
                    with phase("als.wave_x", cat="solve", tracer=tracer,
                               registry=reg, wave=wave.index,
                               iteration=it + 1, bytes=nb, mesh=True):
                        meter.alloc("x_scratch", scratch)
                        rows = wave_update(theta_dev, idx, val, cnt)
                        meter.free("x_scratch")
                        factors.write_slice("x", wave.row_start,
                                            wave.row_stop, rows[:wave.rows])
                    meter.free(f"xwave{wave.index}")
                    reg.counter("waves_run").inc()
                    reg.counter("batches_loaded").inc(len(wave.batches))
                    reg.counter("bytes_streamed").inc(nb)
                    _save(it * wpi + wave.index + 1)
        finally:
            meter.free("fixed_theta")

    def _mesh_accumulators(acc0):
        # per cell: only the owned model shard's systems
        meter.alloc("acc", n * (f * f + f + 1) * 4 // p)
        if acc0 is not None:
            return tuple(np.array(a, np.float64) for a in acc0)
        return (np.zeros((n_data, n, f, f), np.float64),
                np.zeros((n_data, n, f), np.float64),
                np.zeros((n_data, n), np.float64))

    def _theta_half_mesh(it: int, first_wave: int, acc0=None):
        """Per-data-shard partials from each wave's R^T shards (uniform, or
        the stacked bins: one ``wave_herm`` call per bin, scattered through
        the stack's ``items`` map), accumulated in float64 on the host;
        the last wave ends with the reduce and the shards' solves."""
        A_dev, B_dev, c_dev = _mesh_accumulators(acc0)

        def gen():
            for wave in sched.waves[first_wave:]:
                idx = [b.index for b in wave.batches]
                trips = (ratings.theta_wave_stacked(idx) if stacked
                         else [ratings.theta_batch_triplet(j) for j in idx])
                xs = [factors.read_slice("x", b.row_start, b.row_stop)
                      for b in wave.batches]
                yield wave, trips, xs

        def put(item):
            wave, trips, xs = item
            nbatch = len(xs)
            trip_nb = sum(int(t[0].nbytes + t[1].nbytes + t[2].nbytes) for t in trips)
            x_nb = sum(x.nbytes for x in xs)
            slots = sum(t[0].size for t in trips)
            nz = sum(int(t[2].sum()) for t in trips)
            reg.counter("padded_slots").inc(slots)
            reg.counter("nnz_streamed").inc(nz)
            reg.counter("t_padded_slots").inc(slots)
            reg.counter("t_nnz_streamed").inc(nz)
            # per cell: 1/p of one batch's R^T rows (its theta rows) + the
            # batch's full X slice (replicated over the model axis)
            meter.alloc(f"twave{wave.index}",
                        trip_nb // (nbatch * p) + x_nb // nbatch)
            if stacked:
                bins = [t[:3] for t in trips]
                items = _HostOnly([t[3] for t in trips])
            else:
                bins = [tuple(np.stack([t[a] for t in trips]) for a in range(3))]
                items = None
            x_stack = np.stack(xs)
            pad = n_data - nbatch
            if pad:      # ragged last wave: empty batches contribute A = 0
                def padded(a):
                    return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                x_stack = padded(x_stack)
                bins = [tuple(padded(a) for a in b) for b in bins]
            return wave, (x_stack, bins, items, nbatch), trip_nb + x_nb

        try:
            with prefetcher(gen(), put) as pf:
                for wave, (x_stack, bins, items, nbatch), nb in pf:
                    with phase("als.wave_theta", cat="solve", tracer=tracer,
                               registry=reg, wave=wave.index,
                               iteration=it + 1, bytes=nb, mesh=True,
                               **({"bins": len(bins)} if stacked else {})):
                        for b, (idx, val, cnt) in enumerate(bins):
                            A_w, B_w = wave_herm(x_stack, idx, val, cnt)
                            cnt = cnt.cpu().numpy()
                            if items is None:
                                # float64: the host stand-in for the cells'
                                # partial state; exact for f32 summands, so
                                # the final topology reduce is order-free
                                A_dev += A_w
                                B_dev += B_w
                                c_dev += cnt
                                continue
                            for d in range(nbatch):
                                # the rows with ratings: distinct items, so
                                # the scatter-add is the reference's np.add.at
                                # less its exact-zero padding rows
                                live = cnt[d] > 0
                                it_d = items.items[b][d][live]
                                A_dev[d][it_d] += A_w[d][live]
                                B_dev[d][it_d] += B_w[d][live]
                                c_dev[d][it_d] += cnt[d][live]
                            del A_w, B_w
                    meter.free(f"twave{wave.index}")
                    reg.counter("waves_run").inc()
                    reg.counter("batches_loaded").inc(len(wave.batches))
                    reg.counter("bytes_streamed").inc(nb)
                    last = wave.index == W - 1
                    if last:
                        # not nested in the wave's solve span: the reduce and
                        # the shards' solves are their own phase
                        _reduce_and_solve(A_dev, B_dev, c_dev)
                    _save(it * wpi + W + wave.index + 1,
                          acc=None if last else (A_dev, B_dev, c_dev))
        finally:
            meter.free("acc")

    def _reduce_and_solve(A_dev, B_dev, c_dev):
        """Combine the per-data-shard partials (the paper's Fig. 5b
        schedule), then each model shard solves and writes back its own
        theta rows, on its cell's device."""
        with phase("als.reduce_partials", cat="reduce", tracer=tracer,
                   registry=reg, topology=topo_desc,
                   fast_bytes=topo_traffic["fast_link_bytes"],
                   slow_bytes=topo_traffic["slow_link_bytes"]):
            A = dreduce.topology_reduce(list(A_dev), topo, tracer=tracer)
            B = dreduce.topology_reduce(list(B_dev), topo, tracer=tracer)
            c = dreduce.topology_reduce(list(c_dev), topo, tracer=tracer)
        reg.counter("reduce_fast_bytes").inc(topo_traffic["fast_link_bytes"])
        reg.counter("reduce_slow_bytes").inc(topo_traffic["slow_link_bytes"])
        meter.alloc("theta_out", n * f * 4 // p)
        npp = n // p
        for k, cell in enumerate(column_groups(mesh)[0]):
            lo, hi = k * npp, (k + 1) * npp
            Ak, Bk, ck = (torch.from_numpy(np.asarray(a[lo:hi], np.float32)).to(cell)
                          for a in (A, B, c))
            factors.write_shard("theta", k, p, als_mod.solve_accumulated_(Ak, Bk, ck, cfg))
            del Ak, Bk, ck
        meter.free("theta_out")

    x_half = _x_half_mesh if mesh is not None else _x_half
    theta_half = _theta_half_mesh if mesh is not None else _theta_half

    # ------------------------------------------------------------------
    # Plan side of the ledger: per-wave predictions summed over exactly the
    # waves this run will execute (resume-aware), before any wave streams.
    pstats = predicted_stream_stats(ratings, sched, f)
    pred = {"bytes": 0, "slots": 0, "nnz": 0, "reduces": 0,
            "x_slots": 0, "x_nnz": 0, "t_slots": 0, "t_nnz": 0}

    def _predict_iteration(r: int):
        for wi in range(r if r < W else W, W):          # solve-X half
            pred["bytes"] += pstats["x_bytes"][wi]
            pred["slots"] += pstats["x_slots"][wi]
            pred["nnz"] += pstats["x_nnz"][wi]
            pred["x_slots"] += pstats["x_slots"][wi]
            pred["x_nnz"] += pstats["x_nnz"][wi]
        for wi in range(max(0, r - W), W):              # accumulate-Theta
            pred["bytes"] += pstats["t_bytes"][wi]
            pred["slots"] += pstats["t_slots"][wi]
            pred["nnz"] += pstats["t_nnz"][wi]
            pred["t_slots"] += pstats["t_slots"][wi]
            pred["t_nnz"] += pstats["t_nnz"][wi]
        if mesh is not None:
            pred["reduces"] += 1         # one Fig. 5b reduce per theta half

    # ------------------------------------------------------------------
    history: List[dict] = []
    it0 = start_step // wpi
    with phase("als.stream", cat="driver", tracer=tracer, registry=reg,
               iterations=cfg.iters, waves=W, topology=topo_desc):
        for it in range(it0, cfg.iters):
            resume_here = it == it0
            r = start_step % wpi if resume_here else 0
            _predict_iteration(r)
            ph0 = reg.phase_seconds()
            with phase("als.iteration", cat="iteration", tracer=tracer,
                       registry=reg, iteration=it + 1):
                if r < W:
                    with phase("als.solve_x_half", cat="half",
                               tracer=tracer, registry=reg,
                               iteration=it + 1):
                        x_half(it, first_wave=r)
                if r < wpi:
                    with phase("als.accumulate_theta_half", cat="half",
                               tracer=tracer, registry=reg,
                               iteration=it + 1):
                        theta_half(it, first_wave=max(0, r - W),
                                    acc0=acc_restored if resume_here
                                    else None)
            ph1 = reg.phase_seconds()
            rec = {"iteration": it + 1,
                   "waves_run": int(reg.counter("waves_run").value),
                   "peak_bytes": meter.peak_bytes,
                   "phase_seconds": {
                       cat: s - ph0.get(cat, 0.0)
                       for cat, s in ph1.items()
                       if s - ph0.get(cat, 0.0) > 0.0}}
            if train_eval is not None or test_eval is not None:
                x_dev = torch.from_numpy(factors.x[:ratings.m]).to(dev)
                t_dev = torch.from_numpy(factors.theta).to(dev)
                if test_eval is not None:
                    rec["test_rmse"] = float(
                        rmse_padded(x_dev, t_dev, *test_eval))
                if train_eval is not None:
                    rec["train_rmse"] = float(
                        rmse_padded(x_dev, t_dev, *train_eval))
                del x_dev, t_dev
            history.append(rec)
            if callback is not None:
                callback(it, rec)
        if mgr is not None:
            mgr.wait()
    reg.gauge("peak_bytes").set(meter.peak_bytes)

    # ------------------------------------------------------------------
    # Close the loop: every prediction the planner/schedule/budget layer
    # made for this run, confronted with what the meters measured.
    led = Ledger(solver="als", mesh=mesh is not None, p=p,
                 n_data=n_data, waves=W, iterations=cfg.iters - it0,
                 f=f, m_pad=m_pad, n=n, mode=cfg.mode, n_bins=n_bins,
                 resumed_from_step=start_step, topology=topo_desc,
                 autotune=getattr(ratings, "tune", None), device=str(dev),
                 phase_seconds=reg.phase_seconds())
    led.record("peak_device_bytes", sched.capacity_bytes, meter.peak_bytes,
               unit="bytes", check="le")
    led.record("modeled_peak_bytes",
               required_capacity_bytes(ratings, sched, f,
                                       prefetch_depth=prefetch_depth),
               meter.peak_bytes, unit="bytes", check="le")
    meas_slots = int(reg.counter("padded_slots").value)
    meas_nnz = int(reg.counter("nnz_streamed").value)
    led.record("bytes_streamed", pred["bytes"],
               int(reg.counter("bytes_streamed").value), unit="bytes")
    led.record("padded_slots", pred["slots"], meas_slots, unit="slots")
    led.record("nnz_streamed", pred["nnz"], meas_nnz, unit="ratings")
    led.record("fill_waste_ratio",
               pred["slots"] / pred["nnz"] if pred["nnz"] else 0.0,
               meas_slots / meas_nnz if meas_nnz else 0.0,
               unit="ratio", check="rel", rel_tol=1e-9)
    led.record("worst_fill_bound", ratings.worst_fill,
               meas_slots / meas_nnz if meas_nnz else 0.0,
               unit="ratio", check="le")
    # per-half fill attribution: each streamed orientation pays only its own
    # padding
    mxs = int(reg.counter("x_padded_slots").value)
    mxn = int(reg.counter("x_nnz_streamed").value)
    mts = int(reg.counter("t_padded_slots").value)
    mtn = int(reg.counter("t_nnz_streamed").value)
    led.record("fill/solve_x",
               pred["x_slots"] / pred["x_nnz"] if pred["x_nnz"] else 0.0,
               mxs / mxn if mxn else 0.0,
               unit="ratio", check="rel", rel_tol=1e-9)
    led.record("fill/accumulate_theta",
               pred["t_slots"] / pred["t_nnz"] if pred["t_nnz"] else 0.0,
               mts / mtn if mtn else 0.0,
               unit="ratio", check="rel", rel_tol=1e-9)
    for comp, fb in ratings.fill_breakdown().items():
        led.record(f"fill_bound/{comp}", ratings.worst_fill, fb,
                   unit="ratio", check="le")
    if mesh is not None:
        led.record("reduce_fast_bytes",
                   pred["reduces"] * topo_traffic["fast_link_bytes"],
                   int(reg.counter("reduce_fast_bytes").value), unit="bytes")
        led.record("reduce_slow_bytes",
                   pred["reduces"] * topo_traffic["slow_link_bytes"],
                   int(reg.counter("reduce_slow_bytes").value), unit="bytes")
    for kernel in ("fused_herm", "batch_solve"):
        led.record(f"smem/{kernel}", BUDGETS[kernel].smem_limit,
                   footprint_bytes(kernel, f=f),
                   unit="bytes", check="le", mode=cfg.mode)

    return factors, history, StreamTelemetry.from_registry(
        reg, capacity_bytes=sched.capacity_bytes, topology=topo_desc,
        ledger=led.to_obj())
