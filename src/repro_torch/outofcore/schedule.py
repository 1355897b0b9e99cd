"""Wave schedules: streaming plans made executable (paper §4.3/§4.4).

The port's copy of the reference's ``repro/outofcore/schedule.py``: for
equal plans and stores every schedule, capacity and prediction equals the
reference's.

A schedule is a sequence of abstract **wave work items** — each names the
host-resident shards one synchronous streaming step moves through the
(simulated) devices — plus the per-device capacity the driver meters
against.  Two concrete item kinds exist today:

- ``Wave`` (ALS): up to ``n_data`` contiguous q-batches — R row slices on
  the solve-X half, R^T column shards + fresh X slices on the
  accumulate-Theta half.
- ``TileWave`` (SGD): up to ``n_workers`` tiles of one conflict-free
  diagonal block-set of a ``BlockGrid`` — each simulated worker holds one
  (user-block, item-block) tile plus its two factor blocks, the CuMF_SGD
  batch-Hogwild unit.

``build_schedule`` turns the planner's (p, q, waves) into explicit per-
iteration ALS work: which q-batches (X row ranges) each wave streams, which
R shards it touches, and which factor slices must be device-resident.  One
iteration runs two halves over the *same* wave list:

- **solve-X half** — Theta is fully resident (the plan's ``Theta_shard``
  term); wave ``w`` streams the R rows of its batches, solves those X rows
  directly, and writes the slice back to host.
- **accumulate-Theta half** — the A/B Hermitian accumulators for all n items
  are resident; wave ``w`` streams, per batch ``j``, the R^T column shard of
  user-batch ``j`` plus the freshly solved X slice of batch ``j`` (the
  "factor slices resident" of §4.4), and adds the batch's partial Hermitians.
  After the last wave the accumulated systems are solved in row blocks.

This is SU-ALS's partial-sum scheme (eq. 5-7) serialized over waves: with
``n_data`` simulated devices, each wave models one synchronous step in which
every device holds one q-batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.partition import GiB, PartitionPlan, QBatch, export_schedule
from repro_torch.outofcore.store import binned_nbytes


@dataclasses.dataclass(frozen=True)
class WaveItem:
    """Abstract wave work item: one synchronous streaming step.

    ``index`` is the item's checkpoint position within its schedule unit
    (iteration half for ALS, epoch for SGD) — the drivers commit resumable
    state after every item, so ``index`` is also the resume coordinate.
    """

    index: int


@dataclasses.dataclass(frozen=True)
class Wave(WaveItem):
    """ALS wave: up to n_data contiguous q-batches."""

    batches: Tuple[QBatch, ...]

    @property
    def row_start(self) -> int:
        return self.batches[0].row_start

    @property
    def row_stop(self) -> int:
        return self.batches[-1].row_stop

    @property
    def rows(self) -> int:
        return self.row_stop - self.row_start


@dataclasses.dataclass(frozen=True)
class IterationSchedule:
    plan: PartitionPlan
    m_pad: int                  # padded X rows (multiple of q)
    n: int                      # Theta rows
    n_data: int                 # simulated devices on the data axis
    waves: Tuple[Wave, ...]     # shared by both halves of an iteration
    capacity_bytes: int         # per-device budget the driver meters against
    p: int = 1                  # theta model shards (mesh "model" axis size)

    @property
    def waves_per_iteration(self) -> int:
        """Checkpoint steps per iteration: each half walks every wave once."""
        return 2 * len(self.waves)

    def describe(self) -> str:
        w = self.waves[0]
        return (f"waves={len(self.waves)} x {len(w.batches)} batches "
                f"({w.rows} rows/wave, m_pad={self.m_pad}, n={self.n}, "
                f"p={self.p}, capacity={self.capacity_bytes / GiB:.3f}GiB)")


def build_schedule(
    plan: PartitionPlan,
    m: int,
    n: int,
    *,
    n_data: Optional[int] = None,
    capacity_bytes: Optional[int] = None,
) -> IterationSchedule:
    """Explicit per-iteration schedule for ``plan`` on an (m x n) problem.

    ``m`` may be the true row count; it is padded up to a multiple of q here
    so every wave has identical shape (build the RatingStore with the same q
    and the stores line up).  ``capacity_bytes`` defaults to the plan's own
    per-device estimate — the budget the driver's memory meter reports
    against.
    """
    if n_data is None:
        n_data = -(-plan.q // plan.waves)
    m_pad = -(-m // plan.q) * plan.q
    groups = export_schedule(plan, m_pad, n_data)
    waves = tuple(Wave(index=w, batches=g) for w, g in enumerate(groups))
    assert len(waves) * n_data >= plan.q
    assert waves[0].row_start == 0 and waves[-1].row_stop == m_pad
    assert plan.p == 1 or n % plan.p == 0, (n, plan.p)
    return IterationSchedule(
        plan=plan, m_pad=m_pad, n=n, n_data=n_data, waves=waves,
        capacity_bytes=(plan.bytes_per_device if capacity_bytes is None
                        else capacity_bytes),
        p=plan.p)


# ---------------------------------------------------------------------------
# SGD: diagonal block-sets streamed as tile waves.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileWave(WaveItem):
    """SGD wave: up to n_workers tiles of ONE diagonal block-set.

    Tiles within a set touch disjoint user and item blocks, so the wave's
    tiles update concurrently (batch-Hogwild) and consecutive waves of the
    same set commute; a wave must never mix sets — tiles of different sets
    share factor blocks.
    """

    set_index: int
    tiles: Tuple[Tuple[int, int], ...]   # (user-block i, item-block j)


@dataclasses.dataclass(frozen=True)
class SgdEpochSchedule:
    """One SGD epoch as tile waves, grouped by canonical set index.

    ``set_waves[s]`` holds the waves of diagonal set ``s`` in canonical
    order; an epoch executes the sets in a per-epoch permuted order (the
    CuMF_SGD schedule randomization), so ``epoch_waves(set_order)``
    flattens and renumbers the waves for one concrete epoch.
    """

    g: int
    mb: int                     # user rows per block
    nb: int                     # item rows per block
    K: int                      # uniform ELL slots per tile
    f: int                      # latent dimension
    n_workers: int              # simulated devices == tiles per wave
    set_waves: Tuple[Tuple[TileWave, ...], ...]
    capacity_bytes: int         # per-worker budget the driver meters against

    @property
    def waves_per_epoch(self) -> int:
        """Checkpoint steps per epoch (every set, every wave)."""
        return sum(len(ws) for ws in self.set_waves)

    def epoch_waves(self, set_order) -> Tuple[TileWave, ...]:
        """The epoch's flat wave list: sets in ``set_order``, waves
        renumbered 0..waves_per_epoch-1 (the per-epoch resume coordinate)."""
        if sorted(int(s) for s in set_order) != list(range(self.g)):
            raise ValueError(f"set_order {set_order} is not a permutation of "
                             f"0..{self.g - 1}")
        out = []
        for s in set_order:
            for w in self.set_waves[int(s)]:
                out.append(dataclasses.replace(w, index=len(out)))
        return tuple(out)

    def describe(self) -> str:
        return (f"sgd waves={self.waves_per_epoch}/epoch "
                f"({self.g} sets x {len(self.set_waves[0])} waves, "
                f"{self.n_workers} tiles/wave, mb={self.mb}, nb={self.nb}, "
                f"K={self.K}, capacity={self.capacity_bytes / GiB:.3f}GiB)")


def sgd_tile_bytes(mb: int, K: int) -> int:
    """Streamed bytes of one tile's (idx, val, cnt) triplet."""
    return mb * K * 8 + mb * 4


def sgd_required_capacity_bytes(mb: int, nb: int, K: int, f: int,
                                prefetch_depth: int = 2) -> int:
    """Per-worker bytes the streaming SGD driver keeps resident.

    Mirrors ``run_streaming_sgd``'s MemoryMeter model: up to ``depth + 2``
    tile triplets live in the prefetch pipeline (queued + loader-held +
    consumed), while the factor blocks are fetched synchronously at consume
    time (they must see the previous wave's writeback — see the driver) and
    are staged twice (input + updated output) around the tile sweep.
    """
    bufs = prefetch_depth + 2
    factor_bytes = (mb + nb) * f * 4
    return bufs * sgd_tile_bytes(mb, K) + 2 * factor_bytes


def build_sgd_schedule(
    grid,
    f: int,
    *,
    n_workers: Optional[int] = None,
    capacity_bytes: Optional[int] = None,
    prefetch_depth: int = 2,
) -> SgdEpochSchedule:
    """Tile-wave schedule for one SGD epoch over a ``BlockGrid``.

    ``n_workers`` is the simulated device count: each wave streams that many
    tiles of one diagonal set (default: the whole set at once, the in-core
    shape).  ``n_workers < g`` forces multiple waves per set — the
    out-of-core regime where the epoch's tiles stream through a fixed
    budget.  ``capacity_bytes`` defaults to the driver's own resident-bytes
    model (``sgd_required_capacity_bytes``).
    """
    g, mb, nb, K = grid.g, grid.mb, grid.nb, grid.K
    if n_workers is None:
        n_workers = g
    n_workers = max(1, min(int(n_workers), g))
    set_waves = []
    for s in range(g):
        tiles = tuple((i, (i + s) % g) for i in range(g))
        # index is the within-set position only; epoch_waves renumbers to
        # the epoch-flat resume coordinate before any driver sees it
        set_waves.append(tuple(
            TileWave(index=c // n_workers, set_index=s,
                     tiles=tiles[c:c + n_workers])
            for c in range(0, g, n_workers)))
    if capacity_bytes is None:
        capacity_bytes = sgd_required_capacity_bytes(
            mb, nb, K, f, prefetch_depth)
    sched = SgdEpochSchedule(
        g=g, mb=mb, nb=nb, K=K, f=f, n_workers=n_workers,
        set_waves=tuple(set_waves), capacity_bytes=int(capacity_bytes))
    assert sched.waves_per_epoch == g * -(-g // n_workers)
    return sched


def required_capacity_bytes(store, sched: IterationSchedule, f: int,
                            prefetch_depth: int = 2) -> int:
    """Per-device bytes the streaming driver will actually keep resident.

    Mirrors the driver's MemoryMeter model exactly: up to ``depth + 2`` wave
    buffers can be live at once — ``depth`` queued in the Prefetcher, one
    already materialized by the worker while it blocks on the full queue,
    and one held by the consuming wave — plus the fixed factor and solve
    scratch (solve-X half) or the accumulators (accumulate-Theta half).
    The honest counterpart of the planner's eq. (8) estimate, computed from
    the store's *real* padding fills.

    On a ``p > 1`` schedule (mesh streaming) every theta-sized resident —
    the fixed Theta, the Hermitian accumulators, the solved shard — divides
    by p, and the solve-X wave payload is the device's single column block
    of the p-partitioned slice; only the fresh X slice of the accumulate
    half stays replicated across the model axis (every shard's partial
    Hermitian reads the whole batch).

    A degree-binned store streams bin-wise cuts: at p = 1 per-wave
    payloads vary with where each bin's rows fall, so the model bounds
    every wave by the maximum per-batch payload — still ``le`` vs the
    meter, and never above the uniform-K model.  At p > 1 the theta half
    streams the batch-uniform stacks (``rt_stacked``): every batch presents
    the same per-bin shapes, so its payload is one exact constant.
    """
    n_data, p = sched.n_data, sched.p
    wave_rows = sched.waves[0].rows
    bufs = prefetch_depth + 2
    binned = store.r_binned is not None
    stacked = store.rt_stacked
    # solve-X half: resident Theta shard + wave triplets + solve scratch
    theta_bytes = store.n * f * 4 // p
    if binned:
        x_payload = max(
            _binned_span_bytes(store.r_binned, w.row_start, w.row_stop)
            // len(w.batches)
            for w in sched.waves)
    else:
        K = store.r.K if p == 1 else store.r_model_parts.idx.shape[-1]
        x_payload = (wave_rows * (K * 8 + 4)) // n_data
    x_scratch = (wave_rows * (f * f + 2 * f) * 4) // n_data
    x_half = theta_bytes + bufs * x_payload + x_scratch
    # accumulate-Theta half: resident A/B/c shard + per-batch R^T rows of
    # the owned theta shard + the batch's (replicated) X slice
    q, n, K_loc = store.rt_shape
    acc_bytes = n * (f * f + f + 1) * 4 // p
    if binned:
        t_payload = max(binned_nbytes(b) for b in store.rt_binned) \
            + (sched.m_pad // q) * f * 4
    elif stacked is not None:
        # one batch's per-bin triplets, 1/p on each device (rows_b rows are
        # sharded over the model axis), plus the replicated fresh X slice
        batch_trip = sum(st.rows * (st.K * 8 + 4) for st in stacked)
        t_payload = batch_trip // p + (sched.m_pad // q) * f * 4
    else:
        t_payload = n * (K_loc * 8 + 4) // p + (sched.m_pad // q) * f * 4
    t_half = acc_bytes + bufs * t_payload + n * f * 4 // p
    return max(x_half, t_half)


def _binned_span_bytes(binned, start: int, stop: int) -> int:
    """Triplet bytes of original rows ``[start, stop)`` cut bin-wise: each
    bin contributes its span's rows at that bin's own K (idx + val slots
    at 8 bytes, cnt at 4) — exactly what ``x_slice_binned`` materializes."""
    return sum((hi - lo) * (b.K * 8 + 4)
               for b, (lo, hi) in zip(binned.bins,
                                      binned.bin_spans(start, stop)))


def _binned_span_slots(binned, start: int, stop: int) -> int:
    """Padded ELL slots of the same bin-wise cut."""
    return sum((hi - lo) * b.K
               for b, (lo, hi) in zip(binned.bins,
                                      binned.bin_spans(start, stop)))


# ---------------------------------------------------------------------------
# Plan-side streaming predictions (the ledger's "predicted" column).
# ---------------------------------------------------------------------------

def predicted_stream_stats(store, sched: IterationSchedule, f: int) -> dict:
    """Per-wave plan-side streaming stats of ONE ALS iteration, computed
    from the store's array shapes alone — no wave is ever materialized.

    Returns six lists aligned with ``sched.waves``: ``x_bytes`` /
    ``x_slots`` / ``x_nnz`` for the solve-X half and ``t_bytes`` /
    ``t_slots`` / ``t_nnz`` for the accumulate-Theta half.  ``*_bytes``
    predict exactly what the driver's ``bytes_streamed`` counter will
    measure for that wave (rating triplets, and on the theta half the
    fresh X slices too); ``*_slots`` count the padded ELL slots streamed
    and ``*_nnz`` the true ratings under them, from the host-resident cnt
    arrays.  Per-wave granularity keeps the prediction exact under ragged
    last waves and mid-iteration resume: the driver sums exactly the waves
    it executes.  On a ``p > 1`` schedule the solve-X side uses the mesh
    triplet layout (``x_slice_mesh_triplet``'s pre-padding shapes).  On a
    degree-binned store the per-wave numbers sum each bin's contiguous span
    at that bin's own K.  A stacked store (``p > 1`` with ``n_bins > 1``)
    prices the theta half from the batch-uniform ``rt_stacked`` shapes
    while the solve-X side stays on the uniform mesh layout.
    """
    p = sched.p
    binned = store.r_binned is not None
    cnt_rows = store.r.cnt                    # [m_pad], padded rows cnt = 0
    if p == 1:
        per_row_bytes, per_row_slots = store.r.K * 8 + 4, store.r.K
    else:
        K_loc = store.r_model_parts.idx.shape[-1]
        per_row_bytes = p * (K_loc * 8 + 4)   # [rows, p*K_loc] x2 + [rows, p]
        per_row_slots = p * K_loc
    x_bytes, x_slots, x_nnz = [], [], []
    for w in sched.waves:
        if binned:
            x_bytes.append(_binned_span_bytes(
                store.r_binned, w.row_start, w.row_stop))
            x_slots.append(_binned_span_slots(
                store.r_binned, w.row_start, w.row_stop))
        else:
            x_bytes.append(w.rows * per_row_bytes)
            x_slots.append(w.rows * per_row_slots)
        x_nnz.append(int(cnt_rows[w.row_start:w.row_stop].sum()))
    q, n, K_t = store.rt_shape
    if binned:
        shard_bytes = [binned_nbytes(b) for b in store.rt_binned]
        shard_slots = [int(b.padded_slots) for b in store.rt_binned]
    elif store.rt_stacked is not None:
        # batch-uniform stacks: every batch streams the same per-bin shapes
        stacked = store.rt_stacked
        shard_bytes = [sum(st.rows * (st.K * 8 + 4) for st in stacked)] * q
        shard_slots = [sum(st.rows * st.K for st in stacked)] * q
    else:
        shard_bytes = [n * (K_t * 8 + 4)] * q       # one R^T shard's triplet
        shard_slots = [n * K_t] * q
    t_bytes, t_slots, t_nnz = [], [], []
    for w in sched.waves:
        t_bytes.append(sum(
            shard_bytes[b.index] + (b.row_stop - b.row_start) * f * 4
            for b in w.batches))
        t_slots.append(sum(shard_slots[b.index] for b in w.batches))
        t_nnz.append(sum(int(store.rt_cnt[b.index].sum())
                         for b in w.batches))
    return {"x_bytes": x_bytes, "x_slots": x_slots, "x_nnz": x_nnz,
            "t_bytes": t_bytes, "t_slots": t_slots, "t_nnz": t_nnz}


def predicted_sgd_stream_stats(tiles, sched: SgdEpochSchedule) -> dict:
    """Plan-side per-tile streaming stats for the SGD ledger.

    All three come back as ``[g, g]`` per-tile matrices: ``tile_bytes``
    is the tile's ELL triplet (``sgd_tile_bytes`` at the tile's own K on
    a per-tile-binned grid, the grid-wide K otherwise) plus the two
    factor blocks the driver fetches synchronously and the measured
    counter includes; ``tile_slots`` the padded slots the tile's kernel
    shape dispatches; ``tile_nnz`` the true ratings from the grid's
    host-resident cnt.  The driver sums these over exactly the (possibly
    resumed-into, per-epoch-permuted) waves it executes — on a uniform
    grid every entry is the same constant, so the sums are unchanged.
    """
    mb, nb, K, f = sched.mb, sched.nb, sched.K, sched.f
    g = sched.g
    grid = tiles.grid
    tk = (np.full((g, g), K, dtype=np.int64) if grid.tile_K is None
          else grid.tile_K.astype(np.int64))
    return {
        "tile_bytes": mb * tk * 8 + mb * 4 + (mb + nb) * f * 4,  # [g, g]
        "tile_slots": mb * tk,                                   # [g, g]
        "tile_nnz": tiles.grid.cnt.sum(axis=-1),                 # [g, g]
    }
