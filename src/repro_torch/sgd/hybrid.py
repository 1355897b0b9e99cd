"""ALS-warm-start -> SGD-refine hybrid solver (Tan et al. 1808.03843).

ALS makes large, stable moves in the first few iterations (each sweep is
a closed-form block solve) but every iteration costs the full Hermitian +
Cholesky pipeline; SGD epochs are far cheaper per pass but need many
epochs from a cold start.  The hybrid runs a few ALS iterations on the
row/column PaddedELL layouts, then hands the factors to the blocked SGD
driver *on the same rating data* (the BlockGrid is built from the same
layout via ``blocking.block_ell``) for cheap refinement.

``run_streaming_hybrid`` is the out-of-core variant: the warm start
streams R/R^T waves through ``outofcore.run_streaming_als`` and the
refinement streams grid tiles through ``outofcore.run_streaming_sgd``, so
the whole hybrid runs under the same fixed device budget — neither phase
ever holds the full problem resident.
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import als as als_mod
from repro_torch.sgd.blocking import BlockGrid
from repro_torch.sgd.train import SgdConfig, SgdState, pad_factor, sgd_train


def _tagged(phase: str, callback=None):
    """A callback that tags each history record with its phase (before the
    caller's ``callback`` sees it)."""
    def cb(state, rec):
        rec["phase"] = phase
        if callback is not None:
            callback(state, rec)
    return cb


def sgd_state_from_als(als_state: als_mod.AlsState,
                       grid: BlockGrid) -> SgdState:
    """Continue from an AlsState: pad factors to the grid's block shape.

    Padding rows (users/items beyond the true m/n) carry no ratings in
    any tile, so an epoch never touches them — the SGD trajectory starts
    exactly at the ALS iterate.  A degree-sorted grid stores user rows
    permuted, so the ALS factors (original order) are permuted into grid
    order on the way in.
    """
    x = als_state.x
    if grid.user_perm is not None:
        x = x[torch.from_numpy(grid.user_perm).to(x.device)]
    return SgdState(
        x=pad_factor(x, grid.g * grid.mb),
        theta=pad_factor(als_state.theta, grid.g * grid.nb),
        epoch=0)


def hybrid_train(
    r, rt,
    grid: BlockGrid,
    als_cfg: als_mod.AlsConfig,
    sgd_cfg: SgdConfig,
    *,
    test: Optional[tuple] = None,
    train_eval: Optional[tuple] = None,
    ckpt_dir: Optional[str] = None,
    callback=None,
) -> tuple[SgdState, list[dict]]:
    """``als_cfg.iters`` ALS sweeps, then ``sgd_cfg.epochs`` SGD epochs.

    ``r`` / ``rt`` are the ALS-side (idx, val, cnt) triplets of R and R^T;
    ``grid`` is the blocked view of the same ratings.  History records are
    tagged ``phase: "als" | "sgd"`` (before the callback fires) and share
    the RMSE protocol.

    With ``ckpt_dir`` set and a committed checkpoint present, the ALS
    warm start is skipped: the checkpoint already embeds it.
    """
    tagged = functools.partial(_tagged, callback=callback)
    state0 = None
    als_hist: list[dict] = []
    resuming = False
    if ckpt_dir is not None:
        from repro_torch.checkpoint.store import latest_step
        resuming = (os.path.isdir(ckpt_dir)
                    and latest_step(ckpt_dir) is not None)
    if not resuming:
        als_state, als_hist = als_mod.als_train(
            r, rt, grid.m, grid.n, als_cfg, test=test,
            callback=tagged("als"))
        state0 = sgd_state_from_als(als_state, grid)
    final, sgd_hist = sgd_train(
        grid, sgd_cfg, test=test, train_eval=train_eval,
        init_state=state0, ckpt_dir=ckpt_dir, callback=tagged("sgd"))
    return final, als_hist + sgd_hist


def run_streaming_hybrid(
    ratings,                    # outofcore.RatingStore (warm-start phase)
    als_sched,                  # outofcore.IterationSchedule
    tiles,                      # outofcore.TileStore (refine phase)
    sgd_sched,                  # outofcore.SgdEpochSchedule
    als_cfg: als_mod.AlsConfig,
    sgd_cfg: SgdConfig,
    *,
    test_eval=None,
    train_eval=None,
    ckpt_dir: Optional[str] = None,
    keep: int = 3,
    prefetch_depth: int = 2,
    mesh=None,
    topology=None,
    callback=None,
):
    """Out-of-core hybrid: streaming ALS warm start, streaming SGD refine.

    Both phases run through the shared wave runtime under their own
    schedules' budgets, each on its config's device; ``ratings`` and
    ``tiles`` are two host-resident layouts of the same rating matrix.
    Returns ``(FactorStore, history, StreamTelemetry)`` — ONE merged
    telemetry over both phases (``outofcore.runtime.merge_telemetry``):
    traffic and wall time summed, capacity/peak the per-phase maxima,
    ``phase_seconds`` keys prefixed ``als/`` / ``sgd/``, and the phase
    telemetries reachable under ``.phases["als"]`` / ``.phases["sgd"]``
    (``"als"`` absent when the warm start was skipped on resume).  History
    records are phase-tagged like ``hybrid_train``'s.  Checkpoints are
    phase-scoped (``<ckpt_dir>/als`` and ``<ckpt_dir>/sgd`` hold trees of
    different shapes); once the SGD phase has committed a wave, a restart
    skips the warm start — the SGD checkpoint already embeds it.
    ``mesh`` (a ``launch.mesh.Mesh``) runs both phases on its cells;
    ``topology`` is the ALS phase's reduction topology
    (``run_streaming_als``).
    """
    # imported here: repro_torch.outofcore imports repro_torch.sgd.train, so
    # a module-level import back into repro_torch.sgd would be circular
    from repro_torch.checkpoint.store import latest_step
    from repro_torch.outofcore import (FactorStore, run_streaming_als,
                                       run_streaming_sgd)
    from repro_torch.outofcore.runtime import merge_telemetry

    grid = tiles.grid
    if (grid.m, grid.n) != (ratings.m, ratings.n):
        raise ValueError("RatingStore and TileStore hold different matrices")

    tagged = functools.partial(_tagged, callback=callback)
    als_ck = sgd_ck = None
    refine_started = False
    if ckpt_dir is not None:
        als_ck = os.path.join(ckpt_dir, "als")
        sgd_ck = os.path.join(ckpt_dir, "sgd")
        refine_started = (os.path.isdir(sgd_ck)
                          and latest_step(sgd_ck) is not None)

    als_hist: List[dict] = []
    als_tel = None
    warm = None
    if not refine_started:
        fac, als_hist, als_tel = run_streaming_als(
            ratings, als_sched, als_cfg, ckpt_dir=als_ck, keep=keep,
            prefetch_depth=prefetch_depth, test_eval=test_eval,
            train_eval=train_eval, mesh=mesh, topology=topology,
            callback=lambda it, rec: tagged("als")(None, rec))
        # re-block the streamed factors to the grid's padded shape: the ALS
        # store is [m_pad, f] / [n, f], the SGD store [g*mb, f] / [g*nb, f]
        f = als_cfg.f
        x0 = np.zeros((grid.g * grid.mb, f), np.float32)
        t0 = np.zeros((grid.g * grid.nb, f), np.float32)
        if grid.user_perm is not None:    # grid rows live in permuted order
            x0[:grid.m] = fac.x[:grid.m][grid.user_perm]
        else:
            x0[:grid.m] = fac.x[:grid.m]
        t0[:grid.n] = fac.theta[:grid.n]
        warm = FactorStore.from_arrays(x0, t0)
    final, sgd_hist, sgd_tel = run_streaming_sgd(
        tiles, sgd_sched, sgd_cfg, factors=warm, ckpt_dir=sgd_ck, keep=keep,
        prefetch_depth=prefetch_depth, test_eval=test_eval,
        train_eval=train_eval, mesh=mesh, callback=tagged("sgd"))
    tel = merge_telemetry({"als": als_tel, "sgd": sgd_tel})
    return final, als_hist + sgd_hist, tel
