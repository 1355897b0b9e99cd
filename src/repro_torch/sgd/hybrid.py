"""ALS-warm-start -> SGD-refine hybrid solver (Tan et al. 1808.03843).

ALS makes large, stable moves in the first few iterations (each sweep is
a closed-form block solve) but every iteration costs the full Hermitian +
Cholesky pipeline; SGD epochs are far cheaper per pass but need many
epochs from a cold start.  The hybrid runs a few ALS iterations on the
row/column PaddedELL layouts, then hands the factors to the blocked SGD
driver *on the same rating data* (the BlockGrid is built from the same
layout via ``blocking.block_ell``) for cheap refinement.

The reference's out-of-core variant, ``run_streaming_hybrid``, waits for
the port of the streaming drivers.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.core import als as als_mod
from repro_torch.sgd.blocking import BlockGrid
from repro_torch.sgd.train import SgdConfig, SgdState, pad_factor, sgd_train


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
    def tagged(phase):
        def cb(state, rec):
            rec["phase"] = phase
            if callback is not None:
                callback(state, rec)
        return cb

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
