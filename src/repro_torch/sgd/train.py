"""Batch-Hogwild SGD epoch driver (CuMF_SGD) over a BlockGrid.

One epoch walks the g conflict-free diagonal block-sets in a per-epoch
shuffled order (CuMF_SGD randomizes the schedule); the permutation comes
from a ``torch.Generator`` keyed on ``(cfg.seed, epoch)``, so runs are
reproducible and checkpoint resume stays bit-exact.  Every tile in a set
touches disjoint X and Theta rows, so the set's tiles stack into ONE
``sgd_block_update`` call on ``[t*mb]`` user rows against the set's
permuted ``[t*nb]`` item blocks (``sgd_tiles_update``).

The reference's jitted ``lax.scan`` over sets becomes a Python loop over
sets.  In ``"kernel"`` mode each set is one planned call on the whole X
and Theta in place: :func:`build_set_plans` turns each diagonal set into a
``SlotPlan`` in global row and item ids, once per run (the plans depend
only on the grid), and an epoch clones X and Theta once and sweeps them.
In ``"ref"`` mode each set is one stacked call per same-K group of its
tiles, each sliced to that K (a uniform grid has one group per set).

The reference draws its initial state and set orders from ``jax.random``,
which torch cannot reproduce: parity runs inject the reference's state
through :func:`sgd_state_from_numpy` and its set orders through
``sgd_epoch(set_order=)``.

:func:`sgd_train` reports through its tracer (``repro_torch.obs``): per
epoch an ``sgd.epoch`` step span holding one ``sgd.set`` span per diagonal
set (around the sweep's ``kernel.sgd_tile`` span in ``"kernel"`` mode) and
``sgd.evaluate`` with its RMSE spans.  The ``sgd.set`` args are counted
from the host grid once per run, and only while the tracer records.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import DeviceLike, Mode, default_mode, resolve_device
from repro_torch.core.objective import rmse_padded
from repro_torch.kernels.sgd_update import (P_SPLIT, SlotPlan, build_plan,
                                            sgd_block_update, sgd_tile_planned_)
from repro_torch.obs.metrics import process_registry
from repro_torch.obs.trace import NULL_TRACER, current_tracer, phase
from repro_torch.sgd.blocking import BlockGrid
from repro_torch.training.optimizer import lr_schedule

_SYNCS = process_registry().counter("host/syncs")


@dataclasses.dataclass(frozen=True)
class SgdConfig:
    f: int                      # latent dimension
    lam: float                  # per-sample L2 strength
    lr: float = 0.08            # base learning rate
    epochs: int = 30
    schedule: str = "inverse_time"  # constant | inverse_time | cosine
    decay: Optional[float] = None   # inverse-time decay (None = 10/epochs)
    min_lr: float = 0.0             # cosine floor
    mode: Optional[Mode] = None     # kernel | ref; None: kernel on CUDA, ref on CPU
    seed: int = 0
    init_scale: float = 0.3
    device: str = "cuda"        # the card unless the caller asks for "cpu"

    def __post_init__(self):
        dev = resolve_device(self.device)          # raises without a GPU
        if self.mode is None:
            object.__setattr__(self, "mode", default_mode(dev))
        elif self.mode not in ("kernel", "ref"):
            raise ValueError(f"unknown mode {self.mode!r}")


class SgdState(NamedTuple):
    x: torch.Tensor       # [g*mb, f] user factors (padded rows past m unused)
    theta: torch.Tensor   # [g*nb, f] item factors (padded rows past n unused)
    epoch: int


def epoch_lr(cfg: SgdConfig, epoch: int) -> float:
    """The scheduled learning rate for one epoch (a float32 value)."""
    return float(lr_schedule(cfg.schedule, epoch, base_lr=cfg.lr,
                             total_steps=cfg.epochs, decay=cfg.decay,
                             min_lr=cfg.min_lr))


def sgd_init(grid: BlockGrid, cfg: SgdConfig) -> SgdState:
    """U[0, init_scale) factors at the grid's padded sizes, from a
    generator seeded with ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    x = torch.rand((grid.g * grid.mb, cfg.f), generator=gen) * cfg.init_scale
    theta = torch.rand((grid.g * grid.nb, cfg.f), generator=gen) * cfg.init_scale
    dev = resolve_device(cfg.device)
    return SgdState(x=x.to(dev), theta=theta.to(dev), epoch=0)


def sgd_state_from_numpy(x, theta, epoch: int = 0,
                         device: DeviceLike = None) -> SgdState:
    """An :class:`SgdState` on ``device`` from numpy factors, e.g. the
    reference's ``SgdState`` fields passed through ``np.asarray``."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return SgdState(x=put(x), theta=put(theta), epoch=int(epoch))


def grid_triplet(grid: BlockGrid, device: DeviceLike = None):
    """BlockGrid -> (idx [g,g,mb,K] int32, val float32, cnt int32) on ``device``."""
    dev = resolve_device(device)
    return (torch.from_numpy(np.array(grid.idx, dtype=np.int32)).to(dev),
            torch.from_numpy(np.array(grid.val, dtype=np.float32)).to(dev),
            torch.from_numpy(np.array(grid.cnt, dtype=np.int32)).to(dev))


def epoch_set_order(seed: int, epoch: int, g: int) -> torch.Tensor:
    """The epoch's diagonal-set visit order: a permutation of ``range(g)``
    from a generator keyed on ``(seed, epoch)``, so a checkpoint resume
    replays exactly the order the killed run would have used."""
    # the CPU generator keeps only 32 bits of its seed: mix (seed, epoch)
    # into 32 bits first
    key = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.randperm(g, generator=torch.Generator().manual_seed(key))


def sgd_tiles_update(x, theta, idx, val, cnt, lr, lam):
    """One batch-Hogwild sweep over t mutually DISJOINT tiles, stacked
    into a single plain ``sgd_block_update`` call: the path of mode
    ``"ref"`` only (mode ``"kernel"`` runs the set plans).

    ``x [t, mb, f]`` / ``theta [t, nb, f]`` are tile k's two factor
    blocks; ``idx [t, mb, K]`` holds block-local item indices.  Shifting
    tile k's indices by ``k*nb`` turns the stack into one [t*mb] x [t*nb]
    block update with identical semantics: in-slot collisions only ever
    involve items of one tile, whose index ranges stay disjoint after the
    shift.
    """
    t, mb, f = x.shape
    nb = theta.shape[1]
    K = idx.shape[-1]
    offs = (torch.arange(t, dtype=torch.int32, device=idx.device) * nb)[:, None, None]
    x2, t2 = sgd_block_update(
        x.reshape(t * mb, f), theta.reshape(t * nb, f),
        (idx + offs).reshape(t * mb, K), val.reshape(t * mb, K),
        cnt.reshape(t * mb), lr, lam, mode="ref")
    return x2.reshape(t, mb, f), t2.reshape(t, nb, f)


def _set_k_groups(grid: BlockGrid, s: int):
    """Diagonal set ``s``'s tiles grouped by per-tile K: [(K_t, ii, jj)].

    Tiles within a set are disjoint in both factors, so sweeping same-K
    groups one after another is exactly the one-stack sweep.
    """
    by_k: dict[int, list[tuple[int, int]]] = {}
    for i in range(grid.g):
        j = (i + s) % grid.g
        by_k.setdefault(grid.tile_k(i, j), []).append((i, j))
    return [(k, np.array([ij[0] for ij in ts], dtype=np.int64),
             np.array([ij[1] for ij in ts], dtype=np.int64))
            for k, ts in sorted(by_k.items())]


def _grouped_epoch(xb, tb, idx, val, cnt, set_order, lr, grid: BlockGrid,
                   cfg: SgdConfig, tracer=NULL_TRACER, set_args=None):
    """Host loop over sets, one stacked call per same-K group, each sliced
    to that group's K (the trailing slot columns of a tile are all padding,
    so the slice drops only no-op slots).  Returns fresh blocks; the
    inputs are not modified."""
    xb, tb = xb.clone(), tb.clone()
    for s in [int(v) for v in set_order]:
        with tracer.span("sgd.set", cat="set", **(set_args[s] if set_args else {})):
            for k_t, ii, jj in _set_k_groups(grid, s):
                ii = torch.from_numpy(ii).to(xb.device)
                jj = torch.from_numpy(jj).to(xb.device)
                x_new, t_new = sgd_tiles_update(
                    xb[ii], tb[jj], idx[ii, jj, :, :k_t], val[ii, jj, :, :k_t],
                    cnt[ii, jj], lr, cfg.lam)
                xb[ii] = x_new
                tb[jj] = t_new
    return xb, tb


def build_set_plans(gt, grid: BlockGrid, *, p: int = P_SPLIT) -> list[SlotPlan]:
    """One ``SlotPlan`` per diagonal set s (tiles (i, (i+s) % g)), in
    global ids: tile (i, j)'s row u is X's row ``i*mb + u`` and its item v
    Theta's row ``j*nb + v``.  Only live entries are planned, so per-tile-K
    and degree-sorted grids need nothing special."""
    idx, val, cnt = gt
    g, mb, nb = grid.g, grid.mb, grid.nb
    ar = torch.arange(g, device=idx.device)
    plans = []
    for s in range(g):
        j = (ar + s) % g
        items = idx[ar, j] + (j.to(idx.dtype) * nb)[:, None, None]
        plans.append(build_plan(items.reshape(g * mb, -1), val[ar, j].reshape(g * mb, -1),
                                cnt[ar, j].reshape(g * mb), p=p))
    return plans


def _set_args(grid: BlockGrid, cfg: SgdConfig, plan) -> list[dict]:
    """``sgd.set`` span args of each diagonal set, counted on the host from
    the grid: its live ratings, the slot steps its sweep takes (the plan's
    slots, or the sum of its K groups' K in ``"ref"`` mode), the factor
    rows and the grid's shape."""
    g, ar = grid.g, np.arange(grid.g)
    out = []
    for s in range(g):
        slots = (plan[s].n_slots if plan is not None
                 else sum(k for k, _, _ in _set_k_groups(grid, s)))
        out.append(dict(set=s, live=int(grid.cnt[ar, (ar + s) % g].sum()), slots=slots,
                        x_rows=g * grid.mb, theta_rows=g * grid.nb, g=g, mb=grid.mb,
                        f=cfg.f))
    return out


def sgd_epoch(state: SgdState, gt, grid: BlockGrid, cfg: SgdConfig,
              lr: float, *, set_order=None, plan=None, tracer=NULL_TRACER,
              set_args=None) -> SgdState:
    """One full epoch: g diagonal sets x g independent tiles per set.

    ``grid`` supplies the block shape — ``nb`` in particular must NOT be
    recomputed from ``state.theta.shape`` (a caller passing factors padded
    beyond ``g*nb`` would mis-slice every theta block), so shapes are
    checked at entry instead.  ``set_order`` is the epoch's set
    permutation (:func:`epoch_set_order`, or the reference's as numpy);
    None keeps the canonical 0..g-1 order.  ``plan`` is the list of
    :func:`build_set_plans` for ``"kernel"`` mode, built here when None.
    Each set runs in an ``sgd.set`` span of ``tracer``, with the
    :func:`_set_args` ``set_args`` where given.  The caller's ``state`` is
    never modified.
    """
    idx, val, cnt = gt
    g, mb, nb, f = grid.g, grid.mb, grid.nb, cfg.f
    if (tuple(idx.shape[:3]) != (g, g, mb) or tuple(state.x.shape) != (g * mb, f)
            or tuple(state.theta.shape) != (g * nb, f)):
        raise ValueError(f"shapes do not fit the grid (g={g}, mb={mb}, nb={nb}, f={f}): "
                         f"idx {tuple(idx.shape)}, x {tuple(state.x.shape)}, "
                         f"theta {tuple(state.theta.shape)}")
    order = np.asarray(range(g) if set_order is None else set_order).tolist()
    if cfg.mode == "ref":
        xb, tb = _grouped_epoch(state.x.reshape(g, mb, f), state.theta.reshape(g, nb, f),
                                idx, val, cnt, order, lr, grid, cfg, tracer, set_args)
        return SgdState(x=xb.reshape(g * mb, f), theta=tb.reshape(g * nb, f),
                        epoch=state.epoch + 1)
    if plan is None:
        plan = build_set_plans(gt, grid)
    x, theta = state.x.clone(), state.theta.clone()
    for s in order:
        with tracer.span("sgd.set", cat="set", **(set_args[int(s)] if set_args else {})):
            sgd_tile_planned_(x, theta, plan[int(s)], lr, cfg.lam)
    return SgdState(x=x, theta=theta, epoch=state.epoch + 1)


def sgd_train(
    grid: BlockGrid,
    cfg: SgdConfig,
    *,
    test: Optional[tuple] = None,
    train_eval: Optional[tuple] = None,
    init_state: Optional[SgdState] = None,
    ckpt_dir: Optional[str] = None,
    callback=None,
    tracer=None,
    registry=None,
) -> tuple[SgdState, list[dict]]:
    """Epoch loop with lr schedule, RMSE tracking, and checkpoint/resume.

    ``test`` / ``train_eval`` are global-coordinate (idx, val, cnt)
    triplets (the same eval protocol as ``als_train``); evaluation slices
    the padded factors back to the true (m, n).  With ``ckpt_dir`` the
    driver restores the latest epoch on entry and saves after every epoch
    (async, paper §4.4 protocol), so a killed run resumes bit-exact.

    Each epoch's sets and evaluation run in an ``sgd.epoch`` step span of
    ``tracer`` (the module docstring), which defaults to the process-wide
    tracer and is a no-op unless one is enabled; a device-clock tracer
    times the epoch with CUDA events, with no synchronise.  The sets also
    run in an ``epoch`` obs phase (plus a ``checkpoint`` phase per commit)
    feeding ``registry`` when given: on the card that phase ends with a
    stream synchronise (the reference's ``block_until_ready``), so its
    host clock times the epoch's kernels and not only their launch.
    Without a registry the epochs queue on the card unsynchronised.
    """
    tracer = tracer if tracer is not None else current_tracer()
    state = sgd_init(grid, cfg) if init_state is None else init_state
    start = int(state.epoch)
    mgr = None
    if ckpt_dir is not None:
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(ckpt_dir, keep=2)
        restored, ck_epoch = mgr.restore_or_init(
            {"x": state.x, "theta": state.theta}, lambda: None)
        if ck_epoch:
            state = SgdState(x=restored["x"], theta=restored["theta"], epoch=ck_epoch)
            start = ck_epoch
    gt = grid_triplet(grid, state.x.device)
    plan = build_set_plans(gt, grid) if cfg.mode == "kernel" else None
    set_args = _set_args(grid, cfg, plan) if tracer.enabled else None
    history: list[dict] = []
    for ep in range(start, cfg.epochs):
        lr = epoch_lr(cfg, ep)
        with tracer.step_span("sgd.epoch", cat="epoch", epoch=ep + 1, lr=lr):
            with phase("sgd.epoch", cat="epoch", registry=registry):
                state = sgd_epoch(state, gt, grid, cfg, lr,
                                  set_order=epoch_set_order(cfg.seed, ep, grid.g), plan=plan,
                                  tracer=tracer, set_args=set_args)
                if registry is not None and state.x.is_cuda:
                    torch.cuda.current_stream(state.x.device).synchronize()
                    _SYNCS.inc()
            rec = {"epoch": ep + 1, "lr": lr}
            with tracer.span("sgd.evaluate", cat="objective"):
                x, th = eval_factors(state, grid)
                if test is not None:
                    with tracer.span("sgd.rmse_test", cat="objective"):
                        rec["test_rmse"] = float(rmse_padded(x, th, *test))
                        _SYNCS.inc()
                if train_eval is not None:
                    with tracer.span("sgd.rmse_train", cat="objective"):
                        rec["train_rmse"] = float(rmse_padded(x, th, *train_eval))
                        _SYNCS.inc()
        history.append(rec)
        if mgr is not None:
            # host copies, not the live factors: the manager commits on a
            # background thread, and on the CPU ``t.cpu().numpy()`` would
            # alias the tensor itself
            with phase("checkpoint.commit", cat="checkpoint",
                       tracer=tracer, registry=registry, step=ep + 1):
                mgr.save(ep + 1, {"x": np.array(state.x.cpu()),
                                  "theta": np.array(state.theta.cpu())})
        if callback is not None:
            callback(state, rec)
    if mgr is not None:
        mgr.wait()
    return state, history


def pad_factor(a: torch.Tensor, rows_to: int) -> torch.Tensor:
    """Zero-pad a factor's leading axis up to the grid's padded row count."""
    extra = rows_to - a.shape[0]
    if extra < 0:
        raise ValueError(f"cannot pad {a.shape[0]} rows down to {rows_to}")
    if extra == 0:
        return a
    return torch.nn.functional.pad(a, (0, 0, 0, extra))


def eval_factors(state: SgdState, grid: BlockGrid):
    """(X [m, f], Theta [n, f]) in ORIGINAL global coordinates: undoes the
    grid's degree-sort user permutation (identity on unsorted grids) and
    slices off the block-padding rows."""
    if grid.user_perm is None:
        return state.x[:grid.m], state.theta[:grid.n]
    inv = torch.from_numpy(grid.user_inv).to(state.x.device)
    return state.x[inv], state.theta[:grid.n]


def factors_np(state: SgdState, grid: BlockGrid) -> tuple[np.ndarray, np.ndarray]:
    """Unpadded (X [m, f], Theta [n, f]) as numpy, original row order."""
    x, th = eval_factors(state, grid)
    return np.array(x.cpu()), np.array(th.cpu())
