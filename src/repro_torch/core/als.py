"""MO-ALS: the single-device ALS driver (paper Alg. 1 / Alg. 2).

The alternating structure is the paper's: update X with Theta fixed
(eq. 2), then Theta with X fixed (eq. 3), both through the fused
Hermitian + batched Cholesky solve of ``kernels.ops``.  The q-batching
("solve X in batches when X is big and Theta fits", paper §3.4) is a loop
over row blocks so the Hermitians stay bounded at ``batch_rows * f^2``.

Random initial factors come from a ``torch.Generator``; they differ from
the reference's ``jax.random`` draw, so parity runs inject the
reference's initial state through :func:`state_from_numpy`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import DeviceLike, Mode, default_mode, resolve_device
from repro_torch.core.objective import _sq_err_padded, rmse_padded
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class AlsConfig:
    f: int                    # latent dimension
    lam: float                # weighted-lambda regularization strength
    iters: int = 10           # full ALS iterations (each = update-X + update-Theta)
    batch_rows: int = 0       # q-batch size; 0 = solve all rows at once
    mode: Optional[Mode] = None  # kernel | ref; None: kernel on CUDA, ref on CPU
    seed: int = 0
    init_scale: float = 0.3   # paper initializes factors U[0, 1]; we scale down
    device: str = "cuda"      # the card unless the caller asks for "cpu"

    def __post_init__(self):
        dev = resolve_device(self.device)          # raises without a GPU
        if self.mode is None:
            object.__setattr__(self, "mode", default_mode(dev))
        elif self.mode not in ("kernel", "ref"):
            raise ValueError(f"unknown mode {self.mode!r}")


class AlsState(NamedTuple):
    x: torch.Tensor       # [m, f]
    theta: torch.Tensor   # [n, f]
    iteration: int


def als_init(m: int, n: int, cfg: AlsConfig) -> AlsState:
    """U[0, init_scale) factors from a generator seeded with ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    x = torch.rand((m, cfg.f), generator=gen, dtype=torch.float32) * cfg.init_scale
    theta = torch.rand((n, cfg.f), generator=gen, dtype=torch.float32) * cfg.init_scale
    dev = resolve_device(cfg.device)
    return AlsState(x=x.to(dev), theta=theta.to(dev), iteration=0)


def state_from_numpy(x, theta, iteration: int = 0,
                     device: DeviceLike = None) -> AlsState:
    """An :class:`AlsState` on ``device`` from numpy factors, e.g. the
    reference's ``AlsState`` fields passed through ``np.asarray``."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return AlsState(x=put(x), theta=put(theta), iteration=int(iteration))


def _map_row_blocks(solve_block, arrays, batch_rows: int) -> torch.Tensor:
    """Run ``solve_block`` on consecutive ``batch_rows``-row blocks of
    ``arrays`` and concatenate.  The last block may be short: unlike a
    ``lax.map``, nothing here needs equal block shapes, so no padding."""
    m = arrays[0].shape[0]
    return torch.cat([solve_block(tuple(a[lo:lo + batch_rows] for a in arrays))
                      for lo in range(0, m, batch_rows)])


def _update_factor(theta, idx, val, cnt, cfg: AlsConfig) -> torch.Tensor:
    """Solve every row of one factor given the other side fixed."""
    def solve(b):
        return kops.als_update_factor(theta, b[0], b[1], b[2], cfg.lam,
                                      mode=cfg.mode)

    m = idx.shape[0]
    if cfg.batch_rows and cfg.batch_rows < m:
        return _map_row_blocks(solve, (idx, val, cnt), cfg.batch_rows)
    return solve((idx, val, cnt))


def update_rows(fixed, idx, val, cnt, cfg: AlsConfig) -> torch.Tensor:
    """Per-slice update entry point: solves the rows of one factor slice
    given the ``fixed`` other factor — the same math as a full
    ``_update_factor`` call restricted to the slice."""
    return _update_factor(fixed, idx, val, cnt, cfg)


def partial_herm(x_batch, idx_loc, val_loc, cnt_loc, cfg: AlsConfig):
    """Per-batch partial Hermitian (A_j, B_j) with no empty-row guard;
    summing over batches reproduces the full Hermitian because the
    weighted-lambda diagonal ``lam * cnt_loc`` telescopes too."""
    return kops.fused_herm(x_batch, idx_loc, val_loc, cnt_loc, cfg.lam,
                           mode=cfg.mode, diag_fallback=False)


def solve_accumulated(A, B, cnt_total, cfg: AlsConfig) -> torch.Tensor:
    """Solve a factor from accumulated partial Hermitians: a row empty in
    every batch gets A = I (x = 0, like ``diag_fallback``), then the
    batched Cholesky solve, in row blocks of ``cfg.batch_rows`` when set.
    ``A`` is left as it was (the guard goes into one copy)."""
    return solve_accumulated_(A.clone(), B, cnt_total, cfg)


def solve_accumulated_(A, B, cnt_total, cfg: AlsConfig) -> torch.Tensor:
    """:func:`solve_accumulated` that adds the empty rows' identity into
    ``A`` itself: for a caller whose accumulator is spent (the streaming
    driver's last wave), no ``[n, f, f]`` temporary."""
    empty = (cnt_total <= 0).to(A.dtype)
    A.diagonal(dim1=-2, dim2=-1).add_(empty[:, None])

    def solve(ab):
        return kops.batch_solve(ab[0], ab[1], mode=cfg.mode)

    if cfg.batch_rows and cfg.batch_rows < A.shape[0]:
        return _map_row_blocks(solve, (A, B), cfg.batch_rows)
    return solve((A, B))


def als_iteration(state: AlsState, r, rt, cfg: AlsConfig) -> AlsState:
    """One full ALS iteration.  ``r`` / ``rt`` are (idx, val, cnt) triplets of
    R in row-major (users) and of R^T (items) respectively."""
    x = _update_factor(state.theta, r[0], r[1], r[2], cfg)
    theta = _update_factor(x, rt[0], rt[1], rt[2], cfg)
    return AlsState(x=x, theta=theta, iteration=state.iteration + 1)


def als_train(
    r, rt, m: int, n: int, cfg: AlsConfig,
    test: Optional[tuple] = None,
    callback=None,
    init: Optional[AlsState] = None,
) -> tuple[AlsState, list[dict]]:
    """Full training driver.  Returns (final state, per-iteration history).

    ``test`` is an optional (idx, val, cnt) triplet evaluated after every
    iteration (paper Fig. 6 protocol).  ``init`` replaces the seeded
    :func:`als_init` draw."""
    state = als_init(m, n, cfg) if init is None else init
    history: list[dict] = []
    for it in range(cfg.iters):
        state = als_iteration(state, r, rt, cfg)
        rec = {"iteration": it + 1}
        if test is not None:
            rec["test_rmse"] = float(
                rmse_padded(state.x, state.theta, test[0], test[1], test[2]))
        rec["train_rmse"] = float(
            rmse_padded(state.x, state.theta, r[0], r[1], r[2]))
        history.append(rec)
        if callback is not None:
            callback(state, rec)
    return state, history


def ell_triplet(ell, device: DeviceLike = None):
    """PaddedELL -> (idx int32, val float32, cnt int32) tensors on ``device``."""
    dev = resolve_device(device)
    return (torch.from_numpy(np.array(ell.idx, dtype=np.int32)).to(dev),
            torch.from_numpy(np.array(ell.val, dtype=np.float32)).to(dev),
            torch.from_numpy(np.array(ell.cnt, dtype=np.int32)).to(dev))


# ---------------------------------------------------------------------------
# Degree-binned dispatch: the same kernels, once per bin at that bin's K.
# Padding slots are exact zeros, so binned == unbinned numerically.
# ---------------------------------------------------------------------------

def _device_bins(binned, device: DeviceLike):
    """Per non-empty bin: its (idx, val, cnt) triplet and original row ids,
    as tensors on ``device`` (uploaded once per training run)."""
    dev = resolve_device(device)
    return [(ell_triplet(b, dev), torch.from_numpy(np.asarray(rows, np.int64)).to(dev))
            for b, rows in zip(binned.bins, binned.rows) if b.m]


def _update_factor_bins(fixed, dbins, m: int, cfg: AlsConfig) -> torch.Tensor:
    out = torch.zeros((m, cfg.f), dtype=torch.float32, device=fixed.device)
    for (idx, val, cnt), rows in dbins:
        out[rows] = _update_factor(fixed, idx, val, cnt, cfg)
    return out


def update_factor_binned(fixed, binned, cfg: AlsConfig) -> torch.Tensor:
    """Solve one factor from a :class:`~repro_torch.sparse.padded.BinnedELL`:
    ``als_update_factor`` once per degree bin at the bin's own K, results
    scattered back to original row order through ``binned.rows``."""
    return _update_factor_bins(fixed, _device_bins(binned, fixed.device),
                               binned.m, cfg)


def update_rows_binned(fixed, binned, cfg: AlsConfig) -> torch.Tensor:
    """Binned per-slice update: results come back in slice row order,
    exactly like :func:`update_rows` on the uniform layout."""
    return update_factor_binned(fixed, binned, cfg)


def partial_herm_binned(x_batch, binned_loc, cfg: AlsConfig):
    """Binned per-batch partial Hermitian: :func:`partial_herm` once per
    bin, scatter-added into full-size (A_j, B_j)."""
    n, f = binned_loc.m, cfg.f
    A = torch.zeros((n, f, f), dtype=torch.float32, device=x_batch.device)
    B = torch.zeros((n, f), dtype=torch.float32, device=x_batch.device)
    for (idx, val, cnt), rows in _device_bins(binned_loc, x_batch.device):
        Ab, Bb = partial_herm(x_batch, idx, val, cnt, cfg)
        A.index_add_(0, rows, Ab)
        B.index_add_(0, rows, Bb)
    return A, B


def _rmse_bins(x, theta, dbins) -> float:
    sse, nnz = 0.0, 0
    for (idx, val, cnt), rows in dbins:
        s, k = _sq_err_padded(x[rows], theta, idx, val, cnt)
        sse += float(s)
        nnz += int(k)
    return (sse / max(nnz, 1)) ** 0.5


def rmse_binned(x, theta, binned) -> float:
    """RMSE over the nonzeros of a BinnedELL (per-bin SSE, one sqrt)."""
    return _rmse_bins(x, theta, _device_bins(binned, x.device))


def als_train_binned(
    rb, rtb, cfg: AlsConfig,
    test: Optional[tuple] = None,
    callback=None,
    init: Optional[AlsState] = None,
) -> tuple[AlsState, list[dict]]:
    """In-core training driver over binned layouts: the schedule of
    :func:`als_train` with both half-updates dispatched per bin.  ``rb`` /
    ``rtb`` are BinnedELLs of R (rows=users) and R^T (rows=items); their
    bins go to the card once, before the first iteration."""
    state = als_init(rb.m, rtb.m, cfg) if init is None else init
    r_bins = _device_bins(rb, cfg.device)
    rt_bins = _device_bins(rtb, cfg.device)
    history: list[dict] = []
    for it in range(cfg.iters):
        x = _update_factor_bins(state.theta, r_bins, rb.m, cfg)
        theta = _update_factor_bins(x, rt_bins, rtb.m, cfg)
        state = AlsState(x=x, theta=theta, iteration=state.iteration + 1)
        rec = {"iteration": it + 1}
        if test is not None:
            rec["test_rmse"] = float(
                rmse_padded(state.x, state.theta, test[0], test[1], test[2]))
        rec["train_rmse"] = _rmse_bins(state.x, state.theta, r_bins)
        history.append(rec)
        if callback is not None:
            callback(state, rec)
    return state, history
