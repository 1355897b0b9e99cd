"""MO-ALS: the single-device ALS driver (paper Alg. 1 / Alg. 2).

The alternating structure is the paper's: update X with Theta fixed
(eq. 2), then Theta with X fixed (eq. 3), both through the fused
Hermitian + batched Cholesky solve of ``kernels.ops``.  The q-batching
("solve X in batches when X is big and Theta fits", paper §3.4) is a loop
over row blocks so the Hermitians stay bounded at ``batch_rows * f^2``.

Random initial factors come from a ``torch.Generator``; they differ from
the reference's ``jax.random`` draw, so parity runs inject the
reference's initial state through :func:`state_from_numpy`.

:func:`als_train_binned` reports through the current tracer
(``repro_torch.obs``): per iteration an ``als.iteration`` step span
holding two ``als.half`` spans, one ``als.bin`` span per non-empty bin and
q-batch (around the ops' ``kernel.*`` spans) and one ``als.scatter`` per
bin, then ``als.evaluate`` with ``als.rmse_test`` and ``als.rmse_train``
(one ``kernel.sq_err`` span per test call and per bin of R).
The ``als.bin`` ratings are counted from the host layouts once per run,
and only while a tracer records, as are all the ``als.bin`` args.  Each host read of a device value in the loop
counts in the process registry's ``host/syncs``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import DeviceLike, Mode, default_mode, resolve_device
from repro_torch.core.objective import rmse_padded
from repro_torch.kernels import ops as kops
from repro_torch.obs.metrics import process_registry
from repro_torch.obs.trace import NOOP_SPAN, current_tracer

_SYNCS = process_registry().counter("host/syncs")


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


def _row_batches(m: int, batch_rows: int) -> list[tuple[int, int]]:
    """The [lo, hi) rows of each q-batch of ``m`` rows: consecutive
    ``batch_rows``-row blocks where ``batch_rows`` is set below ``m``, else
    one batch."""
    step = batch_rows if batch_rows and batch_rows < m else max(m, 1)
    return [(lo, min(lo + step, m)) for lo in range(0, max(m, 1), step)]


def _map_row_blocks(solve_block, arrays, batch_rows: int) -> torch.Tensor:
    """``solve_block(q, block)`` on each q-batch of ``arrays``
    (:func:`_row_batches`), concatenated; a single batch is ``arrays``
    itself.  The last block may be short: unlike a ``lax.map``, nothing
    here needs equal block shapes, so no padding."""
    batches = _row_batches(arrays[0].shape[0], batch_rows)
    if len(batches) == 1:
        return solve_block(0, arrays)
    return torch.cat([solve_block(q, tuple(a[lo:hi] for a in arrays))
                      for q, (lo, hi) in enumerate(batches)])


def _update_factor(theta, idx, val, cnt, cfg: AlsConfig, batch_span=None) -> torch.Tensor:
    """Solve every row of one factor given the other side fixed.
    ``batch_span(q, rows)``, where given, is the context each q-batch's
    solve runs in."""
    def solve(q, b):
        with NOOP_SPAN if batch_span is None else batch_span(q, b[0].shape[0]):
            return kops.als_update_factor(theta, b[0], b[1], b[2], cfg.lam, mode=cfg.mode)

    return _map_row_blocks(solve, (idx, val, cnt), cfg.batch_rows)


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

    def solve(q, ab):
        return kops.batch_solve(ab[0], ab[1], mode=cfg.mode)

    return _map_row_blocks(solve, (A, B), cfg.batch_rows)


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


def _bin_nnz(binned, batch_rows: int) -> list[list[int]]:
    """Ratings of each non-empty bin's q-batches, from the host layout."""
    return [[int(b.cnt[lo:hi].sum()) for lo, hi in _row_batches(b.m, batch_rows)]
            for b in binned.bins if b.m]


def _update_factor_bins(fixed, dbins, m: int, cfg: AlsConfig, *, nnz=None) -> torch.Tensor:
    """:func:`_update_factor` per bin of ``dbins`` (:func:`_device_bins`),
    each bin's rows scattered back in an ``als.scatter`` span of the
    current tracer.  While it records, each q-batch runs in an ``als.bin``
    span; ``nnz`` (:func:`_bin_nnz`) gives their ratings."""
    tracer = current_tracer()
    out = torch.zeros((m, cfg.f), dtype=torch.float32, device=fixed.device)
    for b, ((idx, val, cnt), rows) in enumerate(dbins):
        batch_span = None
        if tracer.enabled:
            def batch_span(q, n, b=b, K=idx.shape[1]):
                return tracer.span("als.bin", cat="bin", bin=b, batch=q, rows=n, K=K,
                                   nnz=nnz[b][q] if nnz else None,
                                   fixed_rows=fixed.shape[0], f=fixed.shape[1])
        solved = _update_factor(fixed, idx, val, cnt, cfg, batch_span)
        with tracer.span("als.scatter", cat="scatter", bin=b):
            out[rows] = solved
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
    """RMSE over the nonzeros of ``dbins`` (:func:`_device_bins`): every
    bin's squared error added into one float64 accumulator on the device
    (``kops.sq_err`` through the bin's row map), which the host reads once."""
    acc = torch.zeros(2, dtype=torch.float64, device=x.device)
    for (idx, val, cnt), rows in dbins:
        kops.sq_err(x, theta, idx, val, cnt, rows=rows, out=acc)
    sse, nnz = acc.tolist()
    _SYNCS.inc()
    return (sse / max(nnz, 1.0)) ** 0.5


def rmse_binned(x, theta, binned) -> float:
    """RMSE over the nonzeros of a BinnedELL (per-bin SSE, one sqrt)."""
    return _rmse_bins(x, theta, _device_bins(binned, x.device))


def als_train_binned(
    rb, rtb, cfg: AlsConfig,
    test: Optional[tuple] = None,
    callback=None,
    init: Optional[AlsState] = None,
    *,
    mesh=None,
) -> tuple[AlsState, list[dict]]:
    """In-core training driver over binned layouts: the schedule of
    :func:`als_train` with both half-updates dispatched per bin.  ``rb`` /
    ``rtb`` are BinnedELLs of R (rows=users) and R^T (rows=items); their
    bins go to the card once, before the first iteration.  Spans (on the
    process's current tracer) and counters: the module docstring.

    With a ``launch.mesh.Mesh``, SU-ALS (paper Alg. 3) over its cells:
    ``rb`` / ``rtb`` are ``sparse.padded.BinnedShards`` with as many column
    shards as the mesh has column cells, uploaded to the cells once
    (``distributed.su_als.place_side``); each half is
    ``distributed.su_als.mesh_half``, whose reduction is two-level (Fig.
    5b) on a mesh with a pod axis and one-phase (Fig. 5a) without; the
    train RMSE sums the cells' partials
    (``su_als.rmse_shards``) and the test RMSE runs on the mesh's home
    device, where the returned state's factors lie.  The loop, the
    callback and the records are the one-card path's; the spans over
    several cards time every card (``obs/trace.py``)."""
    tracer = current_tracer()
    state = als_init(rb.m, rtb.m, cfg) if init is None else init
    train_args, cards, test_cards = {}, None, None
    if mesh is None:
        r_bins = _device_bins(rb, cfg.device)
        rt_bins = _device_bins(rtb, cfg.device)
        # the bins' ratings go to the halves only while tracing, so a stand-in
        # with _update_factor_bins' four positional arguments (the benchmark's
        # fault checks) still fits an untraced run
        r_kw = rt_kw = {}
        if tracer.enabled:
            r_kw, rt_kw = ({"nnz": _bin_nnz(rb, cfg.batch_rows)},
                           {"nnz": _bin_nnz(rtb, cfg.batch_rows)})
            train_args = {"nnz": rb.nnz}

        def update_x(theta):
            return _update_factor_bins(theta, r_bins, rb.m, cfg, **r_kw)

        def update_theta(x):
            return _update_factor_bins(x, rt_bins, rtb.m, cfg, **rt_kw)

        def train_rmse(x, theta):
            return _rmse_bins(x, theta, r_bins)

        def home(factor):
            return factor
        theta_f = state.theta
    else:
        from repro_torch.distributed import su_als
        r_side, rt_side = su_als.place_side(rb, mesh), su_als.place_side(rtb, mesh)
        kw = dict(f=cfg.f, batch_rows=cfg.batch_rows, mode=cfg.mode)
        r_kw, rt_kw = dict(kw), dict(kw)
        if tracer.enabled:
            r_kw["nnz"] = su_als.mesh_nnz(r_side, cfg.batch_rows)
            rt_kw["nnz"] = su_als.mesh_nnz(rt_side, cfg.batch_rows)
            train_args = {"nnz": rb.nnz}
        cards, test_cards = mesh.distinct_devices, [mesh.home]

        def update_x(theta):
            return su_als.mesh_half(theta, r_side, mesh, cfg.lam, **r_kw)

        def update_theta(x):
            return su_als.mesh_half(x, rt_side, mesh, cfg.lam, **rt_kw)

        def train_rmse(x, theta):
            return su_als.rmse_shards(x, theta, r_side, mesh, mode=cfg.mode)

        def home(factor):
            return factor[mesh.home]
        theta_f = su_als.replicate(state.theta, mesh)
    history: list[dict] = []
    for it in range(cfg.iters):
        tracer.anchor(cards)
        with tracer.step_span("als.iteration", cat="iteration",
                              iteration=state.iteration + 1):
            with tracer.span_on(cards, "als.half", cat="half", side="x"):
                x_f = update_x(theta_f)
            with tracer.span_on(cards, "als.half", cat="half", side="theta"):
                theta_f = update_theta(x_f)
            state = AlsState(x=home(x_f), theta=home(theta_f), iteration=state.iteration + 1)
            rec = {"iteration": it + 1}
            with tracer.span_on(cards, "als.evaluate", cat="objective"):
                if test is not None:
                    with tracer.span_on(test_cards, "als.rmse_test", cat="objective"):
                        rec["test_rmse"] = float(
                            rmse_padded(state.x, state.theta, test[0], test[1], test[2]))
                        _SYNCS.inc()
                with tracer.span_on(cards, "als.rmse_train", cat="objective", **train_args):
                    rec["train_rmse"] = train_rmse(x_f, theta_f)
        history.append(rec)
        if callback is not None:
            callback(state, rec)
    return state, history
