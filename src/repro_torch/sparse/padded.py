"""Padded-ELL sparse layout, host side (numpy).

The port's own copy of the reference's ``repro/sparse/padded.py`` layout
code; the arrays it builds are bit-equal to the reference's.  A sparse
rating matrix R (m x n, Nz nonzeros) is stored as three dense arrays::

    idx  [m, K] int32   column index of each nonzero, rows padded to K
    val  [m, K] float32 rating value, 0 in padding slots
    cnt  [m]    int32   true nnz per row (n_{x_u} of the paper, used by the
                        weighted-lambda regularizer)

Padding slots carry ``idx = 0`` and ``val = 0`` and lie at positions
>= cnt, which the kernels never read.  :class:`BinnedELL` groups rows
into ~log-spaced degree bins (cuMF's degree binning) so each bin pads to
its own, much tighter K.  Because padding slots are exact zeros,
re-padding a row at any K >= its degree changes no f32 sum: binned and
unbinned layouts are numerically identical.

:func:`bin_rows` and :func:`pad_csr_fast` run in ``layout.*`` spans of the
current tracer (host clock: the work is synchronous numpy), one per call
and one per bin fill.

:class:`BinnedShards` is the mesh's layout (SU-ALS, paper eq. 5-7): the
rows binned by their global degree exactly as :func:`bin_rows` bins them,
each bin's columns split into p contiguous shards, and each shard of each
bin padded to its own largest local degree.  :func:`bin_col_shards`
builds it in torch, on any device, from the CSR, in a
``layout.col_shards`` span.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.obs.trace import current_tracer


@dataclasses.dataclass
class PaddedELL:
    """Dense-padded sparse matrix, row-major semantics R[u, idx[u, k]] = val[u, k]."""

    idx: np.ndarray  # [m, K] int32
    val: np.ndarray  # [m, K] float32
    cnt: np.ndarray  # [m]    int32
    n_cols: int      # n — number of columns of the logical matrix

    @property
    def m(self) -> int:
        return self.idx.shape[0]

    @property
    def K(self) -> int:
        return self.idx.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.cnt.sum())

    @property
    def fill(self) -> float:
        """Stored slots / true nonzeros (>= 1)."""
        nnz = self.nnz
        return float(self.padded_slots) / max(nnz, 1)

    @property
    def padded_slots(self) -> int:
        """Stored slots (real + padding): the numerator of ``fill``."""
        return int(self.idx.shape[0]) * int(self.K) if self.idx.ndim == 2 \
            else int(np.prod(self.idx.shape[:-1])) * int(self.K)

    def mask(self) -> np.ndarray:
        """[m, K] float32 1.0 where a slot holds a real nonzero."""
        k = np.arange(self.K, dtype=np.int32)[None, :]
        return (k < self.cnt[:, None]).astype(np.float32)

    def transpose_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (rows, cols, vals) of R^T — used to build the update-Theta side."""
        k = np.arange(self.K, dtype=np.int32)[None, :]
        live = k < self.cnt[:, None]
        rows = np.broadcast_to(np.arange(self.m, dtype=np.int64)[:, None], self.idx.shape)[live]
        cols = self.idx[live].astype(np.int64)
        vals = self.val[live]
        return cols, rows, vals  # transposed: col becomes row


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 m: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort COO by row; return (row_ptr, cols, vals) CSR triplet."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    cnt = np.bincount(rows, minlength=m).astype(np.int64)
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(cnt, out=ptr[1:])
    return ptr, cols.astype(np.int32), vals.astype(np.float32)


def pad_csr(ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
            n_cols: int, k_multiple: int = 8, k_cap: int | None = None) -> PaddedELL:
    """CSR -> PaddedELL, reference implementation (python row loop).

    K = max row degree rounded up to ``k_multiple``.  ``k_cap`` optionally
    truncates pathological rows (keeps the first k_cap ratings).  This is
    the oracle :func:`pad_csr_fast` is tested against.
    """
    m = ptr.shape[0] - 1
    cnt = (ptr[1:] - ptr[:-1]).astype(np.int32)
    if k_cap is not None:
        cnt = np.minimum(cnt, np.int32(k_cap))
    kmax = int(cnt.max()) if m else 0
    K = max(k_multiple, -(-kmax // k_multiple) * k_multiple)
    idx = np.zeros((m, K), dtype=np.int32)
    val = np.zeros((m, K), dtype=np.float32)
    for u in range(m):  # host-side, one-time preprocessing
        c = int(cnt[u])
        lo = int(ptr[u])
        idx[u, :c] = cols[lo:lo + c]
        val[u, :c] = vals[lo:lo + c]
    return PaddedELL(idx=idx, val=val, cnt=cnt, n_cols=n_cols)


def pad_csr_fast(ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_cols: int, k_multiple: int = 8,
                 k_cap: int | None = None) -> PaddedELL:
    """Vectorized :func:`pad_csr` (no python loop) for large matrices;
    bit-identical to it on every input, ``k_cap`` truncation included."""
    m = ptr.shape[0] - 1
    with current_tracer().span("layout.pad_csr", cat="layout", rows=m, nnz=len(cols)):
        full = (ptr[1:] - ptr[:-1]).astype(np.int32)
        cnt = np.minimum(full, np.int32(k_cap)) if k_cap is not None else full
        kmax = int(cnt.max()) if m else 0
        K = max(k_multiple, -(-kmax // k_multiple) * k_multiple)
        # position of each nonzero within its row
        pos = np.arange(len(cols), dtype=np.int64) - np.repeat(ptr[:-1], full)
        rows = np.repeat(np.arange(m, dtype=np.int64), full)
        if k_cap is not None:
            keep = pos < cnt[rows]         # drop each row's truncated tail
            pos, rows = pos[keep], rows[keep]
            cols, vals = cols[keep], vals[keep]
        idx = np.zeros((m, K), dtype=np.int32)
        val = np.zeros((m, K), dtype=np.float32)
        idx[rows, pos] = cols
        val[rows, pos] = vals
    return PaddedELL(idx=idx, val=val, cnt=cnt, n_cols=n_cols)


def row_slice(ell: PaddedELL, start: int, stop: int,
              copy: bool = True) -> PaddedELL:
    """Host-side contiguous row slice ``ell[start:stop]`` with K and
    ``n_cols`` preserved.  The slice owns its memory (``.copy()``), so it
    never aliases the parent; ``copy=False`` returns views of the parent
    (contiguous: a row slice of a C-order array), for a caller whose
    transfer is the copy."""
    if not 0 <= start <= stop <= ell.m:
        raise ValueError(f"row slice [{start}, {stop}) outside [0, {ell.m})")
    take = (lambda a: a[start:stop].copy()) if copy else (lambda a: a[start:stop])
    return PaddedELL(idx=take(ell.idx), val=take(ell.val), cnt=take(ell.cnt),
                     n_cols=ell.n_cols)


def pad_rows(ell: PaddedELL, m_to: int) -> PaddedELL:
    """Append empty rows (cnt = 0, all slots masked) up to ``m_to`` rows;
    padded rows contribute nothing and solve to x_u = 0 under the
    empty-row diagonal fallback."""
    if m_to < ell.m:
        raise ValueError(f"cannot pad {ell.m} rows down to {m_to}")
    extra = m_to - ell.m
    if extra == 0:
        return ell
    return PaddedELL(
        idx=np.pad(ell.idx, ((0, extra), (0, 0))),
        val=np.pad(ell.val, ((0, extra), (0, 0))),
        cnt=np.pad(ell.cnt, (0, extra)),
        n_cols=ell.n_cols,
    )


def partition_padded(ell: PaddedELL, p: int, k_multiple: int = 8) -> PaddedELL:
    """Column-partition a PaddedELL into ``p`` shards (paper eq. 5-7).

    Returns a PaddedELL whose arrays carry a leading shard axis:
        idx [p, m, K_loc], val [p, m, K_loc], cnt [p, m]
    Shard i holds the nonzeros with column in [i*n/p, (i+1)*n/p), in the
    order the row holds them, with the column re-based to the shard.
    """
    if ell.n_cols % p:
        raise ValueError(f"n={ell.n_cols} not divisible by p={p}")
    npp = ell.n_cols // p
    m = ell.m
    live = ell.mask().astype(bool)
    shard_of = ell.idx // npp          # [m, K] which shard owns each nonzero
    local_col = ell.idx % npp
    cnt_p = np.zeros((p, m), dtype=np.int32)
    for i in range(p):
        cnt_p[i] = ((shard_of == i) & live).sum(axis=1)
    kmax = int(cnt_p.max()) if m else 0
    K_loc = max(k_multiple, -(-kmax // k_multiple) * k_multiple)
    idx_p = np.zeros((p, m, K_loc), dtype=np.int32)
    val_p = np.zeros((p, m, K_loc), dtype=np.float32)
    for i in range(p):
        sel = (shard_of == i) & live                       # [m, K]
        pos = np.cumsum(sel, axis=1) - 1                   # slot within shard row
        uu, kk = np.nonzero(sel)
        idx_p[i, uu, pos[uu, kk]] = local_col[uu, kk]
        val_p[i, uu, pos[uu, kk]] = ell.val[uu, kk]
    return PaddedELL(idx=idx_p, val=val_p, cnt=cnt_p, n_cols=npp)


def row_partition(ell: PaddedELL, q: int) -> PaddedELL:
    """Row-partition into ``q`` shards: arrays get a leading q axis (views,
    no copy); rows must divide evenly (pad rows upstream)."""
    if ell.m % q:
        raise ValueError(f"m={ell.m} not divisible by q={q}")
    mq = ell.m // q
    return PaddedELL(
        idx=ell.idx.reshape(q, mq, ell.K),
        val=ell.val.reshape(q, mq, ell.K),
        cnt=ell.cnt.reshape(q, mq),
        n_cols=ell.n_cols,
    )


# ---------------------------------------------------------------------------
# Degree-binned layout (cuMF §4.1 / Tan 1808.03843 memory-optimized batching)
# ---------------------------------------------------------------------------

def round_k(k: int, k_multiple: int = 8) -> int:
    """Round a degree up to the lane multiple (min one lane)."""
    return max(k_multiple, -(-int(k) // k_multiple) * k_multiple)


def bin_caps(kmax: int, n_bins: int, k_multiple: int = 8) -> list[int]:
    """Ascending ~log-spaced per-bin degree caps ending at ``kmax`` rounded.

    Log spacing bounds each row's overshoot (K_bin / degree) by a constant
    factor whatever the skew.  Duplicate rungs collapse, so the result may
    hold fewer than ``n_bins`` caps on low-degree data.
    """
    top = round_k(kmax, k_multiple)
    if n_bins <= 1 or top <= k_multiple:
        return [top]
    grid = np.exp(np.linspace(np.log(k_multiple), np.log(top), n_bins))
    # clamp each rung to top: exp(log(top)) can land epsilon above top and
    # ceil would then mint a phantom rung one lane past the real maximum
    return sorted({min(round_k(int(np.ceil(g)), k_multiple), top)
                   for g in grid})


@dataclasses.dataclass
class BinnedELL:
    """Rows of one logical sparse matrix, grouped into degree bins.

    ``bins[b]`` is a :class:`PaddedELL` holding the rows assigned to bin b,
    padded to that bin's own K.  ``rows[b]`` maps bin-local row u back to
    the original row index and is strictly ascending (stable grouping).
    Factors are always kept in ORIGINAL row order; solvers scatter per-bin
    results back through ``rows[b]``.
    """

    bins: Tuple[PaddedELL, ...]
    rows: Tuple[np.ndarray, ...]   # per-bin original row indices, ascending
    n_cols: int
    m: int                         # original (unbinned) row count

    @property
    def n_bins(self) -> int:
        return len(self.bins)

    @property
    def K_list(self) -> Tuple[int, ...]:
        return tuple(b.K for b in self.bins)

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.bins)

    @property
    def padded_slots(self) -> int:
        return sum(b.padded_slots for b in self.bins)

    @property
    def fill(self) -> float:
        """Stored slots / true nonzeros, summed over bins."""
        return float(self.padded_slots) / max(self.nnz, 1)

    @property
    def perm(self) -> np.ndarray:
        return np.concatenate([r for r in self.rows]) if self.rows \
            else np.zeros(0, dtype=np.int64)

    @property
    def inv_perm(self) -> np.ndarray:
        inv = np.empty(self.m, dtype=np.int64)
        inv[self.perm] = np.arange(self.m, dtype=np.int64)
        return inv

    def bin_spans(self, start: int, stop: int) -> list[Tuple[int, int]]:
        """Per-bin contiguous (lo, hi) bin-local spans covering original
        rows ``[start, stop)`` — exact because each ``rows[b]`` ascends."""
        return [(int(np.searchsorted(r, start)), int(np.searchsorted(r, stop)))
                for r in self.rows]

    def row_slice(self, start: int, stop: int,
                  copy: bool = True) -> "BinnedELL":
        """Bin-wise cut of original rows ``[start, stop)``, rebased to the
        slice (empty bins are kept); ``copy=False`` as in :func:`row_slice`
        (the rebased row maps are new arrays either way)."""
        spans = self.bin_spans(start, stop)
        return BinnedELL(
            bins=tuple(row_slice(b, lo, hi, copy=copy)
                       for b, (lo, hi) in zip(self.bins, spans)),
            rows=tuple((r[lo:hi] - start).astype(np.int64)
                       for r, (lo, hi) in zip(self.rows, spans)),
            n_cols=self.n_cols, m=stop - start)

    def to_padded(self) -> PaddedELL:
        """Reassemble one uniform-K PaddedELL in original row order
        (K = max over bins; re-padding adds only zero slots)."""
        K = max(self.K_list) if self.bins else 8
        idx = np.zeros((self.m, K), dtype=np.int32)
        val = np.zeros((self.m, K), dtype=np.float32)
        cnt = np.zeros(self.m, dtype=np.int32)
        for b, r in zip(self.bins, self.rows):
            idx[r, :b.K] = b.idx
            val[r, :b.K] = b.val
            cnt[r] = b.cnt
        return PaddedELL(idx=idx, val=val, cnt=cnt, n_cols=self.n_cols)


def bin_rows(ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             n_cols: int, n_bins: int = 1, k_multiple: int = 8) -> BinnedELL:
    """CSR -> :class:`BinnedELL`: stable-group rows into ~log-spaced degree
    bins, each padded by :func:`pad_csr_fast` at its own tight K.

    ``n_bins=1`` gives one bin equal to ``pad_csr_fast(ptr, cols, vals,
    n_cols)``.  Empty bins are dropped; at least one bin always remains.
    """
    m = ptr.shape[0] - 1
    tracer = current_tracer()
    with tracer.span("layout.bin_rows", cat="layout", rows=m, nnz=len(cols), n_bins=n_bins):
        cnt = (ptr[1:] - ptr[:-1]).astype(np.int64)
        kmax = int(cnt.max()) if m else 0
        caps = bin_caps(kmax, n_bins, k_multiple)
        # row -> first cap covering its rounded degree (cnt=0 rows -> bin 0)
        assign = np.searchsorted(np.asarray(caps, dtype=np.int64),
                                 np.maximum(cnt, 1), side="left")
        bins: list[PaddedELL] = []
        rows: list[np.ndarray] = []
        for b in range(len(caps)):
            rb = np.nonzero(assign == b)[0].astype(np.int64)
            if rb.size == 0:
                continue
            cnt_b = cnt[rb]
            nnz_b = int(cnt_b.sum())
            with tracer.span("layout.bin", cat="layout", bin=len(bins), rows=rb.size,
                             K=round_k(int(cnt_b.max()), k_multiple) if tracer.enabled else None,
                             nnz=nnz_b):
                # gather this bin's CSR entries (rows keep original relative order)
                off = np.cumsum(cnt_b) - cnt_b
                take = np.repeat(ptr[:-1][rb] - off, cnt_b) \
                    + np.arange(nnz_b, dtype=np.int64)
                ptr_b = np.zeros(rb.size + 1, dtype=np.int64)
                np.cumsum(cnt_b, out=ptr_b[1:])
                bins.append(pad_csr_fast(ptr_b, cols[take], vals[take], n_cols,
                                         k_multiple=k_multiple))
            rows.append(rb)
        if not bins:       # m == 0: keep one (empty) bin so consumers never
            bins.append(pad_csr_fast(ptr, cols, vals, n_cols,   # see zero bins
                                     k_multiple=k_multiple))
            rows.append(np.zeros(0, dtype=np.int64))
    return BinnedELL(bins=tuple(bins), rows=tuple(rows),
                     n_cols=n_cols, m=m)


def bin_padded(ell: PaddedELL, n_bins: int,
               k_multiple: int = 8,
               caps: "list[int] | None" = None) -> BinnedELL:
    """Re-bin an existing PaddedELL without a round trip through COO: rows
    are grouped by ``cnt`` and each bin is re-padded at its own tight K by
    dropping all-padding columns.  ``caps`` overrides the ~log-spaced
    ladder with explicit ascending degree caps."""
    cnt = ell.cnt.astype(np.int64)
    kmax = int(cnt.max()) if ell.m else 0
    if caps is None:
        caps = bin_caps(kmax, n_bins, k_multiple)
    else:
        caps = sorted(int(c) for c in caps)
        if not caps or caps[-1] < kmax:
            raise ValueError(f"caps {caps} do not cover max degree {kmax}")
    assign = np.searchsorted(np.asarray(caps, dtype=np.int64),
                             np.maximum(cnt, 1), side="left")
    bins: list[PaddedELL] = []
    rows: list[np.ndarray] = []
    for b in range(len(caps)):
        rb = np.nonzero(assign == b)[0].astype(np.int64)
        if rb.size == 0:
            continue
        kb = min(round_k(int(cnt[rb].max()), k_multiple), ell.K)
        bins.append(PaddedELL(idx=ell.idx[rb, :kb].copy(),
                              val=ell.val[rb, :kb].copy(),
                              cnt=ell.cnt[rb].copy(), n_cols=ell.n_cols))
        rows.append(rb)
    if not bins:       # m == 0
        bins.append(PaddedELL(idx=ell.idx.copy(), val=ell.val.copy(),
                              cnt=ell.cnt.copy(), n_cols=ell.n_cols))
        rows.append(np.zeros(0, dtype=np.int64))
    return BinnedELL(bins=tuple(bins), rows=tuple(rows),
                     n_cols=ell.n_cols, m=ell.m)


# ---------------------------------------------------------------------------
# Batch-uniform stacked bins (mesh streaming's accumulate-Theta half)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BinShardStack:
    """One degree bin of a q-partitioned matrix, stacked batch-uniform.

    Mesh streaming feeds the accumulate-Theta half one ``[n_data, rows, K]``
    stack per wave (``distributed.su_als.make_wave_herm_fn`` shards the row
    dim over the model axis), which requires every batch's bin to present
    the same shape.  The caps are therefore chosen globally across all q
    batches while per-batch membership stays free: batch ``j``'s members
    occupy the leading ``cnt[j] > 0`` rows and the tail is padding rows
    (``cnt = 0``, exact-zero partials under the weighted-lambda Hermitian
    with ``diag_fallback=False``).

    ``items[j, u]`` is the global row (item) id stored at stacked slot
    ``(j, u)`` — the host-side scatter coordinate of the per-bin partials;
    padding slots carry item 0 with all-zero contributions.  ``rows`` is
    always a multiple of the model-axis size the stack was built for.
    """

    idx: np.ndarray    # [q, rows, K] int32, batch-local columns
    val: np.ndarray    # [q, rows, K] float32
    cnt: np.ndarray    # [q, rows]    int32 (0 on padding rows)
    items: np.ndarray  # [q, rows]    int64 global row ids (0 on padding)
    cap: int           # assignment cap of this bin (degree ladder rung)

    @property
    def q(self) -> int:
        return self.idx.shape[0]

    @property
    def rows(self) -> int:
        return self.idx.shape[1]

    @property
    def K(self) -> int:
        return self.idx.shape[2]

    @property
    def nnz(self) -> int:
        return int(self.cnt.sum())

    @property
    def padded_slots(self) -> int:
        return int(self.q) * int(self.rows) * int(self.K)

    @property
    def nbytes(self) -> int:
        """Streamed bytes across all q batches (idx + val + cnt; ``items``
        is host-side scatter bookkeeping, never transferred)."""
        return int(self.idx.nbytes + self.val.nbytes + self.cnt.nbytes)


def _stack_bins(cnt: np.ndarray, K_loc: int, fill_rows, n_bins: int,
                k_multiple: int, p: int, caps) -> Tuple[BinShardStack, ...]:
    """The stacks of :func:`stack_binned_parts` from the per-batch row
    counts ``cnt [q, n]`` and the uniform width ``K_loc``;
    ``fill_rows(j, members, kb, idx_out, val_out)`` writes batch ``j``'s
    member rows, cut to ``kb`` slots, into ``idx_out``/``val_out``."""
    q, n = cnt.shape
    cnt = cnt.astype(np.int64)
    kmax = int(cnt.max()) if n else 0
    if caps is None:
        caps = bin_caps(kmax, n_bins, k_multiple)
    else:
        caps = sorted(int(c) for c in caps)
        if not caps or caps[-1] < kmax:
            raise ValueError(f"caps {caps} do not cover max degree {kmax}")
    assign = np.searchsorted(np.asarray(caps, dtype=np.int64),
                             np.maximum(cnt, 1), side="left")   # [q, n]
    stacks: list[BinShardStack] = []
    for b, cap in enumerate(caps):
        members = [np.nonzero(assign[j] == b)[0].astype(np.int64)
                   for j in range(q)]
        max_members = max((int(mb.size) for mb in members), default=0)
        if max_members == 0:
            continue
        kb = min(round_k(int(max(int(cnt[j][mb].max()) if mb.size else 0
                                 for j, mb in enumerate(members))),
                         k_multiple), K_loc)
        rows_b = -(-max_members // p) * p
        idx = np.zeros((q, rows_b, kb), dtype=np.int32)
        val = np.zeros((q, rows_b, kb), dtype=np.float32)
        cnt_b = np.zeros((q, rows_b), dtype=np.int32)
        items = np.zeros((q, rows_b), dtype=np.int64)
        for j, mb in enumerate(members):
            fill_rows(j, mb, kb, idx[j, :mb.size], val[j, :mb.size])
            cnt_b[j, :mb.size] = cnt[j, mb]
            items[j, :mb.size] = mb
        stacks.append(BinShardStack(idx=idx, val=val, cnt=cnt_b,
                                    items=items, cap=int(cap)))
    if not stacks:       # n == 0: one all-padding stack keeps shapes legal
        stacks.append(BinShardStack(
            idx=np.zeros((q, p, k_multiple), np.int32),
            val=np.zeros((q, p, k_multiple), np.float32),
            cnt=np.zeros((q, p), np.int32),
            items=np.zeros((q, p), np.int64), cap=k_multiple))
    return tuple(stacks)


def stack_binned_parts(parts: PaddedELL, n_bins: int,
                       k_multiple: int = 8, p: int = 1,
                       caps: "list[int] | None" = None
                       ) -> Tuple[BinShardStack, ...]:
    """Batch-uniform degree binning of a ``partition_padded`` output.

    ``parts`` carries a leading batch axis (idx ``[q, n, K_loc]``); bin caps
    come from the global max batch-local degree so all q batches share one
    cap ladder, then each bin is stacked ``[q, rows_b, K_b]`` with
    ``rows_b`` the max per-batch member count rounded up to a multiple of
    ``p`` (the model-axis row sharding) and ``K_b`` the tight rounded max
    member degree (never above the parent K, so the column cut drops only
    all-padding slots).  Bins empty in every batch are dropped.
    """
    if parts.idx.ndim != 3:
        raise ValueError(f"parts need a leading batch axis, got {parts.idx.shape}")

    def fill(j, mb, kb, idx_out, val_out):
        idx_out[:] = parts.idx[j, mb, :kb]
        val_out[:] = parts.val[j, mb, :kb]

    return _stack_bins(parts.cnt, parts.idx.shape[2], fill, n_bins,
                       k_multiple, p, caps)


def stack_binned_csr(csrs, K_loc: int, n_bins: int, k_multiple: int = 8,
                     p: int = 1, caps: "list[int] | None" = None
                     ) -> Tuple[BinShardStack, ...]:
    """:func:`stack_binned_parts` of the q batches given as CSR
    ``(ptr, cols, vals)`` triples (rows' entries in the order the uniform
    stack holds them) and that stack's width ``K_loc``, without
    materializing the ``[q, n, K_loc]`` stack: equal arrays."""
    cnt = np.stack([np.diff(ptr) for ptr, _, _ in csrs]).astype(np.int32)

    def fill(j, mb, kb, idx_out, val_out):
        ptr, cols, vals = csrs[j]
        deg = (ptr[mb + 1] - ptr[mb]).astype(np.int64)
        off = np.cumsum(deg) - deg
        slot = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(off, deg)
        take = np.repeat(ptr[mb].astype(np.int64), deg) + slot
        row = np.repeat(np.arange(mb.size, dtype=np.int64), deg)
        idx_out[row, slot] = cols[take]
        val_out[row, slot] = vals[take]

    return _stack_bins(cnt, K_loc, fill, n_bins, k_multiple, p, caps)


# ---------------------------------------------------------------------------
# Degree-binned column shards (the mesh's layout: SU-ALS, paper eq. 5-7)
# ---------------------------------------------------------------------------

def shard_starts(n_cols: int, p: int) -> tuple[int, ...]:
    """The ``p + 1`` boundaries of ``p`` contiguous column shards of
    ``ceil(n_cols / p)`` columns each, the last one short."""
    if not 0 < p <= max(n_cols, 1):
        raise ValueError(f"{n_cols} columns do not split over {p} shards")
    width = -(-n_cols // p)
    return tuple(min(k * width, n_cols) for k in range(p + 1))


@dataclasses.dataclass
class BinnedShards:
    """Rows of one sparse matrix in degree bins, each bin's columns split
    into ``p`` contiguous shards.

    ``bins[b][k]`` is ``(idx, val, cnt)``: tensors ``[rows_b, K_bk]``
    int32, ``[rows_b, K_bk]`` float32 and ``[rows_b]`` int32 of shard k's
    ratings of bin b's rows, columns rebased to the shard (column
    ``starts[k] + idx``), in the order each row holds them, padded to the
    shard's own largest count in the bin; a row with no rating in the
    shard keeps its place with count 0.  ``rows[b]`` (int64, ascending)
    maps bin-local rows to the matrix's rows, as :class:`BinnedELL`'s.
    """

    bins: Tuple[Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...], ...]
    rows: Tuple[torch.Tensor, ...]
    starts: Tuple[int, ...]        # p + 1 column boundaries (shard_starts)
    n_cols: int
    m: int

    @property
    def p(self) -> int:
        return len(self.starts) - 1

    @property
    def K_table(self) -> Tuple[Tuple[int, ...], ...]:
        """``K_table[b][k]``: the padded width of shard k of bin b."""
        return tuple(tuple(int(s[0].shape[1]) for s in shards) for shards in self.bins)

    @property
    def nnz(self) -> int:
        return sum(int(s[2].sum()) for shards in self.bins for s in shards)

    def to(self, device) -> "BinnedShards":
        """The layout with every tensor on ``device``."""
        return BinnedShards(
            bins=tuple(tuple(tuple(t.to(device) for t in s) for s in shards)
                       for shards in self.bins),
            rows=tuple(r.to(device) for r in self.rows), starts=self.starts,
            n_cols=self.n_cols, m=self.m)


def bin_col_shards(ptr, cols, vals, n_cols: int, p: int, n_bins: int = 1,
                   k_multiple: int = 8, device=None) -> BinnedShards:
    """CSR (numpy arrays or tensors) -> :class:`BinnedShards` with ``p``
    column shards (:func:`shard_starts`), built on ``device`` (default:
    the CPU) with no loop over rows: rows binned by :func:`bin_rows`' rule
    (:func:`bin_caps` of the largest degree, a row to the first cap that
    covers its degree), the ratings grouped by (bin, shard) with one
    stable sort, and each group placed at its row's next slot.  Runs in a
    ``layout.col_shards`` span of the current tracer."""
    dev = torch.device("cpu" if device is None else device)
    starts = shard_starts(n_cols, p)
    width = max(starts[1] - starts[0], 1)
    ptr = torch.as_tensor(ptr).to(dev, torch.int64)
    m, nnz = ptr.shape[0] - 1, int(ptr[-1])
    tracer = current_tracer()
    with tracer.span("layout.col_shards", cat="layout", rows=m, nnz=nnz, p=p, n_bins=n_bins):
        cols = torch.as_tensor(cols).to(dev)
        vals = torch.as_tensor(vals).to(dev, torch.float32)
        cnt = ptr.diff()
        caps = bin_caps(int(cnt.max()) if m else 0, n_bins, k_multiple)
        assign = torch.searchsorted(torch.tensor(caps, dtype=torch.int64, device=dev),
                                    cnt.clamp(min=1))
        row_of = torch.repeat_interleave(torch.arange(m, device=dev), cnt, output_size=nnz)
        group = assign[row_of] * p + torch.div(cols, width, rounding_mode="floor").long()
        order = torch.sort(group, stable=True).indices
        ends = torch.bincount(group, minlength=len(caps) * p).cumsum(0).tolist()
        del group
        local = torch.zeros(m, dtype=torch.int64, device=dev)
        bins, rows = [], []
        for b in range(len(caps)):
            rb = torch.nonzero(assign == b).flatten()
            if rb.numel() == 0:
                continue
            local[rb] = torch.arange(rb.numel(), device=dev)
            shards = []
            for k in range(p):
                g = b * p + k
                take = order[(ends[g - 1] if g else 0):ends[g]]
                r = local[row_of[take]]
                cnt_bk = torch.bincount(r, minlength=rb.numel())
                K = round_k(int(cnt_bk.max()), k_multiple)
                pos = torch.arange(take.numel(), device=dev) - (cnt_bk.cumsum(0) - cnt_bk)[r]
                idx = torch.zeros((rb.numel(), K), dtype=torch.int32, device=dev)
                val = torch.zeros((rb.numel(), K), dtype=torch.float32, device=dev)
                idx[r, pos] = (cols[take] - starts[k]).to(torch.int32)
                val[r, pos] = vals[take]
                shards.append((idx, val, cnt_bk.to(torch.int32)))
            bins.append(tuple(shards))
            rows.append(rb)
        if not bins:       # m == 0: one empty bin, as bin_rows keeps
            empty = (torch.zeros((0, k_multiple), dtype=torch.int32, device=dev),
                     torch.zeros((0, k_multiple), dtype=torch.float32, device=dev),
                     torch.zeros(0, dtype=torch.int32, device=dev))
            bins.append(tuple(empty for _ in range(p)))
            rows.append(torch.zeros(0, dtype=torch.int64, device=dev))
    return BinnedShards(bins=tuple(bins), rows=tuple(rows), starts=starts,
                        n_cols=n_cols, m=m)
