"""Host-resident stores for out-of-core ALS (paper §4.4 "keep R and R^T"),
the port's copy of the reference's ``repro/outofcore/store.py``.

The rating matrix lives in host memory in *both* orientations, pre-cut into
the shapes the wave driver streams:

- ``RatingStore.r`` — R row-major (rows = users), sliced per wave with
  ``sparse.padded.row_slice`` for the solve-X half (views, not the
  reference's copies: the prefetcher stages them).
- the R^T column shards of the plan's q user-batches (batch-local user
  coordinates), for the accumulate-Theta half: ``rt_parts`` stacks them
  uniform-K exactly as the reference's ``partition_padded`` of the padded
  R^T does; ``rt_binned`` holds one degree-binned ``BinnedELL`` per batch.
- with ``p > 1`` (mesh streaming), R column-partitioned into the p theta
  shards (``r_model_parts``), which the solve-X waves are cut from, and,
  binned, the batch-uniform stacked bins of the theta half
  (``rt_stacked``, one ``sparse.padded.BinShardStack`` per bin: caps chosen
  globally over the q batches so every batch's bin has one shape the mesh
  can shard, per-batch membership carried by the ``items`` map).

Building them differs from the reference, not what they hold.  The
reference pads the whole R^T at the top item's degree and then partitions
it; at quarter-Netflix (top item 107,906 ratings) each of those two arrays
is ~14 GiB on the host, although a binned p = 1 run never streams them.
The port builds each batch's R^T straight from that batch's rows of R
(``_rt_csr``), keeps only the per-batch counts (``rt_cnt``) and the
uniform width (``rt_k``), bins or stacks each batch from its CSR, and
builds the uniform stack ``rt_parts`` only when first read.  Every array
and every fill, pricing and size property equals the reference's.

Factors live in ``FactorStore`` as plain numpy arrays; the driver reads
slices onto the device and writes solved slices back, so device memory
only ever holds the resident factor plus the streaming wave buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.sparse.padded import (BinnedELL, PaddedELL, bin_padded,
                                       bin_rows, csr_from_coo, pad_csr_fast,
                                       pad_rows, partition_padded, row_slice,
                                       stack_binned_csr)

Triplet = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _triplet(ell: PaddedELL) -> Triplet:
    # copy=False: the arrays are already int32/float32; a wave's slices
    # stay views of the store until the prefetcher stages them
    return (ell.idx.astype(np.int32, copy=False),
            ell.val.astype(np.float32, copy=False),
            ell.cnt.astype(np.int32, copy=False))


def triplet_nbytes(t: Triplet) -> int:
    return sum(int(a.nbytes) for a in t)


def binned_nbytes(binned: BinnedELL) -> int:
    """Streamed bytes of a BinnedELL's per-bin triplets (idx + val + cnt)."""
    return sum(int(b.idx.nbytes + b.val.nbytes + b.cnt.nbytes)
               for b in binned.bins)


def _host(a) -> np.ndarray:
    """numpy view of an array or a tensor (on any device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class FactorStore:
    """Host-resident X [m_pad, f] and Theta [n, f] with slice IO."""

    x: np.ndarray
    theta: np.ndarray

    @classmethod
    def from_arrays(cls, x, theta) -> "FactorStore":
        """Owned float32 copies of numpy arrays or tensors: the driver
        writes solved slices back in place."""
        return cls(x=np.array(_host(x), np.float32, order="C"),
                   theta=np.array(_host(theta), np.float32, order="C"))

    def factor(self, side: str) -> np.ndarray:
        if side not in ("x", "theta"):
            raise ValueError(f"side must be 'x' or 'theta', got {side!r}")
        return self.x if side == "x" else self.theta

    def read_slice(self, side: str, start: int, stop: int) -> np.ndarray:
        return np.ascontiguousarray(self.factor(side)[start:stop])

    def write_slice(self, side: str, start: int, stop: int, rows) -> None:
        arr = self.factor(side)
        rows = _host(rows)
        if stop - start != len(rows):
            raise ValueError(f"slice [{start}, {stop}) got {len(rows)} rows")
        arr[start:stop] = rows.astype(arr.dtype, copy=False)

    # -- model-shard IO (mesh streaming): shard k of p owns the contiguous
    # row range [k*rows/p, (k+1)*rows/p) of a factor; only the owning model
    # shard ever writes its range, so shard reads and writes never race.
    def shard_bounds(self, side: str, k: int, p: int) -> tuple[int, int]:
        rows = self.factor(side).shape[0]
        if rows % p:
            raise ValueError(f"{side} rows={rows} not divisible by p={p}")
        if not 0 <= k < p:
            raise IndexError(f"shard {k} outside [0, {p})")
        npp = rows // p
        return k * npp, (k + 1) * npp

    def read_shard(self, side: str, k: int, p: int) -> np.ndarray:
        return self.read_slice(side, *self.shard_bounds(side, k, p))

    def write_shard(self, side: str, k: int, p: int, rows) -> None:
        self.write_slice(side, *self.shard_bounds(side, k, p), rows)

    @property
    def nbytes(self) -> int:
        return int(self.x.nbytes + self.theta.nbytes)


class RatingStore:
    """R in both orientations, pre-cut for a q-batch wave schedule.

    ``q`` is the plan's number of X-row batches.  Rows are padded with empty
    rows to ``m_pad`` (the next multiple of q) so every batch has identical
    shape; padded rows carry cnt = 0 and solve to x_u = 0 without touching
    Theta.

    ``n_bins > 1`` additionally keeps degree-binned shards of both
    orientations (``r_binned``, one ``BinnedELL`` per R^T user-batch in
    ``rt_binned``); the driver then streams each wave bin-wise through
    ``x_slice_binned`` / ``theta_batch_binned``.  With ``p > 1`` the
    theta half is binned batch-uniform instead (``rt_stacked``) so the bins
    stream on a (data, model) mesh; the solve-X half stays on the uniform
    mesh layout (``x_slice_mesh_triplet``).

    ``n_bins="auto"`` resolves the bin count (and the bins'
    ``k_multiple``) through ``core.autotune.tune_als_layout`` — the argmin
    of predicted streamed bytes over the config ladder, cached in
    ``tune_cache`` (a ``core.autotune.TuneCache`` or a path) — and records
    the decision in ``self.tune`` for the driver's ledger run context.
    """

    def __init__(self, r: PaddedELL, q: int, k_multiple: int = 8, p: int = 1,
                 n_bins=1, tune_cache=None):
        self.tune = None
        if n_bins == "auto":
            from repro_torch.core import autotune

            res = autotune.tune_als_layout(r, q=q, p=p, k_multiple=k_multiple,
                                           cache=tune_cache)
            n_bins, k_multiple = res.config.n_bins, res.config.k_multiple
            self.tune = res.to_obj()
        if q < 1 or p < 1 or n_bins < 1:
            raise ValueError(f"need q, p, n_bins >= 1, got q={q} p={p} n_bins={n_bins}")
        if r.n_cols % p:
            raise ValueError(f"n={r.n_cols} not divisible by p={p}")
        self.m = r.m                       # true (unpadded) user count
        self.n = r.n_cols                  # item count
        self.q = q
        self.p = p
        self.n_bins = n_bins
        self.k_multiple = k_multiple
        self.m_pad = -(-r.m // q) * q
        self.r = pad_rows(r, self.m_pad)   # rows = users, global item idx
        # p > 1 (mesh streaming): R also column-partitioned into the p
        # theta shards (shard-local item coordinates), so solve-X waves cut
        # straight into the mesh layout — the real eq. 5-7 p axis
        self.r_model_parts = (partition_padded(self.r, p, k_multiple=k_multiple)
                              if p > 1 else None)
        # per-batch R^T counts [q, n] and, binned, each batch's bins from its
        # CSR (p = 1), or the CSRs the stacked bins are cut from (p > 1); the
        # uniform stack's K is the largest in-batch item degree rounded up
        # (partition_padded's K_loc)
        self.rt_cnt = np.zeros((q, self.n), np.int32)
        self.r_binned = None
        self.rt_binned = None
        self.rt_stacked = None
        rt_binned, csrs = [], []
        for j in range(q):
            ptr, users, vals = self._rt_csr(j)
            self.rt_cnt[j] = np.diff(ptr)
            if n_bins > 1 and p == 1:
                rt_binned.append(bin_rows(ptr, users, vals, self.m_pad // q,
                                          n_bins=n_bins, k_multiple=k_multiple))
            elif n_bins > 1:
                csrs.append((ptr, users, vals))
        kmax = int(self.rt_cnt.max()) if self.n else 0
        self.rt_k = max(k_multiple, -(-kmax // k_multiple) * k_multiple)
        self._rt_parts: Optional[PaddedELL] = None
        if n_bins > 1 and p == 1:
            self.r_binned = bin_padded(self.r, n_bins, k_multiple=k_multiple)
            self.rt_binned = tuple(rt_binned)
        elif n_bins > 1:
            self.rt_stacked = stack_binned_csr(csrs, self.rt_k, n_bins,
                                               k_multiple=k_multiple, p=p)

    def _rt_csr(self, j: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR (ptr, users, vals) of R^T restricted to user-batch ``j``,
        users batch-local and ascending within each item row — the order
        in which the reference's ``partition_padded`` of the padded R^T
        lays out shard ``j``."""
        mq = self.m_pad // self.q
        lo = j * mq
        view = PaddedELL(idx=self.r.idx[lo:lo + mq], val=self.r.val[lo:lo + mq],
                         cnt=self.r.cnt[lo:lo + mq], n_cols=self.n)
        items, users, vals = view.transpose_coo()
        return csr_from_coo(items, users, vals, self.n)

    def _rt_shard(self, j: int) -> PaddedELL:
        """R^T shard of user-batch ``j`` as a standalone PaddedELL view."""
        parts = self.rt_parts
        return PaddedELL(idx=parts.idx[j], val=parts.val[j], cnt=parts.cnt[j],
                         n_cols=self.m_pad // self.q)

    @property
    def rt_shape(self) -> Tuple[int, int, int]:
        """Shape ``(q, n, K_loc)`` of the uniform R^T stack ``rt_parts``."""
        return (self.q, self.n, self.rt_k)

    @property
    def rt_parts(self) -> PaddedELL:
        """R^T column-partitioned into the q user-batches, uniform K:
        idx/val ``[q, n, K_loc]``, cnt ``[q, n]`` — equal to the
        reference's ``partition_padded`` of the padded R^T.  Built on first
        read (the uniform store's theta half reads it)."""
        if self._rt_parts is None:
            q, n, K = self.rt_shape
            idx = np.zeros((q, n, K), np.int32)
            val = np.zeros((q, n, K), np.float32)
            for j in range(q):
                shard = pad_csr_fast(*self._rt_csr(j), n_cols=self.m_pad // q,
                                     k_multiple=self.k_multiple)
                idx[j, :, :shard.K] = shard.idx
                val[j, :, :shard.K] = shard.val
            self._rt_parts = PaddedELL(idx=idx, val=val, cnt=self.rt_cnt,
                                       n_cols=self.m_pad // q)
        return self._rt_parts

    @property
    def nnz(self) -> int:
        return self.r.nnz

    @property
    def fill_r(self) -> float:
        """Padding overhead of the row-major orientation (solve-X waves):
        per-bin padded slots over nnz when binned, uniform-K fill otherwise.
        """
        if self.r_binned is not None:
            return self.r_binned.fill
        return self.r.fill

    @property
    def fill_rt(self) -> float:
        """Padding overhead of the q-partitioned R^T shards: every item row
        pads to the largest in-batch item degree unless binned."""
        if self.rt_binned is not None:
            slots = sum(b.padded_slots for b in self.rt_binned)
            return float(slots) / max(self.nnz, 1)
        if self.rt_stacked is not None:
            slots = sum(st.padded_slots for st in self.rt_stacked)
            return float(slots) / max(self.nnz, 1)
        q, n, K_loc = self.rt_shape
        return float(q * n * K_loc) / max(self.nnz, 1)

    @property
    def fill_r_model(self) -> float:
        """Padding overhead of the p column-partitioned R (mesh solve-X
        waves): every user row pads to its largest in-shard degree."""
        if self.r_model_parts is None:
            return self.fill_r
        p, m, K_loc = self.r_model_parts.idx.shape
        return float(p * m * K_loc) / max(self.nnz, 1)

    @property
    def worst_fill(self) -> float:
        return max(self.fill_r, self.fill_rt, self.fill_r_model)

    def fill_breakdown(self) -> dict:
        """Per-component padding fills, keyed like the ledger records them
        (``worst_fill`` is their max)."""
        out = {"r": self.fill_r, "rt": self.fill_rt}
        if self.r_model_parts is not None:
            out["r_model"] = self.fill_r_model
        return out

    def bin_fill_pairs(self) -> list:
        """Per-bin ``(padded_slots, nnz)`` of the worst-fill orientation —
        the ``plan_for(bin_fills=...)`` pricing input.  Requires a binned
        store.  p = 1: their aggregate equals ``worst_fill``.  p > 1: the
        pairs price the batch-uniform theta-half stacks (the uniform
        solve-X side is priced by ``fill_r_model``)."""
        if self.rt_stacked is not None:
            return [(int(st.padded_slots), int(st.nnz)) for st in self.rt_stacked]
        if self.r_binned is None:
            raise ValueError("RatingStore was built with n_bins=1; pass n_bins "
                             "to price bins")
        if self.fill_r >= self.fill_rt:
            src = self.r_binned.bins
        else:
            src = [bb for b in self.rt_binned for bb in b.bins]
        return [(int(b.padded_slots), int(b.nnz)) for b in src]

    @property
    def host_nbytes(self) -> int:
        """Bytes of the reference store's host arrays (R, the uniform R^T
        stack, the model shards of R and the binned shards), whether or not
        the uniform stack is built."""
        q, n, K_loc = self.rt_shape
        total = int(self.r.idx.nbytes + self.r.val.nbytes + self.r.cnt.nbytes
                    + q * n * K_loc * (4 + 4) + self.rt_cnt.nbytes)
        if self.r_model_parts is not None:
            total += int(self.r_model_parts.idx.nbytes + self.r_model_parts.val.nbytes
                         + self.r_model_parts.cnt.nbytes)
        if self.rt_stacked is not None:
            total += sum(st.nbytes + st.items.nbytes for st in self.rt_stacked)
        if self.r_binned is not None:
            total += binned_nbytes(self.r_binned)
            total += sum(binned_nbytes(b) for b in self.rt_binned)
        return total

    def x_slice_triplet(self, row_start: int, row_stop: int) -> Triplet:
        """R rows for one solve-X wave slice (global item indices): host
        views of the store's arrays (the reference copies them; here the
        prefetcher's pinned staging is the one copy)."""
        return _triplet(row_slice(self.r, row_start, row_stop, copy=False))

    def x_slice_binned(self, row_start: int, row_stop: int) -> BinnedELL:
        """R rows for one solve-X wave slice, cut bin-wise (slice-local row
        indices, every bin kept, possibly empty), its bins host views of
        the store's arrays as in :meth:`x_slice_triplet`.  Requires a
        binned store."""
        if self.r_binned is None:
            raise ValueError("RatingStore was built with n_bins=1; pass n_bins "
                             "to bin waves")
        return self.r_binned.row_slice(row_start, row_stop, copy=False)

    def x_slice_mesh_triplet(self, row_start: int, row_stop: int) -> Triplet:
        """R rows for one solve-X wave slice in the ``shard_ratings`` mesh
        layout: idx/val ``[rows, p*K_loc]`` (shard-local item coordinates,
        the p column blocks side by side) and cnt ``[rows, p]``.  Requires
        a ``p > 1`` store."""
        if self.r_model_parts is None:
            raise ValueError("RatingStore was built with p=1; pass p to stream "
                             "on a mesh")
        parts = self.r_model_parts
        p, _, K_loc = parts.idx.shape
        rows = row_stop - row_start
        idx = np.ascontiguousarray(
            np.transpose(parts.idx[:, row_start:row_stop], (1, 0, 2))).reshape(rows, p * K_loc)
        val = np.ascontiguousarray(
            np.transpose(parts.val[:, row_start:row_stop], (1, 0, 2))).reshape(rows, p * K_loc)
        cnt = np.ascontiguousarray(np.transpose(parts.cnt[:, row_start:row_stop], (1, 0)))
        return idx, val, cnt

    def theta_batch_triplet(self, j: int) -> Triplet:
        """R^T shard of user-batch ``j`` (batch-local user indices): host
        views into the uniform stack."""
        if not 0 <= j < self.q:
            raise IndexError(f"batch {j} outside [0, {self.q})")
        parts = self.rt_parts
        return (parts.idx[j], parts.val[j], parts.cnt[j])

    def theta_batch_binned(self, j: int) -> BinnedELL:
        """Degree-binned R^T shard of user-batch ``j`` (batch-local user
        indices, item rows grouped by in-batch degree).  Requires a binned
        store."""
        if self.rt_binned is None:
            raise ValueError("RatingStore was built with n_bins=1; pass n_bins "
                             "to bin shards")
        if not 0 <= j < self.q:
            raise IndexError(f"batch {j} outside [0, {self.q})")
        return self.rt_binned[j]

    def theta_wave_stacked(self, batch_indices) -> list:
        """Per-bin stacked theta-half payloads of one mesh wave: for each
        bin, (idx ``[nbatch, rows_b, K_b]``, val, cnt ``[nbatch, rows_b]``,
        items ``[nbatch, rows_b]``) cut to the wave's batches (``items``
        stays on the host: it is the scatter map of the per-bin partials).
        Requires a store built with ``p > 1`` and ``n_bins > 1``."""
        if self.rt_stacked is None:
            raise ValueError("RatingStore was built without stacked bins; pass "
                             "p > 1 and n_bins > 1 to stream binned waves on a mesh")
        js = np.asarray(list(batch_indices), dtype=np.int64)
        if not js.size or js.min() < 0 or js.max() >= self.q:
            raise IndexError(f"batches {js.tolist()} outside [0, {self.q})")
        return [(st.idx[js], st.val[js], st.cnt[js], st.items[js])
                for st in self.rt_stacked]


class TileStore:
    """Host-resident g x g ``BlockGrid`` tiles for a streaming SGD driver:
    a thin per-tile view layer over the grid's stacked arrays, the SGD
    counterpart of ``RatingStore``'s wave slicing.  Factor blocks live in a
    ``FactorStore`` whose X is ``[g*mb, f]`` and Theta is ``[g*nb, f]``."""

    def __init__(self, grid):
        self.grid = grid

    @property
    def g(self) -> int:
        return self.grid.g

    @property
    def mb(self) -> int:
        return self.grid.mb

    @property
    def nb(self) -> int:
        return self.grid.nb

    @property
    def K(self) -> int:
        return self.grid.K

    @property
    def m(self) -> int:
        return self.grid.m

    @property
    def n(self) -> int:
        return self.grid.n

    @property
    def nnz(self) -> int:
        return self.grid.nnz

    @property
    def host_nbytes(self) -> int:
        return int(self.grid.idx.nbytes + self.grid.val.nbytes
                   + self.grid.cnt.nbytes)

    def tile_k(self, i: int, j: int) -> int:
        return self.grid.tile_k(i, j)

    def tile_triplet(self, i: int, j: int) -> Triplet:
        """Tile (i, j)'s (idx, val, cnt) as host views (no copy); on a
        per-tile-K grid the slot axis is cut to the tile's own K (the
        trailing columns are all padding)."""
        if not (0 <= i < self.g and 0 <= j < self.g):
            raise IndexError(f"tile ({i}, {j}) outside the {self.g}x{self.g} grid")
        k = self.grid.tile_k(i, j)
        return (self.grid.idx[i, j, :, :k].astype(np.int32, copy=False),
                self.grid.val[i, j, :, :k].astype(np.float32, copy=False),
                self.grid.cnt[i, j].astype(np.int32, copy=False))
