"""CuMF_SGD matrix blocking: g x g rating grid + conflict-free schedule.

The port's own copy of the reference's ``repro/sgd/blocking.py`` (host
numpy; the arrays it builds are bit-equal to the reference's).  The rating
COO is partitioned into a g x g grid of (user-block, item-block) tiles.
Two tiles conflict iff they share a user block (both update the same X
rows) or an item block (same Theta rows); CuMF_SGD's scheduler therefore
runs the grid as ``g`` *diagonal block-sets*

    set s = { (i, (i + s) mod g) : i = 0..g-1 },   s = 0..g-1

— within a set every user block and every item block appears exactly
once, so the g tile updates are mutually independent, and the union over
the g sets covers every tile exactly once per epoch.

Each tile is stored as a block-local PaddedELL slice, built through the
same ``csr_from_coo`` / ``pad_csr_fast`` path as the ALS side, with K
padded to the grid-wide maximum so every tile presents one shape.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.sparse.padded import PaddedELL, csr_from_coo, pad_csr_fast


def diagonal_sets(g: int) -> List[List[Tuple[int, int]]]:
    """The g conflict-free block-sets; set s holds tiles (i, (i+s) % g)."""
    return [[(i, (i + s) % g) for i in range(g)] for s in range(g)]


def ell_to_coo(ell: PaddedELL) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover (rows, cols, vals) of the logical matrix from a PaddedELL."""
    cols_t, rows_t, vals = ell.transpose_coo()   # (orig cols, orig rows, vals)
    return rows_t, cols_t, vals


@dataclasses.dataclass
class BlockGrid:
    """g x g grid of block-local PaddedELL tiles, uniform shape.

    ``idx[i, j]`` holds *item-block-local* column indices (< nb) of the
    nonzeros whose user falls in user-block i and item in item-block j;
    the row coordinate within the [mb, K] tile is the *user-block-local*
    user index.  ``m``/``n`` are the true matrix dims; ``g*mb >= m`` and
    ``g*nb >= n`` (factor rows in the padding range are never touched —
    every cnt there is 0).
    """

    idx: np.ndarray   # [g, g, mb, K] int32
    val: np.ndarray   # [g, g, mb, K] float32
    cnt: np.ndarray   # [g, g, mb]    int32
    g: int
    m: int
    n: int
    #: per-tile kernel K [g, g] int32, on the quantized ladder of
    #: ``tile_k_ladder``: tile (i, j) dispatches only its first
    #: tile_K[i,j] slot columns (the trailing columns are all-padding, so
    #: slicing them off is exact).  None = uniform grid-wide K.
    tile_K: np.ndarray | None = None
    #: degree-sort row permutation [m] int64: ``user_perm[k]`` = original
    #: user id stored at grid row k (heavy users first).  None = identity.
    #: Factors inside the grid live in PERMUTED row order; map back with
    #: ``user_inv`` before any global-coordinate evaluation.
    user_perm: np.ndarray | None = None
    #: the autotuner's decision (``core.autotune.TuneResult.to_obj()``)
    #: when the grid was built with ``per_tile_k="auto"``; the streaming
    #: SGD driver records it in the ledger's run context.  None otherwise.
    tune: dict | None = None

    @property
    def mb(self) -> int:
        return self.idx.shape[2]

    @property
    def nb(self) -> int:
        return -(-self.n // self.g)

    @property
    def K(self) -> int:
        return self.idx.shape[3]

    @property
    def nnz(self) -> int:
        return int(self.cnt.sum())

    @property
    def padded_slots(self) -> int:
        """Slots the kernels actually touch: per-tile K when binned."""
        if self.tile_K is None:
            return self.g * self.g * self.mb * self.K
        return int(self.mb * int(self.tile_K.sum()))

    @property
    def fill(self) -> float:
        """Dispatched slots / true nonzeros across the whole grid (>= 1)."""
        return float(self.padded_slots) / max(self.nnz, 1)

    def tile_k(self, i: int, j: int) -> int:
        return self.K if self.tile_K is None else int(self.tile_K[i, j])

    @property
    def user_inv(self) -> np.ndarray:
        """[m] int64: grid row holding each original user (inverse of
        ``user_perm``; identity when the grid is unsorted)."""
        if self.user_perm is None:
            return np.arange(self.m, dtype=np.int64)
        inv = np.empty(self.m, dtype=np.int64)
        inv[self.user_perm] = np.arange(self.m, dtype=np.int64)
        return inv

    def block(self, i: int, j: int) -> PaddedELL:
        """Tile (i, j) as a standalone block-local PaddedELL, sliced to the
        tile's own K when the grid is per-tile binned."""
        k = self.tile_k(i, j)
        return PaddedELL(idx=self.idx[i, j, :, :k], val=self.val[i, j, :, :k],
                         cnt=self.cnt[i, j], n_cols=self.nb)

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Reassemble the global-coordinate COO (round-trip check)."""
        rows, cols, vals = [], [], []
        for i in range(self.g):
            for j in range(self.g):
                r, c, v = ell_to_coo(self.block(i, j))
                rows.append(r + i * self.mb)
                cols.append(c + j * self.nb)
                vals.append(v)
        out_rows = np.concatenate(rows)
        if self.user_perm is not None:
            out_rows = self.user_perm[out_rows]
        return (out_rows, np.concatenate(cols), np.concatenate(vals))


def tile_k_ladder(k: int, k_multiple: int = 8) -> int:
    """Quantize a tile's K up to the ``k_multiple * 2^j`` ladder, so a
    grid dispatches at most O(log(Kmax/k_multiple)) distinct K per set."""
    rung = k_multiple
    while rung < k:
        rung *= 2
    return rung


def block_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              m: int, n: int, g: int, k_multiple: int = 8,
              per_tile_k: bool | str = False,
              degree_sort: bool = False, tune_cache=None) -> BlockGrid:
    """Partition a rating COO into a g x g BlockGrid.

    Block sizes are ``mb = ceil(m/g)`` users x ``nb = ceil(n/g)`` items;
    every tile is CSR-sorted and ELL-padded through the shared sparse
    stack, then K-padded to the grid maximum.  With ``per_tile_k`` the
    grid also records each tile's own ladder-quantized K (``tile_K``).
    ``degree_sort`` assigns users to blocks in descending degree order
    (recorded in ``user_perm``), so the heavy tail concentrates in the
    leading blocks and ``per_tile_k`` cuts the fill on power-law data.
    Sorting re-partitions the grid, so it changes the (still exact)
    Hogwild visit order.

    ``per_tile_k="auto"`` chooses both knobs (``per_tile_k`` and
    ``degree_sort``, which it overrides) through
    ``core.autotune.tune_sgd_layout`` — the argmin of dispatched padded
    slots over the blocking ladder, cached in ``tune_cache`` — and records
    the decision on ``grid.tune``.
    """
    assert g >= 1
    if per_tile_k == "auto":
        from repro_torch.core.autotune import tune_sgd_layout

        ptr, cc, vv = csr_from_coo(rows, cols, vals, m)
        ell = pad_csr_fast(ptr, cc, vv, n, k_multiple=k_multiple)
        res = tune_sgd_layout(ell, g, k_multiple=k_multiple, cache=tune_cache)
        grid = res.grid
        if grid is None:       # a cache hit carries the config only
            grid = block_coo(rows, cols, vals, m, n, g, k_multiple=k_multiple,
                             per_tile_k=res.config.per_tile_k,
                             degree_sort=res.config.degree_sort)
        grid.tune = res.to_obj()
        return grid
    user_perm = None
    if degree_sort:
        deg = np.bincount(rows, minlength=m)
        user_perm = np.argsort(-deg, kind="stable").astype(np.int64)
        inv = np.empty(m, dtype=np.int64)
        inv[user_perm] = np.arange(m, dtype=np.int64)
        rows = inv[rows]
    mb = -(-m // g)
    nb = -(-n // g)
    bi = rows // mb            # user block of each nonzero
    bj = cols // nb            # item block
    # one pass over the COO: stable-sort by flat block id, then slice
    order = np.argsort(bi * g + bj, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    per_block = np.bincount((bi * g + bj)[order], minlength=g * g)
    ends = np.cumsum(per_block)
    tiles: list[list[PaddedELL]] = []
    kmax = k_multiple
    for i in range(g):
        row_tiles = []
        for j in range(g):
            hi = int(ends[i * g + j])
            lo = hi - int(per_block[i * g + j])
            ptr, cc, vv = csr_from_coo(
                rows[lo:hi] - i * mb, cols[lo:hi] - j * nb, vals[lo:hi], mb)
            ell = pad_csr_fast(ptr, cc, vv, nb, k_multiple=k_multiple)
            kmax = max(kmax, ell.K)
            row_tiles.append(ell)
        tiles.append(row_tiles)
    idx = np.zeros((g, g, mb, kmax), dtype=np.int32)
    val = np.zeros((g, g, mb, kmax), dtype=np.float32)
    cnt = np.zeros((g, g, mb), dtype=np.int32)
    tile_K = np.zeros((g, g), dtype=np.int32) if per_tile_k else None
    for i in range(g):
        for j in range(g):
            e = tiles[i][j]
            idx[i, j, :, :e.K] = e.idx
            val[i, j, :, :e.K] = e.val
            cnt[i, j] = e.cnt
            if tile_K is not None:
                tile_K[i, j] = min(tile_k_ladder(e.K, k_multiple), kmax)
    return BlockGrid(idx=idx, val=val, cnt=cnt, g=g, m=m, n=n,
                     tile_K=tile_K, user_perm=user_perm)


def block_ell(ell: PaddedELL, g: int, k_multiple: int = 8,
              per_tile_k: bool | str = False,
              degree_sort: bool = False, tune_cache=None) -> BlockGrid:
    """Blocked view of an existing row-major PaddedELL (the ALS layout) —
    the shard-sharing entry point the hybrid driver uses.  Accepts
    ``per_tile_k="auto"`` like :func:`block_coo`."""
    rows, cols, vals = ell_to_coo(ell)
    return block_coo(rows, cols, vals, ell.m, ell.n_cols, g,
                     k_multiple=k_multiple, per_tile_k=per_tile_k,
                     degree_sort=degree_sort, tune_cache=tune_cache)
