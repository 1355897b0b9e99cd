"""SU-ALS (paper Alg. 3): data + model parallel ALS over the cells of a
``launch.mesh.Mesh``, driven by one host program.

Axis mapping (paper -> mesh):

- cuMF's **p** (Theta column shards; each GPU computes *partial* A_u, B_u
  from only its local theta_v — eq. 5-7) == the ``"model"`` mesh axis, and
  jointly ``("pod", "model")`` on a three-axis mesh: column shard k of cell
  (pod a, model b) is ``k = a * n_model + b``;
- cuMF's **q** (X row partitions, solved independently) == the ``"data"``
  mesh axis.

One update-X step, per data shard and for each cell of its column group
(update-Theta is symmetric):

  1. local fused Hermitian: A_i, B_i from the cell's columns  (Alg. 3 L11)
  2. parallel reduction: reduce-scatter over the column cells (L13-16;
     one-phase Fig. 5a, or model-then-pod, the two-phase Fig. 5b)
  3. batch solve of the slice the cell owns                     (L17)
  4. all-gather of the solved slices                            (L19)

The reference runs this under ``shard_map``; here each step is a loop over
the cells in ascending order, on one stream, so while cells share a card
the order of their work is fixed.  Step 1 and step 3 are the port's CUDA
kernels (``kernels.ops.fused_herm`` with ``diag_fallback=False``,
``kernels.ops.batch_solve``), launched once per cell; steps 2 and 4 are
``distributed.collectives``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.backend import Mode
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh


def _tensor(a) -> torch.Tensor:
    """A tensor view of an array (a copy of a read-only one)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def col_sizes(mesh: Mesh) -> tuple[int, ...]:
    """Sizes of cuMF's p axes, fast -> slow: ``(n_model,)`` or
    ``(n_model, n_pod)``."""
    return tuple(mesh.shape[a] for a in ("model", "pod") if a in mesh.axis_names)


def mesh_axes(mesh: Mesh) -> tuple[int, int]:
    """``(n_data, p)``: the data-axis size and the number of column shards."""
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh needs a model axis, got {mesh.axis_names}")
    return mesh.shape.get("data", 1), int(np.prod(col_sizes(mesh)))


def column_groups(mesh: Mesh) -> list[list[torch.device]]:
    """For each data index d, the devices of its column cells in shard
    order k = pod * n_model + model."""
    n_data, _ = mesh_axes(mesh)
    n_model, n_pod = mesh.shape["model"], mesh.shape.get("pod", 1)
    groups = []
    for d in range(n_data):
        devs = []
        for a in range(n_pod):
            for b in range(n_model):
                coords = {"data": d, "model": b, "pod": a}
                devs.append(mesh.device(**{k: coords[k] for k in mesh.axis_names}))
        groups.append(devs)
    return groups


def _stage(a, mesh: Mesh) -> torch.Tensor:
    """A global array as a tensor; on a mesh whose cells share one device
    it is moved there once, so every cell's block is a view of it."""
    t = _tensor(a)
    devs = mesh.distinct_devices
    return t.to(devs[0]) if len(devs) == 1 else t


class RowShards(NamedTuple):
    """A factor's rows split over the column cells: ``blocks[d][k]`` is
    row block k, on the device of cell (data d, column k) — the
    reference's ``P(col_axes, None)`` placement, replicated over data."""
    blocks: list[list[torch.Tensor]]


def shard_rows(a, mesh: Mesh) -> RowShards:
    """Place a global ``[n, f]`` factor's row blocks on the column cells:
    the explicit reshard between SU-ALS half-steps."""
    t = _stage(a, mesh)
    _, p = mesh_axes(mesh)
    n = t.shape[0]
    if n % p:
        raise ValueError(f"{n} rows do not split over {p} column shards")
    npp = n // p
    return RowShards([[t[k * npp:(k + 1) * npp].to(dev) for k, dev in enumerate(devs)]
                      for devs in column_groups(mesh)])


def su_als_update(
    theta_locs: Sequence[torch.Tensor],   # per cell [n_loc, f] Theta column shard
    idx_locs: Sequence[torch.Tensor],     # per cell [m_loc, K] shard-local indices
    val_locs: Sequence[torch.Tensor],     # per cell [m_loc, K]
    cnt_locs: Sequence[torch.Tensor],     # per cell [m_loc] local nnz counts
    lam: float,
    *,
    col_sizes: tuple[int, ...],           # cuMF p axes' sizes, fast -> slow
    scheme: str = "two_phase",            # "one_phase" | "two_phase"
    mode: Optional[Mode] = None,
    row_block: int = 0,
    col_axes: tuple[str, ...] = (),       # the p axes' names, fast -> slow (for counting)
) -> list[torch.Tensor]:
    """One SU-ALS half-step for the column group of one data shard.

    The lists hold the group's cells in shard order (slow-major).  Returns
    each cell's ``x_loc [m_loc, f]``, replicated over the group (cells on
    one device share one tensor).  ``row_block`` > 0 processes rows in
    blocks of that size (cuMF's m_b batching, Table 3): it bounds the live
    Hermitians at ``row_block * f^2`` floats a cell; the last block may be
    short (nothing here needs equal block shapes, as in
    ``core.als._map_row_blocks``).
    """
    if scheme not in ("one_phase", "two_phase"):
        raise ValueError(f"unknown scheme {scheme!r}")
    m_loc = idx_locs[0].shape[0]
    if row_block and row_block < m_loc:
        blocks = [su_als_update(theta_locs, [i[lo:lo + row_block] for i in idx_locs],
                                [v[lo:lo + row_block] for v in val_locs],
                                [c[lo:lo + row_block] for c in cnt_locs], lam,
                                col_sizes=col_sizes, scheme=scheme, mode=mode,
                                col_axes=col_axes)
                  for lo in range(0, m_loc, row_block)]
        return _per_device([[b[c] for b in blocks] for c in range(len(idx_locs))])
    # (1) local partial Hermitians — eq. (5)-(7)
    A, B, cnt = [], [], []
    for t, i, v, c in zip(theta_locs, idx_locs, val_locs, cnt_locs):
        Ac, Bc = kops.fused_herm(t, i, v, c, lam, mode=mode, diag_fallback=False)
        A.append(Ac)
        B.append(Bc)
        cnt.append(c.to(torch.float32))

    # (2) parallel reduction of partial results — paper §4.2
    two_phase = scheme == "two_phase" and len(col_sizes) > 1
    if two_phase:
        # Fig. 5b: scatter over the fast (model) cells of each pod first;
        # only 1/n_fast-sized slices then cross the slow (pod) link
        def reduce(parts):
            return coll.two_level_reduce_scatter(parts, col_sizes[0], fast_axes=col_axes[:1],
                                                 slow_axes=col_axes[1:])
    else:
        # Fig. 5a: one reduce-scatter over the joint column cells
        def reduce(parts):
            return coll.reduce_scatter_flat(parts, axes=col_axes)
    A_r, B_r, c_r = reduce(A), reduce(B), reduce(cnt)
    del A, B, cnt

    # (3) singular guard for globally empty rows (x_u = 0), then the solve
    # of the owned slice — Alg. 3 line 17, p-way parallel
    x_slices = []
    for a, b, c in zip(A_r, B_r, c_r):
        a.diagonal(dim1=-2, dim2=-1).add_((c <= 0).to(a.dtype)[:, None])
        x_slices.append(kops.batch_solve(a, b, mode=mode))
    del A_r, B_r

    # (4) collect the solved slices — Alg. 3 line 19.  Two-phase: cell
    # (pod s, model f) owns sub-slice s of slice f
    if two_phase:
        n_fast, n_slow = col_sizes[0], col_sizes[1]
        order = [s * n_fast + f for f in range(n_fast) for s in range(n_slow)]
        gathered = coll.all_gather([x_slices[c] for c in order], 0, axes=col_axes)
        return [gathered[order.index(c)] for c in range(len(x_slices))]
    return coll.all_gather(x_slices, 0, axes=col_axes)


def _per_device(pieces: list[list[torch.Tensor]]) -> list[torch.Tensor]:
    """Each cell's row blocks concatenated, one tensor per distinct device."""
    out: dict[torch.device, torch.Tensor] = {}
    for blocks in pieces:
        if blocks[0].device not in out:
            out[blocks[0].device] = torch.cat(blocks)
    return [out[blocks[0].device] for blocks in pieces]


def _update(fixed: RowShards, idx, val, cnt, mesh: Mesh, lam: float, **kw) -> torch.Tensor:
    """The SU-ALS half-step on global ratings in the :func:`shard_ratings`
    layout (idx/val ``[m, P*K]``, cnt ``[m, P]``): every data shard's
    column group solves its rows; returns the global ``[m, f]`` factor on
    the mesh's home device.  A data shard whose rows do not split over its
    p column cells is padded with empty rows, which solve to 0 and are
    dropped."""
    idx, val, cnt = (_stage(a, mesh) for a in (idx, val, cnt))
    n_data, p = mesh_axes(mesh)
    m = idx.shape[0]
    if m % n_data or idx.shape[1] % p:
        raise ValueError(f"ratings {tuple(idx.shape)} do not split over "
                         f"{n_data} data x {p} column shards")
    m_loc, K = m // n_data, idx.shape[1] // p
    pad = -m_loc % p

    def cell(a, rows, cols, dev):
        t = a[rows, cols].to(dev)
        return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) if pad else t

    out = []
    for d, devs in enumerate(column_groups(mesh)):
        rows = slice(d * m_loc, (d + 1) * m_loc)
        x_loc = su_als_update(
            fixed.blocks[d],
            [cell(idx, rows, slice(k * K, (k + 1) * K), dev) for k, dev in enumerate(devs)],
            [cell(val, rows, slice(k * K, (k + 1) * K), dev) for k, dev in enumerate(devs)],
            [cell(cnt, rows, k, dev) for k, dev in enumerate(devs)],
            lam, col_sizes=col_sizes(mesh),
            col_axes=tuple(a for a in ("model", "pod") if a in mesh.axis_names), **kw)
        out.append(x_loc[0][:m_loc].to(mesh.home))
    return torch.cat(out)


def make_su_als_fns(
    mesh: Mesh,
    lam: float,
    *,
    scheme: str = "two_phase",
    mode: Optional[Mode] = None,
    row_block: int = 0,
):
    """``(update_x, update_theta, iteration)`` on ``mesh``.

    Global layouts (see :func:`shard_ratings`):

      R rows grid:   idx/val [m, P*K] rows over "data", column blocks over
                     the column cells; cnt [m, P]
      R^T rows grid: idxT/valT [n, P*KT], cntT [n, P] likewise
      theta [n, f] / x [m, f]: the fixed side, its rows over the column
                     cells (placed by :func:`shard_rows`)

    ``update_x(theta, idx, val, cnt)`` takes a global factor or its
    :class:`RowShards`; the factors come back global, on the mesh's home
    device.  The reference's TPU tile knobs have no counterpart.
    """
    update = functools.partial(_update, mesh=mesh, lam=lam, scheme=scheme,
                               mode=mode, row_block=row_block)

    def placed(a) -> RowShards:
        return a if isinstance(a, RowShards) else shard_rows(a, mesh)

    def update_x(theta, idx, val, cnt):
        return update(placed(theta), idx, val, cnt)

    def update_theta(x, idxT, valT, cntT):
        return update(placed(x), idxT, valT, cntT)

    def iteration(x, theta, r, rt):
        """One full ALS iteration; the reshard of the new X onto the column
        cells between the half-steps is explicit."""
        x_new = update(shard_rows(theta, mesh), *r)
        theta_new = update(shard_rows(x_new, mesh), *rt)
        return x_new, theta_new

    return update_x, update_theta, iteration


def make_wave_update_fn(
    mesh: Mesh,
    lam: float,
    *,
    scheme: str = "two_phase",
    mode: Optional[Mode] = None,
    row_block: int = 0,
):
    """Per-slice update entry point of the out-of-core wave driver.

    One wave slice's rating arrays (the :func:`shard_ratings` layout —
    idx/val ``[m_slice, P*K]``, cnt ``[m_slice, P]``) go row-sharded over
    "data", so each data shard takes one q-batch of the wave; the fixed
    factor (global, or placed by :func:`shard_rows`) over the column
    cells; the SU-ALS update runs and the solved rows come back to the
    host as numpy, for the driver to write into its factor store.
    ``m_slice`` must divide over the data axis.
    """
    update_x, _, _ = make_su_als_fns(mesh, lam, scheme=scheme, mode=mode,
                                     row_block=row_block)

    def update_slice(fixed, idx, val, cnt) -> np.ndarray:
        return update_x(fixed, idx, val, cnt).cpu().numpy()

    return update_slice


def make_wave_herm_fn(mesh: Mesh, lam: float, *, mode: Optional[Mode] = None):
    """Accumulate-Theta entry point of the out-of-core wave driver.

    One call computes the partial Hermitians of one wave: cell (d, k) holds
    data shard ``d``'s fresh X slice and only column shard ``k``'s rows of
    that batch's R^T shard, and produces the partial (A, B) of its theta
    rows (eq. 5-7 with the weighted-lambda diagonal, which telescopes over
    data shards).  There is no reduction across cells: the partials come
    back to the host with the data axis intact, where the driver
    accumulates them across waves and combines them once per half-iteration
    through ``distributed.reduce.topology_reduce`` — the paper's host-
    scheduled Fig. 5 reduction.

    Stacks (numpy or tensors):
      x_stack [n_data, rows, f]   fresh X slices, one per data shard
      idxT/valT [n_data, n, K]    R^T shards, theta rows over the column cells
      cntT   [n_data, n]          per-shard local nnz counts
    Returns host ``(A [n_data, n, f, f], B [n_data, n, f])`` float32.
    """
    def herm_stack(x_stack, idxT, valT, cntT):
        x_stack, idxT, valT, cntT = (_stage(a, mesh) for a in (x_stack, idxT, valT, cntT))
        n_data, p = mesh_axes(mesh)
        n, f = idxT.shape[1], x_stack.shape[2]
        if n % p or idxT.shape[0] != n_data:
            raise ValueError(f"R^T stack {tuple(idxT.shape)} does not split over "
                             f"{n_data} data x {p} column shards")
        npp = n // p
        A = np.empty((n_data, n, f, f), np.float32)
        B = np.empty((n_data, n, f), np.float32)
        for d, devs in enumerate(column_groups(mesh)):
            for k, dev in enumerate(devs):
                rows = slice(k * npp, (k + 1) * npp)
                # diag_fallback=False: a locally empty theta row may be
                # nonempty globally — the guard follows the topology reduce
                Ac, Bc = kops.fused_herm(
                    x_stack[d].to(dev), idxT[d, rows].to(dev), valT[d, rows].to(dev),
                    cntT[d, rows].to(dev), lam, mode=mode, diag_fallback=False)
                A[d, rows] = Ac.cpu().numpy()
                B[d, rows] = Bc.cpu().numpy()
                del Ac, Bc
        return A, B

    return herm_stack


def shard_ratings(ell_parts, mesh: Mesh):
    """``partition_padded`` output (``[P, m, K]`` arrays) -> the layout of
    :func:`make_su_als_fns`: idx/val ``[m, P*K]`` and cnt ``[m, P]``
    tensors on the mesh's home device (every cell's block a slice of them)."""
    Pn, m, K = ell_parts.idx.shape
    idx = np.transpose(ell_parts.idx, (1, 0, 2)).reshape(m, Pn * K)
    val = np.transpose(ell_parts.val, (1, 0, 2)).reshape(m, Pn * K)
    cnt = np.transpose(ell_parts.cnt, (1, 0)).reshape(m, Pn)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.home)
                 for a in (idx, val, cnt))
