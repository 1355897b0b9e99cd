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
the cells in ascending order, each cell's work on its card's current
stream, so while cells share a card the order of their work is fixed.
Step 1 and step 3 are the port's CUDA kernels (``kernels.ops.fused_herm``
with ``diag_fallback=False``, ``kernels.ops.batch_solve``), launched once
per cell; steps 2 and 4 are ``distributed.collectives``.  Step 2 is given
the partials (``donate``): each cell's slice of the sum is built in its
own partial, and the slices that cross cards move in slabs on copy
streams of their own, both directions of a pair at once, ordered against
the cards' current streams by events alone and joined back into them
before each phase of the reduction ends.

One engine, :func:`_half`, runs the half-step per bin and q-batch on a
``sparse.padded.BinnedShards`` layout (rows binned by global degree,
columns in p shards) that :func:`place_side` has put on the cells.  Its
interfaces:

- :func:`mesh_half`, the port's normal path (``core.als.als_train_binned(
  ..., mesh=mesh)``): layouts placed once, a whole copy of both factors on
  every card (a cell's block of the fixed factor is a view), the reshard
  over "data" after each half-step.  Spans: ``obs/trace.py``'s ``mesh``.
- :func:`make_su_als_fns` and :func:`make_wave_update_fn`, the reference's
  interface (the dry-run's, the out-of-core waves'): :func:`shard_ratings`
  arrays taken as one bin and placed each call, the solved rows joined on
  the home device.  :func:`make_wave_herm_fn` runs step 1 alone.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import Mode
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh
from repro_torch.obs.metrics import process_registry
from repro_torch.obs.trace import current_tracer
from repro_torch.sparse.padded import BinnedShards

_SYNCS = process_registry().counter("host/syncs")


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


def col_axes(mesh: Mesh) -> tuple[str, ...]:
    """Names of cuMF's p axes, fast -> slow: ``("model",)`` or
    ``("model", "pod")``."""
    return tuple(a for a in ("model", "pod") if a in mesh.axis_names)


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


def _on(device: torch.device):
    """The device's CUDA context made current (so that the ops' spans time
    its stream), or nothing for a CPU cell."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


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


def _cell_herm(fixed: torch.Tensor, idx, val, cnt, lam: float, dev: torch.device,
               mode: Optional[Mode]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 1 on one cell, on ``dev``'s stream: the partial Hermitian
    ``(A, B)`` of its ratings against its block of the fixed factor, with
    no diagonal fallback (a row empty in this shard may not be empty in
    all), and its counts as a float32 copy (the reduction folds into what
    it is given, so never into a caller's counts)."""
    with _on(dev):
        A, B = kops.fused_herm(fixed, idx, val, cnt, lam, mode=mode, diag_fallback=False)
    return A, B, cnt.to(torch.float32, copy=True)


def _reduce_solve_gather(A: list, B: list, cnt: list, devs: list, *, col_sizes, col_axes,
                         scheme: str, mode: Optional[Mode], cards=None) -> list[torch.Tensor]:
    """Steps 2-4 for one column group, its cells in shard order on
    ``devs``: the partials ``A``, ``B`` and float ``cnt`` (lists of
    tensors this step owns, emptied once given to the reduction, which
    builds each cell's slice in its own partial) reduce-scattered, the owned
    slices solved, and the slices all-gathered: each cell's rows of the
    group, one tensor per distinct device.  Rows that do not split over
    the cells are ragged (``collectives._chunks``).  ``cards``: the cards
    of the ``su_als.reduce`` (``phase``, ``bytes``), ``su_als.solve`` and
    ``su_als.gather`` spans."""
    tracer = current_tracer()
    two_phase = scheme == "two_phase" and len(col_sizes) > 1

    def phase(name, nbytes):
        return tracer.span_on(cards, "su_als.reduce", cat="mesh", phase=name, bytes=nbytes)

    # (2) parallel reduction of partial results — paper §4.2
    def reduce(parts):
        out = parts[:]
        parts.clear()
        if two_phase:
            # Fig. 5b: scatter over the fast (model) cells of each pod first;
            # only 1/n_fast-sized slices then cross the slow (pod) link
            return coll.two_level_reduce_scatter(out, col_sizes[0], fast_axes=col_axes[:1],
                                                 slow_axes=col_axes[1:], ragged=True,
                                                 phase=phase, donate=True)
        # Fig. 5a: one reduce-scatter over the joint column cells
        with phase("flat", (len(out) - 1) * out[0].numel() * out[0].element_size()):
            return coll.reduce_scatter_flat(out, axes=col_axes, ragged=True, donate=True)
    reduced = list(zip(reduce(A), reduce(B), reduce(cnt)))

    # (3) singular guard for globally empty rows (x_u = 0), then the solve
    # of the owned slice — Alg. 3 line 17, p-way parallel
    with tracer.span_on(cards, "su_als.solve", cat="mesh"):
        x_slices = []
        for dev, (a, b, c) in zip(devs, reduced):
            with _on(dev):
                a.diagonal(dim1=-2, dim2=-1).add_((c <= 0).to(a.dtype)[:, None])
                x_slices.append(kops.batch_solve(a, b, mode=mode))
        del reduced

    # (4) collect the solved slices — Alg. 3 line 19.  Two-phase: cell
    # (pod s, model f) owns sub-slice s of chunk f
    with tracer.span_on(cards, "su_als.gather", cat="mesh"):
        if two_phase:
            n_fast, n_slow = col_sizes[0], col_sizes[1]
            order = [s * n_fast + f for f in range(n_fast) for s in range(n_slow)]
            gathered = coll.all_gather([x_slices[c] for c in order], 0, axes=col_axes)
            return [gathered[order.index(c)] for c in range(len(x_slices))]
        return coll.all_gather(x_slices, 0, axes=col_axes)


def _update(fixed: RowShards, idx, val, cnt, mesh: Mesh, lam: float, *, scheme: str,
            mode: Optional[Mode], row_block: int) -> torch.Tensor:
    """The SU-ALS half-step on global ratings in the :func:`shard_ratings`
    layout (idx/val ``[m, P*K]``, cnt ``[m, P]``), taken as one bin of
    column shards (shard k: the k-th column block and count column; shard
    k of the fixed factor: its row block k, as :func:`shard_rows` splits)
    and run by :func:`_half` in q-batches of ``row_block`` rows; returns
    the global ``[m, f]`` factor on the mesh's home device."""
    idx, val, cnt = (_stage(a, mesh) for a in (idx, val, cnt))
    n_data, p = mesh_axes(mesh)
    m = idx.shape[0]
    if m % n_data or idx.shape[1] % p:
        raise ValueError(f"ratings {tuple(idx.shape)} do not split over "
                         f"{n_data} data x {p} column shards")
    m_loc, K = m // n_data, idx.shape[1] // p
    npp = fixed.blocks[0][0].shape[0]
    layout = BinnedShards(
        bins=(tuple((idx[:, k * K:(k + 1) * K], val[:, k * K:(k + 1) * K], cnt[:, k])
                    for k in range(p)),),
        rows=(torch.arange(m, device=idx.device),),
        starts=tuple(k * npp for k in range(p + 1)), n_cols=p * npp, m=m)
    blocks = [blk for group in fixed.blocks for blk in group]
    out = _half(blocks, place_side(layout, mesh), mesh, lam, f=blocks[0].shape[1],
                batch_rows=row_block, scheme=scheme, mode=mode)
    return torch.cat([out[devs[0]][d * m_loc:(d + 1) * m_loc].to(mesh.home)
                      for d, devs in enumerate(column_groups(mesh))])


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
                # the singular guard follows the topology reduce
                Ac, Bc, _ = _cell_herm(x_stack[d].to(dev), idxT[d, rows].to(dev),
                                       valT[d, rows].to(dev), cntT[d, rows].to(dev), lam, dev,
                                       mode)
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


# ---------------------------------------------------------------------------
# The engine: binned column shards resident on the cells
# ---------------------------------------------------------------------------

class MeshSide(NamedTuple):
    """One side's ratings (R or R^T) resident on the cells of a mesh.

    Cells are taken in group order, c = d * p + k for data shard d and
    column shard k (:func:`column_groups`).  Bin b's rows split into
    ``n_data`` parts of ``ceil(rows_b / n_data)`` rows (``bounds[b][d]``,
    bin-local); ``blocks[b][c]`` is (idx, val, cnt) of part d's rows in
    shard k on cell c's device, and ``rows[b][d]`` part d's row map on
    each device of group d.  ``part_rows[d]`` holds every bin's part-d
    rows and ``all_rows`` every part's in part order, on each device.
    """
    blocks: list
    rows: list
    bounds: list
    part_rows: list
    all_rows: dict
    starts: tuple
    m: int


def place_side(layout, mesh: Mesh) -> MeshSide:
    """Uploads a ``BinnedShards`` layout's blocks to the cells that own
    them, once (a block already on its cell's device stays a view)."""
    n_data, p = mesh_axes(mesh)
    if layout.p != p:
        raise ValueError(f"the layout has {layout.p} column shards, the mesh {p}")
    groups = column_groups(mesh)
    blocks, rows, bounds = [], [], []
    for shards, rb in zip(layout.bins, layout.rows):
        step = -(-rb.numel() // n_data)
        bb = [(min(d * step, rb.numel()), min((d + 1) * step, rb.numel())) for d in range(n_data)]
        blocks.append([tuple(t[lo:hi].to(dev) for t in shards[k])
                       for (lo, hi), devs in zip(bb, groups) for k, dev in enumerate(devs)])
        rows.append([{dev: rb[lo:hi].to(dev) for dev in dict.fromkeys(devs)}
                     for (lo, hi), devs in zip(bb, groups)])
        bounds.append(bb)
    part_of = [torch.cat([rb[bb[d][0]:bb[d][1]] for rb, bb in zip(layout.rows, bounds)])
               for d in range(n_data)]
    part_rows = [{dev: part_of[d].to(dev) for dev in dict.fromkeys(devs)}
                 for d, devs in enumerate(groups)]
    all_rows = {dev: torch.cat(part_of).to(dev) for dev in mesh.distinct_devices}
    return MeshSide(blocks, rows, bounds, part_rows, all_rows, layout.starts, layout.m)


def replicate(t: torch.Tensor, mesh: Mesh) -> dict:
    """A factor copied whole to every device of the mesh."""
    return {dev: t.to(dev) for dev in mesh.distinct_devices}


def mesh_batches(side: MeshSide, batch_rows: int) -> list[list[list]]:
    """``[b][q][d]``: the bin-local (lo, hi) rows of data part d in q-batch
    q of bin b (None where the part has no rows left), q-batches of
    ``batch_rows`` rows (0: one batch), as ``core.als._row_batches``
    cuts."""
    out = []
    for bb in side.bounds:
        sizes = [hi - lo for lo, hi in bb]
        top = max(max(sizes), 1)
        step = batch_rows if batch_rows and batch_rows < top else top
        out.append([[(lo + q * step, lo + min((q + 1) * step, n)) if q * step < n else None
                     for (lo, _), n in zip(bb, sizes)]
                    for q in range(-(-top // step))])
    return out


def mesh_nnz(side: MeshSide, batch_rows: int) -> list[list[list[int]]]:
    """``[b][q][c]``: ratings of cell c in q-batch q of bin b (host reads,
    for a tracer's args, once a run)."""
    n_data = len(side.bounds[0])
    p = len(side.blocks[0]) // n_data
    out = []
    for b, batches in enumerate(mesh_batches(side, batch_rows)):
        cum = [[0] + cnt.long().cumsum(0).tolist() for _, _, cnt in side.blocks[b]]
        per_batch = []
        for parts in batches:
            row = []
            for c, counts in enumerate(cum):
                part, base = parts[c // p], side.bounds[b][c // p][0]
                row.append(counts[part[1] - base] - counts[part[0] - base] if part else 0)
            per_batch.append(row)
        out.append(per_batch)
    return out


def mesh_half(fixed: dict, side: MeshSide, mesh: Mesh, lam: float, *, f: int,
              batch_rows: int = 0, mode: Optional[Mode] = None, nnz=None) -> dict:
    """One SU-ALS half-step on resident shards: solves every row of ``side``
    against ``fixed`` ({device: the whole fixed factor}) by :func:`_half`,
    whose reduction the mesh's column axes decide (two-level over a pod
    axis, one-phase without one); a mesh with a data axis then all-gathers
    each part's rows over it (the reshard), so that every device holds the
    whole new factor, returned as {device: factor}.  ``nnz``
    (:func:`mesh_nnz`) gives the ``su_als.bin`` spans' ratings."""
    p = len(side.starts) - 1
    blocks = [fixed[dev][side.starts[c % p]:side.starts[c % p + 1]]
              for c, dev in enumerate(dev for g in column_groups(mesh) for dev in g)]
    out = _half(blocks, side, mesh, lam, f=f, batch_rows=batch_rows, scheme="two_phase",
                mode=mode, nnz=nnz)
    _reshard(out, side, mesh, mesh.distinct_devices)
    return out


def _half(fixed_blocks: list, side: MeshSide, mesh: Mesh, lam: float, *, f: int,
          batch_rows: int, scheme: str, mode: Optional[Mode], nnz=None) -> dict:
    """The SU-ALS half-step, without the reshard: per bin and q-batch of
    ``batch_rows`` rows, (1) each cell's partial Hermitian from its shard
    and ``fixed_blocks[c]``, its block of the fixed factor, then for each
    column group (2) the reduction (``scheme`` "two_phase" | "one_phase"),
    (3) the solve of the slice each cell owns, with the singular guard for
    rows empty in every shard, (4) the all-gather of the slices
    (:func:`_reduce_solve_gather`), and the rows scattered by the bin's
    row map into every device of the group.  Returns {device: [m, f]},
    each device holding the rows of the groups it serves."""
    if scheme not in ("one_phase", "two_phase"):
        raise ValueError(f"unknown scheme {scheme!r}")
    tracer = current_tracer()
    groups = column_groups(mesh)
    p = len(groups[0])
    devs = [dev for g in groups for dev in g]
    cards = mesh.distinct_devices
    kw = dict(col_sizes=col_sizes(mesh), col_axes=col_axes(mesh), scheme=scheme, mode=mode,
              cards=cards)
    out = {dev: torch.zeros((side.m, f), dtype=torch.float32, device=dev) for dev in cards}
    for b, batches in enumerate(mesh_batches(side, batch_rows)):
        for q, parts in enumerate(batches):
            local = {}          # each live data part's rows of the batch, part-local
            for d, part in enumerate(parts):
                if part is not None:
                    base = side.bounds[b][d][0]
                    local[d] = (part[0] - base, part[1] - base)
            with tracer.span_on(cards, "su_als.bin", cat="bin", bin=b, batch=q,
                                rows=sum(hi - lo for lo, hi in local.values()),
                                K=[blk[0].shape[1] for blk in side.blocks[b]],
                                nnz=nnz[b][q] if nnz else None):
                herm = {}
                with tracer.span_on(cards, "su_als.herm", cat="mesh"):
                    for d, (lo, hi) in local.items():
                        A, B, C = [], [], []
                        for c in range(d * p, (d + 1) * p):
                            Ac, Bc, Cc = _cell_herm(fixed_blocks[c],
                                                    *(t[lo:hi] for t in side.blocks[b][c]),
                                                    lam, devs[c], mode)
                            A.append(Ac)
                            B.append(Bc)
                            C.append(Cc)
                        herm[d] = (A, B, C)
                solved = {d: _reduce_solve_gather(*herm.pop(d), devs[d * p:(d + 1) * p], **kw)
                          for d in list(herm)}
                with tracer.span_on(cards, "als.scatter", cat="scatter", bin=b):
                    for d, (lo, hi) in local.items():
                        for dev, x in zip(devs[d * p:(d + 1) * p], solved[d]):
                            out[dev].index_copy_(0, side.rows[b][d][dev][lo:hi], x)
    return out


def _reshard(out: dict, side: MeshSide, mesh: Mesh, cards) -> None:
    """Completes every device's copy of a new factor: each column cell
    all-gathers the rows the other data parts solved, over the data axis
    (nothing moves on a mesh without one)."""
    groups = column_groups(mesh)
    n_data, p = len(groups), len(groups[0])
    nbytes = p * (n_data - 1) * side.m * next(iter(out.values())).shape[1] * 4
    with current_tracer().span_on(cards, "su_als.reshard", cat="mesh", bytes=nbytes):
        if n_data == 1:
            return
        for k in range(p):
            parts = [out[groups[d][k]].index_select(0, side.part_rows[d][groups[d][k]])
                     for d in range(n_data)]
            got = coll.all_gather(parts, 0, axes="data")
            for d in range(n_data):
                dev = groups[d][k]
                out[dev].index_copy_(0, side.all_rows[dev], got[d])


def rmse_shards(x: dict, theta: dict, side: MeshSide, mesh: Mesh,
                mode: Optional[Mode] = None) -> float:
    """Train RMSE over the ratings of ``side`` (R, resident on the cells):
    each cell's ``sq_err`` over its shards into a float64 ``(sse, nnz)``
    on its device, the cells' partials summed on the home device in
    ascending cell order, and one host read."""
    groups = column_groups(mesh)
    p = len(groups[0])
    accs = []
    for c, dev in enumerate(dev for g in groups for dev in g):
        d, k = divmod(c, p)
        acc = torch.zeros(2, dtype=torch.float64, device=dev)
        th = theta[dev][side.starts[k]:side.starts[k + 1]]
        with _on(dev):
            for b, blocks in enumerate(side.blocks):
                idx, val, cnt = blocks[c]
                kops.sq_err(x[dev], th, idx, val, cnt, rows=side.rows[b][d][dev], out=acc,
                            mode=mode)
        accs.append(acc)
    total = accs[0].to(mesh.home, copy=True)
    for acc in accs[1:]:
        total += acc.to(mesh.home)
    sse, nnz = total.tolist()
    _SYNCS.inc()
    return (sse / max(nnz, 1.0)) ** 0.5
