"""Batch-Hogwild SGD tile sweep: the slot plan and the wrapper of the CUDA
kernel ``csrc/sgd_update.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/sgd_update.py``
``sgd_tile_pallas``.  The kernel takes any number of rows, items and
slots and f <= 128 unpadded, so the reference's tile knobs (``row_mult``,
``col_mult``, ``f_mult``) have no counterpart.

The kernel runs from a :class:`SlotPlan` (:func:`build_plan`): the live
(row, slot) entries of a tile, ordered by (slot, item, row), cut into
work units of one item's collision group or a part of at most ``p`` rows
of one.  The plan depends only on ``idx`` and ``cnt``, so a driver
builds it once per run.  What bounds the kernel and how it is laid out
(one warp per unit, one cooperative launch per call, fp32 sums in a
fixed order, so two runs give bit-equal outputs) is noted in the CUDA
source.

Two entries launch the kernel for tensors on the card and run a plain
PyTorch version for tensors on the CPU:

- ``sgd_tile_cuda(x, theta, idx, val, cnt, lr, lam)`` is pure, like the
  reference's: it builds a plan for its one tile and returns fresh
  tensors (the plain version on the CPU: :func:`sgd_tile_plain`);
- ``sgd_tile_planned_(x, theta, plan, lr, lam)`` updates x and theta in
  place from a prebuilt plan (on the CPU: ``kref.sgd_tile_planned_plain``,
  which mirrors the kernel's order of work).

The process registry counts the calls of either entry that launched the
kernel, and the CUDA launches they made (one each): ``kernel/sgd_tile/...``,
read with ``repro_torch.obs.kernel_launches``.  ``sgd_tile_planned_`` is
the ``kernel.sgd_tile`` span of whatever driver calls it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.backend import Mode, default_mode
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.obs.metrics import kernel_counters
from repro_torch.obs.trace import current_tracer

MAX_F = 128
_LAUNCHES, _CUDA_LAUNCHES = kernel_counters("sgd_tile")
#: rows per work unit: a collision group longer than this is cut into parts
P_SPLIT = 16


# ---------------------------------------------------------------------------
# the slot plan (layout preparation, plain PyTorch on either device)
# ---------------------------------------------------------------------------

class SlotPlan(NamedTuple):
    """The live entries of one stacked tile in kernel order.

    Entries are ordered by (slot, item, row); ``rows`` and ``vals`` hold
    each entry's x row and rating.  ``units[u] = (item, first entry,
    rows, scratch row)`` is one item's collision group, or one part of at
    most ``p`` rows of a longer group, whose sum goes to its scratch row
    (-1 for a whole group); a slot's units are ``units[unit_offs[s]:
    unit_offs[s+1]]``, longest first.  ``splits[q] = (item, first scratch
    row, parts, rows)`` is a group cut into parts, a slot's are
    ``splits[split_offs[s]:split_offs[s+1]]``.  Slots without a live
    entry are left out; ``slots`` holds the tile's slot number of each
    planned slot.
    """
    rows: torch.Tensor        # [L] int32
    vals: torch.Tensor        # [L] float32
    units: torch.Tensor       # [U, 4] int32
    unit_offs: torch.Tensor   # [S + 1] int32
    splits: torch.Tensor      # [G, 4] int32
    split_offs: torch.Tensor  # [S + 1] int32
    slots: torch.Tensor       # [S] int32
    n_scratch: int            # scratch rows one slot needs

    @property
    def n_slots(self) -> int:
        return int(self.slots.numel())

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.rows, self.vals, self.units, self.unit_offs, self.splits,
                    self.split_offs, self.slots))


def build_plan(idx: torch.Tensor, val: torch.Tensor, cnt: torch.Tensor, *,
               p: int = P_SPLIT) -> SlotPlan:
    """The :class:`SlotPlan` of one stacked tile: ``idx [R, K]`` item ids
    (theta's rows), ``val [R, K]``, ``cnt [R]`` live slots per row, row r
    being x's row r; units of at most ``p`` rows.  A stable sort keeps the
    rows of a group ascending, the order in which ``index_add_`` sums them
    on the CPU.  Runs on the tensors' device."""
    if p < 1:
        raise ValueError(f"p={p} must be at least 1")
    dev = idx.device
    R, K = idx.shape
    # the live entries row-major (rows ascending, then slots): row r's
    # slots 0..cnt[r]-1.  Entry-sized arrays stay int32 where the values
    # fit, and the (slot, item) pair is one sort key that also gives both
    # back, so building the plan peaks at a fraction of its int64 form.
    pdt = torch.int32 if R * K < 2 ** 31 else torch.int64
    deg = cnt.clamp(0, K).to(pdt)
    L = int(deg.sum())
    r_ = torch.repeat_interleave(torch.arange(R, dtype=pdt, device=dev), deg, output_size=L)
    k_ = torch.arange(L, dtype=pdt, device=dev) - (torch.cumsum(deg, 0, dtype=pdt) - deg).index_select(0, r_)
    items = idx.reshape(-1).index_select(0, r_ * K + k_)
    n_items = int(items.max()) + 1 if L else 1
    kdt = torch.int32 if K * n_items < 2 ** 31 else torch.int64
    key = k_.to(kdt) * n_items + items.to(kdt)
    del k_, items
    key, order = torch.sort(key, stable=True)        # by (slot, item, row)
    rows = r_.index_select(0, order)
    del r_, order
    vals = val.reshape(-1).index_select(0, rows * K + torch.div(key, n_items, rounding_mode="floor")).float()
    rows = rows.int()

    new = torch.ones(L, dtype=torch.bool, device=dev)
    new[1:] = key[1:] != key[:-1]
    g_start = new.nonzero().squeeze(1)
    del new
    g_len = torch.diff(g_start, append=torch.tensor([L], device=dev))
    g_key = key[g_start].long()
    del key
    g_k = torch.div(g_key, n_items, rounding_mode="floor")
    g_item = g_key - g_k * n_items
    slots, per_slot = torch.unique_consecutive(g_k, return_counts=True)
    S = int(slots.numel())
    g_slot = torch.repeat_interleave(torch.arange(S, device=dev), per_slot)

    parts = (g_len + p - 1) // p
    split = parts > 1
    # scratch rows: a slot's split groups in item order, their parts in order
    sp = torch.where(split, parts, 0)
    ex = torch.cumsum(sp, 0) - sp
    first_g = torch.cumsum(per_slot, 0) - per_slot
    base = ex - ex[first_g][g_slot]
    slot_scratch = torch.zeros(S, dtype=torch.long, device=dev).index_add_(0, g_slot, sp)
    n_scratch = int(slot_scratch.max()) if S else 0

    u_g = torch.repeat_interleave(torch.arange(g_start.numel(), device=dev), parts)
    u_part = torch.arange(u_g.numel(), device=dev) - (torch.cumsum(parts, 0) - parts)[u_g]
    u_len = torch.clamp(g_len[u_g] - u_part * p, max=p)
    units = torch.stack([g_item[u_g], g_start[u_g] + u_part * p, u_len,
                         torch.where(split[u_g], base[u_g] + u_part, -1)], 1)
    u_order = torch.sort(g_slot[u_g] * (p + 1) + (p - u_len), stable=True).indices
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    unit_offs = torch.cat([zero, torch.cumsum(
        torch.zeros(S, dtype=torch.long, device=dev).index_add_(0, g_slot, parts), 0)])
    sg = split.nonzero().squeeze(1)
    splits = torch.stack([g_item[sg], base[sg], parts[sg], g_len[sg]], 1)
    split_offs = torch.cat([zero, torch.cumsum(torch.zeros(
        S, dtype=torch.long, device=dev).index_add_(0, g_slot[sg], torch.ones_like(sg)), 0)])
    return SlotPlan(rows=rows, vals=vals, units=units[u_order].int().contiguous(),
                    unit_offs=unit_offs.int(), splits=splits.int().contiguous(),
                    split_offs=split_offs.int(), slots=slots.int(), n_scratch=n_scratch)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _launcher():
    fn = build.load("sgd_update").sgd_plan_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, theta, idx, val, cnt) -> None:
    mb, K = idx.shape
    _check_factors(x, theta)
    if val.dtype != torch.float32:
        raise ValueError("val must be float32")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise ValueError("idx and cnt must be int32")
    if x.shape[0] != mb or val.shape != (mb, K) or cnt.shape != (mb,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
                         f"val {tuple(val.shape)}, cnt {tuple(cnt.shape)}")
    devices = {t.device for t in (x, theta, idx, val, cnt)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _check_factors(x, theta) -> None:
    if x.dim() != 2 or theta.dim() != 2 or x.shape[1] != theta.shape[1]:
        raise ValueError(f"x [mb, f] and theta [nb, f] disagree: {tuple(x.shape)}, "
                         f"{tuple(theta.shape)}")
    if x.dtype != torch.float32 or theta.dtype != torch.float32:
        raise ValueError("x and theta must be float32")
    if not 0 < x.shape[1] <= MAX_F:
        raise ValueError(f"f={x.shape[1]} outside the kernel's 1..{MAX_F}")


def _launch(x, theta, plan: SlotPlan, lr, lam) -> None:
    """Runs ``plan`` on the contiguous CUDA tensors x and theta in place."""
    f = x.shape[1]
    scratch = torch.empty((plan.n_scratch, f), dtype=torch.float32, device=x.device)
    bar = torch.empty(1, dtype=torch.int32, device=x.device)
    vec = f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, theta, scratch))
    rc = _launcher()(x.data_ptr(), theta.data_ptr(), plan.rows.data_ptr(),
                     plan.vals.data_ptr(), plan.units.data_ptr(), plan.unit_offs.data_ptr(),
                     plan.splits.data_ptr(), plan.split_offs.data_ptr(), scratch.data_ptr(),
                     bar.data_ptr(), plan.n_slots, x.shape[0], theta.shape[0], f,
                     float(lr), float(lam), int(vec), x.device.index or 0,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sgd_tile kernel launch failed: cudaError {rc} "
                           f"(slots={plan.n_slots}, units={plan.units.shape[0]}, f={f})")


#: plain PyTorch version (the K-slot loop with ``index_add_`` collisions)
sgd_tile_plain = kref.sgd_block_ref


def sgd_tile_planned_(
    x: torch.Tensor,       # [nx, f] float32 user factors, updated in place
    theta: torch.Tensor,   # [ntheta, f] float32 item factors, updated in place
    plan: SlotPlan,        # of idx/cnt whose row and item ids index x and theta
    lr: float,
    lam: float,
) -> None:
    """The batch-Hogwild sweep of a planned tile, in place: one CUDA
    launch for tensors on the card, the plan's plain mirror on the CPU."""
    _check_factors(x, theta)
    if not (x.is_contiguous() and theta.is_contiguous()):
        raise ValueError("x and theta must be contiguous: they are updated in place")
    devices = {t.device for t in (x, theta, plan.rows, plan.units)}
    if len(devices) != 1:
        raise ValueError(f"factors and plan lie on several devices: {devices}")
    with current_tracer().span("kernel.sgd_tile", cat="kernel", x_rows=x.shape[0],
                               theta_rows=theta.shape[0], f=x.shape[1],
                               entries=plan.rows.shape[0], slots=plan.n_slots):
        if x.device.type == "cpu":
            x_new, t_new = kref.sgd_tile_planned_plain(x, theta, plan, lr, lam)
            x.copy_(x_new)
            theta.copy_(t_new)
            return
        if plan.n_slots == 0:
            return
        _launch(x, theta, plan, lr, lam)
    _LAUNCHES.inc()
    _CUDA_LAUNCHES.inc()


def sgd_tile_cuda(
    x: torch.Tensor,       # [mb, f] float32 user factors
    theta: torch.Tensor,   # [nb, f] float32 item factors
    idx: torch.Tensor,     # [mb, K] int32 item index per slot (< nb)
    val: torch.Tensor,     # [mb, K] float32 ratings
    cnt: torch.Tensor,     # [mb]    int32 live slots per row
    lr: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', theta') after the batch-Hogwild sweep of all K slots."""
    _check(x, theta, idx, val, cnt)
    if x.device.type == "cpu":
        return sgd_tile_plain(x, theta, idx, val, cnt, lr, lam)
    x_out = x.contiguous().clone()
    t_out = theta.contiguous().clone()
    sgd_tile_planned_(x_out, t_out, build_plan(idx, val, cnt), lr, lam)
    return x_out, t_out


def sgd_block_update(
    x: torch.Tensor,      # [mb, f]  user-block factor slice
    theta: torch.Tensor,  # [nb, f]  item-block factor slice
    idx: torch.Tensor,    # [mb, K]  block-local item indices
    val: torch.Tensor,    # [mb, K]
    cnt: torch.Tensor,    # [mb]
    lr: float,
    lam: float,
    *,
    mode: Optional[Mode] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch-Hogwild sweep over a tile; returns (x', theta').

    ``mode="kernel"`` runs :func:`sgd_tile_cuda` (the plain version on
    CPU tensors), ``"ref"`` the plain version on any device, ``None`` the
    default of the tensors' device.
    """
    mode = default_mode(x.device) if mode is None else mode
    if mode == "kernel":
        return sgd_tile_cuda(x, theta, idx, val, cnt, lr, lam)
    if mode == "ref":
        return sgd_tile_plain(x, theta, idx, val, cnt, lr, lam)
    raise ValueError(f"unknown mode {mode!r}")
