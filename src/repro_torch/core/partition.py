"""Partition planner — paper eq. (8), the port's copy of the reference's
``repro/core/partition.py``; it prices bit-equal for equal arguments.

cuMF chooses p (Theta column shards == data parallelism) and q (X row
batches == model parallelism) so that a single device holds::

    m f / q  +  n f / p  +  |R^(ij)|  +  (m/q) f^2  +  (m/q) f  +  eps  <  C

with the best practices of §4.3:
  1. if p = 1 fits, stay on one device (SU-ALS degenerates to MO-ALS),
  2. stop growing q once p = 1 fits,
  3. otherwise start from p with n f / p ~ C/2 and pick the smallest q.

q larger than the data axis runs in waves (elasticity, §4.4) — ``waves``
reports how many.  C is the card's memory: when the caller passes no
``hbm_bytes`` it is ``torch.cuda.get_device_properties(dev).total_memory``
of the current card, and without a card the planner raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

GiB = 1 << 30


def device_memory_bytes(hbm_bytes: Optional[int] = None) -> int:
    """``hbm_bytes`` when given, else the current card's total memory;
    raises when there is no card to ask."""
    if hbm_bytes is not None:
        return int(hbm_bytes)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no hbm_bytes given and torch.cuda.is_available() is False: pass "
            "the device budget explicitly to plan without a card")
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    p: int                  # column shards of Theta (data parallelism)
    q: int                  # row shards/batches of X (model parallelism)
    bytes_per_device: int
    terms: dict
    fits: bool
    waves: int = 1          # q-batches executed per device wave (elasticity)

    def describe(self) -> str:
        t = ", ".join(f"{k}={v / GiB:.3f}GiB" for k, v in self.terms.items())
        return (f"p={self.p} q={self.q} waves={self.waves} "
                f"total={self.bytes_per_device / GiB:.3f}GiB fits={self.fits} [{t}]")


def streaming_acc_bytes(n: int, f: int, dtype_bytes: int = 4) -> int:
    """Resident accumulate-Theta state of a streaming run: the A [n, f, f],
    B [n, f], c [n] Hermitian accumulators (GLOBAL size — the planner
    divides by p, each model shard owning only its theta rows' systems)."""
    return n * (f * f + f + 1) * dtype_bytes


def _bytes_per_device(m, n, nnz, f, p, q, fill=1.5, dtype_bytes=4, eps=512 << 20,
                      buffers=1, acc_bytes=0):
    terms = {
        "X_batch": m * f * dtype_bytes // q,
        "Theta_shard": n * f * dtype_bytes // p,
        # idx+val, padded; ``buffers`` > 1 models the §4.4 preload buffers an
        # out-of-core run keeps resident (current shard + prefetched next ones)
        "R_shard": int(2 * nnz * dtype_bytes * fill) // (p * q) * buffers,
        "A_batch": m * f * f * dtype_bytes // q,
        "B_batch": m * f * dtype_bytes // q,
        "eps": eps,
    }
    if acc_bytes:
        # streaming accumulate-Theta residents, p-sharded like Theta
        terms["Herm_acc"] = acc_bytes // p
    return sum(terms.values()), terms


def plan_partitions(
    m: int, n: int, nnz: int, f: int,
    hbm_bytes: Optional[int] = None,
    n_model: int = 16,          # devices on the "model" axis (p candidates)
    n_data: int = 16,           # devices on the "data" axis (q waves base)
    fill: float = 1.5,
    dtype_bytes: int = 4,
    eps: int = 512 << 20,
) -> PartitionPlan:
    """Choose (p, q) per paper §4.3 for the given problem and devices."""
    hbm_bytes = device_memory_bytes(hbm_bytes)

    def fits(p, q):
        total, terms = _bytes_per_device(m, n, nnz, f, p, q, fill, dtype_bytes, eps)
        return total < hbm_bytes, total, terms

    # Best practice 1/2: smallest q with p=1, if Theta fits a device.
    if n * f * dtype_bytes + eps < hbm_bytes // 2:
        p = 1
        q = 1
        while True:
            ok, total, terms = fits(p, q)
            if ok:
                waves = -(-q // n_data)
                return PartitionPlan(p, q, total, terms, True, waves)
            q *= 2
            if q > 1 << 24:
                break

    # Best practice 3: p so that Theta shard ~ C/2, then smallest q.
    p = 1
    while n * f * dtype_bytes / p > hbm_bytes / 2 and p < n_model:
        p *= 2
    p = min(p, n_model)
    q = 1
    while q <= 1 << 24:
        ok, total, terms = fits(p, q)
        if ok:
            waves = -(-q // n_data)
            return PartitionPlan(p, q, total, terms, True, waves)
        q *= 2
    total, terms = _bytes_per_device(m, n, nnz, f, p, q, fill, dtype_bytes, eps)
    return PartitionPlan(p, q, total, terms, False, -(-q // n_data))


def plan_for(
    m: int, n: int, nnz: int, f: int,
    p: int, q: int,
    *,
    n_data: int = 16,
    hbm_bytes: Optional[int] = None,
    fill: float = 1.5,
    dtype_bytes: int = 4,
    eps: int = 512 << 20,
    buffers: int = 1,
    acc_bytes: int = 0,
    bin_fills: Optional[Sequence[Tuple[int, int]]] = None,
    auto: bool = False,
    degrees=None,
    tune_cache=None,
    k_multiple: int = 8,
) -> PartitionPlan:
    """Cost a *given* (p, q) choice — the forced-plan entry point.

    ``buffers`` counts how many R-shard buffers stay device-resident at
    once: 1 is the in-core bound of eq. (8), an out-of-core run prefetching
    ``depth`` shards ahead needs ``depth + 2`` (queued, loader-held,
    consumed).  ``acc_bytes`` prices the streaming accumulate-Theta
    residents (``streaming_acc_bytes(n, f)``) as their own p-sharded term.
    ``bin_fills`` prices a degree-binned layout: per-bin ``(padded_slots,
    nnz)`` pairs (``RatingStore.bin_fill_pairs()``) whose aggregate
    ``sum(slots) / sum(nnz)`` overrides the scalar ``fill``.

    ``auto=True`` derives ``bin_fills`` itself: ``degrees`` (the per-row
    nnz counts) is swept through ``core.autotune.tune_plan_fills`` — the
    argmin of padded slots over the (n_bins, k_multiple) ladder, cached in
    ``tune_cache`` — and the winning rung's per-bin pairs price R_shard.
    """
    hbm_bytes = device_memory_bytes(hbm_bytes)
    if auto:
        from repro_torch.core import autotune

        if degrees is None:
            raise ValueError("plan_for(auto=True) needs degrees= (per-row nnz counts)")
        res = autotune.tune_plan_fills(m, n, nnz, f, p, q, degrees=degrees,
                                       k_multiple=k_multiple, cache=tune_cache)
        want = res.config.to_obj()
        bin_fills = next(c["bin_fills"] for c in res.candidates
                         if c["config"] == want)
    if bin_fills:
        slots = sum(int(s) for s, _ in bin_fills)
        true_nnz = sum(int(z) for _, z in bin_fills)
        fill = slots / max(true_nnz, 1)
    total, terms = _bytes_per_device(
        m, n, nnz, f, p, q, fill, dtype_bytes, eps, buffers, acc_bytes)
    return PartitionPlan(p, q, total, terms, total < hbm_bytes, -(-q // n_data))


# ---------------------------------------------------------------------------
# Schedule export: the planner's (q, waves) turned into explicit row ranges.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QBatch:
    """One of the q X-row batches (the §4.4 streaming unit)."""

    index: int       # global batch number in [0, q)
    row_start: int   # first X row of the batch (inclusive)
    row_stop: int    # one past the last X row (exclusive)

    @property
    def rows(self) -> int:
        return self.row_stop - self.row_start


def batch_ranges(m: int, q: int) -> Tuple[QBatch, ...]:
    """Split ``m`` rows into ``q`` balanced contiguous batches: sizes differ
    by at most one row and every row lands in exactly one batch."""
    if m < 0 or q < 1:
        raise ValueError(f"need m >= 0 and q >= 1, got m={m} q={q}")
    base, rem = divmod(m, q)
    out = []
    start = 0
    for b in range(q):
        size = base + (1 if b < rem else 0)
        out.append(QBatch(index=b, row_start=start, row_stop=start + size))
        start += size
    return tuple(out)


def export_schedule(
    plan: PartitionPlan, m: int, n_data: Optional[int] = None,
) -> Tuple[Tuple[QBatch, ...], ...]:
    """Explicit per-iteration wave schedule for a plan's q batches.

    Wave ``w`` streams batches ``[w * n_data, min((w+1) * n_data, q))``;
    ``len(waves) == plan.waves`` when ``n_data`` matches the axis size the
    plan was computed for (the default reconstructs it from
    ``plan.waves``).
    """
    q = plan.q
    if n_data is None:
        n_data = -(-q // plan.waves)
    if n_data < 1:
        raise ValueError(f"n_data={n_data} must be >= 1")
    batches = batch_ranges(m, q)
    n_waves = -(-q // n_data)
    return tuple(
        batches[w * n_data:(w + 1) * n_data] for w in range(n_waves))
