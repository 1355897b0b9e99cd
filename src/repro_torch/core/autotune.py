"""Layout autotuner: cuMF Algorithm-2 sweep over the binning knobs — the
port's copy of the reference's ``repro/core/autotune.py``.

cuMF tunes its tile sizes by *measuring* a ladder of candidates and keeping
the argmin (Alg. 2 "try the ladder, keep the argmin"); Tan 1808.03843
generalizes the same loop into autotuned memory-optimized layouts.  The
knobs swept here are the ones the degree-binned layouts leave to the
caller:

- ALS streaming: ``n_bins`` (degree bins per orientation) and the bin
  ``k_multiple`` (ELL lane rounding of each bin's K),
- SGD blocking: ``per_tile_k`` / ``degree_sort`` on the ``BlockGrid``.

The default mode is **analytic**: each candidate is priced by the exact
per-iteration streamed bytes the planner/schedule layer would predict for
it — the same integers ``predicted_stream_stats`` derives from a real
``RatingStore``, computed here from degree vectors alone so no candidate
store is built.  The pricing is numpy and equals the reference's to the
byte, the p > 1 (stacked-bin) pricing included.  The optional **measured**
mode builds each candidate's store and times one real solve-X wave on a
device (``core.als.update_rows{,_binned}`` in that device's default mode,
so the two ALS kernels on the card) inside an ``obs`` phase of category
``autotune``, and scores by seconds instead of bytes.

Winners are cached in a JSON :class:`TuneCache` keyed by (shape bucket,
degree-skew quantiles, topology, backend) and stamped with provenance, so
repeated runs of the same problem class skip the sweep; a shape or skew
change misses the key and re-tunes.  The schema string is the reference's,
byte for byte, so each package reads the other's cache; the backend field
is ``"cuda"`` or ``"cpu"`` where the reference has JAX's backend name (an
analytic sweep's whether the host has a card, a measured sweep's the
device type it timed), and provenance records ``torch`` where it records
``jax``.

Wired through the stack: ``plan_for(auto=True, degrees=...)``,
``RatingStore(n_bins="auto")`` and ``block_ell(per_tile_k="auto")``
consult the cache, and the streaming drivers record the chosen config and
the cache hit or miss in the ledger's run context.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.backend import DeviceLike, resolve_device
from repro_torch.core.partition import GiB, plan_for
from repro_torch.sparse.padded import bin_caps, round_k

TUNECACHE_SCHEMA = "repro.core/tunecache-v1"

#: default ALS sweep ladder: bin counts x bin lane multiples (n_bins = 1 is
#: the unbinned baseline, where the lane multiple is inert)
ALS_N_BINS_LADDER: Tuple[int, ...] = (1, 2, 4, 8)
#: default SGD sweep ladder: (per_tile_k, degree_sort) — sorted-without-
#: per-tile-K is pointless (sorting only changes which tiles get a small K)
SGD_LADDER: Tuple[Tuple[bool, bool], ...] = (
    (False, False), (True, False), (True, True))

#: the budget a candidate is priced against: only ``fits`` depends on it,
#: and a candidate records its eq. (8) bytes, not whether they fit (the
#: reference planner's default budget)
_PRICING_HBM_BYTES = 16 * GiB


@dataclasses.dataclass(frozen=True)
class LayoutConfig:
    """One rung of the sweep ladder."""

    n_bins: int = 1
    k_multiple: int = 8
    per_tile_k: bool = False
    degree_sort: bool = False

    def to_obj(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: dict) -> "LayoutConfig":
        return cls(**{k: obj[k] for k in
                      ("n_bins", "k_multiple", "per_tile_k", "degree_sort")
                      if k in obj})


@dataclasses.dataclass
class TuneResult:
    """Outcome of one sweep (or one cache hit)."""

    config: LayoutConfig
    score: float             # predicted streamed bytes/iter (analytic),
    #                        # dispatched slots (SGD), or seconds (measured)
    unit: str                # "bytes" | "slots" | "seconds"
    key: str                 # TuneCache key the result lives under
    cache_hit: bool
    mode: str                # "analytic" | "measured"
    candidates: list = dataclasses.field(default_factory=list)
    grid = None              # the SGD sweep's winning grid, never serialized

    def to_obj(self) -> dict:
        """Ledger/JSON form — what the drivers record as run context."""
        return {"config": self.config.to_obj(), "score": self.score,
                "unit": self.unit, "key": self.key,
                "cache_hit": self.cache_hit, "mode": self.mode}


def _backend_tag() -> str:
    """Whether the host has a card: ``"cuda"`` with one, ``"cpu"`` without.
    A tag of the analytic sweeps' keys and of provenance (the reference's
    ``jax.default_backend()``), not a device: a measured sweep tags its key
    with the device it timed."""
    import torch

    on_card = torch.cuda.is_available()
    return "cuda" if on_card else "cpu"  # a tag, not a device  # reprolint: disable=backend-routing


def provenance(backend: Optional[str] = None) -> dict:
    """Cache-entry provenance: commit, time, torch version, backend (by
    default :func:`_backend_tag`)."""
    import datetime

    import torch

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    return {
        "git_sha": sha,
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "torch": torch.__version__,
        "backend": backend or _backend_tag(),
        "schema": TUNECACHE_SCHEMA,
    }


def skew_signature(degrees: np.ndarray) -> str:
    """Degree-skew summary for the cache key: the [0.5, 0.9, 0.99, max]
    quantiles normalized by the mean, rounded to one decimal.  Two problems
    with the same shape bucket and the same (coarse) skew profile bin the
    same way, so they share a tuned config."""
    d = np.asarray(degrees, dtype=np.float64)
    if d.size == 0 or d.max() <= 0:
        return "flat"
    mean = max(d.mean(), 1e-12)
    qs = np.quantile(d, [0.5, 0.9, 0.99, 1.0]) / mean
    return ",".join(f"{v:.1f}" for v in qs)


def tune_key(solver: str, m: int, n: int, nnz: int,
             degrees: np.ndarray, *, p: int = 1, q: int = 1,
             k_multiple: int = 8, backend: Optional[str] = None) -> str:
    """Cache key: (solver, log2 shape buckets, skew quantiles, topology,
    backend).  Shapes are bucketed to the nearest power of two so minor
    size drift hits, while a real scale change (2x) misses and re-tunes."""
    bucket = lambda v: int(round(np.log2(max(int(v), 1))))  # noqa: E731
    return "|".join([
        solver,
        f"m=2^{bucket(m)}", f"n=2^{bucket(n)}", f"nnz=2^{bucket(nnz)}",
        f"skew={skew_signature(degrees)}",
        f"p={int(p)}", f"q={int(q)}", f"km={int(k_multiple)}",
        backend if backend is not None else _backend_tag(),
    ])


class TuneCache:
    """JSON-backed winner cache (``repro.core/tunecache-v1``).

    ``path=None`` keeps the cache in-process only; with a path every
    ``put`` rewrites the file atomically, so the cache survives across
    processes.  Entries carry the winning config, its score, the full
    candidate ladder, and a provenance stamp; ``invalidate()`` drops one
    key (or everything).  A file of another schema reads as empty.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._data = {"schema": TUNECACHE_SCHEMA, "entries": {}}
        if path is not None and os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
            # a schema we don't speak is a miss, not an error
            if data.get("schema") == TUNECACHE_SCHEMA:
                self._data = data

    def __len__(self) -> int:
        return len(self._data["entries"])

    def get(self, key: str) -> Optional[dict]:
        return self._data["entries"].get(key)

    def put(self, key: str, entry: dict) -> dict:
        entry = dict(entry)
        entry.setdefault("provenance", provenance())
        self._data["entries"][key] = entry
        self._flush()
        return entry

    def invalidate(self, key: Optional[str] = None) -> None:
        if key is None:
            self._data["entries"] = {}
        else:
            self._data["entries"].pop(key, None)
        self._flush()

    def _flush(self) -> None:
        if self.path is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._data, fh, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


def _as_cache(cache) -> Optional[TuneCache]:
    if cache is None or isinstance(cache, TuneCache):
        return cache
    return TuneCache(str(cache))


def _hit(cache: Optional[TuneCache], key: str, unit: str) -> Optional[TuneResult]:
    """The cached result under ``key``, or None on a miss."""
    hit = cache.get(key) if cache is not None else None
    if hit is None:
        return None
    return TuneResult(
        config=LayoutConfig.from_obj(hit["config"]), score=hit["score"],
        unit=hit.get("unit", unit), key=key, cache_hit=True,
        mode=hit.get("mode", "analytic"), candidates=hit.get("candidates", []))


# ---------------------------------------------------------------------------
# Analytic pricing: the exact integers a candidate store would stream.
# ---------------------------------------------------------------------------

def _binned_rows_bytes(degrees: np.ndarray, n_bins: int, k_multiple: int,
                       k_parent: int) -> Tuple[int, int]:
    """(bytes, slots) of one orientation's rows binned at (n_bins,
    k_multiple) — mirrors ``bin_padded`` exactly: ~log-spaced caps from the
    max degree, each bin re-padded at ``min(round_k(max member degree),
    k_parent)``, rows streamed as idx+val slots (8 B) plus cnt (4 B)."""
    deg = np.asarray(degrees, dtype=np.int64)
    kmax = int(deg.max()) if deg.size else 0
    caps = bin_caps(kmax, n_bins, k_multiple)
    assign = np.searchsorted(np.asarray(caps, dtype=np.int64),
                             np.maximum(deg, 1), side="left")
    total_bytes = 0
    total_slots = 0
    for b in range(len(caps)):
        sel = assign == b
        rows_b = int(sel.sum())
        if rows_b == 0:
            continue
        kb = min(round_k(int(deg[sel].max()), k_multiple), k_parent)
        total_bytes += rows_b * (kb * 8 + 4)
        total_slots += rows_b * kb
    return total_bytes, total_slots


def _stacked_bytes(deg: np.ndarray, n_bins: int, k_multiple: int,
                   k_parent: int, p: int) -> Tuple[int, int, list]:
    """(bytes, slots, pairs) of a ``[q, n]`` per-batch degree matrix binned
    batch-uniform — the reference's ``sparse.padded.stack_binned_parts``
    layout of a p > 1 store: global caps, per-bin rows = max per-batch
    member count rounded up to p, K = global rounded max member degree.
    ``pairs`` are the per-bin (padded_slots, nnz) the planner prices."""
    q, _n = deg.shape
    kmax = int(deg.max()) if deg.size else 0
    caps = bin_caps(kmax, n_bins, k_multiple)
    assign = np.searchsorted(np.asarray(caps, dtype=np.int64),
                             np.maximum(deg, 1), side="left")
    total_bytes = 0
    total_slots = 0
    pairs = []
    for b in range(len(caps)):
        sel = assign == b                                  # [q, n]
        max_members = int(sel.sum(axis=1).max())
        if max_members == 0:
            continue
        kb = min(round_k(int(deg[sel].max()), k_multiple), k_parent)
        rows_b = -(-max_members // p) * p
        total_bytes += q * rows_b * (kb * 8 + 4)
        total_slots += q * rows_b * kb
        pairs.append((q * rows_b * kb, int(deg[sel].sum())))
    return total_bytes, total_slots, pairs


def _batch_item_degrees(r, q: int) -> np.ndarray:
    """[q, n] per-batch item degrees of a PaddedELL's q balanced row
    batches — the theta-half layout input, one vectorized pass."""
    m_pad = -(-r.m // q) * q
    rows_per = m_pad // q
    k = np.arange(r.K, dtype=np.int32)[None, :]
    live = k < r.cnt[:, None]
    users = np.broadcast_to(
        np.arange(r.m, dtype=np.int64)[:, None], r.idx.shape)[live]
    items = r.idx[live].astype(np.int64)
    deg = np.zeros((q, r.n_cols), dtype=np.int64)
    np.add.at(deg, (users // rows_per, items), 1)
    return deg


def _model_shard_k(r, p: int, k_multiple: int) -> int:
    """K_loc of ``partition_padded(r, p)`` without building the shards."""
    if p == 1:
        return r.K
    npp = r.n_cols // p
    k = np.arange(r.K, dtype=np.int32)[None, :]
    live = k < r.cnt[:, None]
    shard_of = np.where(live, r.idx // npp, -1)
    kmax = 0
    for i in range(p):
        kmax = max(kmax, int((shard_of == i).sum(axis=1).max()))
    return round_k(kmax, k_multiple)


def predicted_als_bytes(r, q: int, cfg: LayoutConfig, *, p: int = 1,
                        f: int = 16,
                        deg_t: Optional[np.ndarray] = None) -> dict:
    """Exact per-iteration streamed bytes of one (r, q, p) problem under
    ``cfg`` — the same totals ``predicted_stream_stats`` sums over a real
    ``RatingStore(n_bins=cfg.n_bins, k_multiple=cfg.k_multiple)``'s
    schedule.  ``deg_t`` (the ``[q, n]`` per-batch item degrees) can be
    passed in so a sweep computes it once."""
    km = cfg.k_multiple
    m_pad = -(-r.m // q) * q
    pad_deg = np.zeros(m_pad, dtype=np.int64)
    pad_deg[:r.m] = r.cnt
    if deg_t is None:
        deg_t = _batch_item_degrees(r, q)
    k_loc_t = round_k(int(deg_t.max()) if deg_t.size else 0, km)
    bin_fills = None
    # solve-X half
    if p > 1:
        k_model = _model_shard_k(r, p, km)
        x_bytes = m_pad * p * (k_model * 8 + 4)
        x_slots = m_pad * p * k_model
    elif cfg.n_bins > 1:
        x_bytes, x_slots = _binned_rows_bytes(pad_deg, cfg.n_bins, km, r.K)
    else:
        x_bytes, x_slots = m_pad * (r.K * 8 + 4), m_pad * r.K
    # accumulate-Theta half (+ the config-independent fresh X slices)
    if cfg.n_bins > 1 and p > 1:
        t_bytes, t_slots, bin_fills = _stacked_bytes(
            deg_t, cfg.n_bins, km, k_loc_t, p)
    elif cfg.n_bins > 1:
        t_bytes = t_slots = 0
        bin_fills = []
        for j in range(q):
            bj, sj = _binned_rows_bytes(deg_t[j], cfg.n_bins, km, k_loc_t)
            t_bytes += bj
            t_slots += sj
            bin_fills.append((sj, int(deg_t[j].sum())))
    else:
        t_bytes = q * r.n_cols * (k_loc_t * 8 + 4)
        t_slots = q * r.n_cols * k_loc_t
    t_bytes += m_pad * f * 4
    nnz = int(r.cnt.sum())
    return {"bytes": x_bytes + t_bytes, "x_bytes": x_bytes,
            "t_bytes": t_bytes, "slots": x_slots + t_slots,
            "fill": (x_slots + t_slots) / max(2 * nnz, 1),
            "bin_fills": bin_fills}


# ---------------------------------------------------------------------------
# The sweeps.
# ---------------------------------------------------------------------------

def als_ladder(k_multiple: int = 8,
               n_bins_ladder: Sequence[int] = ALS_N_BINS_LADDER
               ) -> list[LayoutConfig]:
    """Default ALS candidate ladder: the unbinned baseline, then every
    (n_bins, lane multiple) rung — the lane multiple only matters once
    binning re-rounds each bin's K, so n_bins = 1 carries just the base."""
    out = [LayoutConfig(n_bins=1, k_multiple=k_multiple)]
    for nb in n_bins_ladder:
        if nb <= 1:
            continue
        for km in (k_multiple, 2 * k_multiple):
            out.append(LayoutConfig(n_bins=nb, k_multiple=km))
    return out


def tune_als_layout(r, q: int, *, p: int = 1, f: int = 16,
                    k_multiple: int = 8,
                    ladder: Optional[Sequence[LayoutConfig]] = None,
                    cache=None, mode: str = "analytic",
                    device: DeviceLike = None,
                    tracer=None, registry=None) -> TuneResult:
    """Alg.-2 sweep over the ALS layout ladder for one (r, q, p) problem.

    Analytic mode prices every rung by :func:`predicted_als_bytes` (plus
    the eq. (8) device bytes of ``plan_for(bin_fills=...)`` carried per
    candidate) and keeps the argmin of predicted streamed bytes per
    iteration, ties broken toward fewer bins.  Measured mode also times one
    real solve-X wave per candidate on ``device`` (the card unless the
    caller names the CPU) and keeps the argmin of seconds.  The winner is
    cached under :func:`tune_key`; a hit skips the sweep entirely.  A
    measured winner's key and provenance name the device type it was timed
    on, so seconds from the CPU never answer a sweep on the card.
    """
    if mode not in ("analytic", "measured"):
        raise ValueError(f"unknown mode {mode!r}")
    cache = _as_cache(cache)
    nnz = int(r.cnt.sum())
    timed_on = resolve_device(device).type if mode == "measured" else None
    key = tune_key("als", r.m, r.n_cols, nnz, r.cnt, p=p, q=q,
                   k_multiple=k_multiple, backend=timed_on)
    hit = _hit(cache, key, "bytes")
    if hit is not None:
        return hit
    from repro_torch.obs.trace import phase

    ladder = list(ladder) if ladder is not None else als_ladder(k_multiple)
    deg_t = _batch_item_degrees(r, q)
    candidates = []
    for cfg in ladder:
        with phase("autotune.candidate", cat="autotune", tracer=tracer,
                   registry=registry, solver="als", n_bins=cfg.n_bins,
                   k_multiple=cfg.k_multiple):
            priced = predicted_als_bytes(r, q, cfg, p=p, f=f, deg_t=deg_t)
            plan = plan_for(r.m, r.n_cols, nnz, f, p, q,
                            hbm_bytes=_PRICING_HBM_BYTES,
                            fill=priced["fill"],
                            bin_fills=priced["bin_fills"])
            cand = {"config": cfg.to_obj(), "score": priced["bytes"],
                    "unit": "bytes", "fill": priced["fill"],
                    "bytes_per_device": plan.bytes_per_device}
            if mode == "measured":
                cand["seconds"] = _measure_als_candidate(
                    r, q, cfg, f=f, device=device, tracer=tracer,
                    registry=registry)
            candidates.append(cand)
    score_of = ((lambda c: (c["seconds"], c["config"]["n_bins"]))
                if mode == "measured"
                else (lambda c: (c["score"], c["config"]["n_bins"])))
    best = min(candidates, key=score_of)
    result = TuneResult(
        config=LayoutConfig.from_obj(best["config"]),
        score=best["seconds"] if mode == "measured" else best["score"],
        unit="seconds" if mode == "measured" else "bytes",
        key=key, cache_hit=False, mode=mode, candidates=candidates)
    if cache is not None:
        entry = {"config": result.config.to_obj(), "score": result.score,
                 "unit": result.unit, "mode": mode, "candidates": candidates}
        if timed_on is not None:
            entry["provenance"] = provenance(timed_on)
        cache.put(key, entry)
    return result


def _measure_als_candidate(r, q: int, cfg: LayoutConfig, *, f: int,
                           device: DeviceLike = None,
                           tracer=None, registry=None) -> float:
    """Measured rung: build the candidate store and time ONE real solve-X
    wave (wave 0's rows through the binned or uniform row update, from a
    zero Theta) on ``device``.  The time is the ``autotune`` phase's own
    delta in the registry; on the card the span ends at a stream
    synchronise, so it covers the wave's kernels, not only their launch."""
    import torch

    from repro_torch.core import als as als_mod
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import phase
    from repro_torch.outofcore.store import RatingStore

    dev = resolve_device(device)
    reg = registry if registry is not None else MetricsRegistry()
    store = RatingStore(r, q=q, k_multiple=cfg.k_multiple, n_bins=cfg.n_bins)
    acfg = als_mod.AlsConfig(f=f, lam=0.05, iters=1, device=str(dev))
    theta = torch.zeros((store.n, f), dtype=torch.float32, device=dev)
    rows_per = store.m_pad // q
    before = reg.phase_seconds().get("autotune", 0.0)
    with phase("autotune.measure_wave", cat="autotune", tracer=tracer,
               registry=reg, n_bins=cfg.n_bins, k_multiple=cfg.k_multiple):
        if cfg.n_bins > 1:
            als_mod.update_rows_binned(theta, store.x_slice_binned(0, rows_per),
                                       acfg)
        else:
            idx, val, cnt = store.x_slice_triplet(0, rows_per)
            als_mod.update_rows(theta, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                         for a in (idx, val, cnt)), acfg)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return reg.phase_seconds().get("autotune", 0.0) - before


def tune_sgd_layout(ell, g: int, *, k_multiple: int = 8,
                    ladder: Optional[Sequence[Tuple[bool, bool]]] = None,
                    cache=None, tracer=None, registry=None) -> TuneResult:
    """Alg.-2 sweep over the SGD blocking ladder for one (ell, g) problem.

    Builds each rung's ``BlockGrid`` and scores the slots its kernels
    actually dispatch (``grid.padded_slots`` — per-tile K respected), the
    exact quantity the streaming SGD ledger measures.  The winning grid
    rides back on ``TuneResult.grid`` so ``block_coo(per_tile_k="auto")``
    does not build it twice; cache hits return the config only (the caller
    rebuilds)."""
    from repro_torch.obs.trace import phase
    from repro_torch.sgd.blocking import block_ell

    cache = _as_cache(cache)
    nnz = int(ell.cnt.sum())
    key = tune_key("sgd", ell.m, ell.n_cols, nnz, ell.cnt, q=g,
                   k_multiple=k_multiple)
    hit = _hit(cache, key, "slots")
    if hit is not None:
        return hit
    ladder = list(ladder) if ladder is not None else list(SGD_LADDER)
    candidates = []
    grids = {}
    for ptk, dsort in ladder:
        cfg = LayoutConfig(k_multiple=k_multiple, per_tile_k=ptk,
                           degree_sort=dsort)
        with phase("autotune.candidate", cat="autotune", tracer=tracer,
                   registry=registry, solver="sgd", per_tile_k=ptk,
                   degree_sort=dsort):
            grid = block_ell(ell, g, k_multiple=k_multiple,
                             per_tile_k=ptk, degree_sort=dsort)
        grids[(ptk, dsort)] = grid
        candidates.append({"config": cfg.to_obj(),
                           "score": int(grid.padded_slots),
                           "unit": "slots", "fill": grid.fill})
    best = min(candidates,
               key=lambda c: (c["score"], c["config"]["per_tile_k"],
                              c["config"]["degree_sort"]))
    cfg = LayoutConfig.from_obj(best["config"])
    result = TuneResult(config=cfg, score=best["score"], unit="slots",
                        key=key, cache_hit=False, mode="analytic",
                        candidates=candidates)
    result.grid = grids[(cfg.per_tile_k, cfg.degree_sort)]
    if cache is not None:
        cache.put(key, {"config": cfg.to_obj(), "score": best["score"],
                        "unit": "slots", "mode": "analytic",
                        "candidates": candidates})
    return result


def tune_plan_fills(m: int, n: int, nnz: int, f: int, p: int, q: int, *,
                    degrees, k_multiple: int = 8, cache=None) -> TuneResult:
    """Degree-summary sweep behind ``plan_for(auto=True)``: with only a
    row-degree vector (no index data), bin the rows over the ladder, keep
    the argmin of padded slots, and hand back the winner's per-bin
    ``(slots, nnz)`` pairs as ``TuneResult.candidates[...]["bin_fills"]``
    for the planner's R_shard pricing.  Cached like the full sweeps."""
    cache = _as_cache(cache)
    deg = np.asarray(degrees, dtype=np.int64)
    key = tune_key("plan", m, n, nnz, deg, p=p, q=q, k_multiple=k_multiple)
    hit = _hit(cache, key, "slots")
    if hit is not None:
        return hit
    k_parent = round_k(int(deg.max()) if deg.size else 0, k_multiple)
    candidates = []
    for cfg in als_ladder(k_multiple):
        caps = bin_caps(k_parent, cfg.n_bins, cfg.k_multiple)
        assign = np.searchsorted(np.asarray(caps, dtype=np.int64),
                                 np.maximum(deg, 1), side="left")
        pairs = []
        for b in range(len(caps)):
            sel = assign == b
            rows_b = int(sel.sum())
            if rows_b == 0:
                continue
            kb = min(round_k(int(deg[sel].max()), cfg.k_multiple), k_parent)
            pairs.append((rows_b * kb, int(deg[sel].sum())))
        candidates.append({"config": cfg.to_obj(),
                           "score": sum(s for s, _ in pairs),
                           "unit": "slots", "bin_fills": pairs})
    best = min(candidates,
               key=lambda c: (c["score"], c["config"]["n_bins"]))
    result = TuneResult(config=LayoutConfig.from_obj(best["config"]),
                        score=best["score"], unit="slots", key=key,
                        cache_hit=False, mode="analytic",
                        candidates=candidates)
    if cache is not None:
        cache.put(key, {"config": result.config.to_obj(),
                        "score": result.score, "unit": "slots",
                        "mode": "analytic", "candidates": candidates})
    return result
