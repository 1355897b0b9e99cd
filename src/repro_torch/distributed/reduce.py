"""Topology-aware staged reduction for host-combined partial sums (§4.2),
the port's copy of the reference's ``repro/distributed/reduce.py``.

``distributed.collectives`` reduces per-cell tensors on the mesh's
devices.  The streaming drivers need the same scheme one level up: each
data shard accumulates its own partial Hermitians across waves, and the
host combines the per-shard partials once per half-iteration — the
explicitly scheduled reduction of the paper's Fig. 5, where the host
drives which link carries which partial when.

``topology_reduce`` executes that schedule deterministically:

- **stage 1 (intra-group ring)**: within each fast domain (a PCIe switch,
  an NVLink island) the members' partials are folded in ascending device
  order — no traffic leaves the domain;
- **stage 2 (inter-group tree)**: the group partials are combined in
  pairwise tree rounds (ascending group order), so each slow link crosses
  once per round with already-reduced data — the paper's
  intra-socket-then-inter-socket scheme.

All arithmetic is float64.  The partials the drivers feed in are float32
device results; a float64 sum of float32 summands is exact (hence
association-independent) as long as their exponent spread stays under the
~29 binades of f64 headroom — the regime of same-matrix Hermitian
partials.  That is what makes the scheme testably correct:
``topology_reduce`` matches ``allreduce_oracle`` (the naive flat fold) bit
for bit, for any grouping.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Declared fast-domain grouping of the devices on a reduction axis.

    ``groups[s]`` holds the device ids sharing fast links.  Groups must be
    disjoint and cover ``0..n_devices-1``; order within a group is
    normalized to ascending so the reduction schedule depends only on the
    declared topology, never on how the caller spelled it.
    """

    groups: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        norm = tuple(tuple(sorted(int(d) for d in g)) for g in self.groups)
        object.__setattr__(self, "groups", norm)
        flat = [d for g in norm for d in g]
        if not flat:
            raise ValueError("topology must contain at least one device")
        if sorted(flat) != list(range(len(flat))):
            raise ValueError(f"groups must disjointly cover 0..n-1, got {norm}")

    @property
    def n_devices(self) -> int:
        return sum(len(g) for g in self.groups)

    def describe(self) -> str:
        return "topology[" + " | ".join(
            ",".join(str(d) for d in g) for g in self.groups) + "]"


def linear_topology(n_devices: int, group_size: int = 2) -> DeviceTopology:
    """Consecutive device ids grouped into fast domains of ``group_size``
    (the paper's machine: 2 GPUs per PCIe switch, 2 switches per node)."""
    if n_devices < 1 or group_size < 1:
        raise ValueError(f"need n_devices >= 1 and group_size >= 1, got "
                         f"{n_devices}, {group_size}")
    return DeviceTopology(tuple(
        tuple(range(s, min(s + group_size, n_devices)))
        for s in range(0, n_devices, group_size)))


def allreduce_oracle(parts: Sequence[np.ndarray]) -> np.ndarray:
    """The naive all-reduce: one flat left fold over ascending device ids,
    in float64 — what ``topology_reduce`` is validated against."""
    out = np.asarray(parts[0], np.float64).copy()
    for part in parts[1:]:
        out += np.asarray(part, np.float64)
    return out


def topology_reduce(parts: Sequence[np.ndarray],
                    topo: DeviceTopology | None = None,
                    tracer=None) -> np.ndarray:
    """Staged ring/tree reduction of per-device partials (float64).

    ``parts[d]`` is device ``d``'s partial.  ``topo`` defaults to one flat
    group (pure ring).  The schedule is a pure function of the topology, so
    repeated runs are bit-identical.

    With ``tracer`` set (an enabled ``obs.Tracer``) each stage records a
    ``reduce`` span tagged with the bytes it moves and which link class
    carries them — the ring stage with its fast-domain traffic, every tree
    round with its slow-link crossings.
    """
    if topo is None:
        topo = linear_topology(len(parts), group_size=len(parts))
    if topo.n_devices != len(parts):
        raise ValueError(f"{topo.describe()} has {topo.n_devices} devices, "
                         f"got {len(parts)} partials")
    traced = tracer is not None and getattr(tracer, "enabled", False)
    nbytes = int(np.asarray(parts[0]).nbytes)
    traffic = reduce_traffic(nbytes, topo) if traced else None
    # stage 1: intra-group ring — ascending fold inside each fast domain
    if traced:
        with tracer.span("reduce.ring", cat="reduce", stage="ring",
                         link="fast", groups=len(topo.groups),
                         bytes=traffic["fast_link_bytes"]):
            stage = [allreduce_oracle([parts[d] for d in g])
                     for g in topo.groups]
    else:
        stage = [allreduce_oracle([parts[d] for d in g])
                 for g in topo.groups]
    # stage 2: inter-group tree — pairwise rounds over group partials
    rnd = 0
    while len(stage) > 1:
        rnd += 1
        nxt = []
        if traced:
            pairs = len(stage) // 2
            with tracer.span("reduce.tree", cat="reduce", stage="tree",
                             link="slow", round=rnd,
                             bytes=nbytes * pairs):
                for i in range(0, len(stage) - 1, 2):
                    nxt.append(stage[i] + stage[i + 1])
        else:
            for i in range(0, len(stage) - 1, 2):
                nxt.append(stage[i] + stage[i + 1])
        if len(stage) % 2:
            nxt.append(stage[-1])
        stage = nxt
    return stage[0]


def reduce_traffic(nbytes: int, topo: DeviceTopology) -> dict:
    """Analytic per-stage traffic of one ``topology_reduce`` for an
    ``nbytes`` partial, next to the flat all-reduce it replaces.

    Ring stage: the fold inside a fast domain of size k moves k-1 full
    partials over fast links only.  Tree stage: one already-reduced
    ``nbytes`` partial crosses a slow link per surviving pair and round —
    G-1 crossings in all for G domains.  The flat scheme instead moves D-1
    full partials across whatever link is in the way (a single flat domain
    makes the staged and flat schemes identical, so their counts coincide).
    """
    groups = topo.groups
    d_total = topo.n_devices
    fast = sum(int(nbytes) * (len(g) - 1) for g in groups)
    slow = int(nbytes) * (len(groups) - 1)
    flat = int(nbytes) * (d_total - 1)
    return {
        "fast_link_bytes": fast,
        "slow_link_bytes": slow,
        "flat_all_links_bytes": flat,
        "slow_link_crossings": len(groups) - 1,
    }
