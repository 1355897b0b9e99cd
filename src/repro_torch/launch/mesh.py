"""Meshes of cells for the single-controller multi-device path.

A :class:`Mesh` names its axes with the reference's conventions and puts
one ``torch.device`` on each cell; one host program drives every cell, as
cuMF drives the cards of one machine.  Axis roles:

- ``"data"``  — cuMF's q (X row shards, solved independently);
- ``"model"`` — cuMF's p (Theta column shards: partial Hermitians);
- ``"pod"``   — more column shards, across the slow link of the
  two-phase topology-aware reduction.

Cells may share a card: ``make_mesh((2, 2), ("data", "model"),
devices=["cuda:0"] * 4)`` runs four cells one after another on one H100,
which checks the path and counts its launches but measures no scaling.

:func:`make_production_mesh` is the deployment the dry-run tools
(``launch/dryrun.py``, ``benchmarks_torch/roofline.py``) size cells for:
H100 nodes of 8 cards (the reference's TPU v5e pod keeps its cell counts,
256 and 512, so every per-cell batch shape stays integral).  Its cells are
``meta`` devices: shapes and dtypes, no storage, no card.  The constants
below are that deployment's, the one copy of them in the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.backend import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over an array of devices, one per cell.

    ``devices`` has shape ``tuple(shape[a] for a in axis_names)``; cell
    coordinates index it in ``axis_names`` order.
    """

    axis_names: tuple[str, ...]
    shape: Mapping[str, int]
    devices: np.ndarray              # object array of torch.device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The first cell's device: where global results are assembled."""
        return self.devices.flat[0]

    @property
    def distinct_devices(self) -> list[torch.device]:
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def device(self, **coords: int) -> torch.device:
        """The device of the cell at ``coords`` (every axis named)."""
        return self.devices[tuple(coords[a] for a in self.axis_names)]

    def describe(self) -> str:
        axes = " x ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        devs = ", ".join(str(d) for d in self.distinct_devices)
        return f"mesh[{axes}] on {len(self.distinct_devices)} device(s) ({devs})"


def _normalize(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.

    Without ``devices`` each cell gets its own card (``cuda:0``, ``cuda:1``,
    ...), and fewer cards than cells raises.  Cells share a card only when
    the caller says so (``devices=["cuda:0"] * 4``); ``devices=["cpu"] *
    n`` runs the mesh on the CPU.  ``devices`` lists one device per cell,
    in row-major order of ``shape``.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} do not match")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    n = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} cards, {count} are available; pass "
                f"devices=['cuda:0'] * {n} to share one card, or ['cpu'] * {n}")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = _normalize(d)
    return Mesh(axis_names=axes, shape=dict(zip(axes, shape)),
                devices=arr.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The H100 deployment: 32 nodes of 8 cards (data=32 x model=8, 256
    cells), or two such clusters (pod=2 x data=32 x model=8, 512 cells).

    Axis roles (the reference's ``make_production_mesh``):
      "model" — TP/EP/SP for LMs, cuMF's p for ALS: the 8 cards of a node,
                over NVLink (:data:`NVLINK_BW`);
      "data"  — DP/FSDP for LMs, cuMF's q for ALS: across nodes, one
                400 Gb/s InfiniBand port a card (:data:`IB_BW`);
      "pod"   — another DP replica set for LMs, more column shards and the
                slow phase of the two-phase reduction for ALS: across
                clusters, over the same ports.

    Every cell is a ``meta`` device: the dry-run needs no card."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


# The H100 deployment's figures (NVIDIA H100 SXM5 and DGX H100 data sheets,
# dense rates at 700 W): the per-cell budget and the roofline's peaks and
# links.  A card run below 700 W is slower than these.
HBM_BYTES = 80e9              # 80 GB of HBM3 a card
PEAK_BF16_FLOPS = 989.4e12    # bf16 on the tensor cores, dense
PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s of HBM3
NVLINK_BW = 450e9             # bytes/s each way (NVLink 4, 900 GB/s total): "model"
IB_BW = 50e9                  # bytes/s each way, one ConnectX-7 NDR 400 Gb/s port a card:
                              # "data" and "pod"

#: each mesh axis's link, bytes/s each way
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}
