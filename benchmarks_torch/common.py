"""Shared bench utilities: timing, CSV emission, and the card's published
figures that the modelled rows use."""
from __future__ import annotations

import time

import torch

# NVIDIA H100 SXM5 80GB, NVIDIA's data sheet (dense rates, 700 W board
# power): the figures every modelled row prices against, kept with the
# deployment mesh in ``repro_torch.launch.mesh``.  A card run below 700 W
# (``nvidia-smi --query-gpu=power.limit``) is slower than these.
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,  # noqa: F401
                                     PEAK_BF16_FLOPS, PEAK_FP32_FLOPS)

# The slow link of the two-level reduction is modelled, not measured: a
# PCIe Gen 5 x16 link between hosts' switches, 64 GB/s each way (PCI-SIG:
# 32 GT/s x 16 lanes, 128b/130b coding).
PCIE5_X16_BW = 64e9


def _on_cuda(obj) -> bool:
    """Whether ``obj`` (a tensor, or tuples/lists/dicts of them) holds a
    CUDA tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (tuple, list)):
        return any(_on_cuda(o) for o in obj)
    if isinstance(obj, dict):
        return any(_on_cuda(o) for o in obj.values())
    return False


def time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median time per call in microseconds.

    When the arguments or the result lie on the card, each call is timed
    between two ``torch.cuda.Event``s, after a synchronise that ends the
    warm-up; on the CPU the host clock times each call."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_cuda(args) or _on_cuda(out):
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, stop in pairs:
            start.record()
            fn(*args)
            stop.record()
        torch.cuda.synchronize()
        times = sorted(start.elapsed_time(stop) * 1e3 for start, stop in pairs)
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
    return times[len(times) // 2]


def sync(device) -> None:
    """Wait for the card's queue when ``device`` is a CUDA device, so a
    host clock read afterwards covers the device work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def emit(name: str, us: float, derived: str):
    print(f"{name},{us:.1f},{derived}", flush=True)
