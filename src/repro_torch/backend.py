"""Device and kernel-mode selection (the reference's ``compat.py`` role and
``kernels/ops.default_mode``).

There is no probe-and-fallback: asking for CUDA on a machine without a
GPU raises.  The CPU is used only when the caller names it, and so is
``"meta"`` (shapes and dtypes without storage: the dry-run's cells).
"""
from __future__ import annotations

from typing import Literal, Optional, Union

import torch

Mode = Literal["kernel", "ref"]
DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  A CUDA device without a GPU raises;
    ``"cpu"`` and ``"meta"`` only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_mode(device: DeviceLike = None) -> Mode:
    """``"kernel"`` on CUDA; ``"ref"`` (the plain version) on the CPU and
    on meta (no kernel runs without storage)."""
    return "kernel" if resolve_device(device).type == "cuda" else "ref"
