"""Learning-rate schedules (the reference's ``training/optimizer.py``
``lr_schedule``; its AdamW and Adafactor belong to the LM substrate and
are not ported yet).

The schedule is computed in float32 like the reference's, so a learning
rate handed to a kernel is the same float32 value on both sides (``cos``
may round one ulp apart).
"""
from __future__ import annotations

import math

import torch


def lr_schedule(name: str, step, *, base_lr: float = 1.0,
                total_steps: int = 1000, decay: float | None = None,
                min_lr: float = 0.0) -> torch.Tensor:
    """Learning rate at ``step`` as a float32 scalar tensor.

    - ``constant``:     base_lr
    - ``inverse_time``: base_lr / (1 + decay * step); ``decay`` defaults
      to ``10 / total_steps`` (a 10x+ drop over the horizon)
    - ``cosine``:       min_lr + (base_lr - min_lr) * cos-anneal over
      ``total_steps``, flat at ``min_lr`` afterwards
    """
    t = torch.as_tensor(step, dtype=torch.float32)
    base = torch.full((), base_lr, dtype=torch.float32)
    if name == "constant":
        return base + 0.0 * t
    if name == "inverse_time":
        d = (10.0 / max(total_steps, 1)) if decay is None else decay
        # a true float32 division: ``float / tensor`` would multiply by
        # the reciprocal and round differently
        return torch.div(base, 1.0 + d * t)
    if name == "cosine":
        frac = torch.clamp(t / max(total_steps, 1), 0.0, 1.0)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    raise ValueError(f"unknown lr schedule {name!r}")
