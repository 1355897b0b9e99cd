"""Sharded KV-cache writes for decode (the reference's
``distributed/cache_update.py``).

The cache is laid out over the cells with its sequence dim or its KV-head
dim split over a mesh axis, and its batch dim over the data axes or
replicated.  A write is local arithmetic: each cell checks whether the
target position falls inside its slice and writes (or keeps) its rows —
no communication, no replica of the whole cache.  The write is in place,
into the cells' tensors.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import as_sharded


def write_rows(buf, new, pos, ok):
    """``buf[b, pos[b]] = new[b]`` for the rows where ``ok``, in place."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    pos = pos.clamp(0, buf.shape[1] - 1).long()
    okb = ok.view((-1,) + (1,) * (new.dim() - 1))
    buf[rows, pos] = torch.where(okb, new.to(buf.dtype), buf[rows, pos])


def cache_write(kc, kn, lengths, *, mesh=None, dp=None, seq_axis=None, kv_axis=None):
    """Write one token into the cache at per-row ``lengths``.

    kc [B, S, KV, dh]; kn [B, KV, dh]; lengths [B].  Without a mesh, kc is
    a tensor written in place; a position past its end is dropped.  On a
    mesh the layouts are

      - seq_axis: cache sequence dim sharded over that mesh axis,
      - kv_axis:  cache KV-head dim sharded over that mesh axis,
      - dp:       batch axes (or None = replicated batch);

    kc is laid out ``(dp, seq_axis, kv_axis, None)`` (a ``Sharded``, or a
    tensor laid out here), kn ``(dp, kv_axis, None)``, lengths ``(dp,)``.
    Returns the cache.
    """
    if mesh is None:
        at = lengths.long()
        write_rows(kc, kn, at, at < kc.shape[1])
        return kc
    kc = as_sharded(kc, (dp, seq_axis, kv_axis, None), mesh)
    kn = as_sharded(kn, (dp, kv_axis, None), mesh)
    ln = as_sharded(lengths, (dp,), mesh)
    for c in range(mesh.size):
        buf = kc.cells[c]
        pos = ln.cells[c] - kc.offset(c, 1)
        write_rows(buf, kn.cells[c], pos, (pos >= 0) & (pos < buf.shape[1]))
    return kc
