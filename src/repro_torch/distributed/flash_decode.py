"""Flash-decode: single-token attention over a sequence-sharded KV cache
(the reference's ``distributed/flash_decode.py``).

For long-context decode the KV cache is sharded on its *sequence*
dimension over the "model" axis.  Each cell computes a partial softmax
over its local slice — the running max m, the sum of weights l and the
weighted value sum o — and the partials are combined: the max over the
cells, then ``alpha_i = exp(m_i - m)``, then the sums of ``l_i * alpha_i``
and ``o_i * alpha_i`` in ascending cell order, then ``o / max(l, 1e-30)``.
One host program runs each cell's share in ascending cell order, and the
combine is an explicit fold where the reference has ``pmax``/``psum``.

Precision is the reference's mesh arithmetic, not its single-device
decode's: the scores and ``o`` are products at the cache's dtype (a bf16
cache rounds the scores to bf16 before they are widened), the softmax
statistics are float32 (float64 stays float64).  A slice that is wholly
masked gives ``l_i = 0`` and ``alpha_i = 0`` (scores at ``NEG_INF``, never
``-inf``), not NaN.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.cache_update import write_rows
from repro_torch.distributed.collectives import note
from repro_torch.distributed.sharding import Sharded, as_sharded, groups_over
from repro_torch.models.layers import upcast

NEG_INF = -1e30


def _partial_decode(q, k_loc, v_loc, lengths, s_offset, *, window=None):
    """Partial-softmax stats for the local KV slice.

    q [B, H, dh]; k_loc/v_loc [B, S_loc, KV, dh]; lengths [B];
    s_offset: global position of the local slice's start.
    Returns (m [B,KV,G], l [B,KV,G], o [B,KV,G,dh])."""
    b, h, dh = q.shape
    kv = k_loc.shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    sc = upcast(torch.einsum("bkgd,btkd->bkgt", qg.to(k_loc.dtype), k_loc)) * (dh ** -0.5)
    pos = s_offset + torch.arange(k_loc.shape[1], device=q.device)
    msk = pos[None, :] < lengths[:, None]
    if window is not None:
        msk &= pos[None, :] >= (lengths[:, None] - window)
    msk = msk[:, None, None, :]
    sc = torch.where(msk, sc, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.where(msk, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = upcast(torch.einsum("bkgt,btkd->bkgd", p.to(v_loc.dtype), v_loc))
    return m, l, o


def combine(parts, device):
    """The partials ``[(m_i, l_i, o_i), ...]`` of one group of cells, in
    ascending cell order, combined on ``device``: [B, KV, G, dh]."""
    ms = [m.to(device) for m, _, _ in parts]
    m = ms[0]
    for mi in ms[1:]:
        m = torch.maximum(m, mi)
    l = o = None
    for mi, (_, li, oi) in zip(ms, parts):
        alpha = torch.exp(mi - m)
        lw = li.to(device) * alpha
        ow = oi.to(device) * alpha[..., None]
        l, o = (lw, ow) if l is None else (l + lw, o + ow)
    return o / torch.clamp(l, min=1e-30)[..., None]


def decode_cells(q, kc, vc, lengths, *, seq_axis, window, kn=None, vn=None):
    """The per-cell work of both entry points on laid-out inputs
    (:class:`Sharded`): the optional write of ``kn``/``vn``, the partials
    and their combine over ``seq_axis``.  Returns the output's cell
    tensors, laid out as q."""
    mesh = q.mesh
    outs = [None] * mesh.size
    for group in groups_over(mesh, seq_axis):
        parts = []
        for c in group:
            kcc, vcc, ln = kc.cells[c], vc.cells[c], lengths.cells[c]
            off = kc.offset(c, 1)
            if kn is not None:
                pos = ln - off
                ok = (pos >= 0) & (pos < kcc.shape[1])
                write_rows(kcc, kn.cells[c], pos, ok)
                write_rows(vcc, vn.cells[c], pos, ok)
                ln = ln + 1
            parts.append(_partial_decode(q.cells[c], kcc, vcc, ln, off, window=window))
        if seq_axis:                       # each cell's partials to the group's others
            note("all-gather", len(group) * sum(t.numel() * t.element_size() for t in parts[0]),
                 seq_axis, len(group))
        done: dict = {}        # the group's q is one block: one result a device
        for c in group:
            qq = q.cells[c]
            if qq.device not in done:
                done[qq.device] = combine(parts, qq.device).reshape(qq.shape).to(qq.dtype)
            outs[c] = done[qq.device]
    return outs


def flash_decode(q, k_cache, v_cache, lengths, *, mesh, axis="model", window=None):
    """q [B,H,dh] (replicated over ``axis``); caches [B,S,KV,dh] sharded on
    dim 1 over ``axis`` (a :class:`Sharded`, or a tensor laid out here);
    lengths [B].  Returns [B,H,dh] on the mesh's first device."""
    q = as_sharded(q, (None, None, None), mesh)
    kc = as_sharded(k_cache, (None, axis, None, None), mesh)
    vc = as_sharded(v_cache, (None, axis, None, None), mesh)
    ln = as_sharded(lengths, (None,), mesh)
    outs = decode_cells(q, kc, vc, ln, seq_axis=axis, window=window)
    return Sharded(q.spec, q.shape, mesh, outs).unshard()


def flash_decode_update(q, k_cache, v_cache, k_new, v_new, lengths, *, mesh, dp=None,
                        seq_axis="model", kv_axis=None, window=None):
    """Cache write and decode attention, one pass over the cells.

    The caches are [B, S, KV, dh] laid out ``(dp, seq_axis, kv_axis,
    None)``; q [B, H, dh] ``(dp, kv_axis, None)``; k_new / v_new [B, KV,
    dh] ``(dp, kv_axis, None)``; lengths [B] ``(dp,)`` (each a
    :class:`Sharded`, or a tensor laid out here).  Each cell writes the
    rows whose position falls in its slice — in place, into the caches'
    cell tensors — then attends over its slice; the partials are combined
    over ``seq_axis``.  Returns (out :class:`Sharded` [B, H, dh] laid out
    as q, k cache, v cache)."""
    cache_spec = (dp, seq_axis, kv_axis, None)
    q = as_sharded(q, (dp, kv_axis, None), mesh)
    kc = as_sharded(k_cache, cache_spec, mesh)
    vc = as_sharded(v_cache, cache_spec, mesh)
    kn = as_sharded(k_new, (dp, kv_axis, None), mesh)
    vn = as_sharded(v_new, (dp, kv_axis, None), mesh)
    ln = as_sharded(lengths, (dp,), mesh)
    outs = decode_cells(q, kc, vc, ln, seq_axis=seq_axis, window=window, kn=kn, vn=vn)
    return Sharded(q.spec, q.shape, mesh, outs), kc, vc
