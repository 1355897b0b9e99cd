"""Mixture-of-Experts FFN with sort-based (dropping) dispatch (the
reference's ``models/moe.py``).

Routing: softmax router, top-k experts per token, capacity-bucketed.  Each
token-expert pair takes the next free row of its expert's ``[C, D]``
buffer in token-major order; a pair past the capacity ``C`` is dropped.
Every expert's buffer goes through the expert FFN (``torch.bmm``), and the
kept pairs' outputs are weighted and summed back into token order.

Only the single-device branch is here: the expert-parallel ``mesh`` branch
(experts sharded over "model", one psum) is ROADMAP item 13d.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def router_topk(logits: torch.Tensor, k: int):
    """logits [T, E] -> (weights [T, k] softmaxed over chosen, idx [T, k]).

    The softmax is ``jax.nn.softmax``'s, op by op.  A stable descending
    sort puts the lower expert first among equal gates, as ``lax.top_k``
    does (``torch.topk`` promises no order)."""
    z = L.upcast(logits)
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    gates = e / e.sum(dim=-1, keepdim=True)
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def _dispatch_local(x, w_topk, idx_topk, n_experts_local, e_lo, capacity):
    """Sort-based dispatch of the token-expert pairs routed to experts
    [e_lo, e_lo + n_experts_local).

    x [T, D]; w_topk/idx_topk [T, k] (global expert ids).  A pair's row in
    its expert's bucket is its rank among that expert's pairs in the flat
    token-major [T*k] order (a cumsum of one-hots); pairs at or past
    ``capacity`` are dropped to the overflow row.  Returns (buffers
    [E_loc, C, D] in x's dtype, combine metadata (slot, flat_t, flat_w,
    keep)).  Each kept pair has a row of its own, so the scatter is a plain
    indexed assignment; the dropped pairs all write zeros to the last row."""
    T, D = x.shape
    k = idx_topk.shape[1]
    flat_e = idx_topk.reshape(-1)                       # [T*k]
    flat_w = w_topk.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    local = (flat_e >= e_lo) & (flat_e < e_lo + n_experts_local)
    le = torch.where(local, flat_e - e_lo, n_experts_local)      # overflow bucket
    pos = F.one_hot(le, n_experts_local + 1).cumsum(0) - 1       # [T*k, E_loc+1]
    slot_in_e = pos.gather(1, le[:, None])[:, 0]
    keep = local & (slot_in_e < capacity)
    slot = torch.where(keep, le * capacity + slot_in_e, n_experts_local * capacity)
    buf = torch.zeros((n_experts_local * capacity + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = torch.where(keep[:, None], x[flat_t], 0)
    return (buf[:-1].reshape(n_experts_local, capacity, D),
            (slot, flat_t, flat_w, keep))


def _combine_local(y_buf, meta, T, out_dtype):
    """Expert outputs back to token order with the routing weights, summed
    in float32 over j = 0..k-1 in turn (the reference's scatter-add order;
    an ``index_add_`` on the card would add in no fixed order)."""
    slot, flat_t, flat_w, keep = meta
    E_loc, C, D = y_buf.shape
    acc = L.upcast(y_buf)
    flat = torch.cat([acc.reshape(E_loc * C, D),
                      torch.zeros((1, D), dtype=acc.dtype, device=acc.device)])
    gathered = flat[torch.clamp(slot, max=E_loc * C)]           # [T*k, D]
    contrib = torch.where(keep[:, None], gathered * flat_w[:, None].to(acc.dtype), 0.0)
    contrib = contrib.reshape(T, -1, D)
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out.to(out_dtype)


def moe_ffn(params, x, cfg: MoEConfig, mesh=None):
    """x [B, S, D] -> [B, S, D].  params: router [D,E], w_gate/w_up [E,D,F],
    w_down [E,F,D].  The capacity is the reference's Python arithmetic on
    the token count B*S, so a decode step of B slots routes with its own
    (often 1)."""
    if mesh is not None:
        raise NotImplementedError("an expert-parallel moe_ffn is ROADMAP item 13d (mesh serving)")
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, D)
    logits = xf @ params["router"].to(dt)
    wt, it = router_topk(logits, k)
    capacity = int(cfg.capacity_factor * T * k / E) or 1
    buf, meta = _dispatch_local(xf, wt, it, E, 0, capacity)
    h = torch.bmm(buf, params["w_gate"].to(dt))
    u = torch.bmm(buf, params["w_up"].to(dt))
    y = torch.bmm(L.silu(h) * u, params["w_down"].to(dt))
    return _combine_local(y, meta, T, dt).reshape(B, S, D)


def moe_param_shapes(d_model: int, d_ff: int, cfg: MoEConfig):
    """(shape, logical axes) for every MoE parameter."""
    E = cfg.n_experts
    return {
        "router": ((d_model, E), ("d_model_in", None)),
        "w_gate": ((E, d_model, d_ff), ("experts", "d_model_in", None)),
        "w_up":   ((E, d_model, d_ff), ("experts", "d_model_in", None)),
        "w_down": ((E, d_ff, d_model), ("experts", None, "d_model_in")),
    }
