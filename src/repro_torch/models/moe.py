"""Mixture-of-Experts FFN with sort-based (dropping) dispatch (the
reference's ``models/moe.py``).

Routing: softmax router, top-k experts per token, capacity-bucketed.  Each
token-expert pair takes the next free row of its expert's ``[C, D]``
buffer in token-major order; a pair past the capacity ``C`` is dropped.
Every expert's buffer goes through the expert FFN (``torch.bmm``), and the
kept pairs' outputs are weighted and summed back into token order.

Expert parallelism (``mesh=``): the experts are split over "model", so
each cell holds ``E / tp`` of them; the tokens are split over the data axes
(replicated when the batch does not divide them).  Each cell routes,
dispatches and combines its own tokens into its own experts in float32 —
capacity from its *local* token count, as the reference's — and one
float32 sum over the "model" cells, cast once, gives the output: the
collective of a row-parallel product, no all-to-all.

``fsdp_gather`` (training): the expert weights are split 2D, experts over
"model" and d_model over "data" (the train policy), and each cell gathers
its d_model blocks over "data" just before use, ZeRO-3 style: the router
on axis 0, ``w_gate``/``w_up`` on axis 1, ``w_down`` on axis 2, the dims
whose logical axis :data:`MOE_AXES` names ``d_model_in``
(:func:`moe_ffn_layer`, which the mesh forward runs too;
``distributed.collectives.all_gather_dims``, whose backward is the
reduce-scatter of their gradients).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import all_gather_dims, all_reduce
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


def routed(p, xloc, cfg: MoEConfig, e_lo: int, out_dtype):
    """One cell's share: its tokens xloc [t, D] routed over all E experts,
    dispatched into its own ``p["w_gate"].shape[0]`` experts from ``e_lo``
    on at the capacity of t tokens, combined into [t, D] in ``out_dtype``."""
    dt = xloc.dtype
    E, k = cfg.n_experts, cfg.top_k
    t = xloc.shape[0]
    wt, it = router_topk(xloc @ p["router"].to(dt), k)
    capacity = int(cfg.capacity_factor * t * k / E) or 1
    buf, meta = _dispatch_local(xloc, wt, it, p["w_gate"].shape[0], e_lo, capacity)
    h = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(L.silu(h) * u, p["w_down"].to(dt))
    return _combine_local(y, meta, t, out_dtype)


def moe_ffn(params, x, cfg: MoEConfig, mesh=None, fsdp_gather=False):
    """x [B, S, D] -> [B, S, D].  params: router [D,E], w_gate/w_up [E,D,F],
    w_down [E,F,D].  The capacity is the reference's Python arithmetic on
    the token count B*S, so a decode step of B slots routes with its own
    (often 1).

    ``mesh``: the expert-parallel branch.  ``params`` are tensors or
    ``Sharded`` leaves (router replicated, experts split over "model";
    with ``fsdp_gather`` on a mesh with a "data" axis, their d_model dims
    split over "data" too, gathered before use), ``x`` a tensor; the
    output is a tensor on ``x``'s device.  A mesh without a "model" axis
    of size > 1 runs the single-device arithmetic, as the reference's."""
    B, S, D = x.shape
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if tp == 1:
        return routed(params, x.reshape(B * S, D), cfg, 0, x.dtype).reshape(B, S, D)
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts do not split over model={tp}")
    dp = shd.dp_axes(mesh)
    if B % math.prod(mesh.shape[a] for a in dp):
        dp = None             # replicated batch (e.g. batch=1 decode)
    dp = dp or None
    specs = moe_param_specs(fsdp_gather and "data" in mesh.axis_names)
    p = {n: shd.as_sharded(params[n], specs[n], mesh) for n in specs}
    xs = shd.as_sharded(x, (dp, None, None), mesh)
    out = moe_ffn_layer(p, [t.reshape(-1, D) for t in xs.cells], cfg, mesh, x.dtype)
    return shd.Sharded(xs.spec, xs.shape, mesh,
                       [t.reshape(xs.cells[c].shape) for c, t in enumerate(out)]).unshard(x.device)


def moe_ffn_layer(p, x_cells, cfg: MoEConfig, mesh, dtype, li=None):
    """The expert-parallel branch on laid-out operands: ``p`` the MoE
    leaves as ``Sharded`` (layer ``li`` of layer-stacked ones), experts
    split over "model", each leaf's d_model dims gathered over the axes
    that split them just before use (nothing to gather when none does);
    ``x_cells[c]`` cell c's tokens [t, D].  Returns :func:`moe_ffn_cells`'
    outputs."""
    lead = 0 if li is None else 1
    cells = {n: all_gather_dims(p[n], {d + lead for d in shd.d_model_dims(axes)}, li)
             for n, axes in MOE_AXES.items()}
    return moe_ffn_cells(cells, x_cells, [p["w_gate"].offset(c, lead) for c in range(mesh.size)],
                         cfg, mesh, dtype)


def moe_ffn_cells(p_cells, x_cells, e_offsets, cfg: MoEConfig, mesh, dtype):
    """The expert-parallel branch on laid-out operands: cell c's parameters
    ``{name: p_cells[name][c]}`` (their d_model dims whole), its tokens
    ``x_cells[c]`` [t, D] and its first expert ``e_offsets[c]``.  Each
    cell's float32 share, then one sum over the "model" cells in ascending
    order, cast once to ``dtype``.  Returns the cells' outputs [t, D]."""
    parts = []
    for c, xc in enumerate(x_cells):
        pc = {n: v[c] for n, v in p_cells.items()}
        parts.append(routed(pc, xc, cfg, e_offsets[c], L.upcast(xc).dtype))
    out = [None] * len(parts)
    for group in shd.groups_over(mesh, "model"):
        for c, t in zip(group, all_reduce([parts[c] for c in group], dtype, axes="model")):
            out[c] = t
    return out


#: each MoE leaf's logical axes: experts over "model"; the train policy
#: splits the ``d_model_in`` dims over "data"
MOE_AXES = {
    "router": ("d_model_in", None),
    "w_gate": ("experts", "d_model_in", None),
    "w_up": ("experts", "d_model_in", None),
    "w_down": ("experts", None, "d_model_in"),
}


def moe_param_specs(fsdp: bool = False):
    """The expert-parallel layout of the MoE leaves, the train policy's
    specs of :data:`MOE_AXES` (the reference's ``shard_map`` in_specs): the
    router replicated, the experts split over "model"; ``fsdp``: the
    d_model dims over "data" too."""
    pol = shd.train_policy(None, tp_heads=False, tp_kv=False, fsdp=fsdp)
    return {n: pol.spec(axes) for n, axes in MOE_AXES.items()}


def moe_param_shapes(d_model: int, d_ff: int, cfg: MoEConfig):
    """(shape, logical axes) for every MoE parameter."""
    E = cfg.n_experts
    shapes = {"router": (d_model, E), "w_gate": (E, d_model, d_ff),
              "w_up": (E, d_model, d_ff), "w_down": (E, d_ff, d_model)}
    return {n: (shapes[n], axes) for n, axes in MOE_AXES.items()}
