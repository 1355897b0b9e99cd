"""The decoder's forward on a mesh of cells (the mesh branches of the
reference's ``models/transformer.py`` ``forward``): train, prefill and
decode.

One host program runs each cell's share in ascending cell order; where the
reference's partitioner inserted collectives, the cells' partials are
summed explicitly (``distributed.collectives.all_reduce``: a fold in
ascending "model" order, in float32, cast once).  The layout is the
parameters' own: each leaf is a ``distributed.sharding.Sharded`` (from
``sharding.shard_params`` under the serve policy or its ``mlp_2d``
layout, or under the train policy), and the forward follows its specs:

- the residual stream is split over the data axes by batch rows when they
  divide the batch (replicated otherwise) and replicated over "model";
- a parameter's d_model dims (logical axes ``sharding.D_MODEL_AXES``:
  ``embed_d``, ``d_model_in/out`` and ``attn_din/dout``), which the train
  policy (FSDP) and ``mlp_2d`` split, are gathered over the axes that
  split them just before use, one layer at a time
  (``collectives.all_gather_dims``; ZeRO-3): the backward reduce-scatters
  their gradients.  Under ``remat`` the gather runs inside the layer's
  checkpoint, so the backward gathers again and only one layer's gathered
  weights are held.  A MoE's expert weights are gathered inside
  ``moe.moe_ffn_layer``, the path of ``moe_ffn(fsdp_gather=True)`` (what
  the reference's ``_mlp_forward`` asks of ``moe_ffn`` in train mode);
- q/k/v are column-parallel by head where the policy splits ``wq`` /
  ``wk`` (``tp_heads`` / ``tp_kv``), replicated otherwise; attention is
  local to each cell;
- ``wo`` and the FFN's down projection are row-parallel: each cell's
  partial product, summed over "model";
- the MoE FFN is expert-parallel (``moe.moe_ffn_cells``);
- the embedding and the head are vocab-sharded: each cell looks up the
  tokens of its vocab slice (the others give zeros, so the sum is exact)
  and projects onto its slice; :func:`argmax` picks the lowest index on a
  tie, as ``torch.argmax`` on the whole row;
- decode writes the KV cache in place and attends through
  ``distributed.flash_decode.flash_decode_update``: its sequence split over
  "model" under ``serve_seq_shard``, else its kv heads where the padded kv
  count divides "model" (else the cache is replicated over "model").

Autograd runs through all of it.  A replicated tensor's copies on cells
that share a device are one tensor, so their gradients add there; copies
on distinct devices are distinct tensors, whose gradients the train step
sums (``models.lm.make_train_step``).

The reference's head-sharding constraints on q/k/v and its Megatron-SP
residual layout (the residual split over "model" by sequence between
blocks) are layout hints for its partitioner; here q/k/v are as the
weights make them and the residual stays replicated over "model".

Not on a mesh before ROADMAP item 13g: the ``rglru`` and ``rwkv`` blocks
and a sliding window's ring cache; each raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import all_gather, all_gather_dims, all_reduce
from repro_torch.distributed.cache_update import cache_write
from repro_torch.distributed.flash_decode import decode_cells, flash_decode_update
from repro_torch.distributed.sharding import Sharded
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T

MESH_13G = T._MESH_13G

def check_servable(cfg: ModelConfig) -> None:
    """Raise for an arch the mesh forward does not run."""
    kinds = set(T.layer_pattern(cfg))
    if kinds - {"attn"}:
        raise NotImplementedError(f"{sorted(kinds - {'attn'})} blocks on a mesh are {MESH_13G}")
    if cfg.sliding_window:
        raise NotImplementedError(f"the ring (sliding-window) decode on a mesh is {MESH_13G}")


def gather_dims(cfg: ModelConfig):
    """The parameter tree's d_model dims (``sharding.d_model_dims`` of each
    leaf's logical axes, of its stored, layer-stacked shape), a frozenset a
    leaf of ``transformer.tree_leaves``."""
    def dims(tree):
        if isinstance(tree, dict):
            return {k: dims(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [dims(v) for v in tree]
        return shd.d_model_dims(tree)
    return dims(T.logical_axes_tree(cfg))


def _check_mesh(mesh) -> None:
    extra = set(mesh.axis_names) - {"pod", "data", "model"}
    if extra:
        raise ValueError(f"mesh axes {sorted(extra)}: the LM mesh knows pod, data and model")


def batch_entry(mesh, batch: int):
    """The batch dim's spec entry: the data axes when they divide ``batch``,
    else None (replicated)."""
    dp = shd.dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in dp)
    return dp if dp and batch % n == 0 else None


def cache_spec(cfg: ModelConfig, mesh, batch: int, serve_seq_shard: bool) -> tuple:
    """The KV cache's layout ``(batch, seq, kv, None)`` (the reference's
    ``_attn_forward`` decode branch): the sequence over "model" under
    ``serve_seq_shard``, else the kv heads when ``padded_kv`` divides
    "model", else replicated over "model"."""
    tp_ok = "model" in mesh.axis_names
    seq = "model" if serve_seq_shard and tp_ok else None
    kv = ("model" if tp_ok and not serve_seq_shard
          and cfg.padded_kv % mesh.shape["model"] == 0 else None)
    return (batch_entry(mesh, batch), seq, kv, None)


def init_cache(cfg: ModelConfig, batch: int, smax: int, dtype, mesh,
               serve_seq_shard: bool = False):
    """``transformer.init_cache`` (stacked) laid out on ``mesh``'s cells."""
    check_servable(cfg)
    _check_mesh(mesh)
    spec = (None,) + cache_spec(cfg, mesh, batch, serve_seq_shard)
    shape = (batch, smax, cfg.padded_kv, cfg.d_head)
    return {"blocks": [{str(pi): {n: shd.zeros((repeat,) + shape, spec, mesh, dtype)
                                  for n in ("k", "v")} for pi in range(len(pattern))}
                       for pattern, repeat in T.scan_groups(cfg)]}


class _Cells:
    """The forward's bookkeeping: each cell's device, batch rows and
    "model" index, the cache's layout, and the sums and gathers over
    "model"."""

    def __init__(self, cfg: ModelConfig, mesh, batch: int, serve_seq_shard: bool):
        _check_mesh(mesh)
        self.mesh = mesh
        self.n = mesh.size
        self.dev = list(mesh.devices.flat)
        self.tp = mesh.shape.get("model", 1)
        self.batch = batch
        self.dpb = batch_entry(mesh, batch)
        self.b_loc = batch // shd.n_blocks(self.dpb, mesh)
        self.cache_spec = cache_spec(cfg, mesh, batch, serve_seq_shard)
        _, self.seq_axis, self.kv_axis, _ = self.cache_spec
        coords = [shd.cell_coords(mesh, c) for c in range(self.n)]
        self.mi = [co.get("model", 0) for co in coords]
        self.bi = [shd.block_index(self.dpb, mesh, co) for co in coords]
        self.groups = shd.groups_over(mesh, "model" if "model" in mesh.axis_names else None)

    def rows(self, c: int) -> slice:
        return slice(self.bi[c] * self.b_loc, (self.bi[c] + 1) * self.b_loc)

    def model_sum(self, parts: list, dtype) -> list:
        out = [None] * self.n
        for g in self.groups:
            for c, t in zip(g, all_reduce([parts[c] for c in g], dtype)):
                out[c] = t
        return out

    def model_gather(self, parts: list, dim: int) -> list:
        out = [None] * self.n
        for g in self.groups:
            for c, t in zip(g, all_gather([parts[c] for c in g], axis=dim)):
                out[c] = t
        return out

    def sharded(self, spec: tuple, shape: tuple, parts: list) -> Sharded:
        """Cell tensors as a ``Sharded``; cells with the same block on the
        same device keep one tensor."""
        out = Sharded(tuple(spec), tuple(shape), self.mesh, list(parts))
        seen: dict = {}
        for c in range(self.n):
            key = (out.blocks(c), self.dev[c])
            out.cells[c] = seen.setdefault(key, out.cells[c])
        return out


def _check_params(params, gdims) -> None:
    """Every leaf ``Sharded``, split over anything but "model" only on its
    d_model dims (which the forward gathers)."""
    for leaf, dims in zip(T.tree_leaves(params), T.tree_leaves(gdims)):
        if not isinstance(leaf, Sharded):
            raise TypeError("a mesh forward takes its parameters laid out on the cells: "
                            "pass them through distributed.sharding.shard_params first")
        for d, e in enumerate(leaf.spec):
            if d not in dims and set(shd.entry_axes(e)) - {"model"}:
                raise ValueError(f"a parameter split over {e!r} on a dim that is not "
                                 f"d_model: {leaf.spec}")


def _kv_for_heads(k, k0: int, h0: int, hq: int, g: int):
    """The kv heads that q heads [h0, h0 + hq) attend, from a k [B, S, KV,
    dh] whose first head is global kv head k0, as a [B, S, KV', dh] that
    pairs with those q heads reshaped to (KV', hq / KV')."""
    if h0 % g == 0 and hq % g == 0:
        return k.narrow(2, h0 // g - k0, hq // g)
    idx = (h0 + torch.arange(hq, device=k.device)) // g - k0
    return k.index_select(2, idx)


def argmax(logits: Sharded) -> torch.Tensor:
    """``torch.argmax(logits, -1)`` of vocab-sharded logits [B, S, V], on
    the mesh's first device: each cell's local argmax, then the largest
    over the cells in ascending "model" order, the lower index on a tie."""
    mesh = logits.mesh
    home = mesh.home
    by_rows: dict = {}
    for g in shd.groups_over(mesh, logits.spec[2]):
        best_v = best_i = None
        for c in g:
            lc = logits.cells[c]
            i = torch.argmax(lc, dim=-1, keepdim=True)
            v = lc.gather(-1, i)[..., 0].to(home)
            i = (i[..., 0] + logits.offset(c, 2)).to(home)
            if best_v is None:
                best_v, best_i = v, i
            else:
                take = v > best_v
                best_v, best_i = torch.where(take, v, best_v), torch.where(take, i, best_i)
        by_rows.setdefault(logits.blocks(g[0])[0], best_i)
    return torch.cat([by_rows[b] for b in sorted(by_rows)])


def forward(cfg: ModelConfig, params, batch: dict, *, mode: str, mesh, cache=None,
            lengths: Optional[torch.Tensor] = None, remat: bool = True,
            causal_skip: bool = False, chunk_q: int = 512, chunk_kv: int = 512,
            serve_seq_shard: bool = False, compute_dtype=torch.bfloat16,
            cache_len: Optional[int] = None, return_hidden: bool = False):
    """``transformer.forward`` on ``mesh``.  Returns (logits, cache): the
    logits a ``Sharded`` [B, S', V] split by batch rows over the data axes
    and by vocab over "model" (train: every position; prefill and decode:
    the last); ``return_hidden``: the final-normed hidden states [B, S', D]
    instead, split by batch rows.  The cache is a tree of ``Sharded``
    leaves laid out by :func:`cache_spec` (prefill: stacked, ``cache_len``
    positions, default the prompt's; decode: the cache given, written in
    place; train: empty).  ``remat`` applies in train mode with grad
    enabled: one checkpoint a layer, the layer's FSDP gathers inside."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    check_servable(cfg)
    gd = gather_dims(cfg)
    _check_params(params, gd)
    dt = compute_dtype
    if "embeds" in batch:
        emb_in = batch["embeds"]
        B, S = emb_in.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
    cl = _Cells(cfg, mesh, B, serve_seq_shard)
    n = cl.n
    cache_len = cache_len or S
    if mode == "decode" and (lengths is None or cache is None):
        raise ValueError("decode needs a cache and lengths")
    if mode == "prefill" and cl.seq_axis and cache_len % cl.tp:
        raise ValueError(f"a cache of {cache_len} positions does not split over model={cl.tp}")

    # the embedding: vocab-sharded lookups summed over "model" (exact)
    if "embeds" in batch:
        x = [emb_in[cl.rows(c)].to(cl.dev[c]).to(dt) for c in range(n)]
    else:
        emb = params["embed"]
        table = all_gather_dims(emb, gd["embed"])
        tok = [tokens[cl.rows(c)].to(cl.dev[c]).long() for c in range(n)]
        if emb.spec[0] is None:
            x = [table[c][tok[c]].to(dt) for c in range(n)]
        else:
            parts = []
            for c in range(n):
                e = table[c]
                idx = tok[c] - emb.offset(c, 0)
                live = (idx >= 0) & (idx < e.shape[0])
                parts.append(torch.where(live[..., None], e[idx.clamp(0, e.shape[0] - 1)], 0))
            x = cl.model_sum(parts, dt)
        del table
    if mode == "decode":
        lens = [lengths[cl.rows(c)].to(cl.dev[c]) for c in range(n)]
        positions = [ln[:, None] for ln in lens]
    else:
        pos = {d: torch.arange(S, device=d)[None].expand(cl.b_loc, S) for d in set(cl.dev)}
        positions = [pos[cl.dev[c]] for c in range(n)]
    if cfg.pos_emb == "sinusoidal":
        x = [x[c] + L.sinusoidal_positions(positions[c], cfg.d_model).to(dt) for c in range(n)]

    kw = dict(mode=mode, lens=lens if mode == "decode" else None, cache_len=cache_len, dt=dt,
              attn_kw=dict(causal_skip=causal_skip, chunk_q=chunk_q, chunk_kv=chunk_kv))
    remat = remat and mode == "train" and torch.is_grad_enabled()
    new_groups = []
    for gi, (pattern, repeat) in enumerate(T.scan_groups(cfg)):
        gp, gdg = params["blocks"][gi], gd["blocks"][gi]
        if mode == "train":
            def layer(li, *xs, gp=gp, gdg=gdg, n_pos=len(pattern)):
                xs = list(xs)
                for pi in range(n_pos):
                    xs = _attn_block(cfg, cl, gp[str(pi)], gdg[str(pi)], li, xs, positions,
                                     None, None, **kw)
                return tuple(xs)

            for li in range(repeat):
                x = list(checkpoint(layer, li, *x, use_reentrant=False) if remat
                         else layer(li, *x))
            new_groups.append({str(pi): {} for pi in range(len(pattern))})
            continue
        gc = cache["blocks"][gi] if cache is not None else None
        outs = {str(pi): {"k": [[None] * repeat for _ in range(n)],
                          "v": [[None] * repeat for _ in range(n)]}
                for pi in range(len(pattern))}
        for li in range(repeat):
            for pi in range(len(pattern)):
                lc = {nm: Sharded(t.spec[1:], t.shape[1:], mesh, [x_[li] for x_ in t.cells])
                      for nm, t in gc[str(pi)].items()} if mode == "decode" else None
                x = _attn_block(cfg, cl, gp[str(pi)], gdg[str(pi)], li, x, positions, lc,
                                outs[str(pi)], **kw)
        if mode == "decode":
            new_groups.append(gc)                  # written in place
        else:
            grp = {}
            for pi, kvd in outs.items():
                shape = (repeat, B, cache_len, cfg.padded_kv, cfg.d_head)
                grp[pi] = {nm: cl.sharded((None,) + cl.cache_spec, shape,
                                          [torch.stack(per_layer) for per_layer in kvd[nm]])
                           for nm in ("k", "v")}
            new_groups.append(grp)

    x = [L.rms_norm(x[c], params["final_norm"].cells[c], cfg.norm_eps) for c in range(n)]
    if mode == "prefill":
        x = [t[:, -1:] for t in x]
    s_out = x[0].shape[1]
    if return_hidden:
        return (cl.sharded((cl.dpb, None, None), (B, s_out, cfg.d_model), x),
                {"blocks": new_groups})
    head, table = head_cells(cfg, params, mesh)
    logits = [x[c] @ table[c].to(dt).T for c in range(n)]
    return (cl.sharded((cl.dpb, None, head.spec[0]), (B, s_out, head.shape[0]), logits),
            {"blocks": new_groups})


def head_cells(cfg: ModelConfig, params, mesh) -> tuple[Sharded, list]:
    """The output head (``lm_head``, or the tied embedding) and each cell's
    block of it with its d_model dim gathered: [V / tp, D]."""
    head_name = "lm_head" if "lm_head" in params else "embed"
    return params[head_name], all_gather_dims(params[head_name], gather_dims(cfg)[head_name])


def _attn_block(cfg, cl: _Cells, lp, gd, li, x, positions, lc, outs, *, mode, lens, cache_len,
                dt, attn_kw):
    """One attention block (attention and FFN) over every cell, its
    parameters ``lp`` (layer ``li``) gathered on their d_model dims ``gd``
    first.  Prefill puts each cell's cache block of this layer into
    ``outs``; decode writes ``lc`` in place; train keeps no cache."""
    n, B, S = cl.n, cl.batch, x[0].shape[1]
    H, KV, dh, D = cfg.padded_heads, cfg.padded_kv, cfg.d_head, cfg.d_model
    g = H // KV
    seq_axis, kv_axis = cl.seq_axis, cl.kv_axis
    wq, wk, wo = lp["wq"], lp["wk"], lp["wo"]
    heads_tp = wq.spec[2] is not None
    kv_tp = wk.spec[2] is not None
    if wo.spec[1] != wq.spec[2] or lp["wv"].spec[2] != wk.spec[2]:
        raise ValueError(f"inconsistent attention layout: wq {wq.spec}, wo {wo.spec}, "
                         f"wk {wk.spec}, wv {lp['wv'].spec}")
    if kv_tp and kv_axis is None:
        raise ValueError("kv heads split over 'model' but the cache is not: "
                         "shard the parameters with the same serve_seq_shard")
    if heads_tp and seq_axis:
        raise ValueError("q heads split over 'model' with a sequence-sharded cache: "
                         "shard the parameters with serve_seq_shard=True")
    hl, kvl = H // cl.tp, KV // cl.tp
    moe_leaves = moe_mod.MOE_AXES if cfg.moe is not None else {}
    used = {nm: all_gather_dims(t, gd[nm], li) for nm, t in lp.items() if nm not in moe_leaves}
    pc = [{nm: v[c] for nm, v in used.items()} for c in range(n)]
    del used
    q_, k_, v_ = zip(*(T._qkv(cfg, pc[c], x[c], positions[c]) for c in range(n)))

    def kv_block(t, c):
        """Cell c's kv heads of the cache layout from its k or v."""
        if kv_axis and not kv_tp:
            return t.narrow(2, cl.mi[c] * kvl, kvl)
        return t

    if mode in ("train", "prefill"):
        out = []
        for c in range(n):
            h0 = wq.offset(c, 2)
            k0 = wk.offset(c, 2)
            hq = q_[c].shape[2]
            kk = _kv_for_heads(k_[c], k0, h0, hq, g)
            vv = _kv_for_heads(v_[c], k0, h0, hq, g)
            out.append(T._causal_attention(q_[c], kk, vv, window=None, **attn_kw))
            if mode == "train":
                continue
            for nm, t in (("k", k_[c]), ("v", v_[c])):
                t = kv_block(t, c)
                if seq_axis:
                    sl = cache_len // cl.tp
                    lo = cl.mi[c] * sl
                    t = t[:, lo:min(lo + sl, S)]
                    t = F.pad(t, (0, 0, 0, 0, 0, sl - t.shape[1]))
                elif cache_len > S:
                    t = F.pad(t, (0, 0, 0, 0, 0, cache_len - S))
                outs[nm][c][li] = t
    else:
        # q, k_new, v_new in flash_decode_update's layouts
        if kv_axis:
            qd = [q_[c][:, 0] if heads_tp else q_[c][:, 0].narrow(1, cl.mi[c] * hl, hl)
                  for c in range(n)]
        else:
            qd = [q[:, 0] for q in q_]
            if heads_tp:
                qd = cl.model_gather(qd, dim=1)
        spec = (cl.dpb, kv_axis, None)
        qs = cl.sharded(spec, (B, H, dh), qd)
        kn = cl.sharded(spec, (B, KV, dh), [kv_block(t, c)[:, 0] for c, t in enumerate(k_)])
        vn = cl.sharded(spec, (B, KV, dh), [kv_block(t, c)[:, 0] for c, t in enumerate(v_)])
        ln = cl.sharded((cl.dpb,), (B,), lens)
        if lc["k"].dtype == dt:
            od = flash_decode_update(qs, lc["k"], lc["v"], kn, vn, ln, mesh=cl.mesh,
                                     dp=cl.dpb, seq_axis=seq_axis, kv_axis=kv_axis)[0].cells
        else:     # a cache of another dtype is read at the compute dtype, as the reference's
            for nm, new in (("k", kn), ("v", vn)):
                cache_write(lc[nm], new, ln, mesh=cl.mesh, dp=cl.dpb, seq_axis=seq_axis,
                            kv_axis=kv_axis)
            od = decode_cells(qs, lc["k"].map(lambda t: t.to(dt)),
                               lc["v"].map(lambda t: t.to(dt)),
                               cl.sharded((cl.dpb,), (B,), [t + 1 for t in lens]),
                               seq_axis=seq_axis, window=None)
        if heads_tp and not kv_axis:
            od = [t.narrow(1, cl.mi[c] * hl, hl) for c, t in enumerate(od)]
        elif kv_axis and not heads_tp:
            od = cl.model_gather(od, dim=1)
        out = [t[:, None] for t in od]

    parts = [T._attn_out(out[c], pc[c]["wo"].to(dt)) for c in range(n)]
    o = cl.model_sum(parts, dt) if heads_tp else parts
    x = [x[c] + o[c] for c in range(n)]

    xn2 = [L.rms_norm(x[c], pc[c]["ln2"], cfg.norm_eps) for c in range(n)]
    if cfg.moe is not None:
        if lp["w_gate"].spec[1] != "model" or cl.tp == 1:
            raise ValueError("the expert-parallel MoE needs its experts split over a 'model' "
                             f"axis of size > 1, not {lp['w_gate'].spec} on {cl.mesh.describe()}")
        y = moe_mod.moe_ffn_layer({nm: lp[nm] for nm in moe_leaves},
                                  [t.reshape(-1, D) for t in xn2], cfg.moe, cl.mesh, dt, li)
        y = [t.reshape(xn2[c].shape) for c, t in enumerate(y)]
        return [x[c] + y[c] for c in range(n)]
    ff_name = "w_in" if cfg.mlp == "gelu" else "w_gate"
    ff_tp = lp[ff_name].spec[2] is not None
    parts = [T._ffn_partial(cfg, pc[c], xn2[c]) for c in range(n)]
    y = cl.model_sum(parts, dt) if ff_tp else parts
    if cfg.mlp == "gelu":
        y = [y[c] + pc[c]["b_out"].to(dt) for c in range(n)]
    return [x[c] + y[c] for c in range(n)]
