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
  count divides "model" (else the cache is replicated over "model");
- a sliding window attends within the window in train and prefill; the
  prefill keeps the last ``min(window, S)`` positions as a ring (position
  p in slot p % slots) with their positions ``pos``, and decode writes
  slot ``lengths % slots`` and attends over the ring by its ``pos``.  The
  ring's k/v and ``pos`` are whole over "model" (each cell attends its own
  q heads over it), except that ``serve_seq_shard`` splits the k/v slots
  over "model" (each cell's partial softmax over its slots, combined as
  flash-decode combines them; ``pos`` stays whole);
- the RG-LRU block (``rglru``): ``w_in_rnn`` / ``w_in_gate`` column-parallel
  over the "rnn" channels, the depthwise conv local to a cell's channels,
  the conv output gathered over "model" before ``w_a`` / ``w_x`` (whose
  input is all R channels; each cell forms the gates of its own), ``lam``,
  the recurrence and the gate local, ``w_out`` row-parallel; its cache's
  ``conv`` [B, 3, R] and ``h`` [B, R] split over "model" by channel, where
  each cell produces and consumes them (the reference's ``cache_specs``
  replicates them over "model": the values are equal, the bytes a cell
  holds are not);
- the RWKV6 block (``rwkv``): the token shift and the ``mu_*`` mixes on the
  residual (replicated over "model"); ``w_r`` / ``w_k`` / ``w_v`` / ``w_g``
  column-parallel by heads of 64, the decay's ``w_lora_a`` whole and each
  cell's columns of ``w_lora_b`` and ``w0`` (and of ``u``, ``ln_w``,
  ``ln_b``), the WKV scan and the group norm on the cell's heads, ``w_o``
  row-parallel; the channel mix's ``w_ck`` column- and ``w_cv``
  row-parallel over "ff", ``w_cr`` whole, its gate on the summed product.
  Where the heads do not divide "model" the time mix is replicated over
  "model": every cell gathers the "rnn" blocks and computes every head.
  Its cache's ``s`` [B, H, 64, 64] is split over "model" by heads (whole
  where the time mix is replicated), ``x_prev_t`` / ``x_prev_c`` whole.

Every cache leaf is split by batch rows over the data axes when they
divide the batch.  Decode writes every leaf in place.  A block that cells
share on one device is one tensor: the recurrent states and the ring are
written once a tensor after every cell has computed its step, the full
KV cache by each cell with the same value before it attends, so no cell
reads a half-written block.

Autograd runs through all of it.  A replicated tensor's copies on cells
that share a device are one tensor, so their gradients add there; copies
on distinct devices are distinct tensors, whose gradients the train step
sums (``models.lm.make_train_step``).

The reference's head-sharding constraints on q/k/v and its Megatron-SP
residual layout (the residual split over "model" by sequence between
blocks) are layout hints for its partitioner; here q/k/v are as the
weights make them and the residual stays replicated over "model".
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (all_gather, all_gather_dims, all_gather_over,
                                                 all_reduce, note)
from repro_torch.distributed.cache_update import cache_write, write_rows
from repro_torch.distributed.flash_decode import combine, decode_cells, flash_decode_update
from repro_torch.distributed.sharding import Sharded
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import transformer as T

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
    ``_attn_forward`` decode branch and ``cache_specs``): the sequence over
    "model" under ``serve_seq_shard``, else the kv heads when
    ``padded_kv`` divides "model" and there is no window, else replicated
    over "model"."""
    tp_ok = "model" in mesh.axis_names
    seq = "model" if serve_seq_shard and tp_ok else None
    kv = ("model" if tp_ok and not serve_seq_shard and not cfg.sliding_window
          and cfg.padded_kv % mesh.shape["model"] == 0 else None)
    return (batch_entry(mesh, batch), seq, kv, None)


def rwkv_heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether RWKV6's heads divide "model" (else its time mix and ``s``
    are replicated over "model")."""
    tp = mesh.shape.get("model", 1)
    return "model" in mesh.axis_names and (cfg.d_model // rwkv_mod.HEAD_DIM) % tp == 0


def block_cache_layout(cfg: ModelConfig, kind: str, mesh, batch: int, smax: int,
                       dtype, serve_seq_shard: bool = False) -> dict:
    """One layer's cache of a ``kind`` block on ``mesh``: {name: (global
    shape, spec, dtype)}, the shapes and dtypes of
    ``transformer._block_cache_shape``.  Every leaf split by batch over the
    data axes when they divide it; k/v by :func:`cache_spec` (a window's
    ``pos`` whole over "model"); RG-LRU's ``conv`` and ``h`` over "model"
    by channel; RWKV6's ``s`` by heads (:func:`rwkv_heads_split`), its
    ``x_prev_*`` whole."""
    dpb = batch_entry(mesh, batch)
    m = "model" if "model" in mesh.axis_names else None
    leaves = T._block_cache_shape(cfg, kind, batch, smax, dtype, device="meta")
    specs = {"k": cache_spec(cfg, mesh, batch, serve_seq_shard),
             "pos": (dpb, None),
             "conv": (dpb, None, m), "h": (dpb, m),
             "s": (dpb, m if rwkv_heads_split(cfg, mesh) else None, None, None),
             "x_prev_t": (dpb, None), "x_prev_c": (dpb, None)}
    specs["v"] = specs["k"]
    return {nm: (tuple(t.shape), specs[nm], t.dtype) for nm, t in leaves.items()}


def init_cache(cfg: ModelConfig, batch: int, smax: int, dtype, mesh,
               serve_seq_shard: bool = False):
    """``transformer.init_cache`` (stacked) laid out on ``mesh``'s cells by
    :func:`block_cache_layout` (a window's ``pos`` at -1)."""
    _check_mesh(mesh)
    groups = []
    for pattern, repeat in T.scan_groups(cfg):
        grp = {}
        for pi, kind in enumerate(pattern):
            lay = block_cache_layout(cfg, kind, mesh, batch, smax, dtype, serve_seq_shard)
            grp[str(pi)] = {nm: shd.zeros((repeat,) + shape, (None,) + spec, mesh, dt)
                            for nm, (shape, spec, dt) in lay.items()}
            if "pos" in grp[str(pi)]:
                grp[str(pi)]["pos"] = grp[str(pi)]["pos"].map(lambda t: t.fill_(-1))
        groups.append(grp)
    return {"blocks": groups}


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
            for c, t in zip(g, all_reduce([parts[c] for c in g], dtype, axes="model")):
                out[c] = t
        return out

    def model_gather(self, parts: list, dim: int) -> list:
        out = [None] * self.n
        for g in self.groups:
            for c, t in zip(g, all_gather([parts[c] for c in g], axis=dim, axes="model")):
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

    @staticmethod
    def layer(t: Sharded, li: int) -> Sharded:
        """Layer ``li`` of a layer-stacked ``Sharded``: one view a distinct
        tensor, so cells that share a block share its view."""
        views: dict = {}
        for x in t.cells:
            if id(x) not in views:
                views[id(x)] = x[li]
        return Sharded(t.spec[1:], t.shape[1:], t.mesh, [views[id(x)] for x in t.cells])

    @staticmethod
    def write(leaf: Sharded, new: list) -> None:
        """Decode: each cell's new block copied into ``leaf``'s cell
        tensors in place, each distinct tensor once (cells that share it
        computed the same value)."""
        done: set = set()
        for t, v in zip(leaf.cells, new):
            if id(t) not in done:
                done.add(id(t))
                t.copy_(v)


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
    if h0 // g == (h0 + hq - 1) // g:          # all of them in one kv head's group
        return k.narrow(2, h0 // g - k0, 1)
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
    leaves laid out by :func:`block_cache_layout` (prefill: stacked,
    ``cache_len`` positions, default the prompt's, or a window's ring of
    ``min(window, S)``; decode: the cache given, written in place; train:
    empty).  ``remat`` applies in train mode with grad
    enabled: one checkpoint a layer, the layer's FSDP gathers inside."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    gd = gather_dims(cfg)
    _check_params(params, gd)
    dt = compute_dtype
    B, S = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2]
    cl = _Cells(cfg, mesh, B, serve_seq_shard)
    n = cl.n
    cache_len = cache_len or S
    if mode == "decode" and (lengths is None or cache is None):
        raise ValueError("decode needs a cache and lengths")
    slots = min(cfg.sliding_window, S) if cfg.sliding_window else cache_len
    if mode == "prefill" and cl.seq_axis and slots % cl.tp and "attn" in T.layer_pattern(cfg):
        raise ValueError(f"a cache of {slots} positions does not split over model={cl.tp}")

    x = embed_cells(cfg, params, batch, cl, dt)
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
    # a prefill's cache: a window's ring of min(window, S) slots, else cache_len positions
    smax = S if cfg.sliding_window else cache_len
    new_groups = []
    for gi, (pattern, repeat) in enumerate(T.scan_groups(cfg)):
        gp, gdg = params["blocks"][gi], gd["blocks"][gi]
        if mode == "train":
            def layer(li, *xs, gp=gp, gdg=gdg, pattern=pattern):
                xs = list(xs)
                for pi, kind in enumerate(pattern):
                    xs = _BLOCKS[kind](cfg, cl, gp[str(pi)], gdg[str(pi)], li, xs, positions,
                                       None, None, **kw)
                return tuple(xs)

            for li in range(repeat):
                x = list(checkpoint(layer, li, *x, use_reentrant=False) if remat
                         else layer(li, *x))
            new_groups.append({str(pi): {} for pi in range(len(pattern))})
            continue
        if mode == "decode":
            gc = cache["blocks"][gi]
            for li in range(repeat):
                for pi, kind in enumerate(pattern):
                    lc = {nm: cl.layer(t, li) for nm, t in gc[str(pi)].items()}
                    x = _BLOCKS[kind](cfg, cl, gp[str(pi)], gdg[str(pi)], li, x, positions, lc,
                                      None, **kw)
            new_groups.append(gc)                  # written in place
            continue
        lays = [block_cache_layout(cfg, kind, mesh, B, smax, dt, serve_seq_shard)
                for kind in pattern]
        outs = [{nm: [[None] * repeat for _ in range(n)] for nm in lay} for lay in lays]
        for li in range(repeat):
            for pi, kind in enumerate(pattern):
                x = _BLOCKS[kind](cfg, cl, gp[str(pi)], gdg[str(pi)], li, x, positions, None,
                                  outs[pi], **kw)
        new_groups.append({str(pi): {nm: cl.sharded((None,) + lay[nm][1], (repeat,) + lay[nm][0],
                                                     [torch.stack(per_layer) for per_layer in o])
                                     for nm, o in outs[pi].items()}
                           for pi, lay in enumerate(lays)})

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


def embed_cells(cfg: ModelConfig, params, batch: dict, cl: _Cells, dt) -> list:
    """Each cell's rows of the embedded batch [b, S, D] at ``dt``: the
    ``embeds`` given, or the tokens looked up in the vocab-sharded
    embedding (its d_model dim gathered first), each cell's slice giving
    zeros outside it, summed over "model" (exact)."""
    n = cl.n
    if "embeds" in batch:
        return [batch["embeds"][cl.rows(c)].to(cl.dev[c]).to(dt) for c in range(n)]
    emb = params["embed"]
    table = all_gather_dims(emb, gather_dims(cfg)["embed"])
    tok = [batch["tokens"][cl.rows(c)].to(cl.dev[c]).long() for c in range(n)]
    if emb.spec[0] is None:
        return [table[c][tok[c]].to(dt) for c in range(n)]
    parts = []
    for c in range(n):
        e = table[c]
        idx = tok[c] - emb.offset(c, 0)
        live = (idx >= 0) & (idx < e.shape[0])
        parts.append(torch.where(live[..., None], e[idx.clamp(0, e.shape[0] - 1)], 0))
    return cl.model_sum(parts, dt)


def head_cells(cfg: ModelConfig, params, mesh) -> tuple[Sharded, list]:
    """The output head (``lm_head``, or the tied embedding) and each cell's
    block of it with its d_model dim gathered: [V / tp, D]."""
    head_name = "lm_head" if "lm_head" in params else "embed"
    return params[head_name], all_gather_dims(params[head_name], gather_dims(cfg)[head_name])


def _gathered(cl: _Cells, lp, gd, li, skip=()) -> list:
    """Each cell's parameters of layer ``li`` (but ``skip``), their d_model
    dims gathered (:func:`collectives.all_gather_dims`)."""
    used = {nm: all_gather_dims(t, gd[nm], li) for nm, t in lp.items() if nm not in skip}
    return [{nm: v[c] for nm, v in used.items()} for c in range(cl.n)]


def _attn_block(cfg, cl: _Cells, lp, gd, li, x, positions, lc, outs, *, mode, lens, cache_len,
                dt, attn_kw):
    """One attention block (attention and FFN) over every cell, its
    parameters ``lp`` (layer ``li``) gathered on their d_model dims ``gd``
    first.  Prefill puts each cell's cache block of this layer into
    ``outs``; decode writes ``lc`` in place; train keeps no cache."""
    n, B, S = cl.n, cl.batch, x[0].shape[1]
    H, KV, dh = cfg.padded_heads, cfg.padded_kv, cfg.d_head
    g = H // KV
    window = cfg.sliding_window
    seq_axis, kv_axis = cl.seq_axis, cl.kv_axis
    wq, wk, wo = lp["wq"], lp["wk"], lp["wo"]
    heads_tp = wq.spec[2] is not None
    kv_tp = wk.spec[2] is not None
    if wo.spec[1] != wq.spec[2] or lp["wv"].spec[2] != wk.spec[2]:
        raise ValueError(f"inconsistent attention layout: wq {wq.spec}, wo {wo.spec}, "
                         f"wk {wk.spec}, wv {lp['wv'].spec}")
    if kv_tp and kv_axis is None and not window and mode != "train":
        raise ValueError("kv heads split over 'model' but the cache is not: "
                         "shard the parameters with the same serve_seq_shard")
    if heads_tp and seq_axis:
        raise ValueError("q heads split over 'model' with a sequence-sharded cache: "
                         "shard the parameters with serve_seq_shard=True")
    hl, kvl = H // cl.tp, KV // cl.tp
    pc = _gathered(cl, lp, gd, li, moe_mod.MOE_AXES if cfg.moe is not None else ())
    q_, k_, v_ = zip(*(T._qkv(cfg, pc[c], x[c], positions[c]) for c in range(n)))

    def kv_block(t, c):
        """Cell c's kv heads of the cache layout from its k or v."""
        if kv_axis and not kv_tp:
            return t.narrow(2, cl.mi[c] * kvl, kvl)
        return t

    if window and kv_tp and mode != "train":     # a ring holds every kv head on each cell
        k_, v_ = cl.model_gather(list(k_), dim=2), cl.model_gather(list(v_), dim=2)
    if mode in ("train", "prefill"):
        out = []
        for c in range(n):
            h0 = wq.offset(c, 2)
            k0 = wk.offset(c, 2) if k_[c].shape[2] < KV else 0    # 0: gathered, every kv head
            hq = q_[c].shape[2]
            kk = _kv_for_heads(k_[c], k0, h0, hq, g)
            vv = _kv_for_heads(v_[c], k0, h0, hq, g)
            out.append(T._causal_attention(q_[c], kk, vv, window=window, **attn_kw))
            if mode == "train":
                continue
            if window:
                _ring_prefill(cl, c, li, k_[c], v_[c], positions[c], outs, window)
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
    elif window:
        out = _ring_decode(cl, lc, q_, k_, v_, lens, wq, g, dt)
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
    return _ffn(cfg, cl, lp, pc, x, li, dt)


def _ring_prefill(cl: _Cells, c: int, li: int, k, v, positions, outs, window: int) -> None:
    """Cell c's ring of layer ``li`` from its k/v [B, S, KV, dh] (every kv
    head) into ``outs``: the last ``min(window, S)`` positions rolled so
    that position p sits in slot p % slots, their positions ``pos``; the
    slots split over "model" under ``serve_seq_shard``."""
    S = k.shape[1]
    slots = min(window, S)
    shift = S % slots
    for nm, t in (("k", k), ("v", v)):
        t = torch.roll(t[:, -slots:], shift, dims=1)
        if cl.seq_axis:
            sl = slots // cl.tp
            t = t.narrow(1, cl.mi[c] * sl, sl)
        outs[nm][c][li] = t
    outs["pos"][c][li] = torch.roll(positions[:, -slots:].to(torch.int32), shift, dims=1)


def _ring_partial(q, kc, vc, posbuf, lengths):
    """``transformer._decode_ring``'s softmax over the slots given, as
    flash-decode partials (m, l, o) [B, KV, G(, dh)] in float32 (float64
    stays float64): the scores from upcast operands, the weights at the
    cache's dtype against its values."""
    b, h, dh = q.shape
    kv = kc.shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", L.upcast(qg), L.upcast(kc)) * (dh ** -0.5)
    msk = ((posbuf >= 0) & (posbuf <= lengths[:, None]))[:, None, None, :]
    sc = torch.where(msk, sc, L.NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.where(msk, torch.exp(sc - m[..., None]), 0.0)
    o = L.upcast(torch.einsum("bkgt,btkd->bkgd", p.to(vc.dtype), vc))
    return m, p.sum(dim=-1), o


def _ring_decode(cl: _Cells, lc, q_, k_, v_, lens, wq, g: int, dt) -> list:
    """The ring decode of one layer: the new token's k/v (every kv head)
    written into slot ``lengths % slots`` of ``lc``'s k/v and its position
    into ``pos``, each distinct tensor once, then each cell's q heads
    attend over the ring by ``pos`` (``transformer._decode_ring``); with
    the slots split over "model", each cell over its slots, the partials
    combined over "model" (``flash_decode.combine``).  Returns each cell's
    output [B, 1, heads, dh]."""
    n = cl.n
    kc, vc, pb = lc["k"], lc["v"], lc["pos"]
    slots = kc.shape[1]
    done: set = set()
    for c in range(n):
        slot = (lens[c] % slots).long()
        for buf, new in ((kc, k_[c]), (vc, v_[c])):
            t = buf.cells[c]
            if id(t) not in done:
                done.add(id(t))
                at = slot - buf.offset(c, 1)
                write_rows(t, new[:, 0], at, (at >= 0) & (at < t.shape[1]))
        t = pb.cells[c]
        if id(t) not in done:
            done.add(id(t))
            t[torch.arange(t.shape[0], device=t.device), slot] = lens[c].to(torch.int32)
    out = [None] * n
    for grp in (cl.groups if cl.seq_axis else [[c] for c in range(n)]):
        parts = []
        for c in grp:
            q = q_[c][:, 0]
            kk = _kv_for_heads(kc.cells[c].to(dt), 0, wq.offset(c, 2), q.shape[1], g)
            vv = _kv_for_heads(vc.cells[c].to(dt), 0, wq.offset(c, 2), q.shape[1], g)
            pos = pb.cells[c].narrow(1, kc.offset(c, 1), kc.cells[c].shape[1])
            if not cl.seq_axis:
                out[c] = T._decode_ring(q, kk, vv, pos, lens[c])[:, None]
                continue
            parts.append(_ring_partial(q, kk, vv, pos, lens[c]))
        if cl.seq_axis:                  # each cell's partials to the group's others
            note("all-gather", len(grp) * sum(t.numel() * t.element_size() for t in parts[0]),
                 cl.seq_axis, len(grp))
        done_dev: dict = {}
        for c in grp if cl.seq_axis else ():
            q = q_[c][:, 0]
            if q.device not in done_dev:
                done_dev[q.device] = combine(parts, q.device).reshape(q.shape).to(dt)[:, None]
            out[c] = done_dev[q.device]
    return out


def _ffn(cfg, cl: _Cells, lp, pc, x, li, dt) -> list:
    """The block's FFN with its residual (dense, row-parallel over "model"
    where ``ff`` is split, or the expert-parallel MoE) on every cell."""
    n, D = cl.n, cfg.d_model
    xn2 = [L.rms_norm(x[c], pc[c]["ln2"], cfg.norm_eps) for c in range(n)]
    if cfg.moe is not None:
        if lp["w_gate"].spec[1] != "model" or cl.tp == 1:
            raise ValueError("the expert-parallel MoE needs its experts split over a 'model' "
                             f"axis of size > 1, not {lp['w_gate'].spec} on {cl.mesh.describe()}")
        moe_leaves = moe_mod.MOE_AXES
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


def _rglru_block(cfg, cl: _Cells, lp, gd, li, x, positions, lc, outs, *, mode, dt, **_):
    """One RG-LRU block (the recurrent branch and the FFN) over every cell:
    the cell's "rnn" channels of ``w_in_rnn`` / ``w_in_gate`` / ``conv`` /
    ``lam``, the conv output gathered over "model" for ``w_a`` / ``w_x``,
    ``w_out`` row-parallel.  Prefill puts ``conv`` and ``h`` into ``outs``;
    decode steps them from ``lc`` and writes them in place."""
    n = cl.n
    rnn = lp["w_in_rnn"].spec[2]
    for nm, d in (("w_in_gate", 2), ("conv", 2), ("w_a", 2), ("w_x", 2), ("lam", 1),
                  ("w_out", 1)):
        if lp[nm].spec[d] != rnn:
            raise ValueError(f"inconsistent RG-LRU layout: w_in_rnn {lp['w_in_rnn'].spec}, "
                             f"{nm} {lp[nm].spec}")
    if lc is not None and lc["h"].spec[1] != rnn:
        raise ValueError(f"an RG-LRU cache laid out {lc['h'].spec} for channels on {rnn!r}")
    pc = _gathered(cl, lp, gd, li, moe_mod.MOE_AXES if cfg.moe is not None else ())
    decode = mode == "decode"
    xn = [L.rms_norm(x[c], pc[c]["ln1"], cfg.norm_eps) for c in range(n)]
    u, conv = [], []
    for c in range(n):
        uc, cs = rglru_mod.causal_conv1d(xn[c] @ pc[c]["w_in_rnn"].to(dt), pc[c]["conv"],
                                         state=lc["conv"].cells[c] if decode else None)
        u.append(uc)
        conv.append(cs)
    u_all = cl.model_gather(u, dim=2) if rnn else u
    parts, hs = [], []
    for c in range(n):
        if decode:
            yc, h = rglru_mod.rg_lru_step(pc[c], u[c][:, 0], lc["h"].cells[c],
                                          x_gates=u_all[c][:, 0])
            yc = yc[:, None]
        else:
            yc, h = rglru_mod.rg_lru_scan(pc[c], u[c], x_gates=u_all[c])
        hs.append(h)
        yc = yc * L.gelu(xn[c] @ pc[c]["w_in_gate"].to(dt))
        parts.append(yc @ pc[c]["w_out"].to(dt))
    y = cl.model_sum(parts, dt) if rnn else parts
    if decode:
        cl.write(lc["conv"], conv)
        cl.write(lc["h"], hs)
    elif mode == "prefill":
        for c in range(n):
            outs["conv"][c][li], outs["h"][c][li] = conv[c], hs[c]
    x = [x[c] + y[c] for c in range(n)]
    return _ffn(cfg, cl, lp, pc, x, li, dt)


_TIME_MIX = ("w_r", "w_k", "w_v", "w_g")


def _rwkv_block(cfg, cl: _Cells, lp, gd, li, x, positions, lc, outs, *, mode, dt, **_):
    """One RWKV6 block (time and channel mix) over every cell: the time mix
    on the cell's heads (``w_r``/``w_k``/``w_v``/``w_g`` columns, ``w_o``
    rows summed over "model"; every head on every cell where the heads do
    not divide "model"), the channel mix's ``w_ck`` / ``w_cv`` over "ff".
    Prefill puts ``s``, ``x_prev_t`` and ``x_prev_c`` into ``outs``; decode
    steps them from ``lc`` and writes them in place."""
    n, D = cl.n, cfg.d_model
    rnn = lp["w_r"].spec[2]
    for nm, d in [(nm, 2) for nm in _TIME_MIX[1:]] + [("w_o", 1)]:
        if lp[nm].spec[d] != rnn:
            raise ValueError(f"inconsistent RWKV6 layout: w_r {lp['w_r'].spec}, {nm} "
                             f"{lp[nm].spec}")
    split = rnn is not None and rwkv_heads_split(cfg, cl.mesh)
    if lc is not None and (lc["s"].spec[1] is not None) != split:
        raise ValueError(f"an RWKV6 cache laid out {lc['s'].spec} for a time mix "
                         f"{'split' if split else 'replicated'} over 'model'")
    pc = _gathered(cl, lp, gd, li)
    if rnn and not split:                       # every head on every cell
        for nm, d in [(nm, 1) for nm in _TIME_MIX] + [("w_o", 0)]:
            whole = all_gather_over([p[nm] for p in pc], cl.mesh, rnn, d)
            for c in range(n):
                pc[c][nm] = whole[c]
    decode = mode == "decode"
    xn = [L.rms_norm(x[c], pc[c]["ln1"], cfg.norm_eps) for c in range(n)]
    parts, ss = [], []
    for c in range(n):
        xs = rwkv_mod._token_shift(xn[c], lc["x_prev_t"].cells[c] if decode else None)
        w = D // cl.tp if split else D
        lo = lp["w_r"].offset(c, 2) if split else 0
        o, s = rwkv_mod.time_mix_heads(pc[c], xn[c], xs, slice(lo, lo + w),
                                       lc["s"].cells[c] if decode else None)
        parts.append(o)
        ss.append(s)
    y = cl.model_sum(parts, dt) if split else parts
    x = [x[c] + y[c] for c in range(n)]
    xn2 = [L.rms_norm(x[c], pc[c]["ln2"], cfg.norm_eps) for c in range(n)]
    ff_tp = lp["w_ck"].spec[2] is not None
    kv, gate = [], []
    for c in range(n):
        xs = rwkv_mod._token_shift(xn2[c], lc["x_prev_c"].cells[c] if decode else None)
        xk = rwkv_mod._mix(xn2[c], xs, pc[c]["mu_ck"])
        xr = rwkv_mod._mix(xn2[c], xs, pc[c]["mu_cr"])
        k = torch.square(torch.relu(xk @ pc[c]["w_ck"].to(dt)))
        kv.append(k @ pc[c]["w_cv"].to(dt))
        gate.append(torch.sigmoid(xr @ pc[c]["w_cr"].to(dt)))
    kv = cl.model_sum(kv, dt) if ff_tp else kv
    new = {"s": ss, "x_prev_t": [t[:, -1] for t in xn], "x_prev_c": [t[:, -1] for t in xn2]}
    if decode:
        for nm, v in new.items():
            cl.write(lc[nm], v)
    elif mode == "prefill":
        for nm, v in new.items():
            for c in range(n):
                outs[nm][c][li] = v[c]
    return [x[c] + gate[c] * kv[c] for c in range(n)]


_BLOCKS = {"attn": _attn_block, "rglru": _rglru_block, "rwkv": _rwkv_block}
