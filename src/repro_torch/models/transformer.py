"""Decoder assembly: params, the layer loop, KV caches (the reference's
``models/transformer.py``).

Parameters are the reference's tree as plain tensors: ``{"embed",
"final_norm", ["lm_head"], "blocks": [group, ...]}``, one group per
:func:`scan_groups` entry, each ``{"<position in pattern>": {name: tensor
[repeat, ...]}}`` with the layers of the group stacked on the leading dim.
:func:`params_from_numpy` takes the reference's tree (as numpy arrays), so
both packages run on the same weights.

Modes:
- train   : full-sequence forward, all-position logits; with ``remat`` and
  grad enabled each layer runs under ``torch.utils.checkpoint`` (the
  reference's ``jax.checkpoint`` around its scan body), so the backward
  pass keeps one residual stream a layer and recomputes the rest.
- prefill : full-sequence forward, last-position logits + stacked caches.
- decode  : one token per call against the caches, written in place.

The reference's decode returns fresh cache arrays; here ``forward`` in
decode mode writes the new token's keys and values, and the recurrent
blocks' new states, into the cache it was given (stacked or per-layer) and
returns that cache.  A write at a position past the cache's end is
dropped, as JAX's ``.at[].set`` drops it.

Block kinds: ``attn`` (with a dense or MoE FFN), ``rglru`` (the Griffin
recurrent branch and the same FFN) and ``rwkv`` (time and channel mix).

``mesh=``: prefill and decode of the ``attn`` archs on a mesh of cells,
with the parameters laid out by ``distributed.sharding.shard_params``
(``models/mesh_forward.py``).  The train mode, the recurrent blocks and
the ``mlp_2d`` layout on a mesh are ROADMAP item 13f and raise.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.cache_update import cache_write
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod

_MESH_13F = ("ROADMAP item 13f (mesh LM training, the FSDP gather, the pod sync, the "
             "mlp_2d serving layout and the recurrent blocks on a mesh)")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def layer_pattern(cfg: ModelConfig) -> tuple[str, ...]:
    return (cfg.block_pattern * cfg.n_layers)[: cfg.n_layers]


def scan_groups(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(pattern, repeat)] — full periods then the remainder tail."""
    period = len(cfg.block_pattern)
    n_full, rem = divmod(cfg.n_layers, period)
    groups = []
    if n_full:
        groups.append((tuple(cfg.block_pattern), n_full))
    if rem:
        groups.append((tuple(cfg.block_pattern[:rem]), 1))
    return groups


def tree_map(fn: Callable, tree, name: Optional[str] = None):
    """``fn(name, leaf)`` on every tensor of a params or cache tree (nested
    dicts and lists); ``name`` is the leaf's dict key."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, name) for v in tree]
    return fn(name, tree)


def tree_leaves(tree) -> list:
    """The tensors of a tree in ``jax.tree.leaves``' order (dict keys
    sorted), so they pair with the reference tree's leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# parameter shapes (value = (shape, logical_axes))
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ModelConfig):
    D, dh, KV = cfg.d_model, cfg.d_head, cfg.padded_kv
    H = cfg.padded_heads
    s = {
        "ln1": ((D,), ("norm",)),
        "ln2": ((D,), ("norm",)),
        "wq": ((D, H, dh), ("attn_din", "qheads", "head_dim")),
        "wk": ((D, KV, dh), ("attn_din", "kv_heads", "head_dim")),
        "wv": ((D, KV, dh), ("attn_din", "kv_heads", "head_dim")),
        "wo": ((H, dh, D), ("qheads", "head_dim", "attn_dout")),
    }
    if cfg.qkv_bias:
        s["bq"] = ((H, dh), ("qheads", "head_dim"))
        s["bk"] = ((KV, dh), ("kv_heads", "head_dim"))
        s["bv"] = ((KV, dh), ("kv_heads", "head_dim"))
    if cfg.qk_norm:
        s["qnorm"] = ((dh,), ("norm",))
        s["knorm"] = ((dh,), ("norm",))
    s.update(_mlp_shapes(cfg))
    return s


def _mlp_shapes(cfg: ModelConfig):
    D, F = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        return dict(moe_mod.moe_param_shapes(D, F, cfg.moe))
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": ((D, F), ("d_model_in", "ff")),
            "w_up": ((D, F), ("d_model_in", "ff")),
            "w_down": ((F, D), ("ff", "d_model_out")),
        }
    return {  # gelu
        "w_in": ((D, F), ("d_model_in", "ff")),
        "b_in": ((F,), ("ff",)),
        "w_out": ((F, D), ("ff", "d_model_out")),
        "b_out": ((D,), ("norm",)),
    }


def _rglru_shapes(cfg: ModelConfig):
    s = {"ln1": ((cfg.d_model,), ("norm",)),
         "ln2": ((cfg.d_model,), ("norm",))}
    s.update(rglru_mod.rglru_param_shapes(cfg.d_model, cfg.d_rnn or cfg.d_model))
    # recurrent blocks pair with the same MLP as attention blocks
    s.update(_mlp_shapes(cfg))
    return s


def _rwkv_shapes(cfg: ModelConfig):
    s = {"ln1": ((cfg.d_model,), ("norm",)),
         "ln2": ((cfg.d_model,), ("norm",))}
    s.update(rwkv_mod.rwkv_param_shapes(cfg.d_model, cfg.d_ff))
    return s


_BLOCK_SHAPES = {"attn": _attn_shapes, "rglru": _rglru_shapes, "rwkv": _rwkv_shapes}


def param_shapes(cfg: ModelConfig):
    """Full logical parameter tree: {name: (shape, logical_axes)}."""
    tree: dict[str, Any] = {
        "embed": ((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_d")),
        "final_norm": ((cfg.d_model,), ("norm",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_d"))
    blocks = []
    for pattern, repeat in scan_groups(cfg):
        grp = {}
        for pi, kind in enumerate(pattern):
            grp[str(pi)] = {
                k: ((repeat,) + shp, ("layers",) + axes)
                for k, (shp, axes) in _BLOCK_SHAPES[kind](cfg).items()
            }
        blocks.append(grp)
    tree["blocks"] = blocks
    return tree


def logical_axes_tree(cfg: ModelConfig):
    """:func:`param_shapes` with each leaf's logical axes in place of its
    (shape, axes) pair."""
    def axes(tree):
        if isinstance(tree, dict):
            return {k: axes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [axes(v) for v in tree]
        return tree[1]
    return axes(param_shapes(cfg))


def _shape_tree_map(fn: Callable, shapes, name: Optional[str] = None):
    """``fn(name, shape)`` over a :func:`param_shapes` tree, in its order."""
    if isinstance(shapes, dict):
        return {k: _shape_tree_map(fn, v, k) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_shape_tree_map(fn, v, name) for v in shapes]
    return fn(name, shapes[0])


#: the leaves ``forward`` reads in float32 (float64 in a float64 forward)
#: whatever the compute dtype: the norm scales, RG-LRU's ``lam``, RWKV6's
#: ``w0``, ``u`` and group-norm affine
FLOAT32_LEAVES = ("ln1", "ln2", "final_norm", "qnorm", "knorm", "lam", "w0", "u",
                  "ln_w", "ln_b")

_ZERO_INIT = ("ln1", "ln2", "final_norm", "qnorm", "knorm", "ln_w",
              "b_in", "b_out", "bq", "bk", "bv", "ln_b", "u")


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32):
    """Random parameters drawn from ``gen``, on ``gen``'s device.

    The reference's recipe: N(0, 1) / sqrt(fan_in) with ``fan_in`` the
    second-to-last dim of the stored (layer-stacked) shape — so 1/sqrt(H)
    for ``wq`` [L, D, H, dh] and 1/sqrt(V) for ``embed`` — then the norms
    and biases zeroed, ``mu_*`` at 0.5, ``w0`` at -6, ``lam`` from U(0.9,
    0.999) mapped through the RG-LRU's softplus-inverse, and the padded
    heads' slices of ``wq``/``bq``/``wo`` zeroed.  The numbers differ from
    the reference's ``jax.random`` draw (and its ``lam`` draw, keyed by
    ``hash(name)``, differs per process); parity runs inject the
    reference's tree through :func:`params_from_numpy`.
    """
    dev = gen.device

    def make(name, shape):
        if name in _ZERO_INIT:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if name.startswith("mu_"):
            return torch.full(shape, 0.5, dtype=dtype, device=dev)
        if name == "w0":
            return torch.full(shape, -6.0, dtype=dtype, device=dev)
        if name == "lam":
            un = torch.rand(shape, generator=gen, device=dev) * (0.999 - 0.9) + 0.9
            a = -torch.log(un) / rglru_mod.C_SCALE
            return torch.log(torch.expm1(torch.clamp(a, min=1e-6))).to(dtype)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        w = torch.randn(shape, generator=gen, device=dev)
        return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dtype)

    params = _shape_tree_map(make, param_shapes(cfg))
    if cfg.padded_heads != cfg.n_heads:
        hmask = (torch.arange(cfg.padded_heads, device=dev) < cfg.n_heads).to(dtype)
        for grp in params["blocks"]:
            for p in grp.values():
                if "wq" in p:
                    p["wq"].mul_(hmask[:, None])
                    p["wo"].mul_(hmask[:, None, None])
                if "bq" in p:
                    p["bq"].mul_(hmask[:, None])
    return params


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree (leaves as numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, params)``) as the port's, on ``device``.
    Each leaf keeps its dtype and bits; its shape is checked against
    :func:`param_shapes`."""
    from repro_torch.backend import resolve_device

    dev = resolve_device(device)

    def put(shapes, sub, path):
        if isinstance(shapes, dict):
            if not isinstance(sub, dict) or set(sub) != set(shapes):
                raise ValueError(f"{path}: keys {sorted(sub) if isinstance(sub, dict) else sub!r}"
                                 f" != {sorted(shapes)}")
            return {k: put(v, sub[k], f"{path}/{k}") for k, v in shapes.items()}
        if isinstance(shapes, list):
            if len(sub) != len(shapes):
                raise ValueError(f"{path}: {len(sub)} groups != {len(shapes)}")
            return [put(v, s, f"{path}/{i}") for i, (v, s) in enumerate(zip(shapes, sub))]
        t = _tensor_from_numpy(sub)
        if tuple(t.shape) != tuple(shapes[0]):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {shapes[0]}")
        return t.to(dev)

    return put(param_shapes(cfg), tree, "params")


def params_to_numpy(params):
    """The port's parameter tree as numpy arrays (the reference's layout).
    bf16 leaves come back as float32, which holds them exactly."""
    def get(_, t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(get, params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _block_cache_shape(cfg: ModelConfig, kind: str, batch: int, smax: int,
                       dtype, lead=(), device=None):
    D, dh, KV = cfg.d_model, cfg.d_head, cfg.padded_kv

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if kind == "attn":
        w = cfg.sliding_window
        slots = min(w, smax) if w else smax
        c = {"k": zeros((batch, slots, KV, dh), dtype),
             "v": zeros((batch, slots, KV, dh), dtype)}
        if w:
            c["pos"] = torch.full(lead + (batch, slots), -1, dtype=torch.int32, device=device)
        return c
    if kind == "rglru":
        R = cfg.d_rnn or D
        return {"conv": zeros((batch, 3, R), dtype),
                "h": zeros((batch, R), torch.float32)}
    if kind == "rwkv":
        H = D // rwkv_mod.HEAD_DIM
        return {"s": zeros((batch, H, rwkv_mod.HEAD_DIM, rwkv_mod.HEAD_DIM), torch.float32),
                "x_prev_t": zeros((batch, D), dtype),
                "x_prev_c": zeros((batch, D), dtype)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, smax: int, dtype=torch.bfloat16,
               stacked: bool = True, device=None, mesh=None, serve_seq_shard: bool = False):
    """``stacked=True``: leaves carry a leading layer dim (the layout
    prefill produces).  ``stacked=False``: one subtree per layer.  With a
    ``mesh`` the leaves are ``Sharded`` over its cells, stacked, laid out
    as a mesh decode reads them (``mesh_forward.cache_spec``)."""
    from repro_torch.backend import resolve_device

    if mesh is not None:
        if device is not None:
            raise ValueError("a mesh cache lives on the mesh's devices: pass no device")
        if not stacked:
            raise ValueError("a mesh cache is stacked, as the mesh prefill makes it")
        from repro_torch.models import mesh_forward

        return mesh_forward.init_cache(cfg, batch, smax, dtype, mesh, serve_seq_shard)

    dev = resolve_device(device)
    groups = []
    for pattern, repeat in scan_groups(cfg):
        if stacked:
            groups.append({str(pi): _block_cache_shape(cfg, kind, batch, smax, dtype,
                                                       (repeat,), dev)
                           for pi, kind in enumerate(pattern)})
        else:
            groups.append([
                {str(pi): _block_cache_shape(cfg, kind, batch, smax, dtype, (), dev)
                 for pi, kind in enumerate(pattern)}
                for _ in range(repeat)])
    return {"blocks": groups}


def unstack_cache(cfg: ModelConfig, cache):
    """Stacked (prefill) cache -> per-layer layout.  The per-layer leaves
    are views of the stacked ones: a decode writes through to both."""
    groups = []
    for gi, (_, repeat) in enumerate(scan_groups(cfg)):
        gc = cache["blocks"][gi]
        groups.append([tree_map(lambda _, a, li=li: a[li], gc) for li in range(repeat)])
    return {"blocks": groups}


# ---------------------------------------------------------------------------
# block forwards
# ---------------------------------------------------------------------------

def _proj(x, w):
    """x [..., D] against w [D, *out] -> [..., *out]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _ffn_partial(cfg: ModelConfig, p, x):
    """The dense FFN at ``x``'s dtype without the gelu MLP's output bias:
    on a mesh, each cell's row-parallel partial."""
    dt = x.dtype
    if cfg.mlp == "gelu":
        return L.gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt)) @ p["w_out"].to(dt)
    mlp = L.swiglu_mlp if cfg.mlp == "swiglu" else L.geglu_mlp
    return mlp(x, p["w_gate"].to(dt), p["w_up"].to(dt), p["w_down"].to(dt))


def _mlp_forward(cfg: ModelConfig, p, x):
    if cfg.moe is not None:
        return moe_mod.moe_ffn(p, x, cfg.moe)
    y = _ffn_partial(cfg, p, x)
    return y + p["b_out"].to(x.dtype) if cfg.mlp == "gelu" else y


def _qkv(cfg: ModelConfig, p, x, positions):
    """The attention block's q, k, v [B, S, heads, dh] from the residual
    ``x`` at its dtype: ln1, the projections and biases, qk-norm, RoPE."""
    dt = x.dtype
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _proj(xn, p["wq"].to(dt))
    k = _proj(xn, p["wk"].to(dt))
    v = _proj(xn, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["qnorm"], cfg.norm_eps)
        k = L.rms_norm(k, p["knorm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _causal_attention(q, k, v, *, window, causal_skip, chunk_q, chunk_kv):
    """Train and prefill attention: the whole score matrix up to
    ``max(chunk_q, 256)`` positions, chunked beyond."""
    if q.shape[1] <= max(chunk_q, 256):
        return L.attention_full(q, k, v, causal=True, window=window)
    return L.attention_chunked(q, k, v, causal=True, window=window, chunk_q=chunk_q,
                               chunk_kv=chunk_kv, causal_skip=causal_skip)


def _attn_out(out, wo):
    """The attention's output [B, S, heads, dh] through ``wo`` [heads, dh, D]."""
    return out.reshape(out.shape[0], out.shape[1], -1) @ wo.reshape(-1, wo.shape[-1])


def _attn_forward(cfg, p, x, positions, cache, *, mode, lengths,
                  causal_skip, chunk_q, chunk_kv):
    B, S, _ = x.shape
    dt = x.dtype
    q, k, v = _qkv(cfg, p, x, positions)
    window = cfg.sliding_window
    new_cache = {}
    if mode in ("train", "prefill"):
        out = _causal_attention(q, k, v, window=window, causal_skip=causal_skip,
                                chunk_q=chunk_q, chunk_kv=chunk_kv)
        if mode == "prefill":
            if window:
                # ring-buffer invariant: global position p lives in slot
                # p % slots, so later decode writes replace the oldest entry
                slots = min(window, S)
                shift = S % slots
                new_cache = {
                    "k": torch.roll(k[:, -slots:], shift, dims=1),
                    "v": torch.roll(v[:, -slots:], shift, dims=1),
                    "pos": torch.roll(positions[:, -slots:].to(torch.int32), shift, dims=1),
                }
            else:
                new_cache = {"k": k, "v": v}
    else:  # decode: S == 1, the cache written in place
        kc, vc = cache["k"], cache["v"]
        if window:
            bidx = torch.arange(B, device=x.device)
            slot = (lengths % kc.shape[1]).long()
            kc[bidx, slot] = k[:, 0].to(kc.dtype)
            vc[bidx, slot] = v[:, 0].to(vc.dtype)
            cache["pos"][bidx, slot] = lengths.to(torch.int32)
            out1 = _decode_ring(q[:, 0], kc.to(dt), vc.to(dt), cache["pos"], lengths)
        else:
            cache_write(kc, k[:, 0], lengths)       # a write past the end is dropped
            cache_write(vc, v[:, 0], lengths)
            out1 = L.attention_decode(q[:, 0], kc.to(dt), vc.to(dt), lengths + 1)
        new_cache = cache
        out = out1[:, None]

    x = x + _attn_out(out, p["wo"].to(dt))
    xn2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp_forward(cfg, p, xn2), new_cache


def _decode_ring(q, kc, vc, posbuf, lengths):
    """Decode attention over a ring (sliding-window) cache with explicit
    per-slot global positions."""
    b, h, dh = q.shape
    kv = kc.shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", L.upcast(qg), L.upcast(kc)) * (dh ** -0.5)
    msk = (posbuf >= 0) & (posbuf <= lengths[:, None])
    sc = torch.where(msk[:, None, None, :], sc, L.NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", pr.to(vc.dtype), vc)
    return out.reshape(b, h, dh)


def _write_state(cache, new):
    """Decode: the block's new states copied into the cache tensors it was
    given (views of a stacked cache, or a per-layer layout's own)."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def _rglru_forward(cfg, p, x, positions, cache, *, mode, **_):
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, nc = rglru_mod.recurrent_branch(p, xn, cache=cache if mode == "decode" else None)
    x = x + y
    xn2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _mlp_forward(cfg, p, xn2)
    if mode == "decode":
        return x, _write_state(cache, nc)
    return x, nc if mode == "prefill" else {}


def _rwkv_forward(cfg, p, x, positions, cache, *, mode, **_):
    decode = mode == "decode"
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, ntc = rwkv_mod.time_mix(
        p, xn, cache={"s": cache["s"], "x_prev": cache["x_prev_t"]} if decode else None)
    x = x + y
    xn2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y2, ncc = rwkv_mod.channel_mix(p, xn2, cache={"x_prev": cache["x_prev_c"]} if decode else None)
    x = x + y2
    nc = {"s": ntc["s"], "x_prev_t": ntc["x_prev"], "x_prev_c": ncc["x_prev"]}
    if decode:
        return x, _write_state(cache, nc)
    return x, nc if mode == "prefill" else {}


_BLOCK_FWD = {"attn": _attn_forward, "rglru": _rglru_forward, "rwkv": _rwkv_forward}


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    mode: str,                    # train | prefill | decode
    mesh=None,
    cache=None,
    lengths: Optional[torch.Tensor] = None,
    remat: bool = True,
    causal_skip: bool = False,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    serve_seq_shard: bool = False,
    compute_dtype=torch.bfloat16,
    return_hidden: bool = False,
):
    """Returns (logits, cache).  logits: [B, S, V] for train, [B, 1, V] for
    prefill (last position) and decode.  ``return_hidden`` skips the output
    projection and returns the final-normed hidden states instead (the
    fused chunked loss projects them chunk by chunk).  ``remat`` applies
    in train mode with grad enabled: one checkpoint a layer (one period of
    its group's pattern).

    ``mesh``: prefill or decode on the mesh's cells (``mesh_forward``):
    the parameters and the cache ``Sharded``, the logits returned as a
    ``Sharded`` split by vocab over "model"; ``serve_seq_shard`` splits
    the cache's sequence over "model" (no effect without a mesh, as in the
    reference)."""
    if mesh is not None:
        if return_hidden:
            raise NotImplementedError(f"the hidden states on a mesh (the fused loss) are "
                                      f"{_MESH_13F}")
        from repro_torch.models import mesh_forward

        return mesh_forward.forward(
            cfg, params, batch, mode=mode, mesh=mesh, cache=cache, lengths=lengths,
            causal_skip=causal_skip, chunk_q=chunk_q, chunk_kv=chunk_kv,
            serve_seq_shard=serve_seq_shard, compute_dtype=compute_dtype)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if "embeds" in batch:
        x = batch["embeds"].to(compute_dtype)
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = params["embed"][tokens.long()].to(compute_dtype)

    if mode == "decode":
        if lengths is None or cache is None:
            raise ValueError("decode needs a cache and lengths")
        positions = lengths[:, None]
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.pos_emb == "sinusoidal":
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)

    kw = dict(mode=mode, lengths=lengths, causal_skip=causal_skip, chunk_q=chunk_q,
              chunk_kv=chunk_kv)
    remat = remat and mode == "train" and torch.is_grad_enabled()
    new_groups = []
    for gi, (pattern, repeat) in enumerate(scan_groups(cfg)):
        gp = params["blocks"][gi]
        gc = cache["blocks"][gi] if cache is not None else None
        per_layer = isinstance(gc, (list, tuple))

        def train_layer(xc, li, pattern=pattern, gp=gp):
            for pi, kind in enumerate(pattern):
                lp = {n: t[li] for n, t in gp[str(pi)].items()}
                xc, _ = _BLOCK_FWD[kind](cfg, lp, xc, positions, None, **kw)
            return xc

        outs = []
        for li in range(repeat):
            if remat:
                x = checkpoint(train_layer, x, li, use_reentrant=False)
                outs.append({str(pi): {} for pi in range(len(pattern))})
                continue
            if gc is None:
                lc = {}
            elif per_layer:
                lc = gc[li]
            else:
                lc = {pi: {n: buf[li] for n, buf in c.items()} for pi, c in gc.items()}
            newc = {}
            for pi, kind in enumerate(pattern):
                lp = {n: t[li] for n, t in gp[str(pi)].items()}
                x, newc[str(pi)] = _BLOCK_FWD[kind](
                    cfg, lp, x, positions, lc.get(str(pi)) or None, **kw)
            outs.append(newc)
        if mode == "decode":
            new_groups.append(gc)          # written in place, either layout
        else:                              # stacked over the group's layers
            new_groups.append({pi: {n: torch.stack([o[pi][n] for o in outs])
                                    for n in outs[0][pi]} for pi in outs[0]})

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        x = x[:, -1:]
    if return_hidden:
        return x, {"blocks": new_groups}
    head = params.get("lm_head", params["embed"])
    return x @ head.to(x.dtype).T, {"blocks": new_groups}
