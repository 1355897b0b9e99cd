"""The serving steps: prefill and decode (the reference's ``models/lm.py``).

``cast_params`` casts the float32 master weights to the compute dtype once;
the per-use casts in ``transformer.forward`` are then no-ops, and the
result is bit-equal to casting at each use.  The loss, the int8 pod sync
and the train step are ROADMAP item 13c.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def cast_params(params, dtype=torch.bfloat16):
    """Every float32 leaf cast to ``dtype`` (the others as they are)."""
    return T.tree_map(lambda _, p: p.to(dtype) if p.dtype == torch.float32 else p, params)


def make_prefill_step(cfg: ModelConfig, *, mesh=None, serve_seq_shard=False,
                      chunk_q: int = 512, chunk_kv: int = 512,
                      causal_skip: bool = False, max_seq: Optional[int] = None,
                      compute_dtype=torch.bfloat16):
    """``max_seq`` pads the produced (non-window) KV caches so subsequent
    decode steps have slots to write into."""
    if mesh is not None or serve_seq_shard:
        raise NotImplementedError(f"mesh prefill is {T._MESH_13D}")

    def pad_cache(cache):
        if max_seq is None or cfg.sliding_window:
            return cache

        def fix(name, leaf):
            if name in ("k", "v") and max_seq > leaf.shape[2]:
                # stacked [layers, B, S, KV, dh]: pad S
                return F.pad(leaf, (0, 0, 0, 0, 0, max_seq - leaf.shape[2]))
            return leaf
        return T.tree_map(fix, cache)

    def prefill(params, batch):
        logits, cache = T.forward(
            cfg, params, batch, mode="prefill", causal_skip=causal_skip,
            chunk_q=chunk_q, chunk_kv=chunk_kv, compute_dtype=compute_dtype)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, pad_cache(cache)
    return prefill


def make_decode_step(cfg: ModelConfig, *, mesh=None, serve_seq_shard=False,
                     compute_dtype=torch.bfloat16):
    if mesh is not None or serve_seq_shard:
        raise NotImplementedError(f"mesh decode is {T._MESH_13D}")

    def decode(params, cache, tokens_or_embeds, lengths):
        """tokens [B] int (or embeds [B, D]); lengths [B] = cache fill.
        Writes the cache in place; returns (next tokens, cache, lengths + 1)."""
        if tokens_or_embeds.dtype in (torch.int32, torch.int64):
            batch = {"tokens": tokens_or_embeds[:, None]}
        else:
            batch = {"embeds": tokens_or_embeds[:, None]}
        logits, cache = T.forward(cfg, params, batch, mode="decode", cache=cache,
                                  lengths=lengths, compute_dtype=compute_dtype)
        next_tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return next_tok, cache, lengths + 1
    return decode
