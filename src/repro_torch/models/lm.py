"""LM objectives and step builders: train, prefill, decode (the reference's
``models/lm.py``).

- loss: masked softmax cross-entropy over the logits; ``fused_loss=True``
  projects the final hidden states chunk by chunk over the sequence, each
  chunk's head product and cross-entropy under ``torch.utils.checkpoint``,
  so the full [B, S, V] logits (and their softmax) are never held.
- train step: gradients from ``torch.autograd.grad`` on the float32
  master leaves, summed over microbatches in order, then the AdamW or
  Adafactor update, in place.
- ``quantize_int8``: the stochastic-rounding int8 compression of the
  reference's pod gradient sync; the sync itself
  (``compressed_pod_psum``) is ROADMAP item 13f.
- ``mesh=`` on the prefill and decode steps serves on a mesh of cells
  (``models/mesh_forward.py``): the parameters laid out by
  ``distributed.sharding.shard_params``, the cache on the cells, the next
  tokens gathered on the mesh's first device.  A loss or train step on a
  mesh is ROADMAP item 13f.

``cast_params`` casts the float32 master weights to the compute dtype once;
the per-use casts in ``transformer.forward`` are then no-ops, and the
result is bit-equal to casting at each use.  The cast is differentiable,
so the gradients come back to the float32 leaves in float32.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt_mod


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL, [B, S], from logits [B, S, V] in float32 (float64
    stays float64).  The max is detached, as the reference's
    ``stop_gradient``; the label's logit is a ``gather`` where the
    reference contracts with a one-hot (with finite logits every other
    product of that contraction is 0, so the pick is the same)."""
    lf = L.upcast(logits)
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return lse - picked


def cast_params(params, dtype=torch.bfloat16):
    """Every float32 leaf cast to ``dtype`` (the others as they are)."""
    return T.tree_map(lambda _, p: p.to(dtype) if p.dtype == torch.float32 else p, params)


def make_prefill_step(cfg: ModelConfig, *, mesh=None, serve_seq_shard=False,
                      chunk_q: int = 512, chunk_kv: int = 512,
                      causal_skip: bool = False, max_seq: Optional[int] = None,
                      compute_dtype=torch.bfloat16):
    """``max_seq`` pads the produced (non-window) KV caches so subsequent
    decode steps have slots to write into.

    ``mesh``: the prefill on the mesh's cells; the cache comes back laid
    out for the mesh decode at ``max_seq`` positions (which must divide
    over "model" when ``serve_seq_shard`` splits the cache's sequence)."""
    if mesh is not None:
        from repro_torch.models import mesh_forward

        mesh_forward.check_servable(cfg)
        tp = mesh.shape.get("model", 1)
        if serve_seq_shard and max_seq is not None and max_seq % tp:
            raise ValueError(f"max_seq {max_seq} does not split over model={tp}")

        def prefill_mesh(params, batch):
            n = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
            logits, cache = mesh_forward.forward(
                cfg, params, batch, mode="prefill", mesh=mesh, serve_seq_shard=serve_seq_shard,
                causal_skip=causal_skip, chunk_q=chunk_q, chunk_kv=chunk_kv,
                compute_dtype=compute_dtype,
                cache_len=max(max_seq, n) if max_seq is not None else None)
            return mesh_forward.argmax(logits)[:, -1].to(torch.int32), cache
        return prefill_mesh

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
    """The decode step; ``mesh``: on the mesh's cells, with the tokens,
    lengths and next tokens on the mesh's first device."""
    if mesh is not None:
        from repro_torch.models import mesh_forward

        mesh_forward.check_servable(cfg)

    def decode(params, cache, tokens_or_embeds, lengths):
        """tokens [B] int (or embeds [B, D]); lengths [B] = cache fill.
        Writes the cache in place; returns (next tokens, cache, lengths + 1)."""
        if tokens_or_embeds.dtype in (torch.int32, torch.int64):
            batch = {"tokens": tokens_or_embeds[:, None]}
        else:
            batch = {"embeds": tokens_or_embeds[:, None]}
        logits, cache = T.forward(cfg, params, batch, mode="decode", cache=cache,
                                  lengths=lengths, compute_dtype=compute_dtype, mesh=mesh,
                                  serve_seq_shard=serve_seq_shard)
        if mesh is not None:
            from repro_torch.models import mesh_forward

            next_tok = mesh_forward.argmax(logits)[:, 0].to(torch.int32)
        else:
            next_tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return next_tok, cache, lengths + 1
    return decode


def _chunk_nll_sum(h, head, labels, mask):
    """sum(mask * NLL) of one chunk of hidden states [B, c, D] against the
    head [V, D]."""
    logits = h @ head.to(h.dtype).T
    return torch.sum(_xent(logits, labels) * mask)


def lm_loss(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    mesh=None,
    remat: bool = True,
    fused_loss: bool = False,
    loss_chunk: int = 1024,
    causal_skip: bool = False,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Mean masked NLL, a float32 scalar.  batch: {tokens|embeds, labels
    [B, S], mask [B, S] optional}; the mask's sum is clamped at 1.

    As in the reference, ``compute_dtype`` casts the master weights only:
    the forward runs at its own default compute dtype, bf16 (the
    reference's ``lm_loss`` does not pass ``compute_dtype`` on)."""
    if mesh is not None:
        raise NotImplementedError(f"a mesh loss is {T._MESH_13F}")
    params = cast_params(params, compute_dtype)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    kw = dict(mode="train", remat=remat, causal_skip=causal_skip, chunk_q=chunk_q,
              chunk_kv=chunk_kv)
    denom = torch.clamp(mask.sum(), min=1.0)

    if not fused_loss:
        logits, _ = T.forward(cfg, params, batch, **kw)
        return torch.sum(_xent(logits, labels) * mask) / denom

    hidden, _ = T.forward(cfg, params, batch, return_hidden=True, **kw)
    head = params.get("lm_head", params["embed"])
    S = hidden.shape[1]
    c = min(loss_chunk, S)
    if S % c:
        raise ValueError(f"loss_chunk {c} must divide the sequence length {S}")
    remat_chunks = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        part = (hidden[:, i * c:(i + 1) * c], head, labels[:, i * c:(i + 1) * c],
                mask[:, i * c:(i + 1) * c])
        if remat_chunks:
            total = total + checkpoint(_chunk_nll_sum, *part, use_reentrant=False)
        else:
            total = total + _chunk_nll_sum(*part)
    return total / denom


# ---------------------------------------------------------------------------
# int8 stochastic-rounding gradient compression (the pod sync's codec)
# ---------------------------------------------------------------------------

def quantize_int8(g: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """(q int8, scale): g / scale rounded stochastically, scale = max|g| /
    127 + 1e-30.  ``noise`` is the rounding's U(0, 1) - 0.5 draw (the
    reference draws ``jax.random.uniform(key) - 0.5``); without it the draw
    comes from ``generator``."""
    gf = g.float()
    scale = torch.div(gf.abs().max(), gf.new_full((), 127.0)) + 1e-30
    if noise is None:
        noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                           device=g.device) - 0.5
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# train state and step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def init_train_state(cfg: ModelConfig, gen: torch.Generator, opt_cfg: opt_mod.OptConfig,
                     dtype=torch.float32, device=None) -> TrainState:
    """Random parameters from ``gen`` (on ``gen``'s device, or moved to
    ``device``) and the optimizer's zero state beside them."""
    params = T.init_params(cfg, gen, dtype=dtype)
    if device is not None:
        from repro_torch.backend import resolve_device

        dev = resolve_device(device)
        params = T.tree_map(lambda _, p: p.to(dev), params)
    opt_init, _ = opt_mod.make_optimizer(opt_cfg)
    return TrainState(params=params, opt=opt_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=T.tree_leaves(params)[0].device))


def train_state_from_numpy(cfg: ModelConfig, state, device=None) -> TrainState:
    """The reference's ``TrainState`` with its leaves as numpy arrays
    (``jax.tree.map(np.asarray, state)``) as the port's, on ``device``:
    the params through :func:`transformer.params_from_numpy`, the
    optimizer state (an ``AdamState`` or ``AdafactorState``, told apart by
    its fields) leaf by leaf with its dtype and bits."""
    from repro_torch.backend import resolve_device

    dev = resolve_device(device)
    params = T.params_from_numpy(cfg, state.params, dev)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return T._tensor_from_numpy(tree).to(dev)

    fields = tuple(state.opt._fields)
    if fields == opt_mod.AdamState._fields:
        cls = opt_mod.AdamState
    elif fields == opt_mod.AdafactorState._fields:
        cls = opt_mod.AdafactorState
    else:
        raise ValueError(f"unknown optimizer state fields {fields}")
    opt = cls(*(conv(getattr(state.opt, f)) for f in fields[:-1]),
              step=T._tensor_from_numpy(np.asarray(state.opt.step)).to(dev))
    return TrainState(params=params, opt=opt,
                      step=T._tensor_from_numpy(np.asarray(state.step)).to(dev))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: opt_mod.OptConfig,
    *,
    mesh=None,
    microbatch: int = 1,
    remat: bool = True,
    fused_loss: bool = False,
    causal_skip: bool = False,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    pod_compress: bool = False,
    compute_dtype=torch.bfloat16,
):
    """Returns train_step(state, batch) -> (state, {"loss", "grad_norm"}).

    batch leaves have a leading [global_batch, ...] dim; with microbatch > 1
    the batch splits into that many accumulation steps, whose losses and
    float32 gradients are summed in order and multiplied by 1 / microbatch.
    The step updates the state's parameters and optimizer state in place
    and returns them with the step count advanced."""
    if mesh is not None or pod_compress:
        raise NotImplementedError(f"a mesh train step and the pod sync are {T._MESH_13F}")
    _, opt_update = opt_mod.make_optimizer(opt_cfg)

    def loss_and_grads(params, leaves, batch):
        loss = lm_loss(cfg, params, batch, remat=remat, fused_loss=fused_loss,
                       causal_skip=causal_skip, chunk_q=chunk_q, chunk_kv=chunk_kv,
                       compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), [g.float() for g in grads]

    def grads_of(params, batch):
        leaves = T.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if microbatch <= 1:
                return loss_and_grads(params, leaves, batch)
            mb = {k: v.reshape((microbatch, v.shape[0] // microbatch) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            tot, acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device), None
            for i in range(microbatch):
                loss, grads = loss_and_grads(params, leaves, {k: v[i] for k, v in mb.items()})
                tot = tot + loss
                if acc is None:
                    acc = grads
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                del grads
            inv = 1.0 / microbatch
            for a in acc:
                a.mul_(inv)
            return tot * inv, acc
        finally:
            for p in leaves:
                p.requires_grad_(False)

    def step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        params, opt, gnorm = opt_update(grads, state.opt, state.params)
        del grads
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step
