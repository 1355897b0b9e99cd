"""LM objectives and step builders: train, prefill, decode (the reference's
``models/lm.py``).

- loss: masked softmax cross-entropy over the logits; ``fused_loss=True``
  projects the final hidden states chunk by chunk over the sequence, each
  chunk's head product and cross-entropy under ``torch.utils.checkpoint``,
  so the full [B, S, V] logits (and their softmax) are never held.
- train step: gradients from ``torch.autograd.grad`` on the float32
  master leaves, summed over microbatches in order, then the AdamW or
  Adafactor update, in place.
- ``quantize_int8`` and ``compressed_pod_psum``: the stochastic-rounding
  int8 gradient sync over the "pod" axis.
- ``mesh=`` on the loss, the train step and the prefill and decode steps
  runs on a mesh of cells (``models/mesh_forward.py``): the parameters
  laid out by ``distributed.sharding`` (``shard_params``; a train state by
  ``shard_train_state`` under ``train_policy_for``), the batch and the
  results on the mesh's first device.

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
    """Per-token NLL, [B, S], from logits [B, S, V]: :func:`_xent_cells`
    of one slice."""
    return _xent_cells([logits], [0], labels)


def _xent_cells(parts, offsets, labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL of vocab-sharded logits in float32 (float64 stays
    float64): ``parts[i]`` [B, S, V_i] is the i-th "model" cell's slice,
    from vocab index ``offsets[i]`` on.  The row max (detached, as the
    reference's ``stop_gradient``) and the log-sum-exp go across the
    slices, in slice order, and the slice that holds a label picks it, a
    ``gather`` where the reference contracts with a one-hot (with finite
    logits every other product of that contraction is 0, so the pick is
    the same).  On ``parts[0]``'s device.  Across slices the max, the sum
    of exponentials and the pick are each a sum (or max) over the "model"
    cells, counted as such (``collectives.counting``)."""
    from repro_torch.distributed.collectives import note

    dev = parts[0].device
    if len(parts) > 1:
        for _ in range(3):
            note("all-reduce", labels.numel() * 4, "model", len(parts))
    lf = [L.upcast(t) for t in parts]
    m = lf[0].amax(dim=-1, keepdim=True).detach()
    for t in lf[1:]:
        m = torch.maximum(m, t.amax(dim=-1, keepdim=True).detach().to(dev))
    sumexp = picked = None
    for t, off in zip(lf, offsets):
        shifted = t - m.to(t.device)
        se = torch.sum(torch.exp(shifted), dim=-1).to(dev)
        idx = labels.to(t.device).long() - off
        live = (idx >= 0) & (idx < t.shape[-1])
        pk = shifted.gather(-1, idx.clamp(0, t.shape[-1] - 1)[..., None])[..., 0]
        pk = torch.where(live, pk, 0).to(dev)
        sumexp = se if sumexp is None else sumexp + se
        picked = pk if picked is None else picked + pk
    return torch.log(sumexp) - picked


def cast_params(params, dtype=torch.bfloat16):
    """Every float32 leaf cast to ``dtype`` (the others as they are); a
    ``Sharded`` leaf block by block on its cells (the FSDP gathers then
    move ``dtype``)."""
    from repro_torch.distributed.sharding import Sharded

    def cast(_, p):
        if p.dtype != torch.float32:
            return p
        return p.map(lambda t: t.to(dtype)) if isinstance(p, Sharded) else p.to(dtype)
    return T.tree_map(cast, params)


def make_prefill_step(cfg: ModelConfig, *, mesh=None, serve_seq_shard=False,
                      chunk_q: int = 512, chunk_kv: int = 512,
                      causal_skip: bool = False, max_seq: Optional[int] = None,
                      compute_dtype=torch.bfloat16):
    """``max_seq`` pads the produced (non-window) KV caches so subsequent
    decode steps have slots to write into.

    ``mesh``: the prefill on the mesh's cells; the cache comes back laid
    out for the mesh decode at ``max_seq`` positions, or a window's ring of
    ``min(window, S)`` slots (either must divide over "model" when
    ``serve_seq_shard`` splits the cache's sequence)."""
    if mesh is not None:
        from repro_torch.models import mesh_forward

        tp = mesh.shape.get("model", 1)
        full_kv = "attn" in T.layer_pattern(cfg) and not cfg.sliding_window
        if serve_seq_shard and max_seq is not None and max_seq % tp and full_kv:
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
    reference's ``lm_loss`` does not pass ``compute_dtype`` on).

    ``mesh``: the parameters ``Sharded`` on the mesh's cells, the batch on
    its first device (where the loss is returned).  Each token's loss
    counts once: the cross-entropy goes across the "model" cells' vocab
    slices of one row block (:func:`_xent_cells`), and the mean divides by
    the global mask's sum."""
    params = cast_params(params, compute_dtype)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    kw = dict(mode="train", remat=remat, causal_skip=causal_skip, chunk_q=chunk_q,
              chunk_kv=chunk_kv)
    denom = torch.clamp(mask.sum(), min=1.0)
    if mesh is not None:
        return _mesh_nll_sum(cfg, params, batch, labels, mask, mesh, fused_loss, loss_chunk,
                             kw) / denom
    out, _ = T.forward(cfg, params, batch, return_hidden=fused_loss, **kw)
    heads = [params.get("lm_head", params["embed"])] if fused_loss else None
    return _nll_sum([out], [0], labels, mask, heads, loss_chunk) / denom


def _chunk_nll_cells(offsets, labels, mask, n_cells, *tensors):
    """sum(mask * NLL) of one chunk of a row block: ``tensors`` the
    "model" cells' hidden states [B, c, D], then their head slices
    [V_i, D]."""
    hs, heads = tensors[:n_cells], tensors[n_cells:]
    logits = [h @ w.to(h.dtype).T for h, w in zip(hs, heads)]
    return torch.sum(_xent_cells(logits, offsets, labels) * mask)


def _nll_sum(outs, offsets, labels, mask, heads=None, loss_chunk: int = 1024):
    """sum(mask * NLL) of one row block, on ``outs[0]``'s device: ``outs``
    the "model" cells' logits [B, S, V_i] (vocab from ``offsets[i]`` on;
    one device: the one whole slice), or with ``heads`` their final hidden
    states [B, S, D] and head slices [V_i, D] (the fused loss: projected
    chunk by chunk over the sequence, each chunk's products and
    cross-entropy under ``torch.utils.checkpoint`` while gradients are on,
    so a block's [B, S, V] logits are never held)."""
    if heads is None:
        return torch.sum(_xent_cells(outs, offsets, labels) * mask)
    S = outs[0].shape[1]
    c = min(loss_chunk, S)
    if S % c:
        raise ValueError(f"loss_chunk {c} must divide the sequence length {S}")
    total = torch.zeros((), dtype=torch.float32, device=outs[0].device)
    for k in range(S // c):
        sl = slice(k * c, (k + 1) * c)
        part = (offsets, labels[:, sl], mask[:, sl], len(outs), *[h[:, sl] for h in outs],
                *heads)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll_cells, *part, use_reentrant=False)
        else:
            total = total + _chunk_nll_cells(*part)
    return total


def _mesh_nll_sum(cfg, params, batch, labels, mask, mesh, fused_loss, loss_chunk, kw):
    """sum(mask * NLL) over the global batch on ``mesh``, on its first
    device: each row block once (:func:`_nll_sum`), from the first "model"
    group that holds it, the blocks in order."""
    from repro_torch.distributed.sharding import groups_over
    from repro_torch.models import mesh_forward

    out, _ = T.forward(cfg, params, batch, mesh=mesh, return_hidden=fused_loss, **kw)
    groups, seen = [], set()
    for g in groups_over(mesh, "model" if "model" in mesh.axis_names else None):
        b = out.blocks(g[0])[0]
        if b not in seen:
            seen.add(b)
            groups.append(g)
    if fused_loss:
        head, table = mesh_forward.head_cells(cfg, params, mesh)
    home = mesh.home
    total = torch.zeros((), dtype=torch.float32, device=home)
    for g in groups:
        rows = out.slices(g[0])[0]
        dev = out.cells[g[0]].device
        if fused_loss:
            offsets, heads = [head.offset(i, 0) for i in g], [table[i] for i in g]
        else:
            offsets, heads = [out.offset(i, 2) for i in g], None
        total = total + _nll_sum([out.cells[i] for i in g], offsets, labels[rows].to(dev),
                                 mask[rows].to(dev), heads, loss_chunk).to(home)
    return total


# ---------------------------------------------------------------------------
# int8 stochastic-rounding gradient compression (the pod sync)
# ---------------------------------------------------------------------------

def _round_int8(gf: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale + noise), -127, 127).to(torch.int8)


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
    return _round_int8(gf, scale, noise), scale


#: the pod sync's noise: a ``torch.Generator`` seeded from (POD_SEED, step),
#: where the reference folds the step into ``PRNGKey(17)``
POD_SEED = 17


def pod_generator(step: int, device) -> torch.Generator:
    """The generator of the pod sync's noise at ``step``."""
    return torch.Generator(device=device).manual_seed((POD_SEED << 32) + int(step))


def compressed_pod_psum(grads, noise, mesh, axis: str = "pod"):
    """The reference's ``compressed_pod_psum`` on a tree of ``Sharded``
    gradients, each replicated over ``axis``: for every leaf and every cell
    of an ``axis`` group, the leaf quantized to int8 (its scale over the
    whole leaf, each cell's block with its block of the leaf's noise), the
    int32 sum over the group, the largest scale over it, then / n.  The
    reference runs it with replicated in_specs and one key, so every pod
    quantizes the same gradient with the same noise: the result is the
    stochastic int8 round trip of the whole gradient.  ``noise``: a tree
    of global U(0, 1) - 0.5 tensors (one a leaf), or a ``torch.Generator``
    that draws them leaf by leaf in ``transformer.tree_leaves`` order, on
    its device.  Returns a new tree."""
    from repro_torch.distributed.collectives import note
    from repro_torch.distributed.sharding import Sharded, groups_over

    n = mesh.shape[axis]
    leaves = T.tree_leaves(grads)
    noises = None if isinstance(noise, torch.Generator) else T.tree_leaves(noise)
    done = {}
    for i, g in enumerate(leaves):
        if noises is not None:
            nz = noises[i]
        else:
            nz = torch.rand(g.shape, generator=noise, dtype=torch.float32,
                            device=noise.device) - 0.5
        home = g.mesh.home
        amax = None
        for ts in g.block_tensors().values():
            a = ts[0].float().abs().max().to(home)
            amax = a if amax is None else torch.maximum(amax, a)
        scale = torch.div(amax, amax.new_full((), 127.0)) + 1e-30
        cells: list = [None] * mesh.size
        for group in groups_over(mesh, axis):
            q = [_round_int8(g.cells[c].float(), scale.to(g.cells[c].device),
                             nz[g.slices(c)].to(g.cells[c].device)) for c in group]
            note("all-reduce", q[0].numel() * 4, axis, len(group))   # the int32 sum
            dev0 = q[0].device
            qs = q[0].to(torch.int32)
            for t in q[1:]:
                qs = qs + t.to(dev0).to(torch.int32)
            ss = scale.to(dev0)            # every cell's scale is the leaf's: the max is it
            val = torch.div(qs.float() * ss, ss.new_full((), float(n))).to(g.dtype)
            for c in group:
                cells[c] = val.to(g.cells[c].device)
        done[id(g)] = Sharded(g.spec, g.shape, g.mesh, cells)
    return T.tree_map(lambda _, g: done[id(g)], grads)


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
    the batch splits into that many accumulation steps (microbatch i takes
    rows [i B / mb, (i + 1) B / mb)), whose losses and float32 gradients are
    summed in order and multiplied by 1 / microbatch.  The step updates the
    state's parameters and optimizer state in place and returns them with
    the step count advanced.

    ``mesh``: the state laid out on the mesh's cells
    (``distributed.sharding.shard_train_state``), the batch on its first
    device; each microbatch splits over the data axes.  The gradients of a
    block's copies on distinct devices are summed and every copy gets the
    sum, so replicas stay equal.  ``pod_compress`` on a mesh with a "pod"
    axis syncs the gradients through :func:`compressed_pod_psum` (noise
    from :func:`pod_generator`); anywhere else it does nothing, as in the
    reference."""
    pod_sync = pod_compress and mesh is not None and "pod" in mesh.axis_names
    _, opt_update = opt_mod.make_optimizer(opt_cfg)

    def loss_and_grads(params, leaves, batch):
        loss = lm_loss(cfg, params, batch, mesh=mesh, remat=remat, fused_loss=fused_loss,
                       causal_skip=causal_skip, chunk_q=chunk_q, chunk_kv=chunk_kv,
                       compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), [L.upcast(g) for g in grads]

    def grads_of(params, batch):
        leaves = _distinct_tensors(params) if mesh is not None else T.tree_leaves(params)
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
        if mesh is not None:
            grads = _replica_sums(state.params, grads)
        if pod_sync:
            grads = compressed_pod_psum(grads, pod_generator(int(state.step), mesh.home), mesh)
        params, opt, gnorm = opt_update(grads, state.opt, state.params)
        del grads
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step


def _distinct_tensors(params) -> list:
    """The distinct cell tensors of a tree of ``Sharded`` leaves, leaf by
    leaf in ``transformer.tree_leaves`` order, each leaf's in cell order."""
    out, seen = [], set()
    for leaf in T.tree_leaves(params):
        for t in leaf.cells:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _replica_sums(params, grads: list) -> list:
    """The gradients of :func:`_distinct_tensors`' tensors as one
    ``Sharded`` a leaf (``transformer.tree_leaves`` order): a block's copies
    on distinct devices each get the sum of their gradients (a fold in
    ascending cell order), as a partitioner sums a replicated weight's
    gradients over the axes that replicate it.  ``collectives.counting``
    counts that sum once a block over the cells that hold it, one card a
    cell, also where cells share a device and its copies are one tensor."""
    from repro_torch.distributed.collectives import all_reduce, counting_active
    from repro_torch.distributed.sharding import Sharded

    g_of = dict(zip((id(t) for t in _distinct_tensors(params)), grads))
    out = []
    for leaf in T.tree_leaves(params):
        blocks = leaf.block_tensors()
        if counting_active():
            _note_replica_sums(leaf, blocks)
        for ts in blocks.values():
            if len(ts) > 1:
                for t, s in zip(ts, all_reduce([g_of[id(t)] for t in ts], count=False)):
                    g_of[id(t)] = s
        out.append(Sharded(leaf.spec, leaf.shape, leaf.mesh, [g_of[id(t)] for t in leaf.cells]))
    return out


def _note_replica_sums(leaf, blocks: dict) -> None:
    """Count :func:`_replica_sums`' sum of each of ``leaf``'s ``blocks``
    (``Sharded.block_tensors``) as one float32 all-reduce over the axes
    that replicate it, among the cells that hold the block."""
    from repro_torch.distributed.collectives import note
    from repro_torch.distributed.sharding import entry_axes

    split = {a for e in leaf.spec for a in entry_axes(e)}
    replicas = tuple(a for a in leaf.mesh.axis_names if a not in split)
    holders: dict = {}
    for c in range(leaf.mesh.size):
        holders[leaf.blocks(c)] = holders.get(leaf.blocks(c), 0) + 1
    for key, ts in blocks.items():
        note("all-reduce", ts[0].numel() * 4, replicas, holders[key])
