"""Batched serving engine: slot-based continuous batching over one shared
KV cache (the reference's ``serving/engine.py``).

The engine owns a fixed batch of ``n_slots`` sequences.  Requests queue up;
free slots are prefix-filled one request at a time (token by token through
the decode step, which writes that slot's cache rows), then all active
slots decode in lockstep, with per-slot lengths so ragged sequences are
handled by masking rather than padding-restarts.

Kept from the reference for parity: the decode step returns ``lengths + 1``
for every slot, so an idle slot's length keeps growing, and a request
admitted into a slot that sat idle starts at that nonzero length; a cache
write past ``max_seq`` is dropped.

Also kept, and not reset when a request is admitted into a slot: an
``rglru`` or ``rwkv`` slot's recurrent state and a window cache's ``pos``
(only the slot's length goes back to 0).  Every decode call steps every
slot, the idle ones and, while a request is prefilled, the others too, so
their recurrent states advance on their last tokens; and in a MoE their
tokens are routed with the active ones and take expert capacity from them
(the capacity is the reference's arithmetic on ``n_slots`` tokens).

The loop reports through ``repro_torch.obs``: per-request prefill and
per-step decode run in ``serve.prefill`` / ``serve.decode_step`` spans
(each ends on a host read of the step's tokens, so its time covers the
card's work), an ``active_slots`` gauge tracks occupancy, and
``serve/tokens_decoded`` counts throughput.

``mesh=`` serves on a mesh of cells: global parameters are cast as below
and laid out once by the serve policy (``distributed.sharding.shard_params``);
a tree already laid out as ``Sharded`` leaves (e.g. the ``mlp_2d`` layout
of ``ArchSpec.serve_mlp_2d``) is used as given, each block cast on its
cell.  The bf16 cache is laid out on the cells (its slots split over the
data axes when they divide, else replicated), and the slots' lengths and
tokens stay on the mesh's first device.  Every block kind runs on a mesh;
admission goes through the decode step, so it writes the slot's rows of
every cache kind (k/v, a window's ring and ``pos``, RG-LRU's ``conv``/``h``,
RWKV6's ``s``/``x_prev_*``) on the cells that hold them.

The engine computes in bf16, as the reference's does.  Its float32
weights are cast to bf16 once, except the leaves the forward reads in
float32 (``transformer.FLOAT32_LEAVES``: norm scales, ``lam``, ``w0``,
``u``), which stay float32 as the reference's are read.  Its cache is kept
in bf16 where the reference's is float32 (the recurrent states ``h`` and
``s`` are float32 in both): those entries were bf16 before they were
written, so both caches hold the same values.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.backend import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models import transformer as T
from repro_torch.obs.trace import current_tracer, phase


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S0] int32
    max_new_tokens: int
    out: Optional[list] = None
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_seq: int = 512, mesh=None, serve_seq_shard=False,
                 tracer=None, registry=None, device: DeviceLike = None):
        if mesh is not None:
            if device is not None:
                raise ValueError("a mesh engine runs on the mesh's devices: pass no device")
            from repro_torch.distributed.sharding import Sharded, shard_params

            dev = mesh.home
        else:
            dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh

        def serving_dtype(n, p):
            """bf16 for the float32 leaves outside ``T.FLOAT32_LEAVES``."""
            return (torch.bfloat16 if p.dtype == torch.float32 and n not in T.FLOAT32_LEAVES
                    else None)

        if mesh is not None and isinstance(T.tree_leaves(params)[0], Sharded):
            self.params = T.tree_map(    # laid out already: each block cast on its cell
                lambda n, p: p if serving_dtype(n, p) is None else
                p.map(lambda t: t.to(serving_dtype(n, p))), params)
        elif mesh is not None:   # each cell's block cast on its own device
            self.params = shard_params(cfg, params, mesh, serve_seq_shard=serve_seq_shard,
                                       dtype_of=serving_dtype)
        else:
            self.params = T.tree_map(lambda n, p: p.to(dev, serving_dtype(n, p)), params)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.tracer = tracer if tracer is not None else current_tracer()
        self.registry = registry
        if mesh is not None:
            self.cache = T.init_cache(cfg, n_slots, max_seq, torch.bfloat16, mesh=mesh,
                                      serve_seq_shard=serve_seq_shard)
        else:
            self.cache = T.init_cache(cfg, n_slots, max_seq, torch.bfloat16, device=dev)
        self.lengths = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pending: List[Request] = []
        self._decode = lm_mod.make_decode_step(cfg, mesh=mesh, serve_seq_shard=serve_seq_shard)
        self.last_tok = torch.zeros((n_slots,), dtype=torch.int32, device=dev)

    def submit(self, req: Request):
        req.out = []
        self.pending.append(req)

    def _admit(self):
        """Prefill pending requests into free slots, token by token through
        the decode step (one code path for both)."""
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.pending:
                req = self.pending.pop(0)
                self.slot_req[slot] = req
                with phase("serve.prefill", cat="serve",
                           tracer=self.tracer, registry=self.registry,
                           rid=req.rid, slot=slot,
                           prompt_len=len(req.prompt)):
                    for t in np.asarray(req.prompt, np.int32):
                        tok = self.last_tok.clone()
                        tok[slot] = int(t)
                        nxt, self.cache, _ = self._decode(
                            self.params, self.cache, tok, self.lengths)
                        self.lengths[slot] += 1
                        self.last_tok[slot] = nxt[slot]
                    int(self.last_tok[slot])      # the span ends with the card's work

    def step(self):
        """One decode step for all active slots; retire finished requests."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if self.registry is not None:
            self.registry.gauge("active_slots").set(len(active))
        if not active:
            return False
        with phase("serve.decode_step", cat="serve", tracer=self.tracer,
                   registry=self.registry, active=len(active)):
            nxt, self.cache, self.lengths = self._decode(
                self.params, self.cache, self.last_tok, self.lengths)
            nxt_np = nxt.cpu().numpy()
        if self.registry is not None:
            self.registry.counter("serve/tokens_decoded").inc(len(active))
        for s in active:
            req = self.slot_req[s]
            req.out.append(int(nxt_np[s]))
            if len(req.out) >= req.max_new_tokens:
                req.done = True
                self.slot_req[s] = None
                self.lengths[s] = 0
        self.last_tok = nxt
        return True

    def run(self):
        while self.pending or any(r is not None for r in self.slot_req):
            self.step()
