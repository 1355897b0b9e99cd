"""Cost units: a cell's step cut into pieces that run in seconds on meta
cells, and the meter that reads them (the unit half of the reference's
``benchmarks/roofline.py``).

A whole step over the production mesh's 256 meta cells is too slow to run
(each op on each cell is a Python-level meta call), so a cell is costed
by units, as the reference costs it: one layer of each kind, the
embedding and the head (with its loss and backward in training), each at
its true per-cell shapes and multiplied by its trip count (layers x
microbatches).  The reference's optimizer unit has no counterpart: the
update is elementwise (no counted flop) and exchanges nothing the
counter reads, and its traffic is in ``analytic_bytes``' optimizer
stream.  A unit runs on :func:`unit_mesh`, the
cell's mesh with its data axes ("pod", "data") cut to 1 and the batch cut
to one data shard's rows: every cell of a data group does the same work,
so one group gives the per-cell shapes, flops and "model" collectives,
while :func:`measure` counts the collectives over "data" and "pod" at the
deployment's group sizes (``distributed.collectives.counting``).  The
units times the cells count what ``FlopCounterMode`` counts over the
whole step, with one difference under remat: PyTorch's early-stopping
recompute ends a checkpoint's recompute at its last saved tensor, and a
unit's checkpoint spans one data group's cells where the step's spans
every cell, so each skips one tail (a layer's last product) for a
different number of cells.

:func:`measure` runs a unit under a dispatch mode that

- counts flops with ``torch.utils.flop_counter``'s formulas, as
  ``FlopCounterMode`` counts them (matrix products and attention, not
  elementwise work), split by the dtype of the product's operands;
- sums the bytes each op reads and writes (views excepted): the unfused
  traffic, the counterpart of XLA's ``bytes accessed``;
- tracks every storage the unit creates until it dies, and keeps the
  peak of their bytes: the unit's working set.

Elementwise ops on meta tensors run as Python-level shape functions in
PyTorch (a few hundred microseconds each); the meter answers an
elementwise op on contiguous meta operands itself, from the broadcast of
their shapes and the dtype the op gave the first time it saw those
operand dtypes (a 0-dim operand told from an n-dim one, as type promotion
tells them), which is what the shape function would have returned.
Likewise ``torch.einsum`` on meta tensors outside autograd (the chunked
attention's products, four thousand pairs of tiles a cell at 32k tokens)
runs once for real per signature (equation, operand shapes, strides and
dtypes); a repeat is answered from that run: its output's shape and
strides, its flops, bytes and the transient peak of its decomposition.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchSpec, ShapeConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.launch import builders
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as lm_mod
from repro_torch.models import mesh_forward as MF
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Unit:
    name: str
    fn: Callable
    args: tuple
    mult: float
    layer: bool = False          # a layer unit: its working set is a layer's


def unit_mesh(mesh: Mesh, cut: tuple = ("pod", "data")) -> Mesh:
    """``mesh`` with the axes ``cut`` to 1 (its first data group)."""
    shape = {a: 1 if a in cut else n for a, n in mesh.shape.items()}
    dims = tuple(shape[a] for a in mesh.axis_names)
    return Mesh(axis_names=mesh.axis_names, shape=shape,
                devices=mesh.devices[tuple(slice(0, d) for d in dims)])


def unit_batch(mesh: Mesh, batch: int) -> int:
    """One data shard's rows (all of them where the data axes do not
    divide the batch: it is replicated)."""
    n = builders.dp_size(mesh)
    return batch // n if batch % n == 0 else batch


def kind_counts(cfg) -> dict:
    counts: dict = {}
    for k in T.layer_pattern(cfg):
        counts[k] = counts.get(k, 0) + 1
    return counts


def _first_position(cfg, kind: str) -> tuple[int, int]:
    for gi, (pattern, _) in enumerate(T.scan_groups(cfg)):
        if kind in pattern:
            return gi, pattern.index(kind)
    raise ValueError(kind)


def _layer_structs(cfg, kind, policy, mesh, dtype) -> dict:
    """One layer of ``kind`` as layer-stacked (1, ...) ``Sharded`` zeros."""
    out = {}
    for nm, (shape, axes) in T._BLOCK_SHAPES[kind](cfg).items():
        out[nm] = shd.zeros((1,) + shape, policy.spec(("layers",) + axes), mesh, dtype)
    return out


def _head_structs(cfg, policy, mesh, dtype) -> dict:
    leaf = lambda: shd.zeros((cfg.padded_vocab, cfg.d_model),  # noqa: E731
                             policy.spec(("vocab", "embed_d")), mesh, dtype)
    params = {"embed": leaf()}
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf()
    return params


def _cells_x(cl, s, d, dtype, grad=False) -> list:
    """Each cell's rows of the residual stream (each its own tensor, as the
    forward's)."""
    return [torch.zeros((cl.b_loc, s, d), dtype=dtype, device=cl.dev[c]).requires_grad_(grad)
            for c in range(cl.n)]


def _positions(cl, s) -> list:
    pos = {d: torch.arange(s, device=d)[None].expand(cl.b_loc, s) for d in set(cl.dev)}
    return [pos[cl.dev[c]] for c in range(cl.n)]


def _train_grads(p, forward):
    """The train step's gradients of a unit's laid-out float32 leaves
    ``p``: ``forward(p cast to bf16)`` gives (loss, input tensors); the
    gradients of ``p``'s distinct cell tensors (and of the inputs), then
    the replica sums the step makes (``lm._replica_sums``)."""
    leaves = lm_mod._distinct_tensors(p)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, inputs = forward(lm_mod.cast_params(p))
        if not loss.requires_grad:              # nothing of p used (embeds given)
            return loss
        grads = torch.autograd.grad(loss, leaves + inputs, allow_unused=True,
                                    materialize_grads=True)
        return lm_mod._replica_sums(p, [g.float() for g in grads[:len(leaves)]])
    finally:
        for t in leaves:
            t.requires_grad_(False)


def _tokens(b, s, mesh) -> torch.Tensor:
    return torch.zeros((b, s), dtype=torch.int32, device=mesh.home)


def _embed_unit(spec, mesh, b, s, policy, dtype, train: bool, mult: float = 1.0) -> Unit:
    """The embedding lookup (its FSDP gather, the sum over "model"); in
    training with its backward."""
    cfg = spec.model
    params = _head_structs(cfg, policy, mesh, dtype)
    if cfg.frontend in ("audio_stub", "vision_stub"):
        batch = {"embeds": torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16,
                                       device=mesh.home)}
    else:
        batch = {"tokens": _tokens(b, s, mesh)}

    def run(p, bt):
        cl = MF._Cells(cfg, mesh, b, False)
        if not train:
            return MF.embed_cells(cfg, p, bt, cl, torch.bfloat16)

        def forward(pc):
            x = MF.embed_cells(cfg, pc, bt, cl, torch.bfloat16)
            return sum(t.float().sum() for t in x), []
        return _train_grads(p, forward)
    return Unit("embed", run, (params, batch), mult)


def _layer_unit(spec, kind, count, mesh, b, s, policy, mode, opts, mult) -> Unit:
    """One layer of ``kind`` through ``mesh_forward``'s block: train (value
    and gradients, under remat as the step runs it), prefill (its cache
    block made) or decode (its cache block written)."""
    cfg = spec.model
    dtype = torch.float32 if mode == "train" else torch.bfloat16
    lp = _layer_structs(cfg, kind, policy, mesh, dtype)
    gi, pi = _first_position(cfg, kind)
    gd = MF.gather_dims(cfg)["blocks"][gi][str(pi)]
    seq_shard = spec.serve_seq_shard and mode != "train"
    dt = torch.bfloat16
    attn_kw = dict(causal_skip=opts.causal_skip, chunk_q=opts.chunk_q, chunk_kv=opts.chunk_kv)
    block = MF._BLOCKS[kind]
    cache = None
    if mode == "decode":
        lay = MF.block_cache_layout(cfg, kind, mesh, b, s, dt, seq_shard)
        cache = {nm: shd.zeros((1,) + shape, (None,) + sp, mesh, d)
                 for nm, (shape, sp, d) in lay.items()}

    def run(p, c):
        cl = MF._Cells(cfg, mesh, b, seq_shard)
        if mode == "decode":
            x = _cells_x(cl, 1, cfg.d_model, dt)
            lens = [torch.full((cl.b_loc,), s - 1, dtype=torch.int32, device=cl.dev[i])
                    for i in range(cl.n)]
            lc = {nm: cl.layer(t, 0) for nm, t in c.items()}
            return block(cfg, cl, p, gd, 0, x, [ln[:, None] for ln in lens], lc, None,
                         mode="decode", lens=lens, cache_len=s, dt=dt, attn_kw=attn_kw)
        pos = _positions(cl, s)
        if mode == "prefill":
            outs = {nm: [[None] for _ in range(cl.n)] for nm in
                    MF.block_cache_layout(cfg, kind, mesh, b, s, dt, seq_shard)}
            y = block(cfg, cl, p, gd, 0, _cells_x(cl, s, cfg.d_model, dt), pos, None, outs,
                      mode="prefill", lens=None, cache_len=s, dt=dt, attn_kw=attn_kw)
            return y, outs

        def forward(pc):
            x = _cells_x(cl, s, cfg.d_model, dt, grad=True)

            def layer(*xs):
                return tuple(block(cfg, cl, pc, gd, 0, list(xs), pos, None, None, mode="train",
                                   lens=None, cache_len=s, dt=dt, attn_kw=attn_kw))
            y = (checkpoint(layer, *x, use_reentrant=False) if opts.remat and spec.remat
                 else layer(*x))
            return sum(t.float().sum() for t in y), x
        return _train_grads(p, forward)
    return Unit(f"layer_{kind}_{mode}", run, (lp, cache), mult, layer=True)


def _head_unit(spec, mesh, b, s, policy, opts, train: bool, name: str, mult) -> Unit:
    """The output head on the final hidden states: train — the logits'
    cross-entropy over the vocab-sharded slices (``fused_loss``: chunk by
    chunk, as the step) and its backward; serve — the last position's
    logits and their argmax."""
    cfg = spec.model
    dtype = torch.float32 if train else torch.bfloat16
    params = _head_structs(cfg, policy, mesh, dtype)
    dt = torch.bfloat16

    def run(p):
        cl = MF._Cells(cfg, mesh, b, False)
        if not train:
            head, table = MF.head_cells(cfg, p, mesh)
            h = _cells_x(cl, 1, cfg.d_model, dt)
            logits = [h[c] @ table[c].to(dt).T for c in range(cl.n)]
            return MF.argmax(cl.sharded((cl.dpb, None, head.spec[0]),
                                        (b, 1, head.shape[0]), logits))

        def forward(pc):
            head, table = MF.head_cells(cfg, pc, mesh)
            h = _cells_x(cl, s, cfg.d_model, dt, grad=True)
            total = 0.0
            for g in shd.groups_over(mesh, "model"):
                dev = cl.dev[g[0]]
                labels = torch.zeros((cl.b_loc, s), dtype=torch.int32, device=dev)
                mask = torch.ones((cl.b_loc, s), dtype=torch.float32, device=dev)
                offsets = [head.offset(i, 0) for i in g]
                if opts.fused_loss:
                    part = lm_mod._nll_sum([h[i] for i in g], offsets, labels, mask,
                                           [table[i] for i in g])
                else:
                    part = lm_mod._nll_sum([h[i] @ table[i].to(dt).T for i in g], offsets,
                                           labels, mask)
                total = total + part
            return total, h
        return _train_grads(p, forward)
    return Unit(name, run, (params,), mult)


def train_units(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
                opts: builders.CellOpts) -> tuple[list[Unit], Mesh]:
    """One layer of each kind (forward, backward and, under remat, the
    recomputed forward) x layers x microbatches, the embedding and the
    loss head x microbatches.  Returns (units, the mesh they run on)."""
    cfg = spec.model
    view = builders.tp1_view(mesh) if opts.tp1 else mesh
    mb = max(1, min(opts.microbatch or spec.microbatch, shape.batch // builders.dp_size(view)))
    b = unit_batch(view, shape.batch // mb)
    um = unit_mesh(view)
    policy = builders._train_policy(spec, mesh, tp1=opts.tp1)
    units = [_layer_unit(spec, kind, count, um, b, shape.seq, policy, "train", opts,
                         count * mb)
             for kind, count in kind_counts(cfg).items()]
    units.append(_embed_unit(spec, um, b, shape.seq, policy, torch.float32, True, mb))
    units.append(_head_unit(spec, um, b, shape.seq, policy, opts, True, "loss_head_train", mb))
    return units, um


def fwd_units(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
              opts: builders.CellOpts) -> tuple[list[Unit], Mesh]:
    """Prefill: one layer of each kind (its cache block made) x layers, the
    embedding, the last position's logits."""
    cfg = spec.model
    b = unit_batch(mesh, shape.batch)
    um = unit_mesh(mesh)
    policy = builders._serve_policy(spec, mesh)
    units = [_layer_unit(spec, kind, count, um, b, shape.seq, policy, "prefill", opts, count)
             for kind, count in kind_counts(cfg).items()]
    units.append(_embed_unit(spec, um, b, shape.seq, policy, torch.bfloat16, False))
    units.append(_head_unit(spec, um, b, 1, policy, opts, False, "logits_last", 1.0))
    return units, um


def decode_units(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
                 opts: builders.CellOpts) -> tuple[list[Unit], Mesh]:
    """Decode: one layer of each kind against its cache block x layers,
    the embedding of one token a row, the logits and their argmax."""
    cfg = spec.model
    b = unit_batch(mesh, shape.batch)
    um = unit_mesh(mesh)
    policy = builders._serve_policy(spec, mesh)
    units = [_layer_unit(spec, kind, count, um, b, shape.seq, policy, "decode", opts, count)
             for kind, count in kind_counts(cfg).items()]
    units.append(_embed_unit(spec, um, b, 1, policy, torch.bfloat16, False))
    units.append(_head_unit(spec, um, b, 1, policy, opts, False, "logits_decode", 1.0))
    return units, um


def units_for(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh, opts: builders.CellOpts):
    if shape.kind == "train":
        return train_units(spec, shape, mesh, opts)
    if shape.kind == "prefill":
        return fwd_units(spec, shape, mesh, opts)
    return decode_units(spec, shape, mesh, opts)


# ---------------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------------

def _leaves(tree, out=None) -> list:
    """The leaves of an op's arguments or results (tuples, lists, dicts)."""
    out = [] if out is None else out
    if isinstance(tree, (tuple, list)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _leaves(x, out)
    else:
        out.append(tree)
    return out


def _tensors(tree) -> list:
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _broadcast(shapes) -> tuple:
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[i] not in (1, n):
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = n
    return tuple(out)


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Meter(TorchDispatchMode):
    """Flops by operand dtype (``torch.utils.flop_counter``'s formulas,
    decomposing what they do not cover as ``FlopCounterMode`` does), the
    bytes ops read and write, and the live bytes of the storages created
    inside (with their peak).  ``external``: storages that existed before
    (the arguments), never counted as created."""

    def __init__(self, external=()):
        super().__init__()
        self.dtypes: dict = {}
        self.composite: dict = {}
        self.flops: dict = {}
        self.bytes = 0
        self.live: dict = {}
        self.current = self.peak = 0
        self.external = {t.untyped_storage()._cdata for t in external}

    def _composite(self, func) -> bool:
        """Whether ``func`` decomposes (``FlopCounterMode`` counts the
        pieces of what its formulas do not cover)."""
        hit = self.composite.get(func)
        if hit is None:
            hit = self.composite[func] = (
                func is not torch.ops.prim.device.default
                and (_COMPOSITE in func.py_kernels
                     or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _COMPOSITE)))
        return hit

    def _free(self, key) -> None:
        self.current -= self.live.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.external or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.current += self.live[key]
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, key)

    def _pointwise(self, func, args, kwargs, leaves, ins):
        """An elementwise op on contiguous meta operands, answered from the
        broadcast shape and the op's result dtype for these operand types
        (each tensor's dtype and whether it is 0-dim); None where that does
        not apply."""
        if torch.Tag.pointwise not in func.tags or "out" in kwargs:
            return None
        if not ins or any(t.device.type != "meta" and t.dim() for t in ins) or \
                not all(t.is_contiguous() for t in ins):
            return None
        shape = _broadcast([t.shape for t in ins])
        a0 = func._schema.arguments[0].alias_info
        if a0 is not None and a0.is_write:            # in place: the first operand
            return args[0] if tuple(args[0].shape) == shape else None
        # a 0-dim tensor promotes like a Python scalar (it does not widen an
        # n-dim operand), so the key tells it from an n-dim one
        key = (func,) + tuple((a.dtype, a.dim() == 0) if isinstance(a, torch.Tensor)
                              else type(a) for a in leaves)
        dtype = self.dtypes.get(key)
        if dtype is None:
            out = func(*args, **kwargs)
            if not isinstance(out, torch.Tensor):
                return None
            self.dtypes[key] = out.dtype
            return out
        return torch.empty(shape, dtype=dtype, device="meta")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves((args, kwargs))
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        out = self._pointwise(func, args, kwargs, leaves, ins)
        if out is not None:
            self.bytes += sum(_nbytes(t) for t in ins) + _nbytes(out)
            self._track([out])
            return out
        if func._overloadpacket not in flop_registry and self._composite(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = ins[0].dtype if ins else torch.float32
            self.flops[dt] = self.flops.get(dt, 0) + n
        outs = _tensors(out)
        if not getattr(func, "is_view", False):
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self._track(outs)
        return out


class _MetaEinsum(TorchFunctionMode):
    """``torch.einsum`` on meta operands without autograd, run once for
    real per signature (equation, operand shapes, strides and dtypes) and
    answered from that run afterwards (see the module docstring);
    anything else as it is."""

    def __init__(self, meter: Meter):
        super().__init__()
        self.meter = meter
        self.seen: dict = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.functional.einsum or func is torch.einsum:
            key = self._key(args, kwargs)
            if key is not None:
                return self._einsum(key, func, args)
        return func(*args, **kwargs)

    @staticmethod
    def _key(args, kwargs):
        if kwargs or len(args) < 2 or not isinstance(args[0], str):
            return None
        ops = args[1:]
        if not all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in ops) or \
                (torch.is_grad_enabled() and any(t.requires_grad for t in ops)):
            return None
        return (args[0],) + tuple((tuple(t.shape), t.stride(), t.storage_offset(), t.dtype)
                                  for t in ops)

    def _einsum(self, key, func, args):
        m = self.meter
        hit = self.seen.get(key)
        if hit is None:                 # run it: its flops, bytes and transient peak
            flops0, bytes0, base, peak0 = dict(m.flops), m.bytes, m.current, m.peak
            m.peak = m.current
            out = func(*args)
            hit = ({k: v - flops0.get(k, 0) for k, v in m.flops.items()}, m.bytes - bytes0,
                   m.peak - base, tuple(out.shape), out.stride(), out.dtype)
            m.peak = max(peak0, m.peak)
            self.seen[key] = hit
            return out
        flops, nbytes, extra, shape, stride, dtype = hit
        for k, v in flops.items():
            m.flops[k] = m.flops.get(k, 0) + v
        m.bytes += nbytes
        m.peak = max(m.peak, m.current + extra)
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _arg_tensors(args) -> list:
    out = []
    for leaf in T.tree_leaves(list(args)):
        if isinstance(leaf, shd.Sharded):
            out.extend(leaf.cells)
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def measure(fn: Callable, args: tuple, n_cells: int, sizes: dict) -> dict:
    """Run ``fn(*args)`` under a :class:`Meter` and a collective count over
    ``n_cells`` cells with the deployment's axis ``sizes``.  Returns the
    totals over the cells: {"flops_by_dtype": {dtype name: flops},
    "flops", "bytes", "peak_bytes", "collectives": Counter}."""
    meter = Meter(_arg_tensors(args))
    with coll.counting(n_cells, sizes) as ctr, _MetaEinsum(meter), meter:
        fn(*args)
    by_dtype = {str(k).removeprefix("torch."): float(v) for k, v in meter.flops.items()}
    return {"flops_by_dtype": by_dtype, "flops": float(sum(meter.flops.values())),
            "bytes": float(meter.bytes), "peak_bytes": int(meter.peak), "collectives": ctr}


_MEMO: dict = {}


def cost_cell(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
              opts: builders.CellOpts = builders.CellOpts()) -> dict:
    """The units of a cell measured (:func:`measure`), per cell and times
    their multiplicities: {"units": [...], "flops", "flops_by_dtype",
    "bytes", "collectives" (``Counter.summary`` merged), "working_set_bytes"
    (a layer unit's peak a cell, the largest), "unit_cells", "unit_peak_bytes"
    (that unit's peak over every cell of the unit mesh)}.  Memoised per
    (spec, shape, mesh shape, opts) on meta meshes."""
    if mesh.home.type != "meta":
        return _cost(spec, shape, mesh, opts)
    key = (spec, shape, mesh.axis_names, tuple(mesh.shape.values()), opts)
    if key not in _MEMO:
        _MEMO[key] = _cost(spec, shape, mesh, opts)
    return _MEMO[key]


def _cost(spec, shape, mesh, opts) -> dict:
    units, um = units_for(spec, shape, mesh, opts)
    sizes = dict(mesh.shape)
    if opts.tp1:
        sizes = dict(builders.tp1_view(mesh).shape)
    res = {"units": [], "flops": 0.0, "flops_by_dtype": {}, "bytes": 0.0,
           "working_set_bytes": 0, "unit_cells": um.size, "unit_peak_bytes": 0}
    colls = []
    for u in units:
        n = _mesh_of(u.args).size
        m = measure(u.fn, u.args, n, sizes)
        cs = m["collectives"].summary(u.mult)
        f = m["flops"] / n * u.mult
        res["flops"] += f
        for k, v in m["flops_by_dtype"].items():
            res["flops_by_dtype"][k] = res["flops_by_dtype"].get(k, 0.0) + v / n * u.mult
        res["bytes"] += m["bytes"] / n * u.mult
        if u.layer and m["peak_bytes"] // n > res["working_set_bytes"]:
            res["working_set_bytes"] = m["peak_bytes"] // n
            res["unit_peak_bytes"] = m["peak_bytes"]
        colls.append(cs)
        res["units"].append({"unit": u.name, "mult": u.mult, "flops": f,
                             "flops_by_dtype": {k: v / n * u.mult
                                                for k, v in m["flops_by_dtype"].items()},
                             "bytes": m["bytes"] / n * u.mult,
                             "coll_bytes": cs["total_bytes"], "collectives": cs["count"],
                             "peak_bytes": m["peak_bytes"]})
    res["collectives"] = merge_summaries(colls)
    return res


def _mesh_of(tree) -> Mesh:
    for leaf in T.tree_leaves(tree):
        if isinstance(leaf, shd.Sharded):
            return leaf.mesh
    raise ValueError("no laid-out leaf")


def merge_summaries(parts: list) -> dict:
    """The sum of ``Counter.summary`` dicts."""
    out = {"bytes": {}, "count": {}, "total_bytes": 0.0, "bytes_by_axis": {}}
    for p in parts:
        for key in ("bytes", "count", "bytes_by_axis"):
            for k, v in p[key].items():
                out[key][k] = out[key].get(k, 0) + v
        out["total_bytes"] += p["total_bytes"]
    return out

