"""Sharding policies for the LM stack (logical-axis rules, t5x-style), and
the per-cell tensors they lay out (the reference's
``distributed/sharding.py``).

Every parameter is created together with a tuple of *logical* axis names
(``models.transformer.param_shapes``); a policy maps logical names to mesh
axes.

Policies:
- TRAIN   : FSDP + TP.  Weight matrices are 2D-sharded ("d_model" over the
            data axis, "ff"/"heads" over the model axis).  Ported with the
            module; no path runs it before ROADMAP item 13f.
- SERVE   : TP only on the model axis (weights replicated over data so
            decode needs no per-step parameter gathers); the big MLPs of
            >=100B models are 2D-sharded over (data, model) instead
            (``mlp_2d``, whose forward is item 13f).
- The batch ("dp") axes are ("pod", "data") when the pod axis exists.

Archs whose head counts do not divide the model axis (musicgen 24H,
qwen1.5 20H, recurrentgemma 10H) zero-pad q (and, for MHA, kv) heads to the
next multiple of 16 — exact function, bounded extra projection flops.

A spec is a plain tuple with one entry per dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (split over their product, the first
name major).  The reference's ``constrain`` and ``tree_shardings`` are
layout hints for XLA's partitioner and have no eager counterpart: here one
host program drives the cells of a ``launch.mesh.Mesh``, and what the
partitioner did implicitly is explicit — :class:`Sharded` holds one tensor
per cell, :func:`shard_tree` / :func:`unshard_tree` lay a tree out and
gather it back bit for bit, and :func:`cell_bytes` counts what each cell
would hold on a card of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

Entry = Optional[str | tuple[str, ...]]


def dp_axes(mesh) -> tuple[str, ...]:
    """The pure-data-parallel axes of a mesh: ('pod','data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """logical axis name -> mesh axis (or None = replicate)."""
    rules: Mapping[str, Entry]
    name: str = "custom"

    def spec(self, logical_axes: tuple[str | None, ...]) -> tuple:
        return tuple(self.rules.get(a) if a is not None else None for a in logical_axes)

    def with_overrides(self, name=None, **overrides) -> "ShardingPolicy":
        rules = dict(self.rules)
        rules.update(overrides)
        return ShardingPolicy(rules=rules, name=name or self.name)


def train_policy(mesh, *, tp_heads: bool, tp_kv: bool, fsdp: bool = True) -> ShardingPolicy:
    fs = "data" if fsdp else None
    return ShardingPolicy(name="train", rules={
        "layers": None,
        "vocab": "model",
        "embed_d": fs,
        "d_model_in": fs,
        "d_model_out": fs,
        "attn_din": fs,
        "attn_dout": fs,
        "qheads": "model" if tp_heads else None,
        "kv_heads": "model" if tp_kv else None,
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "rnn": "model",
        "norm": None,
        "lora": None,
    })


def serve_policy(mesh, *, tp_heads: bool, tp_kv: bool, mlp_2d: bool = False,
                 seq_shard_cache: bool = False) -> ShardingPolicy:
    """TP-only policy for decode.  ``mlp_2d`` spreads the FFN over
    (data, model) jointly (needed for >=100B params to fit without FSDP
    gathers); ``seq_shard_cache`` pairs with flash-decode (attention
    projections replicated, KV cache sharded on sequence over "model")."""
    heads = None if seq_shard_cache else ("model" if tp_heads else None)
    kv = None if seq_shard_cache else ("model" if tp_kv else None)
    # 100B-class serving (mlp_2d + replicated heads): spread the attention
    # projections over ("data","model") on d_model — row-parallel with a
    # tiny S=1 sum — so no multi-GB weight replica per chip.
    attn_2d = mlp_2d and heads is None
    return ShardingPolicy(name="serve", rules={
        "layers": None,
        "vocab": "model",
        "embed_d": None,
        "d_model_in": "data" if mlp_2d else None,
        "d_model_out": "data" if mlp_2d else None,
        "attn_din": ("data", "model") if attn_2d else ("data" if mlp_2d else None),
        "attn_dout": "model" if attn_2d else ("data" if mlp_2d else None),
        "qheads": heads,
        "kv_heads": kv,
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "rnn": "model",
        "norm": None,
        "lora": None,
    })


def serve_policy_for(cfg, mesh, *, mlp_2d: bool = False,
                     seq_shard_cache: bool = False) -> ShardingPolicy:
    """The serve policy an arch gets on ``mesh`` (the reference's
    ``launch/builders.py`` ``_serve_policy``): heads split over "model"
    when the padded head count divides it, kv heads when the true kv count
    does."""
    tp = mesh.shape.get("model", 1)
    tp_heads = cfg.padded_heads % tp == 0 and cfg.padded_heads >= tp
    tp_kv = cfg.n_kv % tp == 0
    return serve_policy(mesh, tp_heads=tp_heads, tp_kv=tp_kv, mlp_2d=mlp_2d,
                        seq_shard_cache=seq_shard_cache)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_specs(logical_tree, policy: ShardingPolicy):
    """Map a tree (nested dicts and lists) of logical-axis tuples to the
    same tree of specs."""
    if _is_spec(logical_tree):
        return policy.spec(logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_specs(v, policy) for k, v in logical_tree.items()}
    return [tree_specs(v, policy) for v in logical_tree]


def vocab_axis(dp):
    """'model' for the activation vocab dim, unless 'model' is already a
    batch axis (tp1 remap) — a mesh axis may appear once per spec."""
    flat = ()
    if dp:
        for e in (dp if isinstance(dp, tuple) else (dp,)):
            flat += (e if isinstance(e, tuple) else (e,))
    return None if "model" in flat else "model"


# ---------------------------------------------------------------------------
# per-cell tensors
# ---------------------------------------------------------------------------

def entry_axes(entry: Entry) -> tuple[str, ...]:
    """The mesh axes a spec entry splits over, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def cell_coords(mesh, c: int) -> dict[str, int]:
    """Cell ``c``'s coordinate on each axis (cells in row-major order of
    ``mesh.axis_names``)."""
    idx = np.unravel_index(c, tuple(mesh.shape[a] for a in mesh.axis_names))
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


def n_blocks(entry: Entry, mesh) -> int:
    for a in entry_axes(entry):
        if a not in mesh.axis_names:
            raise ValueError(f"spec entry {entry!r} names an axis the mesh "
                             f"{mesh.axis_names} does not have")
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def block_index(entry: Entry, mesh, coords: Mapping[str, int]) -> int:
    idx = 0
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def groups_over(mesh, axes: Entry) -> list[list[int]]:
    """The cells grouped by every coordinate but ``axes``': each group in
    ascending order along ``axes`` (major first), the groups in ascending
    order of their first cell.  With no axes every cell is its own group."""
    names = entry_axes(axes)
    groups: dict = {}
    for c in range(mesh.size):
        coords = cell_coords(mesh, c)
        key = tuple(v for a, v in coords.items() if a not in names)
        groups.setdefault(key, []).append(c)
    return list(groups.values())


def _check_spec(spec: tuple, shape: Sequence[int], mesh) -> None:
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a {len(shape)}-dim tensor")
    used = [a for e in spec for a in entry_axes(e)]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    for e, n in zip(spec, shape):
        if n % n_blocks(e, mesh):
            raise ValueError(f"dim of size {n} does not split over {e!r} "
                             f"({n_blocks(e, mesh)} blocks) in spec {spec}")


@dataclasses.dataclass
class Sharded:
    """A global tensor of ``shape`` laid out over the cells of ``mesh`` by
    ``spec``: ``cells[c]`` is cell c's block (cells in row-major order).
    Cells with the same block on the same device share one tensor, so a
    replicated leaf is stored once per distinct device."""
    spec: tuple
    shape: tuple
    mesh: object
    cells: list

    @property
    def dtype(self) -> torch.dtype:
        return self.cells[0].dtype

    def blocks(self, c: int) -> tuple[int, ...]:
        coords = cell_coords(self.mesh, c)
        return tuple(block_index(e, self.mesh, coords) for e in self.spec)

    def offset(self, c: int, dim: int) -> int:
        """The global index of cell c's first element along ``dim``."""
        return self.blocks(c)[dim] * self.cells[c].shape[dim]

    def slices(self, c: int) -> tuple[slice, ...]:
        return tuple(slice(b * n, (b + 1) * n)
                     for b, n in zip(self.blocks(c), self.cells[c].shape))

    def local_shape(self) -> tuple[int, ...]:
        return tuple(n // n_blocks(e, self.mesh) for e, n in zip(self.spec, self.shape))

    def unshard(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first cell's)."""
        dev = torch.device(device) if device is not None else self.mesh.home
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for c, t in enumerate(self.cells):
            key = self.blocks(c)
            if key not in done:
                done.add(key)
                out[self.slices(c)] = t.to(dev)
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        """``fn`` on every distinct cell tensor (shape-preserving)."""
        memo: dict[int, torch.Tensor] = {}
        cells = []
        for t in self.cells:
            if id(t) not in memo:
                memo[id(t)] = fn(t)
            cells.append(memo[id(t)])
        return Sharded(self.spec, self.shape, self.mesh, cells)


def _lay_out(spec: tuple, shape: tuple, mesh, make) -> Sharded:
    """A :class:`Sharded` whose cell tensors come from ``make(blocks,
    device)``, called once per distinct block and device."""
    _check_spec(spec, shape, mesh)
    parts: dict = {}
    cells = []
    for c in range(mesh.size):
        coords = cell_coords(mesh, c)
        key = (tuple(block_index(e, mesh, coords) for e in spec), mesh.devices.flat[c])
        if key not in parts:
            parts[key] = make(*key)
        cells.append(parts[key])
    return Sharded(spec, shape, mesh, cells)


def shard(x: torch.Tensor, spec: tuple, mesh, dtype: Optional[torch.dtype] = None) -> Sharded:
    """``x`` laid out over ``mesh``'s cells by ``spec``, each block cast to
    ``dtype`` (if given) on its cell's device.  Each block is contiguous on
    its cell's device; a block that already is (a slice of the leading dim
    on the same device, not cast) shares ``x``'s storage."""
    def block(blocks, dev):
        sl = x
        for d, (e, b) in enumerate(zip(spec, blocks)):
            n = x.shape[d] // n_blocks(e, mesh)
            sl = sl.narrow(d, b * n, n)
        sl = sl.to(dev)
        return (sl if dtype is None else sl.to(dtype)).contiguous()
    return _lay_out(tuple(spec), tuple(x.shape), mesh, block)


def zeros(shape: Sequence[int], spec: tuple, mesh, dtype) -> Sharded:
    """A :class:`Sharded` of zeros (one tensor per distinct block and
    device)."""
    local = tuple(n // n_blocks(e, mesh) for e, n in zip(spec, shape))
    return _lay_out(tuple(spec), tuple(shape), mesh,
                    lambda _, dev: torch.zeros(local, dtype=dtype, device=dev))


def as_sharded(x, spec: tuple, mesh) -> Sharded:
    """``x`` if it already is a :class:`Sharded` with ``spec``, else ``x``
    laid out by it."""
    if isinstance(x, Sharded):
        if tuple(x.spec) != tuple(spec):
            raise ValueError(f"a tensor laid out by {x.spec} where {spec} is needed")
        return x
    return shard(x, spec, mesh)


def _tree_map2(fn, tree, specs, name=None):
    """``fn(name, leaf, spec)`` on every leaf; ``name`` is its dict key."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, specs[k], k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map2(fn, v, s, name) for v, s in zip(tree, specs)]
    return fn(name, tree, specs)


def _tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def shard_tree(tree, specs, mesh, dtype_of: Optional[Callable] = None):
    """Every tensor of ``tree`` (nested dicts and lists) laid out by the spec
    at the same place in ``specs`` (:func:`tree_specs`' output), its blocks
    cast on their cells to ``dtype_of(name, tensor)`` where that is not
    None (``name``: the leaf's dict key)."""
    return _tree_map2(lambda n, t, s: shard(t, s, mesh, dtype_of(n, t) if dtype_of else None),
                      tree, specs)


def unshard_tree(tree, device=None):
    """The global tensors of a tree of :class:`Sharded` (plain tensors as
    they are), bit for bit."""
    def get(x):
        if isinstance(x, dict):
            return {k: get(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [get(v) for v in x]
        return x.unshard(device) if isinstance(x, Sharded) else x
    return get(tree)


def shard_params(cfg, params, mesh, *, serve_seq_shard: bool = False,
                 dtype_of: Optional[Callable] = None):
    """A parameter tree laid out by :func:`serve_policy_for` on ``mesh``
    (without ``mlp_2d``, whose forward is ROADMAP item 13f); ``dtype_of``
    as in :func:`shard_tree`."""
    from repro_torch.models.transformer import logical_axes_tree

    policy = serve_policy_for(cfg, mesh, seq_shard_cache=serve_seq_shard)
    return shard_tree(params, tree_specs(logical_axes_tree(cfg), policy), mesh, dtype_of)


def cell_bytes(tree, mesh) -> list[int]:
    """The bytes of each cell's blocks over a tree of :class:`Sharded`
    leaves: what the cell would hold on a card of its own."""
    out = [0] * mesh.size
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, Sharded):
            for c, t in enumerate(leaf.cells):
                out[c] += t.numel() * t.element_size()
    return out


def layout_bytes(tree, mesh) -> list[int]:
    """:func:`cell_bytes` from the specs alone: each leaf's global bytes
    over its block count, per cell."""
    out = [0] * mesh.size
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, Sharded):
            n = math.prod(leaf.local_shape()) * leaf.cells[0].element_size()
            for c in range(mesh.size):
                out[c] += n
    return out


def device_bytes(tree) -> dict:
    """The bytes each distinct device holds for a tree of :class:`Sharded`
    leaves (a tensor shared by cells counted once)."""
    seen: set = set()
    out: dict = {}
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, Sharded):
            for t in leaf.cells:
                if id(t) not in seen:
                    seen.add(id(t))
                    out[t.device] = out.get(t.device, 0) + t.numel() * t.element_size()
    return out
