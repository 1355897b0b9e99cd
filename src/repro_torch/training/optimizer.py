"""Optimizers on tensor trees (the reference's ``training/optimizer.py``):
the learning-rate schedule, AdamW and Adafactor.

The schedule is computed in float32 like the reference's, so a learning
rate handed to a kernel is the same float32 value on both sides (``cos``
may round one ulp apart).

AdamW keeps two float32 moments per parameter.  Adafactor factors the
second moment of every rank >= 2 leaf into row and column statistics over
its last two dims; a layer-stacked leaf ``[L, ...]`` is one leaf, so a
stacked norm scale ``[L, d]`` is factored and the update clipping's RMS
runs over the whole stack, as the reference's do.  A tree is the port's
nested dicts and lists (``models.transformer.tree_leaves`` order, which
is ``jax.tree.leaves``').

The updates write the parameters and the optimizer state in place under
``torch.no_grad()`` (XLA donates the same buffers) and return them: the
state passed in is the state returned.  Each leaf's arithmetic is the
reference's expression by expression, in float32 (float64 leaves, gradients
and states stay float64).

A leaf may be a ``distributed.sharding.Sharded`` (a train state laid out
on a mesh's cells): its gradient and states are ``Sharded`` too, and the
update runs block by block in place, each block once, its copies on other
devices overwritten with the result.  What spans blocks is taken over the
whole leaf: :func:`global_norm` counts every block once (a replicated leaf
once, not once a cell), Adafactor's row, column and ``vr`` means sum their
partial sums across the blocks that split the dim, and its update-RMS
clip is over the whole leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import Sharded
from repro_torch.distributed.sharding import zeros as sharded_zeros


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when it is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def lr_schedule(name: str, step, *, base_lr: float = 1.0,
                total_steps: int = 1000, decay: float | None = None,
                min_lr: float = 0.0) -> torch.Tensor:
    """Learning rate at ``step`` as a float32 scalar tensor.

    - ``constant``:     base_lr
    - ``inverse_time``: base_lr / (1 + decay * step); ``decay`` defaults
      to ``10 / total_steps`` (a 10x+ drop over the horizon)
    - ``cosine``:       min_lr + (base_lr - min_lr) * cos-anneal over
      ``total_steps``, flat at ``min_lr`` afterwards
    """
    t = torch.as_tensor(step, dtype=torch.float32)
    base = torch.full((), base_lr, dtype=torch.float32)
    if name == "constant":
        return base + 0.0 * t
    if name == "inverse_time":
        d = (10.0 / max(total_steps, 1)) if decay is None else decay
        # a true float32 division: ``float / tensor`` would multiply by
        # the reciprocal and round differently
        return torch.div(base, 1.0 + d * t)
    if name == "cosine":
        frac = torch.clamp(t / max(total_steps, 1), 0.0, 1.0)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    raise ValueError(f"unknown lr schedule {name!r}")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "constant"   # constant | inverse_time | cosine
    schedule_steps: int = 1000   # horizon for cosine / default inverse-time decay
    min_lr: float = 0.0          # cosine floor


def _cfg_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The scheduled lr of an OptConfig at ``step``."""
    return lr_schedule(cfg.schedule, step, base_lr=cfg.lr,
                       total_steps=cfg.schedule_steps, min_lr=cfg.min_lr)


def _leaves(tree) -> list:
    """The tensors of a tree (nested dicts, lists and tuples) with dict
    keys sorted: ``jax.tree.leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    """``fn(leaf)`` on every tensor of a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _step0(params) -> torch.Tensor:
    leaves = _leaves(params)
    dev = None
    if leaves:
        dev = leaves[0].mesh.home if isinstance(leaves[0], Sharded) else leaves[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros(p, shape, spec=None) -> torch.Tensor | Sharded:
    """A zero state of ``shape`` for leaf ``p``: float32, or float64 beside
    a float64 leaf; beside a ``Sharded`` leaf, laid out by ``spec`` on its
    mesh (the step counter on the mesh's first device)."""
    dtype = torch.promote_types(p.dtype, torch.float32)
    if isinstance(p, Sharded):
        return sharded_zeros(shape, spec, p.mesh, dtype)
    return torch.zeros(shape, dtype=dtype, device=p.device)


class AdamState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def adam_init(params) -> AdamState:
    def zeros(p):
        return _zeros(p, p.shape, getattr(p, "spec", None))
    return AdamState(m=_map(zeros, params), v=_map(zeros, params), step=_step0(params))


def _sq_sum(g) -> torch.Tensor:
    """The sum of squares of a leaf; of a ``Sharded`` leaf, its blocks'
    (each once) summed in block order on the mesh's first device."""
    if not isinstance(g, Sharded):
        return torch.sum(torch.square(_wide(g)))
    home = g.mesh.home
    parts = [torch.sum(torch.square(_wide(ts[0]))).to(home) for ts in g.block_tensors().values()]
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in ``jax.tree.leaves``
    order as the reference's Python ``sum`` is."""
    return torch.sqrt(sum(_sq_sum(g) for g in _leaves(tree)))


def _blocks(x) -> dict:
    """Each block's index tuple -> its tensor: a ``Sharded`` leaf's blocks,
    the first copy of each, in cell order; a tensor is its one block."""
    if not isinstance(x, Sharded):
        return {(0,) * x.dim(): x}
    out: dict = {}
    for c in range(x.mesh.size):
        out.setdefault(x.blocks(c), x.cells[c])
    return out


def _spread(x: Sharded, done: set) -> None:
    """Every copy of each of ``x``'s blocks overwritten with the block's
    first copy (once per copy; ``done`` holds the copies already written)."""
    for ts in x.block_tensors().values():
        for t in ts[1:]:
            if id(t) not in done:
                done.add(id(t))
                t.copy_(ts[0])


class _OnDevice:
    """Scalars (0-dim tensors) moved to a device once each."""

    def __init__(self, **scalars):
        self.scalars, self.memo = scalars, {}

    def __call__(self, dev) -> dict:
        if dev not in self.memo:
            self.memo[dev] = {k: v.to(dev) for k, v in self.scalars.items()}
        return self.memo[dev]


def _clip_scale(norm: torch.Tensor, max_norm) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)), a true float32 division (``float
    / tensor`` would multiply by the reciprocal and round differently)."""
    return torch.clamp(torch.div(norm.new_full((), max_norm), torch.clamp(norm, min=1e-9)),
                       max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, as new
    float32 tensors, the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adam_update(grads, state: AdamState, params, cfg: OptConfig):
    """One AdamW step; returns (params, state, grad norm before clipping).

    ``lr`` is the schedule at the step *before* the increment, the bias
    corrections use the step after it (the reference's order).  Each
    gradient is clipped as its leaf is updated, ``g.float() * scale`` as
    :func:`clip_by_global_norm` computes it, so no clipped copy of the
    whole tree is held."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = _cfg_lr(cfg, state.step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    on = _OnDevice(scale=scale, lr=lr, b1c=b1c, b2c=b2c)
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m),
                          _leaves(state.v)):
        gb, mb, vb = _blocks(g), _blocks(m), _blocks(v)
        for k, t in _blocks(p).items():
            _adam_block(t, gb[k], mb[k], vb[k], cfg, **on(t.device))
        if isinstance(p, Sharded):
            done: set = set()
            for x in (p, m, v):
                _spread(x, done)
    return params, AdamState(m=state.m, v=state.v, step=step), gnorm


def _adam_block(p, g, m, v, cfg: OptConfig, *, scale, lr, b1c, b2c) -> None:
    """One AdamW update of a leaf (or a block of one) in place."""
    g = _wide(g) * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
    del g
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * _wide(p)
    p.copy_((_wide(p) - lr * delta).to(p.dtype))


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; the memory option for 100B+ runs)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    vr: Any     # row stats (rank>=2 leaves) or full v (rank<2)
    vc: Any     # col stats (rank>=2) or a [1] placeholder
    step: torch.Tensor


def _factored(p) -> bool:
    return len(p.shape) >= 2


def adafactor_init(params) -> AdafactorState:
    def vr(p):
        spec = getattr(p, "spec", None)
        if _factored(p):
            return _zeros(p, p.shape[:-1], spec and spec[:-1])
        return _zeros(p, p.shape, spec)

    def vc(p):
        spec = getattr(p, "spec", None)
        if _factored(p):
            return _zeros(p, p.shape[:-2] + p.shape[-1:], spec and spec[:-2] + spec[-1:])
        return _zeros(p, (1,), spec and (None,))
    return AdafactorState(vr=_map(vr, params), vc=_map(vc, params), step=_step0(params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, cfg: OptConfig):
    """One Adafactor step; returns (params, state, grad norm before
    clipping).  The decay is ``1 - (step_new + 1) ** -0.8``; the update is
    divided by max(1, its RMS over the whole leaf)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = _cfg_lr(cfg, state.step)
    decay = 1.0 - (step.float() + 1.0) ** -0.8
    on = _OnDevice(scale=scale, lr=lr, decay=decay)
    for p, g, vr, vc in zip(_leaves(params), _leaves(grads), _leaves(state.vr),
                            _leaves(state.vc)):
        _adafactor_leaf(p, g, vr, vc, cfg, on)
    return params, AdafactorState(vr=state.vr, vc=state.vc, step=step), gnorm


def _sum_over(parts: dict, drop: int, dev_of: dict) -> dict:
    """Partial sums keyed by block index tuples, added across the blocks
    that differ only at position ``drop`` (in ascending order of it): the
    reduced key (``drop`` removed) -> the total on ``dev_of[reduced key]``."""
    out: dict = {}
    for key in sorted(parts, key=lambda k: (k[:drop] + k[drop + 1:], k[drop])):
        rk = key[:drop] + key[drop + 1:]
        t = parts[key].to(dev_of[rk])
        out[rk] = t if rk not in out else out[rk] + t
    return out


def _adafactor_leaf(p, g, vr, vc, cfg: OptConfig, on: "_OnDevice") -> None:
    """One Adafactor update of a leaf, block by block in place (a tensor is
    one block): a mean over a dim is the sum of its blocks' partial sums
    over the dim's length, and the update-RMS clip is over the whole
    leaf."""
    pb, vrb, vcb = _blocks(p), _blocks(vr), _blocks(vc)
    gb = _blocks(g)
    gs = {k: _wide(gb[k]) * on(t.device)["scale"] for k, t in pb.items()}
    nd = len(p.shape)
    if _factored(p):
        n_row, n_col = p.shape[-1], p.shape[-2]
        g2 = {k: torch.square(t) + 1e-30 for k, t in gs.items()}
        rows = _sum_over({k: t.sum(dim=-1) for k, t in g2.items()}, nd - 1,
                         {k: t.device for k, t in vrb.items()})
        cols = _sum_over({k: t.sum(dim=-2) for k, t in g2.items()}, nd - 2,
                         {k: t.device for k, t in vcb.items()})
        del g2
        for k, t in vrb.items():
            d = on(t.device)["decay"]
            t.copy_(d * t + (1 - d) * (rows[k] / n_row))
        for k, t in vcb.items():
            d = on(t.device)["decay"]
            t.copy_(d * t + (1 - d) * (cols[k] / n_col))
        # vr's mean over its last dim (the leaf's second-to-last)
        vr_sum = _sum_over({k: t.sum(dim=-1, keepdim=True) for k, t in vrb.items()}, nd - 2,
                           {k[:-1]: t.device for k, t in vrb.items()})
        delta = {}
        for k, t in pb.items():
            kr, kc = k[:-1], k[:-2] + k[-1:]
            r = vrb[kr] / torch.clamp(vr_sum[kr[:-1]].to(t.device) / n_col, min=1e-30)
            precond = torch.rsqrt(torch.clamp(r[..., None] * vcb[kc][..., None, :], min=1e-30))
            delta[k] = gs[k] * precond
    else:
        delta = {}
        for k, t in vrb.items():
            d = on(t.device)["decay"]
            t.copy_(d * t + (1 - d) * (torch.square(gs[k]) + 1e-30))
            delta[k] = gs[k] * torch.rsqrt(torch.clamp(t, min=1e-30))
    del gs
    # relative-scale clipping (Adafactor's d=1 update clipping)
    home = p.mesh.home if isinstance(p, Sharded) else p.device
    sq = None
    for t in delta.values():
        s = torch.sum(torch.square(t)).to(home)
        sq = s if sq is None else sq + s
    rms = torch.sqrt(sq / math.prod(p.shape) + 1e-30)
    for k, t in pb.items():
        _adafactor_apply(t, delta[k] / torch.clamp(rms.to(t.device), min=1.0), cfg,
                         on(t.device)["lr"])
    if isinstance(p, Sharded):
        done: set = set()
        for x in (p, vr, vc):
            _spread(x, done)


def _adafactor_apply(p, delta, cfg: OptConfig, lr) -> None:
    new_p = _wide(p) - lr * delta
    if cfg.weight_decay:
        new_p = new_p - lr * cfg.weight_decay * _wide(p)
    p.copy_(new_p.to(p.dtype))


def make_optimizer(cfg: OptConfig):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state, grad norm))."""
    if cfg.name == "adamw":
        return adam_init, lambda g, s, p: adam_update(g, s, p, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(g, s, p, cfg)
    raise ValueError(cfg.name)
