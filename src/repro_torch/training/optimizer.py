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
reference's expression by expression.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


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
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


class AdamState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def adam_init(params) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(m=_map(zeros, params), v=_map(zeros, params), step=_step0(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in ``jax.tree.leaves``
    order as the reference's Python ``sum`` is."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


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
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m),
                          _leaves(state.v)):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        del g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamState(m=state.m, v=state.v, step=step), gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; the memory option for 100B+ runs)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    vr: Any     # row stats (rank>=2 leaves) or full v (rank<2)
    vc: Any     # col stats (rank>=2) or a [1] placeholder
    step: torch.Tensor


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    def vr(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
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
    for p, g, vr, vc in zip(_leaves(params), _leaves(grads), _leaves(state.vr),
                            _leaves(state.vc)):
        g = g.float() * scale
        g2 = torch.square(g) + 1e-30
        if _factored(p):
            vr.copy_(decay * vr + (1 - decay) * g2.mean(dim=-1))
            vc.copy_(decay * vc + (1 - decay) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            precond = torch.rsqrt(torch.clamp(r[..., None] * vc[..., None, :], min=1e-30))
        else:
            vr.copy_(decay * vr + (1 - decay) * g2)
            precond = torch.rsqrt(torch.clamp(vr, min=1e-30))
        del g2
        delta = g * precond
        del g, precond
        # relative-scale clipping (Adafactor's d=1 update clipping)
        rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
        delta = delta / torch.clamp(rms, min=1.0)
        new_p = p.float() - lr * delta
        if cfg.weight_decay:
            new_p = new_p - lr * cfg.weight_decay * p.float()
        p.copy_(new_p.to(p.dtype))
    return params, AdafactorState(vr=state.vr, vc=state.vc, step=step), gnorm


def make_optimizer(cfg: OptConfig):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state, grad norm))."""
    if cfg.name == "adamw":
        return adam_init, lambda g, s, p: adam_update(g, s, p, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(g, s, p, cfg)
    raise ValueError(cfg.name)
