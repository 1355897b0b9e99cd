"""Primitive layers: norms, RoPE, MLPs, attention math (GQA, chunked, decode)
(the reference's ``models/layers.py``).

All functions are pure functions on tensors.  Attention comes in three
execution paths:

- ``attention_full``    : O(S^2) masked attention — short sequences.
- ``attention_chunked`` : online softmax over (q-chunk, kv-chunk) tiles in
  a Python loop — memory O(S * chunk) for long prefill.  With
  ``causal_skip=True`` the chunk pairs that no (q, k) pair of the mask
  reaches are skipped.
- ``attention_decode``  : one query position against a KV cache.

Precision follows the reference's: ``attention_full`` forms its scores in
the input dtype and softmaxes them in float32; ``attention_chunked`` and
``attention_decode`` form float32 scores from float32-accumulated products
(a torch product of two bf16 tensors would round to bf16, so both sides
are upcast first: the products of bf16 values are exact in float32).
``rms_norm`` works in float32.  Each of these float32 steps keeps a
float64 input in float64 (``upcast``), so a float64 forward rounds nowhere
to float32 and its decode and prefill paths can be held to each other at
any depth.  SiLU and GELU (the tanh form,
``jax.nn.gelu``'s default) are ``jax.nn``'s formulas op by op in the
input's dtype, with their constants rounded to it, so bf16 rounds where the
reference's rounds (``F.silu`` and ``F.gelu`` round once, and differ from
it in ~40 % of bf16 elements).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when it is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = upcast(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x [..., S, H, dh]; positions [..., S] (int)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq                  # [..., S, half]
    sin = torch.sin(angles)[..., None, :]                         # [..., S, 1, half]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Classic transformer sinusoidal embeddings (musicgen backbone)."""
    half = d // 2
    freq = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _const(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``: a JAX literal meeting an array of it."""
    return torch.tensor(v, dtype=dtype).item()


def silu(x):
    """``jax.nn.silu``: x * 1 / (1 + exp(-x))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu(approximate=True)``: the tanh form."""
    c = _const(math.sqrt(2.0 / math.pi), x.dtype)
    k = _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def swiglu_mlp(x, w_gate, w_up, w_down):
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = x @ w_in + b_in
    return gelu(h) @ w_out + b_out


def geglu_mlp(x, w_gate, w_up, w_down):
    return (gelu(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# Attention math (GQA throughout; H must be a multiple of KV)
# ---------------------------------------------------------------------------

def attention_full(q, k, v, *, causal=True, window=None):
    """Masked O(S^2) attention.  q [B,S,H,dh]; k/v [B,T,KV,dh]."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * (dh ** -0.5)
    qp = torch.arange(s, device=q.device)
    kp = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    scores = torch.where(mask, upcast(scores), NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(b, s, h, dh)


def attention_chunked(
    q, k, v, *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    causal_skip: bool = False,
):
    """Online-softmax chunked attention (memory O(S * chunk))."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    cq, ck = min(chunk_q, s), min(chunk_kv, t)
    if s % cq or t % ck:
        raise ValueError(f"chunks must divide the sequences: {(s, cq, t, ck)}")
    scale = dh ** -0.5
    dev = q.device
    outs = []
    for i in range(s // cq):
        qc = upcast(q[:, i * cq:(i + 1) * cq].reshape(b, cq, kv, g, dh))
        qpos = i * cq + torch.arange(cq, device=dev)
        m = torch.full((b, kv, g, cq), NEG_INF, dtype=qc.dtype, device=dev)
        l = torch.zeros((b, kv, g, cq), dtype=qc.dtype, device=dev)
        acc = torch.zeros((b, kv, g, cq, dh), dtype=qc.dtype, device=dev)
        for j in range(t // ck):
            if causal_skip:
                # chunk-level bounds: is any (q, k) pair inside the tile live?
                if causal and not j * ck <= i * cq + cq - 1:
                    continue
                if window is not None and not j * ck + ck - 1 > i * cq - window:
                    continue
            kc = k[:, j * ck:(j + 1) * ck]
            vc = v[:, j * ck:(j + 1) * ck]
            kpos = j * ck + torch.arange(ck, device=dev)
            sc = torch.einsum("bqkgd,btkd->bkgqt", qc, upcast(kc)) * scale
            msk = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                msk &= kpos[None, :] > qpos[:, None] - window
            sc = torch.where(msk, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", upcast(p.to(vc.dtype)), upcast(vc))
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, h, dh))
    return torch.cat(outs, dim=1)


def attention_decode(q, k_cache, v_cache, length, *, window=None):
    """One-token decode.  q [B,H,dh]; caches [B,Smax,KV,dh]; length [B] int
    = number of valid cache positions (including the token just written)."""
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", upcast(qg), upcast(k_cache)) * (dh ** -0.5)
    idx = torch.arange(k_cache.shape[1], device=q.device)
    msk = idx[None, :] < length[:, None]
    if window is not None:
        msk &= idx[None, :] >= (length[:, None] - window)
    sc = torch.where(msk[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, dh)
