"""RWKV-6 "Finch" block (arXiv:2404.05892; the reference's
``models/rwkv6.py``): attention-free time mix with a data-dependent
per-channel decay, and a squared-ReLU channel mix.

Time-mix recurrence per head (dh = 64), state S [B, H, dh_k, dh_v]:

    w_t = exp(-exp(w0 + tanh(x_w A) B))
    y_t[:] = sum_i r_t[i] * (S_{t-1}[i, :] + u[i] k_t[i] v_t[:])
    S_t[i, :] = w_t[i] * S_{t-1}[i, :] + k_t[i] v_t[:]

Token shift is the static mix x + (shift(x) - x) * mu.  The WKV recurrence
is a sequential loop over time in float32 (float64 in a float64 forward)
for train, prefill and decode alike.  A sequence of several ``chunk``s
runs chunk by chunk, each chunk under ``torch.utils.checkpoint`` when
grad is enabled (the reference's two-level, rematerialised scan): the
backward pass then keeps one [B, H, dh, dh] state a chunk instead of
several a step.  The forward is the same loop either way.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

HEAD_DIM = 64


def _token_shift(x, prev=None):
    """[B, S, D] -> the previous timestep (zeros, or ``prev``, at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _decay(params, xw, cols=slice(None)):
    """Data-dependent decay w_t in (0, 1).  xw [B, S, D] -> [B, S, D] (the
    channels ``cols`` of it)."""
    dt = xw.dtype
    lora = torch.tanh(xw @ params["w_lora_a"].to(dt)) @ params["w_lora_b"][:, cols].to(dt)
    return torch.exp(-torch.exp(L.upcast(params["w0"][cols]) + L.upcast(lora)))


def _wkv_steps(r, k, v, w, u, s):
    """The WKV recurrence step by step from state ``s``.  r/k/v/w [B, S, H,
    dh] (upcast); returns (y [B, S, H, dh], s_last)."""
    uu = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # [B, H, dh, dh]
        att = s + uu * kv
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], att))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv_scan(r, k, v, w, u, s0=None, chunk: int = 64):
    """Recurrent WKV.  r/k/v/w [B, S, H, dh]; u [H, dh].
    Returns (y [B, S, H, dh], s_last [B, H, dh, dh]).

    With S a multiple of ``chunk`` larger than it, an outer loop over the
    S / chunk chunks, each rematerialised in the backward pass when grad is
    enabled; otherwise one loop over the steps."""
    B, S, H, dh = r.shape
    r, k, v, w = (L.upcast(t) for t in (r, k, v, w))
    s = torch.zeros((B, H, dh, dh), dtype=r.dtype, device=r.device) if s0 is None else s0
    if S <= chunk or S % chunk:
        return _wkv_steps(r, k, v, w, u, s)
    remat = torch.is_grad_enabled()
    ys = []
    for c in range(S // chunk):
        part = [t[:, c * chunk:(c + 1) * chunk] for t in (r, k, v, w)]
        if remat:
            y, s = checkpoint(_wkv_steps, *part, u, s, use_reentrant=False)
        else:
            y, s = _wkv_steps(*part, u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def time_mix(params, x, *, cache=None):
    """RWKV6 attention replacement.  x [B, S, D] -> (y, new_cache).
    cache = {"s": [B,H,dh,dh], "x_prev": [B, D]} for decode."""
    xs = _token_shift(x, None if cache is None else cache["x_prev"])
    out, s_last = time_mix_heads(params, x, xs, slice(None),
                                 None if cache is None else cache["s"])
    return out, {"s": s_last, "x_prev": x[:, -1]}


def time_mix_heads(params, x, xs, cols: slice, s0=None):
    """The time mix of the heads whose channels are ``cols`` (whole heads)
    from x [B, S, D] and its shift ``xs``: ``w_r``/``w_k``/``w_v``/``w_g``
    hold those columns and ``w_o`` those rows (on a mesh, the cell's
    blocks); ``w_lora_b``, ``w0``, ``u``, ``ln_w`` and ``ln_b`` are whole
    and sliced here.  ``s0``: those heads' state.  Returns (their
    product with ``w_o`` [B, S, D]: a row-parallel partial on a mesh,
    their last state)."""
    B, S, _ = x.shape
    dt = x.dtype
    xr, xk, xv, xw, xg = (_mix(x, xs, params[f"mu_{c}"]) for c in "rkvwg")
    r = xr @ params["w_r"].to(dt)
    k = xk @ params["w_k"].to(dt)
    v = xv @ params["w_v"].to(dt)
    g = L.silu(xg @ params["w_g"].to(dt))
    w = _decay(params, xw, cols)
    C = r.shape[-1]
    H = C // HEAD_DIM

    def hd(t):
        return t.reshape(B, S, H, HEAD_DIM)

    u = L.upcast(params["u"][cols]).reshape(H, HEAD_DIM)
    # the decay is rounded to the compute dtype before the scan, as the
    # reference's is (in bf16, exp(-exp(-6)) rounds to 0.99609375 or 1)
    y, s_last = _wkv_scan(hd(r), hd(k), hd(v), hd(w.to(dt)), u, s0)

    # per-head group norm (population variance)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yn = (y - mean) * torch.rsqrt(var + 64e-5)
    yn = yn.reshape(B, S, C) * L.upcast(params["ln_w"][cols]) + L.upcast(params["ln_b"][cols])
    return (yn.to(dt) * g) @ params["w_o"].to(dt), s_last


def channel_mix(params, x, *, cache=None):
    """RWKV squared-ReLU FFN with receptance gate.  x [B,S,D] -> (y, cache)."""
    dt = x.dtype
    xs = _token_shift(x, None if cache is None else cache["x_prev"])
    xk = _mix(x, xs, params["mu_ck"])
    xr = _mix(x, xs, params["mu_cr"])
    k = torch.square(torch.relu(xk @ params["w_ck"].to(dt)))
    kv = k @ params["w_cv"].to(dt)
    rgate = torch.sigmoid(xr @ params["w_cr"].to(dt))
    return rgate * kv, {"x_prev": x[:, -1]}


def rwkv_param_shapes(d_model: int, d_ff: int, lora_dim: int = 64):
    D, FF = d_model, d_ff
    return {
        # time mix
        "mu_r": ((D,), ("norm",)), "mu_k": ((D,), ("norm",)),
        "mu_v": ((D,), ("norm",)), "mu_w": ((D,), ("norm",)),
        "mu_g": ((D,), ("norm",)),
        "w_r": ((D, D), ("d_model_in", "rnn")),
        "w_k": ((D, D), ("d_model_in", "rnn")),
        "w_v": ((D, D), ("d_model_in", "rnn")),
        "w_g": ((D, D), ("d_model_in", "rnn")),
        "w_o": ((D, D), ("rnn", "d_model_out")),
        "w0": ((D,), ("norm",)),
        "w_lora_a": ((D, lora_dim), ("d_model_in", "lora")),
        "w_lora_b": ((lora_dim, D), ("lora", None)),
        "u": ((D,), ("norm",)),
        "ln_w": ((D,), ("norm",)), "ln_b": ((D,), ("norm",)),
        # channel mix
        "mu_ck": ((D,), ("norm",)), "mu_cr": ((D,), ("norm",)),
        "w_ck": ((D, FF), ("d_model_in", "ff")),
        "w_cv": ((FF, D), ("ff", "d_model_out")),
        "w_cr": ((D, D), ("d_model_in", None)),
    }
