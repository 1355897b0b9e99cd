"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
reference's ``models/rglru.py``).

    x -> [linear in (2 branches)] -> conv1d(w=4, depthwise) -> RG-LRU -> *gate -> linear out

RG-LRU recurrence per channel: r_t = sigmoid(W_a x_t), i_t = sigmoid(W_x
x_t), log a_t = -c softplus(Lambda) r_t, h_t = a_t h_{t-1} + sqrt(1 -
a_t^2) (i_t x_t).  The coefficients and ``h`` are float32 (float64 in a
float64 forward).  Train and prefill run the recurrence as a sequential
loop over the sequence (the reference's ``lax.associative_scan`` sums in
another order: the two agree within 1e-4); decode is one affine step.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L

C_SCALE = 8.0  # Griffin's c constant


def _lru_coeffs(params, x, x_gates=None):
    """x [B, S, R] -> (a, b) with h_t = a_t h_{t-1} + b_t.  ``softplus`` is
    ``jax.nn.softplus``'s ``logaddexp(lam, 0)`` (``F.softplus`` switches to
    the identity above 20).  ``x_gates``: the gates' input (default ``x``);
    on a mesh the whole [B, S, R'] conv output, whose product with the
    cell's columns of ``w_a`` / ``w_x`` gives the gates of ``x``'s
    channels."""
    dt = x.dtype
    xg = x if x_gates is None else x_gates
    r = torch.sigmoid(xg @ params["w_a"].to(dt))
    i = torch.sigmoid(xg @ params["w_x"].to(dt))
    lam = L.upcast(params["lam"])
    lam = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -C_SCALE * lam * L.upcast(r)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        L.upcast(i) * L.upcast(x))
    return a, b


def rg_lru_scan(params, x, h0=None, x_gates=None):
    """RG-LRU over a sequence.  x [B, S, R] -> (y, h_last)."""
    a, b = _lru_coeffs(params, x, x_gates)
    hp = torch.zeros_like(b[:, 0]) if h0 is None else h0.to(b.dtype)
    hs = []
    for t in range(x.shape[1]):
        hp = a[:, t] * hp + b[:, t]
        hs.append(hp)
    return torch.stack(hs, dim=1).to(x.dtype), hp


def rg_lru_step(params, x, h, x_gates=None):
    """Single decode step.  x [B, R], h [B, R] -> (y, h_new)."""
    a, b = _lru_coeffs(params, x[:, None], None if x_gates is None else x_gates[:, None])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x.dtype), h_new


def causal_conv1d(x, kernel, state=None):
    """Depthwise causal conv, width W.  x [B, S, R]; kernel [W, R].

    ``state`` [B, W-1, R] carries the last W-1 inputs for decode; returns
    (y, new_state)."""
    W = kernel.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [B, S+W-1, R]
    y = sum(xp[:, i:i + x.shape[1]] * kernel[i].to(x.dtype) for i in range(W))
    return y, xp[:, -(W - 1):]


def recurrent_branch(params, x, *, cache=None):
    """The Griffin recurrent block body (pre-norm residual by the caller).

    x [B, S, D] -> (y [B, S, D], new_cache).
    cache = {"conv": [B, W-1, R], "h": [B, R]} for decode, None for the scan.
    params: w_in_rnn [D,R], w_in_gate [D,R], conv [W,R], w_a [R,R], w_x [R,R],
            lam [R], w_out [R,D] (other keys are ignored).
    """
    dt = x.dtype
    u = x @ params["w_in_rnn"].to(dt)
    g = x @ params["w_in_gate"].to(dt)
    if cache is None:
        u, conv_state = causal_conv1d(u, params["conv"])
        y, h_last = rg_lru_scan(params, u)
        new_cache = {"conv": conv_state, "h": h_last}
    else:
        u2, conv_state = causal_conv1d(u, params["conv"], state=cache["conv"])
        y1, h_new = rg_lru_step(params, u2[:, 0], cache["h"])
        y = y1[:, None]
        new_cache = {"conv": conv_state, "h": h_new}
    y = y * L.gelu(g)
    return y @ params["w_out"].to(dt), new_cache


def rglru_param_shapes(d_model: int, d_rnn: int, conv_width: int = 4):
    return {
        "w_in_rnn":  ((d_model, d_rnn), ("d_model_in", "rnn")),
        "w_in_gate": ((d_model, d_rnn), ("d_model_in", "rnn")),
        "conv":      ((conv_width, d_rnn), (None, "rnn")),
        "w_a":       ((d_rnn, d_rnn), (None, "rnn")),
        "w_x":       ((d_rnn, d_rnn), (None, "rnn")),
        "lam":       ((d_rnn,), ("rnn",)),
        "w_out":     ((d_rnn, d_model), ("rnn", "d_model_out")),
    }
