"""RWKV6 "Finch": the parameter shapes and the head width (the reference's
``models/rwkv6.py``).  ``time_mix`` and ``channel_mix`` are ROADMAP item
13b; until then an ``rwkv`` block in ``transformer.forward`` raises."""
from __future__ import annotations

HEAD_DIM = 64


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
