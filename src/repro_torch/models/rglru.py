"""RG-LRU (Griffin / recurrentgemma): the parameter shapes and the decay
constant (the reference's ``models/rglru.py``).  The recurrent branch is
ROADMAP item 13b; until then an ``rglru`` block in ``transformer.forward``
raises."""
from __future__ import annotations

C_SCALE = 8.0  # Griffin's c constant


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
