"""Mixture-of-Experts: the config and the parameter shapes (the reference's
``models/moe.py``).  The routed FFN (``moe_ffn``) is ROADMAP item 13b; until
then a MoE block in ``transformer.forward`` raises."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def moe_param_shapes(d_model: int, d_ff: int, cfg: MoEConfig):
    """(shape, logical axes) for every MoE parameter."""
    E = cfg.n_experts
    return {
        "router": ((d_model, E), ("d_model_in", None)),
        "w_gate": ((E, d_model, d_ff), ("experts", "d_model_in", None)),
        "w_up":   ((E, d_model, d_ff), ("experts", "d_model_in", None)),
        "w_down": ((E, d_ff, d_model), ("experts", None, "d_model_in")),
    }
