"""Config dataclasses: model architecture, input shapes, parallelism knobs
(the port's copy of the reference's ``configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free archs)
    n_kv: int                    # KV heads (GQA); == n_heads for MHA
    d_head: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled: attn | rglru | rwkv
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"        # rope | sinusoidal | none
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # local attention window
    mlp: str = "swiglu"          # swiglu | gelu | geglu (rwkv blocks carry their own)
    d_rnn: Optional[int] = None  # RG-LRU width
    frontend: Optional[str] = None   # audio_stub | vision_stub (embeds input)
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # --- implementation knobs (not architecture) ---
    head_pad_to: Optional[int] = None  # zero-pad q heads for TP divisibility
    subquadratic: bool = False   # True for SSM/hybrid: eligible for long_500k

    @property
    def attn_free(self) -> bool:
        return all(b != "attn" for b in self.block_pattern)

    @property
    def padded_heads(self) -> int:
        if self.head_pad_to and self.n_heads % self.head_pad_to:
            return (self.n_heads // self.head_pad_to + 1) * self.head_pad_to
        return self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the embedding/logits tables shard evenly:
        to 256 (the full chip count, for the tp1 256-way layout) for real
        vocabularies, to 16 for tiny smoke vocabs."""
        mult = 256 if self.vocab >= 1024 else 16
        return -(-self.vocab // mult) * mult

    @property
    def padded_kv(self) -> int:
        """MHA archs (kv == heads) must pad KV alongside Q so the GQA
        group structure (g = H/KV) survives TP head padding."""
        if self.n_kv == self.n_heads:
            return self.padded_heads
        return self.n_kv

    def params_count(self) -> int:
        """Analytic parameter count (true heads, no TP padding)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        pattern = (self.block_pattern * self.n_layers)[: self.n_layers]
        for kind in pattern:
            if kind == "attn":
                total += D * (self.n_heads + 2 * self.n_kv + self.n_heads) * self.d_head
                if self.moe is not None:
                    total += D * self.moe.n_experts + 3 * self.moe.n_experts * D * F
                elif self.mlp in ("swiglu", "geglu"):
                    total += 3 * D * F
                else:
                    total += 2 * D * F + F + D
                total += 2 * D
            elif kind == "rglru":
                R = self.d_rnn or D
                total += 2 * D * R + 4 * R + 2 * R * R + R * D + 3 * D * F + 2 * D
            elif kind == "rwkv":
                total += 4 * D * D + D * D + 2 * D * 64 + 12 * D \
                    + D * F + F * D + D * D + 2 * D
        total += D  # final norm
        return total

    def active_params_count(self) -> int:
        """MoE: only top-k experts active per token (for 6*N_active*D flops)."""
        if self.moe is None:
            return self.params_count()
        D, F = self.d_model, self.d_ff
        per_layer_all = 3 * self.moe.n_experts * D * F
        per_layer_act = 3 * self.moe.top_k * D * F
        return self.params_count() - self.n_layers * (per_layer_all - per_layer_act)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq: int
    batch: int              # global batch
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """A model config + the parallelism/implementation plan for the mesh."""
    model: ModelConfig
    source: str = ""             # provenance note
    fsdp: bool = True            # 2D param sharding for training
    serve_seq_shard: bool = False  # flash-decode over seq-sharded cache
    serve_mlp_2d: bool = False   # spread FFN over (data, model) when serving
    microbatch: int = 1          # gradient-accumulation steps for train_4k
    remat: bool = True
    opt: str = "adamw"           # adamw | adafactor (memory option for 100B+)
    notes: str = ""

    def skip_reason(self, shape: ShapeConfig) -> Optional[str]:
        if shape.name == "long_500k" and not self.model.subquadratic:
            return "SKIP(full-attention): 500k decode needs sub-quadratic arch"
        return None
