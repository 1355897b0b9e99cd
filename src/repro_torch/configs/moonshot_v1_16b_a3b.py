"""moonshot-v1-16b-a3b [moe] (kimi/moonlight): 48L d_model=2048 16H (kv=16)
d_ff=1408/expert vocab=163840, MoE 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchSpec, ModelConfig
from repro_torch.models.moe import MoEConfig

MODEL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6),
    rope_theta=50_000.0, mlp="swiglu", tie_embeddings=False,
)

ARCH = ArchSpec(
    model=MODEL,
    source="hf:moonshotai/Moonlight-16B-A3B",
    fsdp=True, serve_seq_shard=False, microbatch=4,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=96, vocab=128, moe=MoEConfig(n_experts=8, top_k=2),
    mlp="swiglu", tie_embeddings=False,
)
