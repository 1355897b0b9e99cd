"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024/expert
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]

64 experts shard 4-per-device over the model axis (EP); sort-based
dispatch (see models/moe.py) because GShard one-hot dispatch would cost
more flops than these d_ff=1024 experts themselves.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig
from repro_torch.models.moe import MoEConfig

MODEL = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8),
    rope_theta=10_000.0, mlp="swiglu", tie_embeddings=False,
)

ARCH = ArchSpec(
    model=MODEL,
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
    fsdp=True, serve_seq_shard=False, microbatch=2,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=64, vocab=128, moe=MoEConfig(n_experts=8, top_k=2),
    mlp="swiglu", tie_embeddings=False,
)
