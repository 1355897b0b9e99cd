"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk-norm (per-head RMS on q and k) + GQA — the Qwen3 signature.
[hf:Qwen/Qwen3-4B family; hf]
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="qwen3-4b",
    n_layers=36, d_model=2560, n_heads=32, n_kv=8, d_head=128,
    d_ff=9728, vocab=151936,
    qk_norm=True, rope_theta=1e6, mlp="swiglu", tie_embeddings=True,
)

ARCH = ArchSpec(
    model=MODEL,
    source="hf:Qwen/Qwen3-4B",
    fsdp=True, serve_seq_shard=True, microbatch=4,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=16,
    d_ff=128, vocab=128, qk_norm=True, mlp="swiglu", tie_embeddings=True,
)
