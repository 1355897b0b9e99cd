"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU + (here trivial, kv == heads) GQA.  [arXiv:2404.14219]
32 heads divide the model axis exactly; KV heads shard 2-per-device, so
decode uses the tp_kv path (no flash-decode needed at 32k).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, d_head=96,
    d_ff=8192, vocab=32064,
    rope_theta=10_000.0, mlp="swiglu", tie_embeddings=False,
)

ARCH = ArchSpec(
    model=MODEL,
    source="arXiv:2404.14219 (unverified per assignment)",
    fsdp=True, serve_seq_shard=False, microbatch=4,
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=128, mlp="swiglu", tie_embeddings=False,
)
