"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.

QKV bias (the Qwen1.5 signature), RoPE, SwiGLU.  [hf:Qwen/Qwen1.5-*; hf]
20 heads don't divide the 16-wide model axis: padded to 32 for TP
(decode uses flash-decode with replicated projections instead).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="qwen1.5-4b",
    n_layers=40, d_model=2560, n_heads=20, n_kv=20, d_head=128,
    d_ff=6912, vocab=151936,
    qkv_bias=True, rope_theta=1e6, mlp="swiglu",
    tie_embeddings=False, head_pad_to=16,
)

ARCH = ArchSpec(
    model=MODEL,
    source="hf:Qwen/Qwen1.5-4B (scaled family config per assignment)",
    fsdp=True, serve_seq_shard=True, microbatch=4,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=128, qkv_bias=True, mlp="swiglu",
    tie_embeddings=False,
)
