"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (R, R, A).
[arXiv:2402.19427; hf]

Sub-quadratic: eligible for the long_500k cell (RG-LRU state + 2048-token
window cache => O(1) decode state).  26 layers = 8 x (rglru, rglru, attn)
+ 2 rglru tail (two scan groups).  10 heads pad to 16 for TP.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_head=256,
    d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "attn"),
    d_rnn=2560, sliding_window=2048,
    rope_theta=10_000.0, mlp="geglu", tie_embeddings=True,
    head_pad_to=16, subquadratic=True,
)

ARCH = ArchSpec(
    model=MODEL,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
    fsdp=True, serve_seq_shard=False, microbatch=4,
    notes="window cache is tiny (2048); decode shards it on batch only",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    n_layers=5, d_model=64, n_heads=4, n_kv=1, d_head=16,
    d_ff=128, vocab=128, block_pattern=("rglru", "rglru", "attn"),
    d_rnn=64, sliding_window=8, mlp="geglu", tie_embeddings=True,
    subquadratic=True,
)
