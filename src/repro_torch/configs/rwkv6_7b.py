"""rwkv6-7b [ssm] "Finch": 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — data-dependent decay.  [arXiv:2404.05892; hf]

Sub-quadratic: long_500k decode carries only the [H, 64, 64] WKV state per
layer.  Head bookkeeping (64 heads x 64 dims) is internal to the rwkv
block; n_heads here is metadata only.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="rwkv6-7b",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_head=64,
    d_ff=14336, vocab=65536,
    block_pattern=("rwkv",),
    pos_emb="none", mlp="swiglu",  # mlp field unused by rwkv blocks
    tie_embeddings=False, subquadratic=True,
)

ARCH = ArchSpec(
    model=MODEL,
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b",
    fsdp=True, serve_seq_shard=False, microbatch=4,
    notes="paper technique (attention sharding) N/A — attention-free; "
          "see DESIGN.md §Arch-applicability",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    n_layers=2, d_model=128, n_heads=2, n_kv=2, d_head=64,
    d_ff=256, vocab=128, block_pattern=("rwkv",), pos_emb="none",
    tie_embeddings=False, subquadratic=True,
)
