"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

The framework's flagship memory case: trains only under 2D FSDP+TP with
Adafactor-compatible layouts (AdamW fits at 256 chips: ~12 GiB/chip of
optimizer+param state, see EXPERIMENTS.md §Dry-run); 32k decode requires
the sequence-sharded KV cache + flash-decode, and the FFN is 2D-sharded
when serving.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_head=128,
    d_ff=28672, vocab=32768,
    rope_theta=1e6, mlp="swiglu", tie_embeddings=False,
)

ARCH = ArchSpec(
    model=MODEL,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    fsdp=True, serve_seq_shard=True, serve_mlp_2d=True, microbatch=16,
    opt="adafactor",
    notes="123B dense; microbatch=16 + Adafactor keep remat activations "
          "and optimizer state under 16 GiB/chip (see EXPERIMENTS.md)",
)

SMOKE = ModelConfig(
    name="mistral-large-smoke",
    n_layers=3, d_model=64, n_heads=8, n_kv=2, d_head=16,
    d_ff=192, vocab=128, mlp="swiglu", tie_embeddings=False,
)
