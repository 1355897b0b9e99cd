"""musicgen-medium [audio]: decoder-only over EnCodec tokens.

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048  [arXiv:2306.05284; hf]
Backbone only — the EnCodec frontend is a stub; input_specs() provides
precomputed frame embeddings.  GELU MLP + sinusoidal positions (the
original musicgen transformer), biasless.  24 heads don't divide the
16-wide model axis: q-heads are zero-padded to 32 (exact function,
+33% attn-projection flops — see DESIGN.md §head-padding).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_head=64,
    d_ff=6144, vocab=2048,
    mlp="gelu", pos_emb="sinusoidal", rope_theta=0.0,
    frontend="audio_stub", tie_embeddings=False,
    head_pad_to=16,
)

ARCH = ArchSpec(
    model=MODEL,
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
    fsdp=True, serve_seq_shard=True, microbatch=2,
    notes="audio backbone; frame embeddings stubbed per assignment",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=64, mlp="gelu", pos_emb="sinusoidal",
    frontend="audio_stub", tie_embeddings=False, head_pad_to=None,
)
