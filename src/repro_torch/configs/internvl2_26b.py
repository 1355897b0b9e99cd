"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 backbone.  [arXiv:2404.16821; hf]

Backbone only per assignment: the InternViT frontend is a stub and
input_specs() provides precomputed patch embeddings [B, S, d_model].
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=16384, vocab=92553,
    rope_theta=1e6, mlp="swiglu", tie_embeddings=False,
    frontend="vision_stub",
)

ARCH = ArchSpec(
    model=MODEL,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
    fsdp=True, serve_seq_shard=True, serve_mlp_2d=True, microbatch=8,
    notes="vision patch embeddings stubbed per assignment",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=16,
    d_ff=128, vocab=128, mlp="swiglu", tie_embeddings=False,
    frontend="vision_stub",
)
