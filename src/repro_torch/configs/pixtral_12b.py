"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
— pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Per the brief the ViT frontend is a STUB: input_specs() provides precomputed
patch embeddings (batch, n_patches, d_model) which are concatenated with the
text token embeddings; the assigned seq_len counts text+image tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e9,  # mistral-nemo long-context base
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    frontend="patch_stub",
    n_frontend_tokens=1024,  # 1024 image patches pre-embedded
    max_seq_len=131072,
)
