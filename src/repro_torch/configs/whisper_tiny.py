"""whisper-tiny [audio] — enc-dec, 4L encoder + 4L decoder, d_model=384 6H
d_ff=1536 vocab=51865, conv frontend STUB. [arXiv:2212.04356; unverified]

input_specs() provides precomputed frame embeddings (batch, 1500, 384); the
assigned decode shapes exercise the *decoder* (self-attn KV at the given
lengths + static cross-attn KV) — real Whisper caps the decoder at 448 tokens,
we honor the assigned shapes as a sharding/roofline exercise (DESIGN.md §4).
6 heads don't divide 16 -> batch-over-model attention sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab_size=51865,
    ffn_kind="gelu",
    norm_kind="layernorm",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    n_frontend_tokens=1500,
    max_seq_len=32768,
)
