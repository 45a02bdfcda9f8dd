"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA => bounded decode KV window => long_500k runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab_size=32000,
    rope_theta=1e4,
    sliding_window=4096,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=16384,
)
