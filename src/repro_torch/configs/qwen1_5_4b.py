"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.

QKV bias per the Qwen1.5 family. [hf:Qwen/Qwen1.5-0.5B; hf]
20 heads do not divide the 16-wide TP axis -> attention uses batch-over-model
sharding (see DESIGN.md §mesh mapping); FFN TP is standard (6912 = 16·432).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=5e6,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=32768,
)
