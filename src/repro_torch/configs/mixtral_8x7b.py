"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]

EP sharding: 8 experts < 16 TP shards, so experts keep their identity and each
expert is TP-sharded over `model` (w1/w3 column-, w2 row-split).
SWA => long_500k runs with a bounded 4K decode window.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    moe_top_k=2,
    rope_theta=1e6,
    sliding_window=4096,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=32768,
)
