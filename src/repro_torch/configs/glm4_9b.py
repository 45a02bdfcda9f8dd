"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE + extreme GQA (kv=2). [hf:THUDM/glm-4-9b; hf]
kv=2 -> KV heads replicated across TP; decode shards the KV *sequence* over
(data×model) instead (multi-master decode), which is exactly where LoongServe's
token-granularity KV placement shines.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=5e6,
    rope_fraction=0.5,  # GLM applies rotary to half the head dim
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=131072,
)
