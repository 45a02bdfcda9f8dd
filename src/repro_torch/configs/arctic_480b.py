"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]

938 GB of bf16 expert weights cannot replicate across the data axis: experts
shard over `model` (128/16 = 8 per shard) and the expert FFN hidden dim shards
over `data` (expert-TP), giving ~3.7 GB/chip. 56 heads don't divide 16 ->
attention uses batch-over-model sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    moe_top_k=2,
    dense_ff=14336,  # parallel dense residual MLP
    rope_theta=1e6,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=4096,
)
