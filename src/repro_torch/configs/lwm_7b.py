"""lwm-7b — the paper's own evaluation model (LWM-1M-Text = Llama-2-7B
architecture with a 1M context window). [arXiv:2402.08268 / Llama-2-7B]

This is the config used by the serving examples / benchmarks to mirror the
paper's testbed.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="lwm-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=1e7,  # LWM's scaled theta for the 1M window
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=1048576,
)
