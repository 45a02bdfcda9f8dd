"""xlstm-350m [ssm] — 24L d_model=1024 4H vocab=50304, d_ff=0 (blocks carry
their own up/down projections) — sLSTM + mLSTM blocks. [arXiv:2405.04517;
unverified]

Attention-free: ESP's striped KV ring is inapplicable (no KV); the analogue is
chunkwise mLSTM with a single chunk-state handoff between sequence shards.
Decode state is O(1)/request => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_head=256,
    d_ff=0,
    vocab_size=50304,
    ssm_state=0,  # marks xlstm (matrix-memory, not mamba SSD)
    xlstm_slstm_every=8,  # blocks 7, 15, 23 are sLSTM; rest mLSTM
    xlstm_proj_factor=2.0,
    norm_kind="layernorm",
    max_seq_len=1048576,
)
