"""zamba2-2.7b [hybrid] — 54L d_model=2560, Mamba2 backbone + ONE shared
attention block (32H kv=32, d_ff=10240) applied every 6 mamba layers,
ssm_state=64, vocab=32000. [arXiv:2411.15242; hf]

ESP applicability: the shared-attention applications keep full KV (sharded
with multi-master decode / striped-ring prefill); the Mamba2 layers are
recurrent over the sequence so the striped ring is inapplicable to them —
they run chunked-SSD locally per sequence shard with a chunk-state handoff
(linear ppermute chain), see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,  # keeps the [L,L,H] intra-chunk decay tensors VMEM-sized
    hybrid_mamba_per_block=6,  # 9 superblocks x (6 mamba + shared attn)
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    max_seq_len=1048576,
)
