"""Model / shape configuration dataclasses shared by the whole framework.

Every assigned architecture is described by a single `ModelConfig`. The model
builders in `repro_torch.models` consume nothing but this dataclass, so adding an
architecture == adding a config file.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> derived d_model // n_heads

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope_fraction: float = 1.0  # fraction of d_head with rotary applied
    sliding_window: Optional[int] = None  # SWA window (tokens), None = full
    attn_logit_softcap: Optional[float] = None

    # --- ffn ---
    ffn_kind: str = "swiglu"  # swiglu | relu2 | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # --- moe ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    dense_ff: int = 0  # arctic-style parallel dense residual FFN (0 = none)

    # --- ssm (mamba2) / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2-style): layers grouped into superblocks of
    # `hybrid_mamba_per_block` mamba layers followed by ONE application of a
    # single *shared* attention+FFN block (weights shared across superblocks).
    hybrid_mamba_per_block: int = 0

    # --- xlstm ---
    xlstm_slstm_every: int = 0  # every k-th block is an sLSTM block (0 = none)
    xlstm_proj_factor: float = 2.0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder length (whisper: 1500 frames)

    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # None | "patch_stub" | "audio_stub"
    n_frontend_tokens: int = 0  # patches / frames provided pre-embedded

    # --- misc ---
    max_seq_len: int = 32768
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ---------------- derived ----------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.ssm_state == 0  # xlstm

    @property
    def has_full_attention(self) -> bool:
        """True if the arch has *unbounded-window full* attention anywhere.

        Used to decide long_500k applicability: SWA / SSM / hybrid / xlstm are
        sub-quadratic; pure full-attention archs skip long_500k.
        """
        if self.family in ("ssm",):
            return self.ssm_state == 0 and False  # neither mamba nor xlstm
        if self.family == "hybrid":
            # zamba2 shared-attn keeps full KV but over a bounded set of
            # attention applications; the paper brief classifies hybrids as
            # long_500k-runnable.
            return False
        return self.sliding_window is None

    @property
    def kv_bytes_per_token(self) -> int:
        """bf16 KV bytes per token (all layers) - used by the KV pool."""
        if self.family == "ssm":
            return 0
        n_attn = self.n_attention_applications
        return n_attn * 2 * self.n_kv_heads * self.head_dim * 2

    @property
    def n_attention_applications(self) -> int:
        if self.family == "hybrid" and self.hybrid_mamba_per_block:
            return self.n_layers // self.hybrid_mamba_per_block
        if self.family == "ssm":
            return 0
        if self.is_encoder_decoder:
            return self.n_layers  # decoder self-attn layers
        return self.n_layers

    # approximate parameter count (used for roofline MODEL_FLOPS = 6·N·D)
    def param_count(self, active_only: bool = False) -> int:
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        if self.ffn_kind == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.family == "moe":
            n_e = self.moe_top_k if active_only else self.n_experts
            moe = n_e * ffn + d * self.n_experts
            dense = 3 * d * self.dense_ff if self.dense_ff else 0
            per_layer = attn + moe + dense
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh_ssm = d_in // self.ssm_head_dim
            ssm = (
                d * (2 * d_in + 2 * self.ssm_state + nh_ssm)
                + d_in * d
                + (d_in + 2 * self.ssm_state) * self.ssm_conv_width
            )
            shared = attn + ffn  # one shared block, counted once
            total = self.n_layers * ssm + shared
        elif self.family == "ssm":  # xlstm
            d_in = int(self.xlstm_proj_factor * d)
            per = 2 * d * d_in + 3 * d_in * (nh * 3) + d_in * d + 4 * d * d_in
            total = self.n_layers * per
        else:
            total = self.n_layers * (attn + ffn)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (attn + ffn)
            cross = self.n_layers * attn
            total += enc + cross
        return int(total)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant of `cfg` for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else cfg.n_kv_heads,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=256,
        max_seq_len=512,
        dtype="float32",
    )
    if cfg.family == "moe":
        # generous capacity so smoke tests see no token dropping
        small.update(n_experts=4, moe_top_k=2, dense_ff=64 if cfg.dense_ff else 0,
                     moe_capacity_factor=4.0)
    if cfg.family == "hybrid":
        small.update(
            n_layers=4, hybrid_mamba_per_block=2, ssm_state=16, ssm_head_dim=16,
            ssm_chunk=32, n_kv_heads=4,
        )
    if cfg.family == "ssm" and cfg.ssm_state:  # pure mamba
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.xlstm_slstm_every:
        small.update(xlstm_slstm_every=2)
    if cfg.is_encoder_decoder:
        small.update(n_encoder_layers=2, n_layers=2, encoder_seq=16,
                     n_frontend_tokens=16)
    if cfg.frontend == "patch_stub":
        small.update(n_frontend_tokens=16)
    if cfg.sliding_window:
        small.update(sliding_window=128)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
