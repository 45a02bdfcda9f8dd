"""Shared primitive layers: norms, RoPE, FFN variants, embeddings, init.

PyTorch counterpart of `repro/models/layers.py`: plain functions over
explicit parameter dicts of tensors, same layouts (``w_up [d, f]``,
``w_down [f, d]``, stacked layers ``[L, ...]``) so parameters convert 1:1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- init utils


def normal_init(shape, dtype, generator: torch.Generator, device) -> torch.Tensor:
    """normal(0, 0.02) drawn directly on `device` (the reference's
    `normal_init`; a torch Generator gives other numbers than a jax key)."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, 0.02, generator=generator
    )


# ---------------------------------------------------------------- norms


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm / LayerNorm with f32 statistics, output in x.dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
    else:  # pragma: no cover
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- RoPE


def rope_cos_sin(positions: torch.Tensor, d_rot: int, theta: float):
    """cos/sin tables [..., d_rot//2] (float32) for rotary embedding."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                               device=positions.device) / d_rot)
    )
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, d_rot: int):
    """Rotate the first `d_rot` features of the last dim of x [..., S, H, D]
    with the half-split pair layout of the reference (``x1 = x[:d_rot/2]``,
    ``x2 = x[d_rot/2:d_rot]``); cos/sin [..., S, d_rot//2] broadcast over H."""
    if d_rot == 0:
        return x
    rot, rest = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = rot[..., : d_rot // 2], rot[..., d_rot // 2:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.cat([r1, r2, rest], dim=-1)


# ---------------------------------------------------------------- FFN


def apply_ffn(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "relu2":
        r = F.relu(x @ p["w_up"])
        h = r * r
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:  # pragma: no cover
        raise ValueError(kind)
    return h @ p["w_down"]


# ---------------------------------------------------------------- embeddings


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def lm_head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d] x [d, vocab] -> f32 logits (softmax stability).  Operands are
    widened to f32: bf16 products are exact in f32, so this is the
    reference's ``preferred_element_type=f32`` product."""
    return x.float() @ w.float()
