"""Shared primitive layers: norms, RoPE, FFN variants, embeddings, init.

PyTorch counterpart of `repro/models/layers.py`: plain functions over
explicit parameter dicts of tensors, same layouts (``w_up [d, f]``,
``w_down [f, d]``, stacked layers ``[L, ...]``) so parameters convert 1:1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- init utils


def normal_init(shape, dtype, generator: torch.Generator, device,
                scale: float = 0.02) -> torch.Tensor:
    """normal(0, scale) drawn directly on `device` (the reference's
    `normal_init`; a torch Generator gives other numbers than a jax key)."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, scale, generator=generator
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


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [n, d] (float32)."""
    half = d // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------- FFN


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [B, T, K] and w [K, N].  The matmul flattens x's
    leading dims; over a DTensor whose T dim is split and whose B dim (of
    more than one row) is not (the prefill activations, seq over "data")
    that flatten has no sharding rule in some torch releases (even over a
    size-1 mesh axis), so the product runs on a contiguous T-leading copy
    (a strided one would make the matmul broadcast w over T instead of
    flattening).  A plain tensor is ``x @ w``."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and x.ndim == 3 and x.shape[0] > 1:
        split = {p.dim for p in x.placements if p.is_shard()}
        if 1 in split and 0 not in split:
            return (x.transpose(0, 1).contiguous() @ w).transpose(0, 1)
    return x @ w


def apply_ffn(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    elif kind == "relu2":
        r = F.relu(dense(x, p["w_up"]))
        h = r * r
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, p["w_up"]), approximate="tanh")
    else:  # pragma: no cover
        raise ValueError(kind)
    return dense(h, p["w_down"])


# ---------------------------------------------------------------- embeddings


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (`F.embedding`: its gradient is the
    embedding backward, which DTensor shards over a batch-split ``ids``)."""
    return F.embedding(ids, table)


def lm_head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d] x [d, vocab] -> f32 logits (softmax stability).  Operands are
    widened to f32: bf16 products are exact in f32, so this is the
    reference's ``preferred_element_type=f32`` product."""
    return dense(x.float(), w.float())
