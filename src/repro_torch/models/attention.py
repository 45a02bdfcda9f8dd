"""Attention math: masks, GQA, full/partial (flash-style) attention.

PyTorch counterpart of `repro/models/attention.py`, same layouts
(``q [B,Sq,H,D]``, ``k/v [B,Sk,KVH,D]``, ``Partial(o [B,Sq,H,D], m, l
[B,Sq,H])``).  `partial_attention` returns *unnormalized* output + (max,
sum-exp) statistics so that partials over disjoint KV shards combine exactly
— the primitive both the striped ESP ring (prefill) and multi-master decode
are built on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class Partial(NamedTuple):
    """Unnormalized attention partial over one KV shard."""

    o: torch.Tensor  # [B, Sq, H, D] f32, sum_j exp(s_j - m) v_j
    m: torch.Tensor  # [B, Sq, H] f32 running max of logits (-inf = empty)
    l: torch.Tensor  # [B, Sq, H] f32 sum of exp(s - m)


def empty_partial(b: int, sq: int, h: int, d: int, device=None) -> Partial:
    """Partial over an empty KV shard: a no-op under merge_partial
    (m=-inf carries zero weight)."""
    return Partial(
        o=torch.zeros((b, sq, h, d), dtype=torch.float32, device=device),
        m=torch.full((b, sq, h), -torch.inf, dtype=torch.float32, device=device),
        l=torch.zeros((b, sq, h), dtype=torch.float32, device=device),
    )


def gqa_expand(kv: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, KVH*q_per_kv, D] by repetition."""
    if q_per_kv == 1:
        return kv
    return kv.repeat_interleave(q_per_kv, dim=2)


def packed_segment_ids(seq_offsets, t: int, device=None) -> torch.Tensor:
    """Segment id per packed token index for a ragged batch concatenated on
    one token axis: request b owns ``[seq_offsets[b], seq_offsets[b+1])``.
    Tokens past ``seq_offsets[-1]`` (bucket padding) get segment id B and
    never interact with real rows."""
    off = torch.as_tensor(seq_offsets, dtype=torch.int32, device=device)
    ti = torch.arange(t, dtype=torch.int32, device=off.device)
    return (ti[:, None] >= off[None, 1:]).sum(dim=1).to(torch.int32)


def mask_from_positions(
    q_pos: torch.Tensor,  # [Sq] or [B, Sq] int global positions
    k_pos: torch.Tensor,  # [Sk] or [B, Sk]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,  # [Sk] or [B, Sk] bool
) -> torch.Tensor:
    """Boolean mask [.., Sq, Sk]; True = attend. Position-based so it is
    correct under *any* sequence permutation (striped layout)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    shape = torch.broadcast_shapes(qp.shape, kp.shape)
    m = torch.ones(shape, dtype=torch.bool, device=qp.device)
    if causal:
        m = m & (qp >= kp)
    if window is not None:
        m = m & (qp - kp < window)
    if k_valid is not None:
        m = m & k_valid[..., None, :]
    return m


def partial_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KVH, D]
    v: torch.Tensor,  # [B, Sk, KVH, D]
    mask: Optional[torch.Tensor],  # [Sq, Sk] or [B, Sq, Sk] or None
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> Partial:
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    k = gqa_expand(k, h // kvh)
    v = gqa_expand(v, h // kvh)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    # f32 accumulation (the reference's preferred_element_type=f32): bf16
    # products are exact in f32, so widening the operands is the same math
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None, None]
        elif mask.ndim == 3:
            mask = mask[:, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1)  # [B,H,Sq]
    # guard fully-masked rows: exp(NEG_INF - NEG_INF)=1 would pollute l; use
    # a masked max floor instead.
    m_safe = torch.clamp(m, min=-1e29)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=p.device))
    l = p.sum(dim=-1)  # [B,H,Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    m_out = torch.where(m <= NEG_INF / 2, torch.full((), -torch.inf, device=m.device), m_safe)
    return Partial(o=o, m=m_out.transpose(1, 2), l=l.transpose(1, 2))


def merge_partial(a, b) -> Partial:
    ao, am, al = a
    bo, bm, bl = b
    m = torch.maximum(am, bm)
    zero = torch.zeros((), device=m.device)
    m_safe = torch.where(torch.isinf(m), zero, m)
    wa = torch.where(torch.isinf(am), zero, torch.exp(am - m_safe))
    wb = torch.where(torch.isinf(bm), zero, torch.exp(bm - m_safe))
    return Partial(
        o=ao * wa[..., None] + bo * wb[..., None],
        m=m,
        l=al * wa + bl * wb,
    )


def finalize_partial(p: Partial) -> torch.Tensor:
    denom = torch.where(p.l == 0.0, torch.ones((), device=p.l.device), p.l)
    return p.o / denom[..., None]


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: Optional[torch.Tensor] = None,
    k_pos: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Dense reference attention. Returns [B, Sq, H, D] in q.dtype."""
    sq, sk = q.shape[1], k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(sk, device=q.device)
    need_mask = causal or window is not None or k_valid is not None
    mask = (
        mask_from_positions(q_pos, k_pos, causal=causal, window=window, k_valid=k_valid)
        if need_mask
        else None
    )
    out = finalize_partial(partial_attention(q, k, v, mask, softcap=softcap))
    return out.to(q.dtype)
