"""Dense oracles for the kernels and the engine (allclose / token targets).

PyTorch counterparts of the dense oracles in `repro/kernels/ref.py`: O(T^2)
masks.  They are the plain versions of the kernels (K4, K5 here; K1-K3 in
their modules) and, through `PlainAttnImpl`, the attention of the port's
serial oracle, so the oracle stays plain on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_flash_decode import (  # noqa: F401
    paged_flash_decode_partial_plain as paged_flash_decode_partial_ref,
)
from repro_torch.models import attention as A


def striped_flash_attention_ref(q, k, v, q_pos, k_pos, *, causal=True,
                                window=None, softcap=None):
    """Plain K4: dense position-masked attention (`A.full_attention`),
    normalized, in q's dtype."""
    return A.full_attention(
        q, k, v, q_pos=torch.as_tensor(q_pos).to(q.device),
        k_pos=torch.as_tensor(k_pos).to(q.device), causal=causal,
        window=window, softcap=softcap,
    )


def striped_flash_attention_ref_lse(q, k, v, q_pos, k_pos, *, causal=True,
                                    window=None, softcap=None, o_acc=False):
    """Plain K4 forward with its row statistics: (o [B,Sq,H,D] in q's
    dtype, or in the accumulation type with ``o_acc`` (the ESP ring step's
    partial), lse [B,H,Sq] in the accumulation type: f32, f64 for f64).
    ``lse = m + log l`` of the row's softmax over the soft-capped, scaled
    scores; a row with no key gets ``+inf``, so ``exp(t - lse)`` is 0 for
    it in the backward."""
    qp = torch.as_tensor(q_pos).to(q.device)
    kp = torch.as_tensor(k_pos).to(q.device)
    need_mask = causal or window is not None
    mask = (A.mask_from_positions(qp, kp, causal=causal, window=window)
            if need_mask else None)
    part = A.partial_attention(q, k, v, mask, softcap=softcap)
    lse = torch.where(part.l > 0, part.m + torch.log(part.l),
                      torch.full((), torch.inf, device=q.device))
    o = A.finalize_partial(part)
    return (o if o_acc else o.to(q.dtype)), lse.transpose(1, 2).contiguous()


def striped_flash_attention_bwd_ref(q, k, v, o, do, lse, q_pos, k_pos, *,
                                    causal=True, window=None, softcap=None,
                                    rows=None):
    """Plain K4 backward: the explicit FlashAttention-2 gradient formula in
    f32 (f64 for f64 operands), not autograd.  The reference's order of operations
    (`repro/models/attention.py:102-142`): ``s = (q k^T) * scale``, then the
    softcap ``t = c tanh(s / c)``, then the mask; ``p = exp(t - lse)``,
    ``delta = rowsum(do * o)``, ``dv = p^T do``, ``dp = do v^T``,
    ``ds = p (dp - delta)`` (times ``1 - tanh^2(s / c)`` under a softcap),
    ``dq = scale ds k``, ``dk = scale ds^T q``; GQA sums dk / dv over the q
    heads of each KV head.  ``rows`` evaluates the query rows in blocks of
    that many (dk / dv accumulated across blocks), so a full-width check
    never holds the whole [B, H, Sq, Sk] score matrix.  Returns (dq, dk,
    dv) in q's dtype."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / d ** 0.5
    dev = q.device
    qp = torch.as_tensor(q_pos).to(dev)
    kp = torch.as_tensor(k_pos).to(dev)
    kf = A.widen(A.gqa_expand(k, g))
    vf = A.widen(A.gqa_expand(v, g))
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(kf)
    dqs = []
    step = rows or max(sq, 1)
    for i0 in range(0, sq, step):
        sl = slice(i0, i0 + step)
        qf, dof = A.widen(q[:, sl]), A.widen(do[:, sl])
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if softcap is not None:
            th = torch.tanh(s / softcap)
            s = softcap * th
        p = torch.exp(s - lse[:, :, sl, None].to(s.dtype))
        if causal or window is not None:
            mask = A.mask_from_positions(qp[sl], kp, causal=causal,
                                         window=window)
            p = torch.where(mask[None, None], p, torch.zeros((), device=dev))
        delta = (dof * A.widen(o[:, sl])).sum(-1).transpose(1, 2)  # [B,H,q]
        dv += torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        ds = p * (dp - delta[..., None])
        if softcap is not None:
            ds = ds * (1.0 - th * th)
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    sk = k.shape[1]
    dk = dk.view(b, sk, kvh, g, d).sum(3)
    dv = dv.view(b, sk, kvh, g, d).sum(3)
    dq = torch.cat(dqs, dim=1) if dqs else torch.zeros_like(q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_decode_partial_ref(q, k, v, lengths, *, k_pos_offset=0,
                             window=None, softcap=None) -> A.Partial:
    """Plain K5: the unnormalized partial of q [B,1,H,D] over one dense KV
    shard [B,S,KVH,D] whose first key sits at global position
    ``k_pos_offset``.  Repo window convention (see the reference's
    striped_attention.py): the query sits at global position ``lengths``
    (its own KV is not in the shard), so ``qp - kp < window`` is
    ``kp > lengths - window``."""
    b, s = k.shape[0], k.shape[1]
    pos = k_pos_offset + torch.arange(s, device=q.device)
    cl = torch.as_tensor(lengths).to(q.device)
    valid = pos[None, :] < cl[:, None]
    if window is not None:
        valid &= pos[None, :] > (cl[:, None] - window)
    mask = valid[:, None, :].expand(b, q.shape[1], s)
    return A.partial_attention(q, k, v, mask, softcap=softcap)


class PlainAttnImpl:
    """The default attention of the model in plain PyTorch (no kernel):
    `DefaultAttnImpl` with K4 / K5 replaced by their dense oracles.  The
    serial oracle runs the model under it, so on the card the oracle never
    goes through the kernels it is held against."""

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        return striped_flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                           window=window, softcap=softcap)

    def decode_attn(self, q, k_cache, v_cache, k_new, v_new, cache_len, *,
                    window, softcap):
        p_hist = flash_decode_partial_ref(q, k_cache, v_cache, cache_len,
                                          window=window, softcap=softcap)
        p_new = A.partial_attention(q, k_new, v_new, None, softcap=softcap)
        return A.finalize_partial(A.merge_partial(p_hist, p_new)).to(q.dtype)

    def ssm_scan(self, kind, p, x, cfg, state):
        """The recurrent layers hold no kernel: the default impl's scan."""
        from repro_torch.models.transformer import DefaultAttnImpl

        return DefaultAttnImpl().ssm_scan(kind, p, x, cfg, state)


def serial_decode_oracle(model, params, prompt, n_decode: int) -> list:
    """Greedy token oracle for engine parity: one serial prefill over
    `prompt` followed by ``n_decode`` dense-cache decode steps (argmax,
    KV appended in place; an attention-free model carries only its
    recurrent state), with the model's attention swapped for
    `PlainAttnImpl` for the duration (the way the executor swaps impls).
    Returns the ``n_decode + 1`` emitted token ids — what a real-mode engine
    must reproduce exactly."""
    prev_impl = model.attn_impl
    model.attn_impl = PlainAttnImpl()
    try:
        return _serial_decode(model, params, prompt, n_decode)
    finally:
        model.attn_impl = prev_impl


def _serial_decode(model, params, prompt, n_decode: int) -> list:
    dev = model.device
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    logits, cache = model.prefill(params, {"tokens": toks})
    nxt = int(torch.argmax(logits[0, -1]))
    out = [nxt]
    n_in = len(prompt)
    if cache.k is not None:
        s_max = n_in + n_decode + 2
        shape = (cache.k.shape[0], 1, s_max) + tuple(cache.k.shape[3:])
        k_pad = torch.zeros(shape, dtype=cache.k.dtype, device=dev)
        v_pad = torch.zeros_like(k_pad)
        k_pad[:, :, :n_in] = cache.k
        v_pad[:, :, :n_in] = cache.v
        cache = cache._replace(k=k_pad, v=v_pad)
    for _ in range(n_decode):
        logits, cache, kvs = model.decode(
            params, torch.as_tensor([nxt], device=dev), cache
        )
        if kvs is not None:
            pos = int(cache.length[0]) - 1
            cache.k[:, :, pos:pos + 1] = kvs[0]
            cache.v[:, :, pos:pos + 1] = kvs[1]
        nxt = int(torch.argmax(logits[0]))
        out.append(nxt)
    return out


def packed_prefill_ref(q, k, v, seq_offsets, *, window=None, softcap=None):
    """Dense segment-mask oracle for packed ragged prefill (O(T^2) mask).
    Causality/window are evaluated in packed coordinates."""
    t = q.shape[0]
    ti = torch.arange(t, device=q.device)
    seg = A.packed_segment_ids(seq_offsets, t, device=q.device)
    mask = (seg[:, None] == seg[None, :]) & (ti[:, None] >= ti[None, :])
    if window is not None:
        mask &= (ti[:, None] - ti[None, :]) < window
    out = A.finalize_partial(
        A.partial_attention(q[None], k[None], v[None], mask[None],
                            softcap=softcap)
    )
    return out[0]


def _ring_chunk_mask(tl, q_shard, k_shard, n_shards, seq_offsets, *,
                     window=None, device=None):
    """[Tl, Tl] mask for one striped ring chunk: shard r's local slot j is
    global packed index ``j * n + r``; segment ids derive from the GLOBAL
    offsets at global positions."""
    j = torch.arange(tl, device=device)
    gq = j * n_shards + q_shard
    gk = j * n_shards + k_shard
    off = torch.as_tensor(seq_offsets, dtype=torch.int64).to(device)
    seg_q = (gq[:, None] >= off[None, 1:]).sum(dim=1)
    seg_k = (gk[:, None] >= off[None, 1:]).sum(dim=1)
    mask = (seg_q[:, None] == seg_k[None, :]) & (gq[:, None] >= gk[None, :])
    if window is not None:
        mask &= (gq[:, None] - gk[None, :]) < window
    return mask


def packed_prefill_ring_chunk_ref(q, k, v, seq_offsets, carry, *, q_shard,
                                  k_shard, n_shards, window=None,
                                  softcap=None):
    """Dense oracle for one ring step: fold one striped KV chunk into the
    carried unnormalized (o, m, l) state.  ``seq_offsets`` are the GLOBAL
    packed offsets."""
    tl = q.shape[0]
    mask = _ring_chunk_mask(tl, q_shard, k_shard, n_shards, seq_offsets,
                            window=window, device=q.device)
    part = A.partial_attention(q[None], k[None], v[None], mask[None],
                               softcap=softcap)
    o, m, l = A.merge_partial(
        A.Partial(carry[0][None], carry[1][None], carry[2][None]), part
    )
    return o[0], m[0], l[0]


def paged_decode_merge_ref(q, k_new, v_new, shards, *, query_pos=None,
                           window=None, softcap=None):
    """Dense multi-shard oracle for the distributed decode merge (SPMD or
    per-shard loop): the new token's own KV partial LSE-merged with one
    paged partial per shard, finalized.  ``shards`` is an iterable of
    ``(k_pages, v_pages, block_table, lengths, page_pos)`` tuples — the
    per-instance pool views, merged in instance order."""
    part = A.partial_attention(q, k_new, v_new, None, softcap=softcap)
    for kp, vp, bt, lens, pos in shards:
        p = paged_flash_decode_partial_ref(
            q, kp, vp, bt, lens, pos, query_pos=query_pos, window=window,
            softcap=softcap,
        )
        part = A.merge_partial(part, p)
    return A.finalize_partial(part)


def paged_decode_batch_sharded_ref(q, k_new, v_new, shards, *,
                                   query_pos=None, window=None, softcap=None):
    """Dense oracle for the BATCH-SHARDED multi-master decode boundary
    (`core.esp.paged_decode_attn_sharded`) with ``n = len(shards)`` virtual
    ranks: rank i holds shard i's paged KV and owns batch rows
    ``[i*B/n, (i+1)*B/n)``.  Each rank's full-batch partial over its shard,
    the weighted sum over ranks (the reduce-scatter), and every rank's
    merge with ITS slice of the new-token partial; the slices concatenate
    to the full [B,1,H,D] output."""
    n = len(shards)
    b = q.shape[0]
    assert b % n == 0, (b, n)
    b_l = b // n
    parts = [
        paged_flash_decode_partial_ref(
            q, kp, vp, bt, lens, pos, query_pos=query_pos, window=window,
            softcap=softcap,
        )
        for kp, vp, bt, lens, pos in shards
    ]
    m_g = torch.stack([p.m for p in parts]).amax(dim=0)
    m_safe = torch.where(torch.isinf(m_g), torch.zeros_like(m_g), m_g)
    w = [torch.where(torch.isinf(p.m), torch.zeros_like(p.m),
                     torch.exp(p.m - m_safe)) for p in parts]
    o_sum = sum(p.o * wi[..., None] for p, wi in zip(parts, w))
    l_sum = sum(p.l * wi for p, wi in zip(parts, w))
    outs = []
    for r in range(n):
        sl = slice(r * b_l, (r + 1) * b_l)
        p_new = A.partial_attention(q[sl], k_new[sl], v_new[sl], None,
                                    softcap=softcap)
        merged = A.merge_partial(A.Partial(o_sum[sl], m_g[sl], l_sum[sl]),
                                 p_new)
        outs.append(A.finalize_partial(merged))
    return torch.cat(outs, dim=0)
