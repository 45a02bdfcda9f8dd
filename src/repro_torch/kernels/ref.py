"""Dense oracles for the kernels and the engine (allclose / token targets).

PyTorch counterparts of the dense oracles in `repro/kernels/ref.py`: O(T^2)
masks, for tests and the on-card parity phase only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_flash_decode import (  # noqa: F401
    paged_flash_decode_partial_plain as paged_flash_decode_partial_ref,
)
from repro_torch.models import attention as A


def serial_decode_oracle(model, params, prompt, n_decode: int) -> list:
    """Greedy token oracle for engine parity: one serial prefill over
    `prompt` followed by ``n_decode`` dense-cache decode steps (argmax,
    KV appended in place).  Returns the ``n_decode + 1`` emitted token ids —
    what a real-mode engine must reproduce exactly."""
    dev = model.device
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    logits, cache = model.prefill(params, {"tokens": toks})
    nxt = int(torch.argmax(logits[0, -1]))
    out = [nxt]
    n_in = len(prompt)
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
