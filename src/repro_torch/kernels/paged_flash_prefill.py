"""Packed ragged causal flash prefill (K1) and its striped ring step (K3).

PyTorch counterparts of `repro/kernels/paged_flash_prefill.py`.  Both run
one hand-written CUDA kernel body (`csrc/flash_prefill.cu`; K1 is the ring
step with ``n_shards=1``, no carry and a final ``o / l``).  Each wrapper:

  * on a CPU tensor, returns its plain PyTorch version (`*_plain` below) —
    the same masked online-softmax math, exact per block of q rows;
  * on a CUDA tensor, launches the kernel (counted in `launch_counts`) or
    raises on what the kernel does not take.  Nothing falls back.

Contract (unchanged from the reference):
  * ``q`` [T, H, D], ``k``/``v`` [T, KVH, D] — the packed batch padded to a
    bucketed T, f32 or bf16 (q, k and v share one type);
  * ``seq_offsets`` [B+1] int — request b owns packed positions
    ``[off[b], off[b+1])``; trailing repeats are empty segments and tokens
    past ``off[-1]`` form their own padding segment;
  * the ring step takes the per-shard offsets of its q shard and KV chunk
    (`striped.shard_offsets`), evaluates causality/window on global striped
    positions ``j * n + shard`` and folds into the carried unnormalized
    ``(o [Tl,H,D], m [Tl,H], l [Tl,H])`` f32 state (``carry=None`` = empty).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from repro_torch.models import attention as A

#: kernel launches on CUDA tensors, by kernel name (plain CPU calls and
#: comparisons with the plain version are not launches of the kernel)
launch_counts: Counter = Counter()

_PLAIN_BLOCK_Q = 512  # q rows per dense block of the plain version


def _offsets(off, device) -> torch.Tensor:
    return torch.as_tensor(off, dtype=torch.int32).to(device)


def _seg_ids(j: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Segment id per local index: #off[1:] <= j (offsets non-decreasing)."""
    return (j[:, None] >= off[None, 1:].long()).sum(dim=1)


# ------------------------------------------------------------ plain versions


def packed_flash_prefill_ring_chunk_plain(
    q, k, v, q_offsets, k_offsets, carry=None, *, q_shard: int,
    k_shard: int, n_shards: int, window: Optional[int] = None,
    softcap: Optional[float] = None,
):
    """Plain PyTorch ring step: the q shard attends the whole KV chunk in
    blocks of q rows (dense masked partial per block), merged into the
    carry.  Returns the updated unnormalized (o, m, l)."""
    tl, h, d = q.shape
    dev = q.device
    n = int(n_shards)
    j = torch.arange(tl, device=dev)
    seg_q = _seg_ids(j, _offsets(q_offsets, dev))
    seg_k = _seg_ids(j, _offsets(k_offsets, dev))
    gq = j * n + q_shard
    gk = j * n + k_shard
    os_, ms, ls = [], [], []
    for s0 in range(0, tl, _PLAIN_BLOCK_Q):
        s1 = min(s0 + _PLAIN_BLOCK_Q, tl)
        mask = (seg_q[s0:s1, None] == seg_k[None, :]) & (gq[s0:s1, None] >= gk[None, :])
        if window is not None:
            mask &= (gq[s0:s1, None] - gk[None, :]) < window
        p = A.partial_attention(q[None, s0:s1], k[None], v[None], mask[None],
                                softcap=softcap)
        os_.append(p.o[0])
        ms.append(p.m[0])
        ls.append(p.l[0])
    part = A.Partial(torch.cat(os_), torch.cat(ms), torch.cat(ls))
    if carry is None:
        return tuple(part)
    return tuple(A.merge_partial(A.Partial(*carry), part))


def packed_flash_prefill_plain(q, k, v, seq_offsets, *, window=None,
                               softcap=None) -> torch.Tensor:
    """Plain PyTorch K1: the ring step with one shard, finalized."""
    part = packed_flash_prefill_ring_chunk_plain(
        q, k, v, seq_offsets, seq_offsets, None, q_shard=0, k_shard=0,
        n_shards=1, window=window, softcap=softcap,
    )
    return A.finalize_partial(A.Partial(*part))


# ------------------------------------------------------------ the kernel


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(q, k, v, q_offsets, k_offsets, carry, *, q_shard, k_shard,
            n_shards, window, softcap, normalize):
    from repro_torch.kernels import _build

    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill kernel: tensors on {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_prefill kernel: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} (need one of f32 / bf16)")
    tl, h, d = q.shape
    kvh = k.shape[1]
    if k.shape != (tl, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_prefill kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h // kvh > 64 or d > 256:
        raise ValueError(f"flash_prefill kernel: q_per_kv {h // kvh} > 64 "
                         f"or head size {d} > 256")
    dev = q.device
    qo, ko = _offsets(q_offsets, dev), _offsets(k_offsets, dev)
    if qo.shape != ko.shape or qo.ndim != 1 or qo.numel() > 4097:
        raise ValueError(f"flash_prefill kernel: offsets {tuple(qo.shape)}, "
                         f"{tuple(ko.shape)} (need equal [B+1], B <= 4096)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((tl, h, d), dtype=torch.float32, device=dev)
    m = l = None
    if not normalize:
        m = torch.empty((tl, h), dtype=torch.float32, device=dev)
        l = torch.empty((tl, h), dtype=torch.float32, device=dev)
    c_o = c_m = c_l = None
    if carry is not None:
        c_o, c_m, c_l = (torch.as_tensor(x).to(dev, torch.float32).contiguous()
                         for x in carry)
        if c_o.shape != (tl, h, d) or c_m.shape != (tl, h) or c_l.shape != (tl, h):
            raise ValueError("flash_prefill kernel: carry shapes "
                             f"{tuple(c_o.shape)}, {tuple(c_m.shape)}, "
                             f"{tuple(c_l.shape)}")
    lib = _build.load_library("flash_prefill")
    P = _build.ptr
    err = lib.repro_flash_prefill(
        P(q), P(k), P(v), P(qo), P(ko), qo.numel() - 1,
        P(c_o), P(c_m), P(c_l), P(o), P(m), P(l),
        tl, h, kvh, d, _DTYPE_CODE[q.dtype], int(q_shard), int(k_shard),
        int(n_shards), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0, 1.0 / math.sqrt(d),
        int(normalize), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "flash_prefill", err)
    return o if normalize else (o, m, l)


def packed_flash_prefill(q, k, v, seq_offsets, *, window=None,
                         softcap=None) -> torch.Tensor:
    """K1: one ragged launch over the packed token axis; returns the
    normalized attention output [T, H, D] (f32)."""
    if q.device.type == "cpu":
        return packed_flash_prefill_plain(q, k, v, seq_offsets, window=window,
                                          softcap=softcap)
    out = _launch(q, k, v, seq_offsets, seq_offsets, None, q_shard=0,
                  k_shard=0, n_shards=1, window=window, softcap=softcap,
                  normalize=True)
    launch_counts["packed_flash_prefill"] += 1
    return out


def packed_flash_prefill_ring_chunk(
    q, k, v, q_offsets, k_offsets, carry=None, *, q_shard: int,
    k_shard: int, n_shards: int, window: Optional[int] = None,
    softcap: Optional[float] = None,
):
    """K3: one ring step — fold one striped KV chunk into the carried flash
    state with a single ragged launch.  Returns the updated (o, m, l);
    finalize with ``o / l`` after the last step (empty rows keep m=-inf,
    l=0)."""
    if q.device.type == "cpu":
        return packed_flash_prefill_ring_chunk_plain(
            q, k, v, q_offsets, k_offsets, carry, q_shard=q_shard,
            k_shard=k_shard, n_shards=n_shards, window=window,
            softcap=softcap,
        )
    out = _launch(q, k, v, q_offsets, k_offsets, carry, q_shard=q_shard,
                  k_shard=k_shard, n_shards=n_shards, window=window,
                  softcap=softcap, normalize=False)
    launch_counts["packed_flash_prefill_ring_chunk"] += 1
    return out
