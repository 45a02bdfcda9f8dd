"""Elastic Sequence Parallelism: the striped ring prefill of one DoP>1 ESP
group, replayed in one process (LoongServe §4).

The port's counterpart of `repro.core.esp.ring_packed_prefill`.  The SPMD
mesh programs of the reference (`ring_packed_prefill_spmd`, the sharded
decode iterations) are not ported yet (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import striped


def ring_packed_prefill(q, k, v, seq_offsets, n_shards: int, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Ring-fused packed ragged prefill for one DoP>1 ESP group.

    The packed token axis [T] is striped across the group's ``n_shards``
    instances (global packed index ``g`` -> shard ``g % n``, local slot
    ``g // n``).  Every instance starts holding its own KV stripe; the ring
    replays `striped.ring_chunk_schedule` and at each step each instance
    folds the chunk it holds into its carried (o, m, l) flash state with ONE
    packed ragged `ops.prefill_ring_chunk` launch (K3).  After n steps the
    per-instance states finalize and un-stripe back to the packed order.

    q [T,H,D], k/v [T,KVH,D] in PACKED order (``seq_offsets`` a numpy
    [B+1]); returns the normalized [T,H,D] f32 output, equal to
    `ops.prefill_packed`."""
    from repro_torch.kernels import ops

    t = q.shape[0]
    n = int(n_shards)
    assert n >= 1 and t % n == 0, (t, n)
    if n == 1:
        return ops.prefill_packed(q, k, v, seq_offsets, window=window,
                                  softcap=softcap)
    ops.dispatch_counts["prefill_ring_replay"] += 1
    qs = [q[r::n] for r in range(n)]
    ks = [k[r::n] for r in range(n)]
    vs = [v[r::n] for r in range(n)]
    offs = list(striped.all_shard_offsets(seq_offsets, n))
    sched = striped.ring_chunk_schedule(n)
    carries: list = [None] * n
    for step in range(n):
        for r in range(n):
            c = sched[step][r]
            carries[r] = ops.prefill_ring_chunk(
                qs[r], ks[c], vs[c], offs[r], offs[c], carries[r],
                q_shard=r, k_shard=c, n_shards=n, window=window,
                softcap=softcap,
            )
    outs = []
    for r in range(n):
        o, _, l = carries[r]
        denom = torch.where(l == 0.0, torch.ones((), device=l.device), l)
        outs.append(o / denom[..., None])  # l==0 rows are bucket padding
    return striped.unstripe(torch.cat(outs, dim=0), n, axis=0)
