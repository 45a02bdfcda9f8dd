"""Elastic Sequence Parallelism on `torch.distributed` (LoongServe §4).

The port's counterpart of `repro/core/esp.py`'s serving programs:

  * `ring_packed_prefill`: the striped ring of one DoP>1 ESP group, replayed
    in one process (the executor's aliased groups);
  * `ring_packed_prefill_spmd`: the same ring across processes — each rank
    holds its stripe, folds the chunk it holds with one K3 launch and
    passes the KV stripe on to the next rank (`ops.ring_ppermute`, one
    `batch_isend_irecv` per leg, double-buffered against the fold);
  * `paged_decode_spmd` (per layer: local K2 partial, `pmax` + weighted
    `psum`), `paged_decode_attn_sharded` / `paged_decode_iteration_spmd`
    (the batch-sharded multi-master iteration: all_gather of the q slices,
    `psum_scatter` back to the masters, in-program sampling and KV routing);
  * `unified_iteration_spmd`: the unified chunked step striped over the
    group (prefix plane by collectives, chunk plane by the ring).

The reference runs each as ONE shard_map program over a device mesh driven
by a single controller.  Here every rank is a process running the same code
in lockstep, so a "program" is the per-rank body itself: each process
computes with its own rank as a Python int (the reference's per-rank
`lax.switch` specialization has no counterpart) on its own pool mirror (no
leading rank axis on the paged operands), and the collectives are explicit.
``mesh`` is a `torch.distributed.device_mesh.DeviceMesh` or a
`launch.mesh.SubMesh`.  `ESPAttnImpl` and the recurrent families' sequence
parallelism are ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import striped
from repro_torch.models import attention as A


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
    outs = [_finalize_carry(c) for c in carries]
    return striped.unstripe(torch.cat(outs, dim=0), n, axis=0)


def _finalize_carry(carry):
    o, _, l = carry
    denom = torch.where(l == 0.0, torch.ones((), device=l.device), l)
    return o / denom[..., None]  # l==0 rows are bucket padding


def _ring_fold(group, n: int, r: int, q, k, v, seq_offsets, carry, *,
               window, softcap, double_buffer: bool):
    """The striped ring over ``group`` (this rank is ``r`` of ``n``): at
    step s fold the KV chunk held — provenance ``(r - s) mod n``,
    `striped.chunk_provenance` — into the carried (o, m, l) with one K3
    launch and pass the chunk on.  With ``double_buffer`` the next leg's
    send / receive is posted before the fold and waited on after it;
    without, the leg starts only after the fold.  ``seq_offsets`` are the
    GLOBAL packed offsets (numpy); each chunk's shard offsets derive from
    them here, so only KV bytes ride the ring."""
    from repro_torch.kernels import ops

    q_off = striped.shard_offsets(seq_offsets, n, r)
    kk, vv = k.contiguous(), v.contiguous()
    for step in range(n):
        if step < n - 1 and double_buffer:
            nxt = ops.ring_ppermute((kk, vv), group, async_op=True)
        c = (r - step) % n
        carry = ops.prefill_ring_chunk(
            q, kk, vv, q_off, striped.shard_offsets(seq_offsets, n, c), carry,
            q_shard=r, k_shard=c, n_shards=n, window=window, softcap=softcap,
        )
        if step < n - 1:
            kk, vv = (nxt.wait() if double_buffer
                      else ops.ring_ppermute((kk, vv), group))
    return carry


def ring_packed_prefill_spmd(mesh, q, k, v, seq_offsets, *,
                             sp_axis: str = "data",
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             double_buffer: bool = True):
    """Ring-fused packed ragged prefill across the ranks of ``mesh``'s
    ``sp_axis``: rank r holds stripe r of the packed token axis (global
    packed index ``g`` -> rank ``g % n``, local slot ``g // n``), folds the
    chunk it holds at each of the n ring steps with one K3 launch, and the
    KV stripes travel rank to rank over `ops.ring_ppermute`
    (``double_buffer=True``: the next leg is posted before the fold).  The
    finalized stripes are all-gathered (``ring_out_gather``) and unstriped.

    q [T,H,D], k/v [T,KVH,D] in PACKED order, the same on every rank of the
    axis (T % n == 0; ``seq_offsets`` a numpy [B+1]); returns the normalized
    [T,H,D] f32 output, equal to `ops.prefill_packed`.  At ``n == 1`` it IS
    `ops.prefill_packed` (K1)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_info

    n, r, group = axis_info(mesh, sp_axis)
    t = q.shape[0]
    assert n >= 1 and t % n == 0, (t, n)
    if n == 1:
        return ops.prefill_packed(q, k, v, seq_offsets, window=window,
                                  softcap=softcap)
    ops.dispatch_counts["prefill_ring_spmd"] += 1
    carry = _ring_fold(group, n, r, q[r::n], k[r::n], v[r::n], seq_offsets,
                       None, window=window, softcap=softcap,
                       double_buffer=double_buffer)
    out = ops.all_gather(_finalize_carry(carry), group, axis=0,
                         key="ring_out_gather")  # striped layout
    return striped.unstripe(out, n, axis=0)


def _lse_weights(part, m_g):
    """Per-rank weights exp(m - M) of the collective LSE merge (0 where
    this rank's partial is empty)."""
    m_safe = torch.where(torch.isinf(m_g), torch.zeros_like(m_g), m_g)
    return torch.where(torch.isinf(part.m), torch.zeros_like(part.m),
                       torch.exp(part.m - m_safe))


def paged_decode_spmd(mesh, q, k_new, v_new, query_pos, k_pages, v_pages,
                      table, lengths, page_pos=None, *,
                      sp_axis: str = "data",
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      overlap: bool = True):
    """One decode layer's multi-master paged attention across the ranks of
    ``mesh``'s ``sp_axis``: each rank computes its K2 partial over the pool
    mirror it holds (no KV moves), and the LSE merge of the per-instance
    partials is a collective on the weighted running accumulator:

        M   = pmax(m)                       (tiny [B, 1, H])
        o_s = psum(o · exp(m - M))          (the paper's "send back partial
        l_s = psum(l · exp(m - M))           results", §4.2, as ONE reduce)

    The new token's own KV partial does not depend on the reduce: with
    ``overlap=True`` the reduce is posted asynchronously and the new-token
    partial computes while it runs; ``overlap=False`` waits for the reduce
    first (the sequential baseline).

    q [B, 1, H, D], k_new / v_new [B, 1, KVH, D] and query_pos [B] are the
    same on every rank; k_pages / v_pages [n_pages, P, KVH, D] (one layer),
    table [B, max_pages], lengths [B] and page_pos [n_pages, P] (window
    only) are THIS rank's mirror view.  Returns the finalized merged
    [B, 1, H, D] f32, the same on every rank."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_info

    _, _, group = axis_info(mesh, sp_axis)
    ops.dispatch_counts["paged_decode_spmd"] += 1
    part = ops.paged_decode_partial(
        q, k_pages, v_pages, table, lengths, page_pos, query_pos=query_pos,
        window=window, softcap=softcap,
    )
    m_g = ops.pmax(part.m, group)
    w = _lse_weights(part, m_g)
    red = ops.psum((part.o * w[..., None], part.l * w), group,
                   async_op=overlap)
    if not overlap:
        o_s, l_s = red
    p_new = A.partial_attention(q, k_new, v_new, None, softcap=softcap)
    if overlap:
        o_s, l_s = red.wait()
    merged = A.merge_partial(A.Partial(o_s, m_g, l_s), p_new)
    return A.finalize_partial(merged)


def paged_decode_attn_sharded(sp, n: int, q, k_new, v_new, query_pos_full,
                              k_pages, v_pages, table, lengths,
                              page_pos=None, *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              overlap: bool = True):
    """One decode layer's BATCH-SHARDED multi-master paged attention
    boundary (LoongServe §4.2), inside the batch-sharded iteration
    (`paged_decode_iteration_spmd`).  ``sp`` is the process group of the
    axis, ``n`` its size.  Each rank owns a ``B/n`` batch slice:

        qg  = all_gather(q-slice)            (the paper's "send query
                                              tensors": full-B q per rank)
        part = K2 partial over LOCAL KV      (full B vs this rank's mirror)
        M   = pmax(m)                        (tiny [B, 1, H])
        o_s, l_s = psum_scatter(o·exp(m-M),  ("send back partial results"
                                l·exp(m-M))   addressed to the masters)
        merge with the rank's own new-token partial, finalize

    ``overlap=True`` posts the reduce-scatter asynchronously and computes
    the new-token partial meanwhile; ``overlap=False`` waits first.
    q / k_new / v_new: this rank's slice [B/n, 1, ...]; query_pos_full [B]
    (every rank masks the full-B partial); the paged operands are this
    rank's mirror view.  Returns the rank's finalized slice [B/n, 1, H, D]
    f32."""
    import torch.distributed as dist

    from repro_torch.kernels import ops

    ops.dispatch_counts["paged_decode_sharded"] += 1
    b_l = q.shape[0]
    r = dist.get_rank(sp)
    qg = ops.all_gather(q, sp, axis=0)  # [B, 1, H, D]
    part = ops.paged_decode_partial(
        qg, k_pages, v_pages, table, lengths, page_pos,
        query_pos=query_pos_full, window=window, softcap=softcap,
    )
    m_g = ops.pmax(part.m, sp)
    w = _lse_weights(part, m_g)
    red = ops.psum_scatter((part.o * w[..., None], part.l * w), sp,
                           scatter_dimension=0, async_op=overlap)
    m_s = m_g[r * b_l:(r + 1) * b_l]
    if not overlap:
        o_s, l_s = red
    p_new = A.partial_attention(q, k_new, v_new, None, softcap=softcap)
    if overlap:
        o_s, l_s = red.wait()
    merged = A.merge_partial(A.Partial(o_s, m_s, l_s), p_new)
    return A.finalize_partial(merged)


def paged_decode_iteration_spmd(mesh, model, impl, params, toks,
                                n_cached_full, k_pages, v_pages, table,
                                lengths, page_pos, route, *,
                                sp_axis: str = "data",
                                overlap: bool = True):
    """The WHOLE batch-sharded decode iteration, per rank: embed, QKV, FFN,
    norms, unembed and greedy sampling run on this rank's ``B/n`` batch
    slice; only the per-layer attention boundary
    (`paged_decode_attn_sharded`, armed through ``impl``) and the final
    exchanges are collectives:

      * sampling: each rank argmaxes its OWN logits slice
        (`model.decode_sampled`, equal to the engine's host
        `_sample_token`) and the ids are all-gathered, so every rank sees
        the full next-token vector;
      * per-master KV routing: the step's new per-layer KV rows are
        all-gathered over the batch axis and the rows of the requests each
        master owns are taken in ``route`` order (master-major).

    toks [B] and n_cached_full [B] (B % n == 0, bucket-padded) and
    route [n, R] (R = bucketed max requests per master; padding points at
    row 0) are the same on every rank — each rank slices its own rows;
    k_pages / v_pages [L, n_pages, P, KVH, D], table [B, max_pages],
    lengths [B], page_pos [n_pages, P] (window only) are this rank's mirror
    view.  Returns (sampled ids [B] int32, k_routed, v_routed
    [L, n*R, 1, KVH, D]), the same on every rank."""
    from repro_torch.core.paged_decode import SpmdPagedShards
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_info
    from repro_torch.models.transformer import Cache

    n, r, group = axis_info(mesh, sp_axis)
    bb = int(toks.shape[0])
    assert bb % n == 0, (bb, n)
    b_l = bb // n
    ops.dispatch_counts["decode_iteration_spmd"] += 1
    rows = slice(r * b_l, (r + 1) * b_l)
    shards = SpmdPagedShards(k_pages, v_pages, table, lengths, page_pos)
    impl.begin_step(shards, axis_name=group, n_ranks=n,
                    query_pos=n_cached_full, overlap=overlap)
    try:
        nxt, _, kvs = model.decode_sampled(
            params, toks[rows], Cache(length=n_cached_full[rows])
        )
    finally:
        impl.end_step()
    nxt_all = ops.all_gather(nxt, group, axis=0)  # [B] tiny ids
    k_all, v_all = ops.all_gather((kvs[0], kvs[1]), group, axis=1)
    idx = route.reshape(-1).long()
    return nxt_all, k_all.index_select(1, idx), v_all.index_select(1, idx)


def unified_iteration_spmd(mesh, model, impl, params, toks, positions,
                           seq_offsets, last_idx, k_pages, v_pages, table,
                           lengths, page_pos, *, sp_axis: str = "data",
                           double_buffer: bool = True):
    """A whole UNIFIED engine iteration across the ranks of ``mesh``'s
    ``sp_axis``: a bounded chunk of every admitted prompt's prefill tokens
    AND all in-flight decode tokens packed on one ragged token axis,
    STRIPED over the ranks.  Each rank runs the full stack on its stripe;
    at every layer the armed `core.unified.UnifiedAttnImpl` runs both
    planes (`UnifiedAttnImpl._attn_axis`): the prefix plane (all_gather of
    the q stripes, K2 over the rank's own pool plane with per-token tables,
    pmax + psum_scatter back to the stripes) and the chunk plane (the
    striped KV ring folded into the prefix carry with K3).

    Epilogue: the final hidden stripes are all-gathered, each segment's
    sampling row is unembedded and greedily argmaxed (equal to the
    engine's host `_sample_token`).  As in the reference, logits never
    leave the step, so there is no host NaN guard on this path.

    toks [T] and positions [T] in STRIPED order (T % n == 0; rank r's stripe
    is block r), seq_offsets [S+1] the GLOBAL packed offsets (numpy),
    last_idx [S] striped-coordinate sampling rows — all the same on every
    rank; k_pages / v_pages [L, n_pages, P, KVH, D], table [T, max_pages],
    lengths [T] (per token, striped order), page_pos [n_pages, P] (window
    only): this rank's pool plane.  Returns (ids [S] int32, the same on
    every rank; k_stripe, v_stripe [L, T/n, KVH, D]: this rank's packed
    KV)."""
    from repro_torch.core.unified import UnifiedShard
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_info

    n, r, group = axis_info(mesh, sp_axis)
    t = int(toks.shape[0])
    assert t % n == 0, (t, n)
    t_l = t // n
    ops.dispatch_counts["unified_iteration_spmd"] += 1
    mine = slice(r * t_l, (r + 1) * t_l)
    shard = UnifiedShard(k_pages, v_pages, page_pos, table, lengths)
    impl.begin_step(seq_offsets, positions, shards=[shard], axis_name=group,
                    n_ranks=n, double_buffer=double_buffer)
    try:
        x, kv = model.prefill_packed_hidden(
            params, {"tokens": toks[mine][None]}, positions[mine]
        )
    finally:
        impl.end_step()
    xg = ops.all_gather(x[0], group, axis=0)  # [T, d]
    sel = xg.index_select(0, last_idx.long())
    logits = model.unembed(params, sel[None])[0]  # [S, V]
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return ids, kv[0], kv[1]
