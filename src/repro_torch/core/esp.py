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
`launch.mesh.SubMesh`.

The model-level half — `ESPAttnImpl` (the striped ring through the
layers' attention, multi-master decode with its LSE merge, the recurrent
layers' handoff through `core.ssm_sp`) and `ShardedAttnImpl` (the mesh
train step's attention) — runs on a `DeviceMesh` over the model's DTensors:
each `shard_map` body of the reference is a `launch.mesh.shmap`
(`local_map`) body here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import striped
from repro_torch.models import attention as A
from repro_torch.models.transformer import DefaultAttnImpl


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
        (`model.decode_sampled`, equal to the local executor's
        `greedy_ids`) and the ids are all-gathered, so every rank sees
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
    local executor's `greedy_ids`).  As in the reference, there is no
    value guard on this path.

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


# ====================================================== the model-level ESP


def _slice_kv_heads(k, v, tp_idx: int, h_local: int, q_per_kv: int):
    """Select the KV heads a rank's q-head block needs when KV is replicated
    across tp. Requires blocks not to straddle KV groups (q_per_kv % h_local
    == 0 or h_local % q_per_kv == 0) — true for every assigned arch."""
    if h_local >= q_per_kv:
        n_loc = h_local // q_per_kv
        start = tp_idx * n_loc
    else:
        n_loc = 1
        start = (tp_idx * h_local) // q_per_kv
    return k[:, :, start:start + n_loc], v[:, :, start:start + n_loc]


def _local_rank(mesh, axis: Optional[str]) -> int:
    return int(mesh.get_local_rank(axis)) if axis else 0


class ESPAttnImpl(DefaultAttnImpl):
    """The model-level half of ESP on a `DeviceMesh` ("data" = the ESP
    sequence axis ``sp``, "model" = tensor parallelism ``tp``): the port of
    the reference's `ESPAttnImpl`, whose `shard_map` bodies become
    `launch.mesh.shmap` (`local_map`) bodies over the model's DTensors.

      * prefill: the striped ring over ``sp`` (or over DoP sub-rings of
        it): at each step one `ops.attention_partial` (K4 with its LSE)
        against the KV stripe held, merged in f32, and the stripe passed on
        with `ops.ring_ppermute` (posted before the partial, waited on
        after).  Heads mode shards q heads (and KV heads when divisible,
        else each rank slices the KV heads its block needs) over ``tp``;
        batch mode shards the batch over ``tp``.  ``ring_slice_tp`` (the
        reference's §Perf A2) forwards 1/g of a stripe replicated over a
        de-dup group of g tp ranks and all-gathers it after the leg.
      * decode: multi-master (batch over ``sp``: all_gather of q, K5 over
        the local KV shard, `pmax` + `psum_scatter` back to the masters) or
        single master (`psum`); mode 1 shards KV heads over ``tp`` and the
        sequence over ``sp``, mode 2 the sequence over ``sp`` x ``tp``
        (shard ``lin = sp_rank * n_tp + tp_rank``, then a `psum` over tp).
        The new token's one-key partial stays plain, as in
        `DefaultAttnImpl`.
      * ssm_scan: the sequence-parallel recurrent layers (`core.ssm_sp`).

    At ``n_sp == 1`` each method runs `DefaultAttnImpl`'s (K4 / K5) inside
    a `local_map` with the same tp layout.  The process groups (the whole
    ``sp`` axis or its DoP sub-rings, tp, sp x tp, A2's de-dup groups) are
    created here, collectively: every rank builds the impl in the same
    order.  The reference's ``interpret`` flag has no counterpart."""

    def __init__(self, mesh, cfg, *, sp_axis: str = "data",
                 tp_axis: Optional[str] = "model", dop: Optional[int] = None,
                 force_batch_mode: bool = False, ring_slice_tp: bool = False):
        from repro_torch.launch.mesh import axis_groups, axis_size

        self.mesh = mesh
        self.cfg = cfg
        self.sp = sp_axis
        names = tuple(mesh.mesh_dim_names)
        self.tp = tp_axis if (tp_axis and tp_axis in names) else None
        self.n_sp = axis_size(mesh, sp_axis)
        self.n_tp = axis_size(mesh, self.tp) if self.tp else 1
        self.dop = dop or self.n_sp
        assert self.n_sp % self.dop == 0
        # prefill head sharding mode. Hybrid/ssm archs force batch mode so
        # attention sharding matches the recurrent layers' (batch-over-tp)
        # activation layout with no per-layer reshard.
        self.heads_mode = (
            not force_batch_mode
            and (self.n_tp == 1 or cfg.n_heads % self.n_tp == 0)
        )
        self.kv_div = cfg.n_kv_heads % self.n_tp == 0 if self.n_tp > 1 else True
        # decode KV sharding mode (mode1: heads over tp; mode2: seq over both)
        self.decode_heads_mode = (
            not force_batch_mode
            and (self.n_tp == 1
                 or (cfg.n_kv_heads % self.n_tp == 0
                     and cfg.n_heads % self.n_tp == 0))
        )
        self.ring_slice_tp = ring_slice_tp
        self.sp_rank = _local_rank(mesh, sp_axis)
        self.tp_rank = _local_rank(mesh, self.tp)
        # prefill geometry (static in cfg and the mesh)
        tp = self.tp
        self.h_local = (cfg.n_heads // self.n_tp if (self.heads_mode and tp)
                        else cfg.n_heads)
        self.slice_kv = bool(self.heads_mode and tp and not self.kv_div)
        slice_ring = bool(self.ring_slice_tp and tp and self.n_tp > 1
                          and (not self.kv_div or not self.heads_mode))
        # ranks holding IDENTICAL kv tensors form the de-dup group: all tp
        # ranks in batch mode; the q_per_kv/h_local block in heads mode
        if slice_ring and self.heads_mode and self.slice_kv:
            self.ring_group = max(cfg.q_per_kv // self.h_local, 1)
        else:
            self.ring_group = self.n_tp
        self.slice_ring = slice_ring and self.ring_group >= 2
        # process groups, created collectively once
        self.sp_group = mesh.get_group(sp_axis)
        self.ring = axis_groups(mesh, (sp_axis,), block=self.dop)
        self.tp_group = mesh.get_group(tp) if tp else None
        self.sptp_group = (axis_groups(mesh, (sp_axis, tp))
                           if tp and self.n_tp > 1 else self.sp_group)
        self.ag_group = (axis_groups(mesh, (tp,), block=self.ring_group)
                         if self.slice_ring else None)

    def _shmap(self, body, in_specs, out_specs):
        from repro_torch.launch.mesh import shmap

        return shmap(body, self.mesh, in_specs, out_specs)

    # ---------------------------------------------------------------- prefill
    def _prefill_specs(self, b: int):
        from repro_torch.launch.sharding import P

        sp, tp = self.sp, self.tp
        if self.heads_mode:
            q_spec = P(None, sp, tp, None)
            kv_spec = P(None, sp, tp if (tp and self.kv_div) else None, None)
        else:  # batch mode: batch over tp (replicated if not divisible)
            btp = tp if (tp and b % self.n_tp == 0) else None
            q_spec = P(btp, sp, None, None)
            kv_spec = P(btp, sp, None, None)
        return q_spec, kv_spec, P(sp)

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        """q [B,S,H,D] in the (striped) layout matching q_pos; S shards over
        sp as the stripes. Returns [B,S,H,D]."""
        from repro_torch.kernels import ops

        q_spec, kv_spec, pos_spec = self._prefill_specs(q.shape[0])
        q_pos = _positions(q_pos, q.shape[1], q)
        k_pos = _positions(k_pos, k.shape[1], q)
        kw = dict(causal=causal, window=window, softcap=softcap)
        slice_kv, tp_rank = self.slice_kv, self.tp_rank
        h_local, q_per_kv = self.h_local, self.cfg.q_per_kv
        if self.n_sp == 1:
            def local(qb, kb, vb, qp, kp):
                if slice_kv:
                    kb, vb = _slice_kv_heads(kb, vb, tp_rank, h_local, q_per_kv)
                return DefaultAttnImpl.prefill_attn(self, qb, kb, vb, qp, kp, **kw)

            return self._shmap(local, (q_spec, kv_spec, kv_spec, pos_spec,
                                       pos_spec), q_spec)(q, k, v, q_pos, k_pos)
        ring_len, ring = self.dop, self.ring
        ring_group, ag_group = self.ring_group, self.ag_group
        # batch mode with the batch split over tp: the tp ranks hold
        # different KV rows, so there is no de-dup group to slice the ring
        # over (the reference slices all the same and attends to the wrong
        # rows); the full stripe travels instead
        slice_ring = self.slice_ring and not (
            not self.heads_mode and q_spec[0] is not None)

        def body(qb, kb, vb, qp, kp):
            if slice_kv:
                kb, vb = _slice_kv_heads(kb, vb, tp_rank, h_local, q_per_kv)
            acc = None
            kk, vv, kv_pos = kb.contiguous(), vb.contiguous(), kp.contiguous()
            s_l = kb.shape[1]
            for step in range(ring_len):
                last = step == ring_len - 1
                if not last:
                    if slice_ring:
                        # A2 slice-ring: each rank of the de-dup group
                        # forwards only its 1/g token slice; receivers
                        # re-gather within the group.
                        per = s_l // ring_group
                        t0 = (tp_rank % ring_group) * per
                        nxt = ops.ring_ppermute(
                            (kk[:, t0:t0 + per], vv[:, t0:t0 + per], kv_pos),
                            ring, async_op=True)
                    else:
                        nxt = ops.ring_ppermute((kk, vv, kv_pos), ring,
                                                async_op=True)
                part = ops.attention_partial(qb, kk, vv, qp, kv_pos, **kw)
                acc = part if acc is None else A.merge_partial(acc, part)
                if not last:
                    kk, vv, kv_pos = nxt.wait()
                    if slice_ring:
                        kk, vv = ops.all_gather((kk, vv), ag_group, axis=1)
            return A.finalize_partial(acc).to(qb.dtype)

        return self._shmap(body, (q_spec, kv_spec, kv_spec, pos_spec, pos_spec),
                           q_spec)(q, k, v, q_pos, k_pos)

    # ---------------------------------------------------------------- decode
    def decode_attn(self, q, k_cache, v_cache, k_new, v_new, cache_len, *,
                    window, softcap):
        """Multi-master distributed decode (LoongServe §4.2).

        q [B,1,H,D]; caches [B,S,KVH,D] sharded over sp (and tp in mode2) on
        the sequence dim; k_new/v_new [B,1,KVH,D] live with the masters."""
        from repro_torch.kernels import ops
        from repro_torch.launch.sharding import P

        n_sp, tp, sp = self.n_sp, self.tp, self.sp
        b = q.shape[0]
        cl = _positions(cache_len, b, q)
        if n_sp == 1 and self.n_tp == 1:
            def local(qb, kb, vb, knb, vnb, clb):
                return DefaultAttnImpl.decode_attn(
                    self, qb, kb, vb, knb, vnb, clb, window=window,
                    softcap=softcap)

            rep = P(None, None, None, None)
            return self._shmap(local, (rep, rep, rep, rep, rep, P(None)),
                               rep)(q, k_cache, v_cache, k_new, v_new, cl)
        multi_master = b % n_sp == 0 and b >= n_sp
        heads_mode = self.decode_heads_mode
        h_local = (self.cfg.n_heads // self.n_tp if (heads_mode and tp)
                   else self.cfg.n_heads)
        n_tp, sp_rank, tp_rank = self.n_tp, self.sp_rank, self.tp_rank
        lin = sp_rank if heads_mode else sp_rank * n_tp + tp_rank
        merge_group = self.sp_group if heads_mode else self.sptp_group
        slice_new = heads_mode and tp and not self.kv_div

        def body(qb, kb, vb, knb, vnb, clb):
            s_l = kb.shape[1]
            # --- gather queries from masters (the q broadcast) ---
            qg = (ops.all_gather(qb, self.sp_group, axis=0) if multi_master
                  else qb)
            part = ops.decode_partial(qg, kb, vb, clb, k_pos_offset=lin * s_l,
                                      window=window, softcap=softcap)
            # --- LSE-weighted combine across KV shards ---
            m_g = ops.pmax(part.m, merge_group)
            w = _lse_weights(part, m_g)
            o_w, l_w = part.o * w[..., None], part.l * w
            if not heads_mode and tp:
                o_w, l_w = ops.psum((o_w, l_w), self.tp_group)
            if multi_master:
                # reduce-scatter back to masters (batch shards over sp)
                o_s, l_s = ops.psum_scatter((o_w, l_w), self.sp_group)
                b_l = b // n_sp
                m_s = m_g[sp_rank * b_l:(sp_rank + 1) * b_l]
            else:
                o_s, l_s = ops.psum((o_w, l_w), self.sp_group)
                m_s = m_g
            # --- merge the master-local new-token partial ---
            if slice_new:
                knb, vnb = _slice_kv_heads(knb, vnb, tp_rank, h_local,
                                           self.cfg.q_per_kv)
            p_new = A.partial_attention(qb, knb, vnb, None, softcap=softcap)
            merged = A.merge_partial(A.Partial(o_s, m_s, l_s), p_new)
            return A.finalize_partial(merged).to(qb.dtype)

        bspec = sp if multi_master else None
        if heads_mode:
            q_spec = P(bspec, None, tp, None)
            kv_spec = P(None, sp, tp, None)
            new_spec = P(bspec, None, tp if self.kv_div else None, None)
        else:
            q_spec = P(bspec, None, None, None)
            kv_spec = P(None, (sp, tp) if tp else sp, None, None)
            new_spec = P(bspec, None, None, None)
        return self._shmap(
            body, (q_spec, kv_spec, kv_spec, new_spec, new_spec, P(None)),
            q_spec)(q, k_cache, v_cache, k_new, v_new, cl)

    # ------------------------------------------------------------ recurrent
    def ssm_scan(self, kind, p, x, cfg, state):
        """Sequence-parallel recurrent layers (hybrid/ssm archs).

        Mamba2/mLSTM use the 3-phase chunk-state handoff (local state-only
        fold -> log-step exclusive device scan -> local pass with the true
        incoming state). sLSTM is inherently sequential (xLSTM paper §2.3):
        we all-gather its input and scan redundantly, slicing the local part.
        These run on the *contiguous* (non-striped) layout; see
        DESIGN.md §Arch-applicability.  At ``n_sp == 1`` the layer runs
        whole per rank, the batch over tp when it divides."""
        from repro_torch.core import ssm_sp

        if self.n_sp == 1:
            return ssm_sp.recurrent_local(self.mesh, kind, p, x, cfg, state,
                                          tp=self.tp)
        fns = {
            "mamba": ssm_sp.mamba2_forward_sp,
            "mlstm": ssm_sp.mlstm_forward_sp,
            "slstm": ssm_sp.slstm_forward_sp,
        }
        return fns[kind](self.mesh, self.sp, p, x, cfg, state, tp=self.tp)


def _positions(pos, n: int, like):
    """Positions / lengths broadcast to [n] (a DTensor stays one)."""
    from torch.distributed.tensor import DTensor

    if isinstance(pos, DTensor):
        return pos if tuple(pos.shape) == (n,) else pos.expand(n)
    return torch.as_tensor(pos, device=like.device).expand(n)


class ShardedAttnImpl(DefaultAttnImpl):
    """The default attention on a mesh without ESP (the mesh train step's):
    K4 runs per shard inside a `local_map` with the layout the train
    constraint gives q / kv / attn_out — heads over "model" (KV heads too
    when divisible, else each rank slices the KV heads its q-head block
    needs and the KV gradient is partial over "model"), batch over the
    batch axes; batch mode puts the batch over (pod, data, model).  The
    recurrent layers run whole per rank on the batch shard (their weights
    replicated, their gradients partial over the batch axes).  `local_map`
    is differentiable, so K4's backward runs per shard."""

    def __init__(self, mesh, cfg):
        from repro_torch.launch import sharding as shlib

        self.mesh = mesh
        self.cfg = cfg
        self.heads_mode = shlib.heads_mode(cfg, mesh)
        self.kv_div = shlib.kv_div(cfg, mesh)
        names = tuple(mesh.mesh_dim_names)
        self.tp = "model" if "model" in names else None
        self.n_tp = shlib.tp_size(mesh)
        self.tp_rank = _local_rank(mesh, self.tp)

    def _grad_partial(self, spec, over):
        """Placements of a gradient: the spec's shards, Partial on the mesh
        dims named in ``over``."""
        from torch.distributed.tensor import Partial as PartialPl
        from repro_torch.launch.sharding import placements

        names = tuple(self.mesh.mesh_dim_names)
        pl = placements(self.mesh, spec, len(spec))
        return tuple(PartialPl() if names[i] in over else p
                     for i, p in enumerate(pl))

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        from repro_torch.launch import sharding as shlib
        from repro_torch.launch.mesh import shmap
        from repro_torch.launch.sharding import P

        b = q.shape[0]
        kw = dict(causal=causal, window=window, softcap=softcap)
        grad = None
        slice_kv = False
        if self.heads_mode:
            ba = shlib.batch_axes(self.mesh, b)
            q_spec = P(ba, None, self.tp, None)
            kv_spec = P(ba, None, self.tp if self.kv_div else None, None)
            slice_kv = bool(self.tp and not self.kv_div)
            if slice_kv:
                g = self._grad_partial(kv_spec, (self.tp,))
                grad = (None, g, g, None, None)
        else:
            ba = shlib.batch_axes(self.mesh, b, extra_model=True)
            q_spec = kv_spec = P(ba, None, None, None)
        h_local = self.cfg.n_heads // self.n_tp if self.heads_mode else self.cfg.n_heads
        tp_rank, q_per_kv = self.tp_rank, self.cfg.q_per_kv

        def local(qb, kb, vb, qp, kp):
            if slice_kv:
                kb, vb = _slice_kv_heads(kb, vb, tp_rank, h_local, q_per_kv)
            return DefaultAttnImpl.prefill_attn(self, qb, kb, vb, qp, kp, **kw)

        q_pos = _positions(q_pos, q.shape[1], q)
        k_pos = _positions(k_pos, k.shape[1], q)
        return shmap(local, self.mesh,
                     (q_spec, kv_spec, kv_spec, P(None), P(None)), q_spec,
                     in_grad_specs=grad)(q, k, v, q_pos, k_pos)

    def ssm_scan(self, kind, p, x, cfg, state):
        from repro_torch.core import ssm_sp

        return ssm_sp.recurrent_local(self.mesh, kind, p, x, cfg, state,
                                      batch_only=True)
