"""The compute executor: every real-mode kernel-dispatch body, behind one
seam (the port of `repro/engine/executor.py`'s `LocalExecutor`).

`engine/server.py` owns the control plane — clock, events, scheduling,
request lifecycle, pool *accounting*; the executor owns the compute plane:
how a scheduled PrefillBatch / DecodeBatch turns into model steps, kernel
launches and KV writes, on the engine's device:

  * ONE packed model step per prefill batch: one K1 launch per layer at
    DoP=1; DoP>1 groups replay the striped ring in process, one K3 launch
    per instance per ring step;
  * batched paged decode: one K2 launch per instance per layer over the
    pool mirrors in place, partials LSE-merged multi-master style;
  * per-request serial prefill and decode for the families the packed and
    paged impls do not cover (moe: capacity dropping depends on the batch;
    hybrid and ssm: recurrent state), through the model's default
    attention — one K4 launch per attention layer per prefill, one K5
    launch per attention layer per decode step (none for the
    attention-free ssm family, which has no KV).  The recurrent state stays
    on the device in ``engine._real_cache`` between steps.

  * the unified chunked step (``ManagerConfig(prefill_chunk_tokens=...)``,
    and every salvage recovery chain): a bounded chunk of each admitted
    prompt and every in-flight decode token share ONE packed model step;
    per layer, one K2 launch per instance reads the requests' filled
    prefixes through per-token block tables and one K3 launch folds the
    chunk into them (`core.unified`).

PyTorch runs eagerly, so the reference's jitted-program LRU has no
counterpart; the padding buckets stay so that padded shapes and striping
(``T % dop == 0``) match the reference exactly.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class _USeg(NamedTuple):
    """One segment of a unified iteration's packed token axis."""

    r: Any  # the Request
    decode: bool  # decode row (ln == 1) vs prefill chunk
    start: int  # first global position this iteration
    ln: int  # token count this iteration
    limit: int  # filled-prefix length: positions < limit are in the pool
    final: bool  # sample a token from this segment's last row


def _token_span(r, start: int, ln: int) -> np.ndarray:
    """Token ids at positions [start, start+ln): prompt ids below
    `input_len`, generated tokens above (token at position p >= input_len
    is output_tokens[p - input_len] — what a decode-resume recovery hole
    re-feeds when the lost stripe covers generated positions)."""
    end = start + ln
    out = list(r.prompt[start:min(end, r.input_len)])
    if end > r.input_len:
        lo = max(start, r.input_len) - r.input_len
        out += list(r.output_tokens[lo:end - r.input_len])
    return np.asarray(out, np.int64)


class LocalExecutor:
    """In-process executor: one device, ring replayed as a chunk schedule."""

    def __init__(self, engine):
        self.eng = engine
        self.device = engine.device
        self._paged_impl = None
        self._packed_prefill_impl = None
        self._unified_impl = None
        if engine.cfg.family in ("dense", "vlm"):
            from repro_torch.core.paged_decode import PagedDecodeAttnImpl
            from repro_torch.core.paged_prefill import PackedPrefillAttnImpl
            from repro_torch.core.unified import UnifiedAttnImpl
            from repro_torch.models.transformer import DefaultAttnImpl

            if type(getattr(engine.model, "attn_impl", None)) is DefaultAttnImpl:
                self._paged_impl = PagedDecodeAttnImpl()
                self._packed_prefill_impl = PackedPrefillAttnImpl()
                self._unified_impl = UnifiedAttnImpl()
        self._bind_pool_devices()

    def _bind_pool_devices(self) -> None:
        """Pin every pool's mirror to the engine's device (also called by
        the engine after a join grows the pool registry)."""
        for pool in self.eng.pool.pools:
            pool.bind_device(self.device)

    @property
    def _prefill_programs(self) -> Dict:
        """Compiled-program cache probe of the reference: eager PyTorch
        compiles nothing, so it is always empty."""
        return {}

    def on_instance_failed(self, inst: int) -> None:
        """Failure notification from the engine; the executor holds no
        per-instance state."""

    # ------------------------------------------------------------ NaN guard
    def _guard_logits(self, r, row):
        """Value guard on one request's logits row (numpy): a NaN/inf row
        quarantines ONLY that request instead of finishing it with a garbage
        argmax.  Chaos injection (`_logit_poison`) overwrites the row BEFORE
        the finite check.  Returns the row, or None when quarantined."""
        eng = self.eng
        if r.rid in eng._logit_poison:
            eng._logit_poison.discard(r.rid)
            row = np.full_like(row, np.nan)
        if not np.isfinite(row).all():
            eng._quarantine.add(r.rid)
            return None
        return row

    # ------------------------------------------------------------- buckets
    @staticmethod
    def _bucket(n: int, lo: int = 16) -> int:
        """Power-of-two padding bucket (same formula as the pool's)."""
        from repro_torch.kvcache.pool import _pad_bucket

        return max(lo, _pad_bucket(n))

    @classmethod
    def _token_bucket(cls, n: int, lo: int = 16) -> int:
        """Packed-token-axis bucket: powers of two plus their 3/4 points
        (16, 24, 32, 48, 64, ...)."""
        b = cls._bucket(n, lo)
        mid = (b * 3) // 4
        return mid if (n <= mid and mid >= lo) else b

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------- prefill
    def prefill(self, batch) -> None:
        """Dispatch one prefill batch: packed fast path when armed and every
        prompt is materialized, per-request serial otherwise.  Requests whose
        reserved placement sits on a failed instance are pruned and requeued
        for recompute; the rest of the batch keeps the packed path."""
        eng = self.eng
        lost = [r for r in batch.requests if eng._placement_lost(batch, r)]
        if lost:
            batch.requests = [r for r in batch.requests if r not in lost]
            batch.instances = [i for i in batch.instances if i not in eng.failed]
            for r in lost:
                eng.pool.free_request(r.rid)
                eng._requeue_for_recompute(r)
                if r not in eng.pending:
                    eng.pending.append(r)
            if not batch.requests:
                return
        if self._packed_prefill_impl is not None and all(
            r.prompt is not None and len(r.prompt) == r.input_len
            for r in batch.requests
        ):
            return self.prefill_packed(batch)
        return self.prefill_serial(batch)

    def prefill_packed(self, batch) -> None:
        """One packed model step for the WHOLE prefill batch: prompts are
        concatenated on a single bucketed token axis, attention is
        segment-masked by one ragged kernel launch per layer (DoP>1 groups:
        one ring-chunk launch per instance per ring step), first tokens are
        sampled from the packed logits, and the per-layer KV output is
        scattered straight into each instance's pool mirror at the slots the
        scheduler reserved (`pool.fill_packed` write-through)."""
        eng = self.eng
        reqs = batch.requests
        lens = [len(r.prompt) for r in reqs]
        total = sum(lens)
        # ring degree = the alive ESP group; the token bucket is a bucketed
        # SHARD length x dop so the striped shards stay aligned
        dop = max(len([i for i in batch.instances if i not in eng.failed]), 1)
        tb = self._token_bucket(-(-total // dop)) * dop
        bb = self._bucket(len(reqs), lo=1)
        tokens = np.zeros(tb, np.int64)
        positions = np.zeros(tb, np.int64)
        offsets = np.full(bb + 1, total, np.int32)
        offsets[0] = 0
        last_idx = np.zeros(bb, np.int64)
        c = 0
        for b, r in enumerate(reqs):
            n = lens[b]
            tokens[c:c + n] = np.asarray(r.prompt, np.int64)
            positions[c:c + n] = np.arange(n)
            c += n
            offsets[b + 1] = c
            last_idx[b] = c - 1
        impl = self._packed_prefill_impl
        prev_impl = eng.model.attn_impl
        eng.model.attn_impl = impl
        impl.begin_step(offsets, dop=dop)
        try:
            logits, (k_packed, v_packed) = eng.model.prefill_packed(
                eng.params, {"tokens": self._to_dev(tokens)[None]},
                self._to_dev(positions), self._to_dev(last_idx),
            )
        finally:
            impl.end_step()
            eng.model.attn_impl = prev_impl
        logits = logits.cpu().numpy()
        for b, r in enumerate(reqs):
            row = self._guard_logits(r, logits[b])
            if row is None:
                continue  # quarantined: no first token, engine requeues
            r.output_tokens.append(eng._sample_token(row))
        if not eng.pool.pools[0].store_values:
            return
        # direct-to-pool paged KV writes: per instance, gather the packed
        # columns this instance retains (placement from batch.placement —
        # ESP scale-down stays zero-migration) and write-through into its
        # mirror at the reserved block-table slots
        starts = np.concatenate([[0], np.cumsum(lens)])
        per_inst: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
        for b, r in enumerate(reqs):
            for inst, pos_list in batch.placement.get(r.rid, {}).items():
                if not pos_list or inst in eng.failed:
                    continue
                p = np.asarray(pos_list, np.int64)
                cols, slots = per_inst.setdefault(inst, ([], []))
                cols.append(starts[b] + p)
                slots.append(eng.pool.pools[inst].slots_for(r.rid, p))
        for inst, (cols, slots) in per_inst.items():
            cidx = self._to_dev(np.concatenate(cols))
            eng.pool.pools[inst].fill_packed(
                np.concatenate(slots),
                k_packed.index_select(1, cidx),
                v_packed.index_select(1, cidx),
            )

    def prefill_serial(self, batch) -> None:
        """Per-request prefill (recurrent/hybrid state, moe capacity, or a
        custom attention impl)."""
        from repro_torch.kernels import ops

        eng = self.eng
        for r in batch.requests:
            # dispatch-counted so tests can assert the packed paths (incl.
            # DoP>1 ring fusion) never fall back to serial prefill
            ops.dispatch_counts["prefill_serial_model"] += 1
            toks = self._to_dev(np.asarray(r.prompt, np.int64)[None])
            logits, cache = eng.model.prefill(eng.params, {"tokens": toks})
            row = self._guard_logits(r, logits[0, -1].cpu().numpy())
            if row is None:
                continue  # quarantined: no first token, engine requeues
            r.output_tokens.append(eng._sample_token(row))
            if cache.k is not None:  # the ssm family has no KV
                k = cache.k[:, 0].float().cpu().numpy()  # [L, T, KVH, D]
                v = cache.v[:, 0].float().cpu().numpy()
                for inst, positions in batch.placement[r.rid].items():
                    if positions and inst not in eng.failed:
                        eng.pool.pools[inst].fill(
                            r.rid, positions, k[:, positions], v[:, positions]
                        )
            if cache.ssm is not None:
                eng._real_cache[r.rid] = cache.ssm  # stays on the device

    # -------------------------------------------------------------- decode
    def decode(self, g) -> None:
        if self._paged_impl is not None and self.eng.pool.pools[0].store_values:
            return self.decode_paged(g)
        return self.decode_serial(g)

    def decode_paged(self, g) -> None:
        """Gather-free batched decode: ONE model step for the whole group;
        per layer, one paged-kernel launch per instance over the pool mirror
        in place (block tables), partials LSE-merged multi-master style."""
        from repro_torch.core.paged_decode import PagedShard
        from repro_torch.models.transformer import Cache

        eng = self.eng
        rids = [r.rid for r in g.requests]
        n_cached = np.array([r.seq_len - 1 for r in g.requests], np.int32)
        shards, covered = [], np.zeros(len(rids), np.int64)
        for pool in eng.pool.pools:
            if pool.instance_id in eng.failed:
                continue
            table, lengths = pool.block_table(rids)
            if not lengths.any():
                continue
            covered += lengths
            # incrementally-synced mirror: steady-state decode uploads one
            # slot per request; packed-prefill slots upload 0
            kdev, vdev, posdev = pool.device_paged_kv()
            shards.append(PagedShard(
                k_pages=kdev, v_pages=vdev, table=pool._dev_put(table),
                lengths=pool._dev_put(lengths),
                pos=(posdev if eng.cfg.sliding_window else None),
            ))
        # cache holds tokens 0..seq_len-2; the processed token's KV is
        # produced by this step and appended at the master afterwards
        assert (covered == n_cached).all(), (covered, n_cached)
        toks = self._to_dev(np.asarray([r.output_tokens[-1] for r in g.requests],
                                       np.int64))
        cache = Cache(length=self._to_dev(n_cached))
        prev_impl = eng.model.attn_impl
        eng.model.attn_impl = self._paged_impl
        self._paged_impl.begin_step(shards)
        try:
            logits, _, kvs = eng.model.decode(eng.params, toks, cache)
        finally:
            self._paged_impl.end_step()
            eng.model.attn_impl = prev_impl
        self._emit_decoded(g, logits, kvs)

    def _emit_decoded(self, g, logits, kvs) -> None:
        """Shared batched-decode epilogue: sample one token per request and
        stash the step's new per-layer KV on the host; _on_decode_done fills
        it into the pool once the slot is allocated, and the next decode's
        mirror sync uploads it (device -> host -> device, as the reference
        does).  logits [B, V]; kvs (k, v) each [L, B, 1, KVH, D]."""
        eng = self.eng
        logits = logits.cpu().numpy()
        k_host = kvs[0].float().cpu().numpy() if kvs is not None else None
        v_host = kvs[1].float().cpu().numpy() if kvs is not None else None
        for b, r in enumerate(g.requests):
            row = self._guard_logits(r, logits[b])
            if row is None:
                continue  # quarantined: no token, no KV stash
            r.output_tokens.append(eng._sample_token(row))
            if k_host is not None:
                eng._pending_kv[r.rid] = (k_host[:, b], v_host[:, b])

    def decode_serial(self, g) -> None:
        """Per-request decode over a dense cache gathered from the pools on
        the host and uploaded for the step (the reference's design: every
        step moves the request's whole KV host -> device), with the
        recurrent state passed back in from ``engine._real_cache``."""
        from repro_torch.models.transformer import Cache

        eng = self.eng
        for r in g.requests:
            positions, k, v = eng.pool.gather_request(r.rid)
            # cache holds tokens 0..seq_len-2; the processed token's KV is
            # produced by this step and appended at the master afterwards
            n_cached = r.seq_len - 1
            if k is not None:
                assert len(positions) == n_cached, (len(positions), n_cached)
            dt = eng.model.dtype
            cache = Cache(
                k=self._to_dev(k[:, None]).to(dt) if k is not None else None,
                v=self._to_dev(v[:, None]).to(dt) if v is not None else None,
                length=self._to_dev(np.asarray([n_cached], np.int32)),
                ssm=eng._real_cache.get(r.rid),
            )
            logits, new_cache, kvs = eng.model.decode(
                eng.params, self._to_dev(np.asarray([r.output_tokens[-1]],
                                                    np.int64)), cache
            )
            row = self._guard_logits(r, logits[0].cpu().numpy())
            if row is None:
                continue  # quarantined: no token, no cache/KV update
            r.output_tokens.append(eng._sample_token(row))
            if new_cache.ssm is not None:
                eng._real_cache[r.rid] = new_cache.ssm
            if kvs is not None:
                # stash; _on_decode_done fills it once the slot is allocated
                eng._pending_kv[r.rid] = (
                    kvs[0][:, 0].float().cpu().numpy(),  # [L, 1, KVH, D]
                    kvs[1][:, 0].float().cpu().numpy(),
                )

    # ------------------------------------------------------------- unified
    @property
    def supports_unified(self) -> bool:
        """The fused chunked-prefill+decode iteration needs the packed attn
        impls (dense/vlm family) and real paged KV storage for the prefix
        partials to read from."""
        return (
            self._unified_impl is not None
            and self.eng.pool.pools[0].store_values
        )

    def _unified_segments(self, work) -> List[_USeg]:
        """Packed-axis layout of one unified iteration: every admitted
        prompt's prefill chunk (batch order), then one decode row per
        in-flight request.  A prefill segment's filled prefix is everything
        before its chunk cursor; a decode row's is its whole cache (tokens
        0..seq_len-2 — the processed token's KV is produced by this step)."""
        segs: List[_USeg] = []
        recovering = self.eng._recovering
        for r in work.batch.requests:
            if r.rid not in work.chunks:
                continue  # out of chunk budget this iteration
            start, ln = work.chunks[r.rid]
            # a decode-resume recovery hole may cover generated positions
            # (up to seq_len - 2), not just the prompt
            hi = max(r.input_len, r.seq_len - 1)
            assert ln > 0 and start + ln <= hi, (start, ln, r.input_len, hi)
            rec = recovering.get(r.rid)
            # hole chunks of a decode-resume recovery NEVER sample: the
            # request's tokens already exist — it re-enters decode at its
            # cursor once coverage is whole (a hole ending exactly at
            # input_len must not re-emit the first generated token)
            final = start + ln == r.input_len and (
                rec is None or not rec.resume_decode
            )
            segs.append(_USeg(r, False, start, ln, start, final))
        for g in work.groups:
            for r in g.requests:
                segs.append(_USeg(r, True, r.seq_len - 1, 1, r.seq_len - 1, True))
        return segs

    def _unified_pack(self, segs):
        """Host-side packing: (tokens [tb], positions [tb], offsets [bb+1],
        last_idx [bb]) — exactly `prefill_packed`'s layout, with decode rows
        as length-1 segments carrying their request's last sampled token."""
        total = sum(s.ln for s in segs)
        tb = self._token_bucket(total)
        bb = self._bucket(len(segs), lo=1)
        tokens = np.zeros(tb, np.int64)
        positions = np.zeros(tb, np.int64)
        offsets = np.full(bb + 1, total, np.int32)
        offsets[0] = 0
        last_idx = np.zeros(bb, np.int64)
        c = 0
        for b, s in enumerate(segs):
            if s.decode:
                tokens[c] = s.r.output_tokens[-1]
            else:
                tokens[c:c + s.ln] = _token_span(s.r, s.start, s.ln)
            positions[c:c + s.ln] = np.arange(s.start, s.start + s.ln)
            c += s.ln
            offsets[b + 1] = c
            last_idx[b] = c - 1
        return tokens, positions, offsets, last_idx

    def _unified_count(self, segs) -> None:
        from repro_torch.kernels import ops

        ops.dispatch_counts["unified_step"] += 1
        ops.dispatch_counts["unified_prefill_tokens"] += sum(
            s.ln for s in segs if not s.decode
        )
        ops.dispatch_counts["unified_decode_tokens"] += sum(
            s.ln for s in segs if s.decode
        )

    def _unified_shards(self, segs, tb: int):
        """Per-pool `core.unified.UnifiedShard`s with PER-TOKEN paged prefix
        operands: one `prefix_block_table` row per segment (clipped to the
        filled prefix), expanded to the packed token axis.  Returns
        (shards, covered); covered[b] sums segment b's prefix length over
        every pool and must equal its limit — no filled slot unreachable,
        none double-counted."""
        from repro_torch.core.unified import UnifiedShard

        eng = self.eng
        rids = [s.r.rid for s in segs]
        limits = np.array([s.limit for s in segs], np.int64)
        infos = []
        for pool in eng.pool.pools:
            if pool.instance_id in eng.failed:
                continue
            table, lengths = pool.prefix_block_table(rids, limits)
            if lengths.any():
                infos.append((pool, table, lengths))
        covered = (
            np.sum([lg for _, _, lg in infos], axis=0)
            if infos
            else np.zeros(len(segs), np.int64)
        )
        mpb = self._bucket(
            max((t.shape[1] for _, t, _ in infos), default=1), lo=1
        )
        seg_lens = np.array([s.ln for s in segs], np.int64)
        shards = []
        for pool, table, lengths in infos:
            # row t of the packed axis carries its segment's table row
            tbl_t = np.zeros((tb, mpb), np.int32)
            len_t = np.zeros(tb, np.int32)
            n = int(seg_lens.sum())
            tbl_t[:n, :table.shape[1]] = np.repeat(table, seg_lens, axis=0)
            len_t[:n] = np.repeat(lengths, seg_lens)
            kdev, vdev, posdev = pool.device_paged_kv()
            shards.append(UnifiedShard(
                k_pages=kdev,
                v_pages=vdev,
                page_pos=(posdev if eng.cfg.sliding_window else None),
                table=pool._dev_put(tbl_t),
                lengths=pool._dev_put(len_t),
            ))
        return shards, covered

    def unified(self, work) -> None:
        """ONE packed model step for a whole unified iteration: a bounded
        chunk of each admitted prompt's prefill tokens AND every in-flight
        decode token share one ragged token axis; per layer the chunk
        attention folds on top of the paged prefix partials
        (`core.unified`).  First/next tokens are sampled from the packed
        logits, prefill chunk KV write-throughs at the reserved slots, and
        decode KV is stashed exactly like `decode_paged`."""
        eng = self.eng
        segs = self._unified_segments(work)
        tokens, positions, offsets, last_idx = self._unified_pack(segs)
        shards, covered = self._unified_shards(segs, len(tokens))
        limits = np.array([s.limit for s in segs], np.int64)
        assert (covered == limits).all(), (covered, limits)
        self._unified_count(segs)
        pos_dev = self._to_dev(positions)
        impl = self._unified_impl
        prev_impl = eng.model.attn_impl
        eng.model.attn_impl = impl
        impl.begin_step(self._to_dev(offsets), pos_dev, shards=shards)
        try:
            logits, (k_packed, v_packed) = eng.model.prefill_packed(
                eng.params, {"tokens": self._to_dev(tokens)[None]}, pos_dev,
                self._to_dev(last_idx),
            )
        finally:
            impl.end_step()
            eng.model.attn_impl = prev_impl
        self._unified_emit(work, segs, logits.cpu().numpy(), k_packed, v_packed)

    def _unified_emit(self, work, segs, logits, k_packed, v_packed) -> None:
        """Unified epilogue: ``logits`` [>=S, V] rows pass the NaN guard,
        then greedy sampling.  Prefill chunk KV scatters write-through at
        the chunk's reserved placement slots; decode KV is stashed on the
        host for `_on_unified_done` to fill once the slot is allocated."""
        eng = self.eng
        starts = np.concatenate([[0], np.cumsum([s.ln for s in segs])])
        emitted = set()
        for b, s in enumerate(segs):
            if not s.final:
                continue
            row = self._guard_logits(s.r, logits[b])
            if row is None:
                continue  # quarantined: no token, engine requeues
            s.r.output_tokens.append(eng._sample_token(row))
            emitted.add(s.r.rid)
        if not eng.pool.pools[0].store_values:
            return
        per_inst: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
        dec_cols: List[int] = []
        dec_reqs: List[Any] = []
        for b, s in enumerate(segs):
            if s.decode:
                if s.r.rid in emitted:  # quarantined rows stash no KV
                    dec_cols.append(int(starts[b]))
                    dec_reqs.append(s.r)
                continue
            lo, hi = s.start, s.start + s.ln
            for inst, pos_list in work.batch.placement.get(s.r.rid, {}).items():
                if not pos_list or inst in eng.failed:
                    continue
                p = np.asarray(pos_list, np.int64)
                p = p[(p >= lo) & (p < hi)]
                if not len(p):
                    continue
                cols, slots = per_inst.setdefault(inst, ([], []))
                cols.append(starts[b] + (p - lo))
                slots.append(eng.pool.pools[inst].slots_for(s.r.rid, p))
        for inst, (cols, slots) in per_inst.items():
            cidx = self._to_dev(np.concatenate(cols))
            eng.pool.pools[inst].fill_packed(
                np.concatenate(slots),
                k_packed.index_select(1, cidx),
                v_packed.index_select(1, cidx),
            )
        if dec_cols:
            dc = self._to_dev(np.asarray(dec_cols, np.int64))
            kd = k_packed.index_select(1, dc).float().cpu().numpy()
            vd = v_packed.index_select(1, dc).float().cpu().numpy()
            for j, r in enumerate(dec_reqs):
                eng._pending_kv[r.rid] = (kd[:, j:j + 1], vd[:, j:j + 1])
