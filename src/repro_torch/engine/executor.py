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

`MeshExecutor` runs the same bodies across the processes of a
`torch.distributed` world (NCCL on CUDA, gloo on the CPU): the ring between
the ranks of a DoP>1 group, the multi-master decode merge and the unified
step by collectives (K1-K3 per rank), every rank running the engine in
lockstep.

Each entry (``prefill``, ``decode``, ``unified``) is a span of
`repro_torch.obs` (``executor.<entry>``) with one child per stage:
``executor.plan`` (tables, shards, packing, uploads), ``executor.launch``
(the model call, until it returns on the host), ``executor.wait`` (the
stream drained), ``executor.d2h`` (the copies to the host) and
``executor.sample`` (tokens from the sampled ids, the quarantine and the
KV stash).  The serial paths make one set per request, as they make one
model call each.

Greedy sampling and the value guard run on the device (`greedy_ids`): of
a step's ``[B, V]`` logits only one int32 per row comes to the host.

PyTorch runs eagerly, so the reference's jitted-program LRU has no
counterpart; the padding buckets stay so that padded shapes and striping
(``T % dop == 0``) match the reference exactly.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import obs


class _USeg(NamedTuple):
    """One segment of a unified iteration's packed token axis."""

    r: Any  # the Request
    decode: bool  # decode row (ln == 1) vs prefill chunk
    start: int  # first global position this iteration
    ln: int  # token count this iteration
    limit: int  # filled-prefix length: positions < limit are in the pool
    final: bool  # sample a token from this segment's last row


def greedy_ids(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling and the value guard of logits rows ``[B, V]``, on
    their device: int32 ``[B]``, each row's first maximal index (as
    `np.argmax`), or -1 where the row is not all finite."""
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(torch.isfinite(logits).all(dim=-1), ids, -1)


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

    def on_instance_failed(self, inst: int) -> None:
        """Failure notification from the engine; the executor holds no
        per-instance state."""

    # ------------------------------------------------------------ sampling
    def _sampled(self, logits) -> torch.Tensor:
        """A step's tokens from its logits rows ``[B, V]``: `greedy_ids` on
        the device.  An engine whose per-row sampler ``_sample_token`` is
        replaced gets each row on the host instead, finite rows sampled
        through it (-1 for the others)."""
        from repro_torch.engine.server import BaseServingEngine

        sample = self.eng._sample_token
        if getattr(sample, "__func__", None) is BaseServingEngine._sample_token:
            return greedy_ids(logits)
        (rows,) = self._to_host(logits)
        return torch.tensor([sample(x) if np.isfinite(x).all() else -1
                             for x in rows], dtype=torch.int32)

    def _guard(self, r, tok: int) -> bool:
        """Value guard on one request's sampled id: a row that was not all
        finite (id -1) quarantines ONLY that request instead of finishing
        it with a garbage token.  Chaos injection (`_logit_poison`) counts
        as such a row.  True when the request keeps its token."""
        eng = self.eng
        if r.rid in eng._logit_poison:
            eng._logit_poison.discard(r.rid)
            tok = -1
        if tok < 0:
            eng._quarantine.add(r.rid)
            return False
        return True

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

    @staticmethod
    def _to_host(*tensors) -> List[Any]:
        """A step's outputs as numpy arrays (None stays None): the stream is
        waited for first (``executor.wait``; the copy would wait for it
        anyway), then each tensor is copied (``executor.d2h``, value: the
        bytes that came to the host)."""
        with obs.span("executor.wait"):
            for t in tensors:
                if t is not None and t.is_cuda:
                    torch.cuda.current_stream(t.device).synchronize()
                    break
        with obs.span("executor.d2h") as sp:
            out = [None if t is None else t.cpu().numpy() for t in tensors]
            sp.value = sum(x.nbytes for x in out if x is not None)
        return out

    # ------------------------------------------------------------- prefill
    def prefill(self, batch) -> None:
        """Dispatch one prefill batch: packed fast path when armed and every
        prompt is materialized, per-request serial otherwise.  Requests whose
        reserved placement sits on a failed instance are pruned and requeued
        for recompute; the rest of the batch keeps the packed path."""
        with obs.span("executor.prefill",
                      sum(r.input_len for r in batch.requests)):
            self._prefill(batch)

    def _prefill(self, batch) -> None:
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
        with obs.span("executor.plan"):
            lens, packed = self._pack_prefill(batch)
        logits, k_packed, v_packed = self._prefill_step(*packed)
        self._emit_prefill(batch, lens, self._agree(logits), k_packed,
                           v_packed)

    def _pack_prefill(self, batch):
        """Host-side packing of a prefill batch: (prompt lengths, (dop,
        tokens [tb], positions [tb], offsets [bb+1], last_idx [bb]))."""
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
        return lens, (dop, tokens, positions, offsets, last_idx)

    def _arm_packed_step(self, impl, offsets, dop: int) -> None:
        """Arm the packed attention impl for one step (the mesh executor
        overrides this to hand the impl its ring's sub-mesh)."""
        impl.begin_step(offsets, dop=dop)

    def _prefill_step(self, dop, tokens, positions, offsets, last_idx):
        """The packed model step: (logits [bb, V], k_packed, v_packed
        [L, tb, KVH, D])."""
        eng = self.eng
        impl = self._packed_prefill_impl
        prev_impl = eng.model.attn_impl
        eng.model.attn_impl = impl
        with obs.span("executor.launch"):
            self._arm_packed_step(impl, offsets, dop)
            try:
                logits, (k_packed, v_packed) = eng.model.prefill_packed(
                    eng.params, {"tokens": self._to_dev(tokens)[None]},
                    self._to_dev(positions), self._to_dev(last_idx),
                )
            finally:
                impl.end_step()
                eng.model.attn_impl = prev_impl
        return logits, k_packed, v_packed

    def _agree(self, logits):
        """The step's logits as every process of the executor sees them
        before they are sampled (one process here; the mesh executor
        broadcasts)."""
        return logits

    def _emit_prefill(self, batch, lens, logits, k_packed, v_packed) -> None:
        """Prefill epilogue: first tokens from the packed logits (device
        [>=B, V], sampled and guarded there), then the direct-to-pool paged
        KV writes:
        per instance, the packed columns it retains (placement from
        batch.placement — ESP scale-down stays zero-migration) written
        through into its mirror at the reserved block-table slots.  A pool
        whose mirror lives in another process only marks the slots
        (``k_packed`` may then be None)."""
        eng = self.eng
        reqs = batch.requests
        (ids,) = self._to_host(self._sampled(logits))
        self._sample_rows(reqs, ids)
        if not eng.pool.pools[0].store_values:
            return
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
        self._fill_columns(per_inst, k_packed, v_packed)

    def _fill_columns(self, per_inst, k_packed, v_packed) -> None:
        """Write-through of packed KV columns: {inst: (column lists, slot
        lists)} into each pool at its slots."""
        for inst, (cols, slots) in per_inst.items():
            pool = self.eng.pool.pools[inst]
            if not pool.mirror_here:
                pool.fill_packed(np.concatenate(slots), None, None)
                continue
            cidx = self._to_dev(np.concatenate(cols))
            pool.fill_packed(
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
            with obs.span("executor.plan"):
                toks = self._to_dev(np.asarray(r.prompt, np.int64)[None])
            with obs.span("executor.launch"):
                logits, cache = eng.model.prefill(eng.params, {"tokens": toks})
            # [L, T, KVH, D]; the ssm family has no KV
            kv = ((cache.k[:, 0].float(), cache.v[:, 0].float())
                  if cache.k is not None else (None, None))
            ids, k, v = self._to_host(self._sampled(logits[:, -1]), *kv)
            if not self._sample_rows([r], ids):
                continue  # quarantined: no first token, engine requeues
            if k is not None:
                for inst, positions in batch.placement[r.rid].items():
                    if positions and inst not in eng.failed:
                        eng.pool.pools[inst].fill_rows([(
                            r.rid, positions, k[:, positions], v[:, positions]
                        )])
            if cache.ssm is not None:
                eng._real_cache[r.rid] = cache.ssm  # stays on the device

    # -------------------------------------------------------------- decode
    def decode(self, g) -> None:
        paged = (self._paged_impl is not None
                 and self.eng.pool.pools[0].store_values)
        with obs.span("executor.decode", len(g.requests)):
            if paged:
                return self.decode_paged(g)
            return self.decode_serial(g)

    def decode_paged(self, g) -> None:
        """Gather-free batched decode: ONE model step for the whole group;
        per layer, one paged-kernel launch per instance over the pool mirror
        in place (block tables), partials LSE-merged multi-master style."""
        from repro_torch.models.transformer import Cache

        eng = self.eng
        with obs.span("executor.plan"):
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
                shards.append(self._paged_shard(pool, table, lengths))
            # cache holds tokens 0..seq_len-2; the processed token's KV is
            # produced by this step and appended at the master afterwards
            assert (covered == n_cached).all(), (covered, n_cached)
            toks = self._to_dev(np.asarray(
                [r.output_tokens[-1] for r in g.requests], np.int64))
            cache = Cache(length=self._to_dev(n_cached))
        prev_impl = eng.model.attn_impl
        eng.model.attn_impl = self._paged_impl
        with obs.span("executor.launch"):
            self._paged_impl.begin_step(shards)
            try:
                logits, _, kvs = eng.model.decode(eng.params, toks, cache)
            finally:
                self._paged_impl.end_step()
                eng.model.attn_impl = prev_impl
        self._emit_decoded(g, self._agree(logits), kvs)

    def _paged_shard(self, pool, table, lengths):
        """One pool's `PagedShard` for a decode step: the incrementally
        synced mirror (steady-state decode uploads one slot per request;
        packed-prefill slots upload 0) and the batch's block table."""
        from repro_torch.core.paged_decode import PagedShard

        kdev, vdev, posdev = pool.device_paged_kv()
        return PagedShard(
            k_pages=kdev, v_pages=vdev, table=pool._dev_put(table),
            lengths=pool._dev_put(lengths),
            pos=(posdev if self.eng.cfg.sliding_window else None),
        )

    def _emit_decoded(self, g, logits, kvs) -> None:
        """Shared batched-decode epilogue: sample one token per request on
        the device and stash the step's new per-layer KV on the host;
        _on_decode_done fills it into the pool once the slot is allocated,
        and the next decode's mirror sync uploads it (device -> host ->
        device, as the reference does).  logits [B, V] (they stay on the
        device); kvs (k, v) each [L, B, 1, KVH, D]."""
        kv = (kvs[0].float(), kvs[1].float()) if kvs is not None else (None, None)
        ids, k_host, v_host = self._to_host(self._sampled(logits), *kv)
        self._sample_rows(g.requests, ids, k_host, v_host)

    def _sample_rows(self, reqs, ids, k_host=None, v_host=None) -> int:
        """Tokens from host ids [>=B] (`greedy_ids`), each through the value
        guard (a quarantined request gets no token and no KV stash), with
        each sampled request's new KV (``k_host`` / ``v_host`` [L, B, ...],
        decode only) stashed for the engine to fill once its slot is
        allocated.  One ``executor.sample`` record; value: tokens
        emitted."""
        eng = self.eng
        with obs.span("executor.sample") as sp:
            n = 0
            for b, r in enumerate(reqs):
                if not self._guard(r, int(ids[b])):
                    continue  # quarantined: no token, engine requeues
                r.output_tokens.append(int(ids[b]))
                n += 1
                if k_host is not None:
                    eng._pending_kv[r.rid] = (k_host[:, b], v_host[:, b])
            sp.value = n
        return n

    def decode_serial(self, g) -> None:
        """Per-request decode over a dense cache gathered from the pools on
        the host and uploaded for the step (the reference's design: every
        step moves the request's whole KV host -> device), with the
        recurrent state passed back in from ``engine._real_cache``."""
        from repro_torch.models.transformer import Cache

        eng = self.eng
        for r in g.requests:
            with obs.span("executor.plan"):
                positions, k, v = eng.pool.gather_request(r.rid)
                # cache holds tokens 0..seq_len-2; the processed token's KV
                # is produced by this step and appended at the master
                # afterwards
                n_cached = r.seq_len - 1
                if k is not None:
                    assert len(positions) == n_cached, (len(positions),
                                                        n_cached)
                dt = eng.model.dtype
                dev = (lambda x: self._to_dev(x[:, None]).to(dt)
                       if x is not None else None)
                cache = Cache(
                    k=dev(k), v=dev(v),
                    length=self._to_dev(np.asarray([n_cached], np.int32)),
                    ssm=eng._real_cache.get(r.rid),
                )
                tok = self._to_dev(np.asarray([r.output_tokens[-1]], np.int64))
            with obs.span("executor.launch"):
                logits, new_cache, kvs = eng.model.decode(eng.params, tok,
                                                          cache)
            # [L, 1, 1, KVH, D]: stashed for _on_decode_done to fill once
            # the slot is allocated
            kv = ((kvs[0].float(), kvs[1].float()) if kvs is not None
                  else (None, None))
            ids, k_new, v_new = self._to_host(self._sampled(logits), *kv)
            if not self._sample_rows([r], ids, k_new, v_new):
                continue  # quarantined: no token, no cache/KV update
            if new_cache.ssm is not None:
                eng._real_cache[r.rid] = new_cache.ssm

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

    def _unified_pack(self, segs, tb=None):
        """Host-side packing: (tokens [tb], positions [tb], offsets [bb+1],
        last_idx [bb]) — exactly `prefill_packed`'s layout, with decode rows
        as length-1 segments carrying their request's last sampled token.
        ``tb`` defaults to the token bucket of the total."""
        total = sum(s.ln for s in segs)
        tb = self._token_bucket(total) if tb is None else tb
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
            shards.append(self._unified_shard(pool, tbl_t, len_t))
        return shards, covered

    def _unified_shard(self, pool, tbl_t, len_t):
        """One pool's `UnifiedShard`: its mirror and the per-token prefix
        table / lengths."""
        from repro_torch.core.unified import UnifiedShard

        kdev, vdev, posdev = pool.device_paged_kv()
        return UnifiedShard(
            k_pages=kdev, v_pages=vdev,
            page_pos=(posdev if self.eng.cfg.sliding_window else None),
            table=pool._dev_put(tbl_t), lengths=pool._dev_put(len_t),
        )

    def unified(self, work) -> None:
        """ONE packed model step for a whole unified iteration: a bounded
        chunk of each admitted prompt's prefill tokens AND every in-flight
        decode token share one ragged token axis; per layer the chunk
        attention folds on top of the paged prefix partials
        (`core.unified`).  First/next tokens are sampled from the packed
        logits, prefill chunk KV write-throughs at the reserved slots, and
        decode KV is stashed exactly like `decode_paged`."""
        with obs.span("executor.unified") as sp:
            segs = self._unified_segments(work)
            sp.value = sum(s.ln for s in segs)
            self._unified_run(work, segs)

    def _unified_run(self, work, segs) -> None:
        eng = self.eng
        with obs.span("executor.plan"):
            tokens, positions, offsets, last_idx = self._unified_pack(segs)
            shards, covered = self._unified_shards(segs, len(tokens))
            limits = np.array([s.limit for s in segs], np.int64)
            assert (covered == limits).all(), (covered, limits)
            self._unified_count(segs)
            pos_dev = self._to_dev(positions)
            offsets, tokens, last_idx = (self._to_dev(x) for x in
                                         (offsets, tokens, last_idx))
        impl = self._unified_impl
        prev_impl = eng.model.attn_impl
        eng.model.attn_impl = impl
        with obs.span("executor.launch"):
            impl.begin_step(offsets, pos_dev, shards=shards)
            try:
                logits, (k_packed, v_packed) = eng.model.prefill_packed(
                    eng.params, {"tokens": tokens[None]}, pos_dev, last_idx,
                )
            finally:
                impl.end_step()
                eng.model.attn_impl = prev_impl
        self._unified_emit(work, segs, self._agree(logits), None, k_packed,
                           v_packed, None)

    def _unified_emit(self, work, segs, logits, ids, k_packed, v_packed,
                      colmap) -> None:
        """Unified epilogue.  Local path (``ids`` None): ``logits`` [>=S, V]
        rows are sampled on the device and pass the value guard; SPMD path:
        ``ids`` [>=S] were sampled in the step (no value guard, as in the
        reference); both are device tensors.
        ``colmap`` maps a packed column to its row on the KV output's token
        axis (striped order under SPMD; None = identity).  Decode rows' new
        KV comes to the host with the ids and is stashed for
        `_on_unified_done` to fill once the slot is allocated; prefill chunk
        KV scatters write-through at the chunk's reserved placement slots."""
        eng = self.eng
        starts = np.concatenate([[0], np.cumsum([s.ln for s in segs])])
        col_of = (lambda c: c) if colmap is None else (lambda c: colmap[c])
        store = eng.pool.pools[0].store_values
        dec = [b for b, s in enumerate(segs) if s.decode] if store else []
        kd = vd = None
        if dec:
            dc = self._to_dev(np.asarray([int(col_of(starts[b])) for b in dec],
                                         np.int64))
            kd = k_packed.index_select(1, dc).float()
            vd = v_packed.index_select(1, dc).float()
        guarded = ids is None
        if guarded:
            ids = self._sampled(logits)
        ids, kd, vd = self._to_host(ids, kd, vd)
        emitted = set()
        with obs.span("executor.sample") as sp:
            for b, s in enumerate(segs):
                if not s.final:
                    continue
                if guarded and not self._guard(s.r, int(ids[b])):
                    continue  # quarantined: no token, engine requeues
                s.r.output_tokens.append(int(ids[b]))
                emitted.add(s.r.rid)
            for j, b in enumerate(dec):
                r = segs[b].r
                if r.rid in emitted:  # quarantined rows stash no KV
                    eng._pending_kv[r.rid] = (kd[:, j:j + 1], vd[:, j:j + 1])
            sp.value = len(emitted)
        if not store:
            return
        per_inst: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
        for b, s in enumerate(segs):
            if s.decode:
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
                cols.append(np.asarray(col_of(starts[b] + (p - lo)), np.int64))
                slots.append(eng.pool.pools[inst].slots_for(s.r.rid, p))
        self._fill_columns(per_inst, k_packed, v_packed)


class _SpmdCall(NamedTuple):
    """One SPMD step of the mesh executor: ``fn(*args)`` runs this rank's
    share (None on ranks outside the group, which receive the results);
    ``mesh`` the group's `SubMesh`; ``aux`` the path's epilogue map."""

    fn: Any
    args: Tuple
    aux: Any
    mesh: Any


class MeshExecutor(LocalExecutor):
    """SPMD executor on `torch.distributed`: DoP>1 ring prefill, the
    multi-master decode merge and the unified step across processes.

    Process model: every rank of the world runs the same engine in
    lockstep.  The control plane (scheduler, pool bookkeeping, the backoff
    jitter) is numpy and deterministic, and the real-mode clock is the SIB
    model, so ranks given the same seed, config and requests schedule the
    same batches; only the compute plane is sharded.  Whatever the control
    plane reads after a step comes out of a collective the same on every
    rank: the sampled ids (all-gathered in the batch-sharded decode and the
    unified step), or the logits broadcast from one rank and sampled alike
    on every rank.

    Construction binds engine instance ``i`` to data coordinate
    ``i % data`` of a ("data", "model") mesh (`launch.mesh`): only the
    ranks of that coordinate hold its pool mirror (`KVPool.bind_mesh`);
    the others keep its host bookkeeping, and a host sync of it is a
    broadcast from its owner.  Every rank holds the whole parameter set
    (the reference replicates it too).  With ``data > 1`` the instance
    count must equal ``data``: across processes, a group whose instances
    alias one coordinate has no process that holds all its mirrors.  With
    ``data == 1`` every group aliases, and the executor replays in process,
    as the reference does.

    * prefill: a group of more than one alive instance runs the ring
      (`core.esp.ring_packed_prefill_spmd`) on the sub-mesh of exactly its
      coordinates (cached per instance tuple — a `dist.new_group` is
      entered by every rank in the same order, which the lockstep engine
      gives); a DoP 1 group runs the packed step (K1) on every rank.
    * decode (``spmd_decode=True``): ONE step over the sub-mesh of the
      KV-holding instances, each rank's K2 partial over its own mirror.
      ``batch_shard=True`` (default) runs the batch-sharded iteration
      (`core.esp.paged_decode_iteration_spmd`: each rank embeds, runs the
      stack and samples its B/n slice; all_gather(q) in, psum_scatter out,
      ids and routed KV all-gathered); ``batch_shard=False`` the replicated
      stack with a pmax + psum merge per layer
      (`core.esp.paged_decode_spmd`).  ``decode_overlap=False`` waits for
      each merge before the new-token partial.  Groups with one KV-holding
      shard, and ``spmd_decode=False``, run the reference's per-shard loop:
      every rank runs the stack, each shard's partial is computed by its
      owner and broadcast home.
    * unified (``spmd_decode=True``, two or more KV-holding instances):
      `core.esp.unified_iteration_spmd` striped over the same sub-mesh;
      otherwise the per-shard loop form.
    * ``double_buffer=False`` starts each ring leg only after the fold.

    Ranks outside a step's group receive its results by broadcast from the
    group's leader (``result_broadcast`` in `ops.comm_bytes`).
    """

    def __init__(self, engine, mesh=None, *, double_buffer: bool = True,
                 spmd_decode: bool = True, decode_overlap: bool = True,
                 batch_shard: bool = True):
        import torch.distributed as dist

        from repro_torch.launch import mesh as lm

        if mesh is None:
            lm.init_process_group(engine.device)
            world = dist.get_world_size()
            data = min(len(engine.pool.pools), world)
            mesh = lm.make_test_mesh(data=data, model=max(world // data, 1),
                                     device=engine.device)
        assert "data" in mesh.mesh_dim_names, mesh.mesh_dim_names
        backend = lm.backend_for(engine.device)
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the mesh's process group runs {dist.get_backend()}, the "
                f"engine's device {engine.device} needs {backend}"
            )
        self.mesh = mesh
        self.data = lm.axis_size(mesh, "data")
        self._coord = lm.data_coordinate(mesh)
        self._rank = dist.get_rank()
        self._world = dist.get_world_size()
        self.double_buffer = double_buffer
        self.spmd_decode = spmd_decode
        self.decode_overlap = decode_overlap
        self.batch_shard = batch_shard
        self._sub_meshes: Dict[Tuple[int, ...], Any] = {}
        self._step_mesh = None
        super().__init__(engine)

    def _bind_pool_devices(self) -> None:
        """Instance i lives on data coordinate i % data: the ranks of that
        coordinate hold its mirror, the rank at (i % data, model 0) answers
        its host syncs."""
        from repro_torch.launch.mesh import rank_of

        pools = self.eng.pool.pools
        if self.data > 1 and len(pools) != self.data:
            raise ValueError(
                f"{len(pools)} engine instances on a mesh with data = "
                f"{self.data}: across processes every instance needs its "
                "own data coordinate"
            )
        for i, pool in enumerate(pools):
            if self.data == 1:
                pool.bind_device(self.device)
            else:
                pool.bind_mesh(self.device, rank_of(self.mesh, i % self.data),
                               here=(i % self.data == self._coord))

    def on_instance_failed(self, inst: int) -> None:
        """Drop every cached sub-mesh holding the dead rank: a surviving
        group re-forms at DoP-1 through `_group_mesh` / `_decode_mesh` on
        first use, like any other elastic resize."""
        for key in [k for k in self._sub_meshes if inst in k]:
            del self._sub_meshes[key]

    def _group_mesh(self, instances):
        """`SubMesh` over exactly the group's data coordinates (cached per
        instance tuple).  None (-> in-process replay) when the instances
        alias a coordinate, which happens only with ``data == 1``."""
        from repro_torch.launch.mesh import SubMesh

        key = tuple(sorted(instances))
        if key not in self._sub_meshes:
            coords = [i % self.data for i in key]
            self._sub_meshes[key] = (
                None if len(set(coords)) < len(coords)
                else SubMesh(self.mesh, coords)
            )
        return self._sub_meshes[key]

    def _decode_mesh(self, instances):
        """The sub-mesh of a decode / unified group's KV-holding instances
        (None when they alias: the per-shard loop)."""
        return self._group_mesh(instances)

    def _replicated_params(self, mesh):
        """Every rank holds the whole parameter set on its device (the
        engine's), so nothing is transferred per group."""
        return self.eng.params

    # ------------------------------------------------------------- helpers
    def _agree(self, logits):
        """The logits of the paths every rank runs, broadcast from rank 0,
        so every rank samples the same tokens."""
        if self._world == 1:
            return logits
        from repro_torch.kernels import ops

        return ops.broadcast(logits.float().contiguous(), 0,
                             key="result_broadcast")

    def _publish(self, mesh, items):
        """Hand a group step's results to the ranks outside the group:
        ``items`` is a list of (tensor or None, shape, dtype); returns the
        tensors, broadcast from the group's leader when some rank of the
        world is outside the group."""
        if len(mesh.ranks) == self._world:
            return [x for x, _, _ in items]
        from repro_torch.kernels import ops

        out = [
            x.contiguous() if self._rank == mesh.leader
            else torch.empty(shape, dtype=dt, device=self.device)
            for x, shape, dt in items
        ]
        ops.broadcast(tuple(out), mesh.leader, key="result_broadcast")
        return out

    def _paged_shard(self, pool, table, lengths):
        """Per-shard loop across processes: a shard whose mirror lives in
        another process is computed there and its partial broadcast home."""
        if pool._mesh_src is None:
            return super()._paged_shard(pool, table, lengths)
        from repro_torch.core.paged_decode import PagedShard

        if self._rank != pool._mesh_src:
            return PagedShard(None, None, None, None, None, src=pool._mesh_src)
        return super()._paged_shard(pool, table, lengths)._replace(
            src=pool._mesh_src)

    def _unified_shard(self, pool, tbl_t, len_t):
        if pool._mesh_src is None:
            return super()._unified_shard(pool, tbl_t, len_t)
        from repro_torch.core.unified import UnifiedShard

        if self._rank != pool._mesh_src:
            return UnifiedShard(None, None, None, None, None,
                                src=pool._mesh_src)
        return super()._unified_shard(pool, tbl_t, len_t)._replace(
            src=pool._mesh_src)

    # --------------------------------------------------------------- prefill
    def prefill_packed(self, batch) -> None:
        """The packed step with the ring across the processes of the
        group's sub-mesh; ranks outside the group receive the logits."""
        alive = tuple(i for i in batch.instances if i not in self.eng.failed)
        sub = self._group_mesh(alive) if len(alive) > 1 else None
        if sub is None:
            return super().prefill_packed(batch)
        with obs.span("executor.plan"):
            lens, packed = self._pack_prefill(batch)
        logits = k_packed = v_packed = None
        if sub.rank is not None:
            self._step_mesh = sub
            try:
                logits, k_packed, v_packed = self._prefill_step(*packed)
            finally:
                self._step_mesh = None
        bb, v_sz = len(packed[4]), self.eng.cfg.vocab_size
        (logits,) = self._publish(sub, [(
            None if logits is None else logits.float(), (bb, v_sz),
            torch.float32,
        )])
        if len(sub.ranks) == self._world:
            logits = self._agree(logits)
        self._emit_prefill(batch, lens, logits, k_packed, v_packed)

    def _arm_packed_step(self, impl, offsets, dop: int) -> None:
        impl.begin_step(offsets, dop=dop, mesh=self._step_mesh,
                        double_buffer=self.double_buffer)

    # ---------------------------------------------------------------- decode
    def _decode_spmd_setup(self, g):
        """Assemble the SPMD decode step for one DecodeBatch, or None when
        the group cannot run SPMD (one KV-holding shard, or aliased
        coordinates).  Each rank's paged operands are its own pool mirror in
        place: the executor ships per-request block-table rows (tiny) and
        ZERO KV bytes.  ``aux`` is None for the replicated program; for the
        batch-sharded one it maps rid -> row of the master-major routed KV
        output (rank*rb + j, from the route built out of
        `DecodeBatch.masters`; a master holding no KV in this group routes
        through rank 0)."""
        from functools import partial

        from repro_torch.core.esp import paged_decode_iteration_spmd

        eng = self.eng
        rids = [r.rid for r in g.requests]
        n_cached = np.array([r.seq_len - 1 for r in g.requests], np.int32)
        infos = []
        for pool in eng.pool.pools:
            if pool.instance_id in eng.failed:
                continue
            table, lengths = pool.block_table(rids)
            if lengths.any():
                infos.append((pool, table, lengths))
        if len(infos) < 2:
            return None
        mesh = self._decode_mesh(tuple(p.instance_id for p, _, _ in infos))
        if mesh is None:
            return None
        covered = np.sum([lg for _, _, lg in infos], axis=0)
        # cache holds tokens 0..seq_len-2; the processed token's KV is
        # produced by this step and appended at the master afterwards
        assert (covered == n_cached).all(), (covered, n_cached)
        n, b = len(infos), len(rids)
        bb = self._bucket(b, lo=1)
        if self.batch_shard:
            # each rank owns bb/n batch rows (padded rows hold zero KV
            # everywhere and their sampled tokens are discarded)
            bb = -(-bb // n) * n
        mpb = self._bucket(max(t.shape[1] for _, t, _ in infos), lo=1)
        rb = route = rowmap = None
        if self.batch_shard:
            inst_rank = {p.instance_id: i for i, (p, _, _) in enumerate(infos)}
            per_rank: List[List[int]] = [[] for _ in range(n)]
            owner_of: List[Tuple[int, int]] = []
            for bi, r in enumerate(g.requests):
                rank = inst_rank.get(g.masters.get(r.rid), 0)
                owner_of.append((rank, len(per_rank[rank])))
                per_rank[rank].append(bi)
            rb = self._bucket(max(len(rows) for rows in per_rank), lo=1)
            route = np.zeros((n, rb), np.int64)  # padding rows read row 0
            for i, rows in enumerate(per_rank):
                route[i, :len(rows)] = rows
            rowmap = {r.rid: rank * rb + j
                      for r, (rank, j) in zip(g.requests, owner_of)}
        aux = (rowmap, bb, None if rb is None else n * rb)
        if mesh.rank is None:
            return _SpmdCall(None, (), aux, mesh)
        pool, table, lengths = infos[mesh.rank]
        kd, vd, pd = pool.device_paged_kv()
        tbl = np.zeros((bb, mpb), np.int32)
        lens = np.zeros(bb, np.int32)
        tbl[:b, :table.shape[1]] = table
        lens[:b] = lengths
        toks = np.zeros(bb, np.int64)
        toks[:b] = [r.output_tokens[-1] for r in g.requests]
        ncb = np.zeros(bb, np.int32)
        ncb[:b] = n_cached
        pos = pd if eng.cfg.sliding_window else None
        dev = self._to_dev
        if self.batch_shard:
            fn = partial(paged_decode_iteration_spmd, mesh, eng.model,
                         self._paged_impl, overlap=self.decode_overlap)
            args = (self._replicated_params(mesh), dev(toks), dev(ncb), kd,
                    vd, dev(tbl), dev(lens), pos, dev(route))
        else:
            fn = self._decode_replicated
            args = (mesh, dev(toks), dev(ncb), kd, vd, dev(tbl), dev(lens),
                    pos)
        return _SpmdCall(fn, args, aux, mesh)

    def _decode_replicated(self, mesh, toks, n_cached, kd, vd, tbl, lens,
                           pos):
        """The replicated-stack program (``batch_shard=False``): every rank
        of the group runs the full batch, one pmax + psum merge per layer."""
        from repro_torch.core.paged_decode import SpmdPagedShards
        from repro_torch.models.transformer import Cache

        impl = self._paged_impl
        impl.begin_step(SpmdPagedShards(kd, vd, tbl, lens, pos), mesh=mesh,
                        overlap=self.decode_overlap)
        try:
            logits, _, kvs = self.eng.model.decode(
                self._replicated_params(mesh), toks, Cache(length=n_cached))
        finally:
            impl.end_step()
        return logits, kvs

    def decode_paged(self, g) -> None:
        """One SPMD decode step for the whole group: per layer, each rank's
        K2 partial over the mirror it holds and the LSE merge as a
        collective; otherwise the per-shard loop (`LocalExecutor`)."""
        with obs.span("executor.plan"):
            setup = self._decode_spmd_setup(g) if self.spmd_decode else None
        if setup is None:
            return super().decode_paged(g)
        fn, args, (rowmap, bb, rows), mesh = setup
        eng = self.eng
        out = None
        if fn is not None:
            prev_impl = eng.model.attn_impl
            eng.model.attn_impl = self._paged_impl
            try:
                with obs.span("executor.launch"):
                    out = fn(*args)
            finally:
                eng.model.attn_impl = prev_impl
        cfg = eng.cfg
        kv_tail = (1, cfg.n_kv_heads, cfg.head_dim)
        n_l = eng.pool.pools[0].n_attn
        dt = eng.model.dtype
        if rowmap is None:
            logits, (k, v) = out if out is not None else (None, (None, None))
            logits, k, v = self._publish(mesh, [
                (None if logits is None else logits.float(),
                 (bb, cfg.vocab_size), torch.float32),
                (k, (n_l, bb) + kv_tail, dt),
                (v, (n_l, bb) + kv_tail, dt),
            ])
            if len(mesh.ranks) == self._world:
                logits = self._agree(logits)
            self._emit_decoded(g, logits, (k, v))
            return
        ids, k_rt, v_rt = out if out is not None else (None, None, None)
        ids, k_rt, v_rt = self._publish(mesh, [
            (ids, (bb,), torch.int32),
            (k_rt, (n_l, rows) + kv_tail, dt),
            (v_rt, (n_l, rows) + kv_tail, dt),
        ])
        self._emit_decoded_routed(g, ids, k_rt, v_rt, rowmap)

    def _emit_decoded_routed(self, g, toks_next, k_rt, v_rt, rowmap) -> None:
        """Batch-sharded epilogue: tokens were sampled in the step (each rank
        argmaxed its own logits slice, ids exchanged by all_gather) and the
        new per-layer KV arrives master-major [L, n*rb, 1, KVH, D] — this
        appends each request's id and stashes its routed KV rows for
        _on_decode_done to fill.  As in the reference, the NaN-logit guard
        cannot apply here (logits never leave the step)."""
        eng = self.eng
        toks, k_rt, v_rt = self._to_host(toks_next, k_rt.float(), v_rt.float())
        with obs.span("executor.sample", len(g.requests)):
            for b, r in enumerate(g.requests):
                r.output_tokens.append(int(toks[b]))
                row = rowmap[r.rid]
                eng._pending_kv[r.rid] = (k_rt[:, row], v_rt[:, row])

    # --------------------------------------------------------------- unified
    def _unified_spmd_setup(self, work, segs):
        """Assemble the SPMD unified step, or None when the iteration cannot
        run SPMD (fewer than two KV-holding instances, or aliased
        coordinates).  ``aux`` is (inv, tb, bb): ``inv`` maps a packed column
        to its striped row on the step's token axis.  Each rank's paged
        operands are its own pool plane in place, with per-TOKEN prefix
        table rows in striped order."""
        from functools import partial

        from repro_torch.core import striped
        from repro_torch.core.esp import unified_iteration_spmd

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
        if len(infos) < 2:
            return None
        mesh = self._decode_mesh(tuple(p.instance_id for p, _, _ in infos))
        if mesh is None:
            return None
        covered = np.sum([lg for _, _, lg in infos], axis=0)
        assert (covered == limits).all(), (covered, limits)
        n = len(infos)
        total = sum(s.ln for s in segs)
        tb = self._token_bucket(-(-total // n)) * n
        tokens, positions, offsets, last_idx = self._unified_pack(segs, tb)
        bb = len(last_idx)
        # striped layout: packed column c lives at striped row inv[c] (rank
        # c % n); rank r's stripe is block r of the striped axis
        perm = striped.stripe_indices(tb, n)
        inv = striped.unstripe_indices(tb, n)
        aux = (inv, tb, bb)
        if mesh.rank is None:
            return _SpmdCall(None, (), aux, mesh)
        pool, table, lengths = infos[mesh.rank]
        mpb = self._bucket(max(t.shape[1] for _, t, _ in infos), lo=1)
        seg_lens = np.array([s.ln for s in segs], np.int64)
        tbl_t = np.zeros((tb, mpb), np.int32)
        len_t = np.zeros(tb, np.int32)
        tbl_t[:total, :table.shape[1]] = np.repeat(table, seg_lens, axis=0)
        len_t[:total] = np.repeat(lengths, seg_lens)
        kd, vd, pd = pool.device_paged_kv()
        dev = self._to_dev
        fn = partial(unified_iteration_spmd, mesh, eng.model,
                     self._unified_impl, double_buffer=self.double_buffer)
        args = (self._replicated_params(mesh), dev(tokens[perm]),
                dev(positions[perm]), offsets, dev(inv[last_idx]), kd, vd,
                dev(tbl_t[perm]), dev(len_t[perm]),
                pd if eng.cfg.sliding_window else None)
        return _SpmdCall(fn, args, aux, mesh)

    def _unified_run(self, work, segs) -> None:
        """The whole unified iteration striped over the group's sub-mesh
        (`core.esp.unified_iteration_spmd`): per layer, the decode-style
        paged prefix merge and the prefill-style chunk ring; tokens sampled
        in the step.  The KV stripes are all-gathered on the group
        (``kv_gather``) for the write-through.  Otherwise the per-shard loop
        form (`LocalExecutor`)."""
        from repro_torch.kernels import ops

        with obs.span("executor.plan"):
            setup = (
                self._unified_spmd_setup(work, segs) if self.spmd_decode
                else None
            )
        if setup is None:
            return super()._unified_run(work, segs)
        fn, args, (inv, tb, bb), mesh = setup
        self._unified_count(segs)
        eng = self.eng
        ids = k_packed = v_packed = None
        if fn is not None:
            prev_impl = eng.model.attn_impl
            eng.model.attn_impl = self._unified_impl
            try:
                with obs.span("executor.launch"):
                    ids, k_st, v_st = fn(*args)
            finally:
                eng.model.attn_impl = prev_impl
            k_packed, v_packed = ops.all_gather((k_st, v_st), mesh.group,
                                                axis=1, key="kv_gather")
        cfg = eng.cfg
        kv_shape = (eng.pool.pools[0].n_attn, tb, cfg.n_kv_heads,
                    cfg.head_dim)
        ids, k_packed, v_packed = self._publish(mesh, [
            (ids, (bb,), torch.int32),
            (k_packed, kv_shape, eng.model.dtype),
            (v_packed, kv_shape, eng.model.dtype),
        ])
        self._unified_emit(work, segs, None, ids, k_packed, v_packed, inv)
