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
  * per-request serial fallbacks (dense family only here).

PyTorch runs eagerly, so the reference's jitted-program LRU has no
counterpart; the padding buckets stay so that padded shapes and striping
(``T % dop == 0``) match the reference exactly.  The unified chunked step
is not ported yet (ROADMAP queue 1 item 9): `supports_unified` is False.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


class LocalExecutor:
    """In-process executor: one device, ring replayed as a chunk schedule."""

    def __init__(self, engine):
        self.eng = engine
        self.device = engine.device
        self._paged_impl = None
        self._packed_prefill_impl = None
        if engine.cfg.family in ("dense", "vlm"):
            from repro_torch.core.paged_decode import PagedDecodeAttnImpl
            from repro_torch.core.paged_prefill import PackedPrefillAttnImpl
            from repro_torch.models.transformer import DefaultAttnImpl

            if type(getattr(engine.model, "attn_impl", None)) is DefaultAttnImpl:
                self._paged_impl = PagedDecodeAttnImpl()
                self._packed_prefill_impl = PackedPrefillAttnImpl()
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

    @property
    def supports_unified(self) -> bool:
        return False

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
        """Per-request fallback (a custom attention impl)."""
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
            k = cache.k[:, 0].float().cpu().numpy()  # [L, T, KVH, D]
            v = cache.v[:, 0].float().cpu().numpy()
            for inst, positions in batch.placement[r.rid].items():
                if positions and inst not in eng.failed:
                    eng.pool.pools[inst].fill(
                        r.rid, positions, k[:, positions], v[:, positions]
                    )

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
        """Per-request fallback over a dense gathered cache (a custom
        attention impl)."""
        from repro_torch.models.transformer import Cache

        eng = self.eng
        for r in g.requests:
            positions, k, v = eng.pool.gather_request(r.rid)
            n_cached = r.seq_len - 1
            assert len(positions) == n_cached, (len(positions), n_cached)
            dt = eng.model.dtype
            cache = Cache(
                k=self._to_dev(k[:, None]).to(dt),
                v=self._to_dev(v[:, None]).to(dt),
                length=self._to_dev(np.asarray([n_cached], np.int32)),
            )
            logits, _, kvs = eng.model.decode(
                eng.params, self._to_dev(np.asarray([r.output_tokens[-1]],
                                                    np.int64)), cache
            )
            row = self._guard_logits(r, logits[0].cpu().numpy())
            if row is None:
                continue  # quarantined: no token, no KV update
            r.output_tokens.append(eng._sample_token(row))
            eng._pending_kv[r.rid] = (
                kvs[0][:, 0].float().cpu().numpy(),  # [L, 1, KVH, D]
                kvs[1][:, 0].float().cpu().numpy(),
            )
