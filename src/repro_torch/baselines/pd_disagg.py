"""Baseline: prefill-decode disaggregation (DistServe-like, §7).

Instances split statically into a prefill group and a decode group. After the
prefill phase the whole KV cache migrates to the decode group — *reactive*
migration, the overhead LoongServe's proactive scale-down eliminates. Each
group only sees half the fleet's memory: long requests that fit the unified
pool OOM here (the paper's LV-Eval rows), reproduced via `rejected`.
"""
from __future__ import annotations

from typing import List

from repro_torch.engine.request import Phase, Request
from repro_torch.engine.server import BaseServingEngine
from repro_torch.kvcache.pool import OutOfSlots


class PDDisaggEngine(BaseServingEngine):
    def __init__(self, *args, prefill_frac: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        split = max(1, int(self.n * prefill_frac))
        self.p_group = list(range(split))
        self.d_group = list(range(split, self.n))
        self.active: List[Request] = []
        self._p_running = False
        self._d_running = False

    def _pg(self):
        return [i for i in self.p_group if i not in self.failed]

    def _dg(self):
        return [i for i in self.d_group if i not in self.failed]

    def _try_schedule(self) -> None:
        self._schedule_prefill()
        self._schedule_decode()

    def _schedule_prefill(self) -> None:
        if self._p_running:
            return
        pg = self._pg()
        if not pg:
            return
        self.pending.sort(key=lambda r: r.arrival)
        admit: List[Request] = []
        free_p = sum(self.pool.pools[i].free_slots for i in pg)
        # decode group must ALSO fit the request post-migration
        free_d = sum(self.pool.pools[i].free_slots for i in self._dg())
        for r in list(self.pending):
            reserve = int(0.2 * r.max_new_tokens)
            if r.input_len > self.capacity * len(pg) or (
                r.input_len + reserve > self.capacity * len(self._dg())
            ):
                # static halves cannot serve it at all -> OOM/reject
                self.pending.remove(r)
                self.metrics.rejected += 1
                continue
            if r.input_len <= free_p and r.input_len + reserve <= free_d:
                admit.append(r)
                free_p -= r.input_len
                free_d -= r.input_len
                if len(admit) >= 16:
                    break
            else:
                break
        if not admit:
            return
        for r in admit:
            self.pending.remove(r)
            r.phase = Phase.PREFILL
            if r.prefill_start is None:
                r.prefill_start = self.clock
            plan = self.pool.plan_placement(r.rid, list(range(r.input_len)), pg)
            self.pool.place(plan)
        dur = self.sib.prefill_time(len(pg), [r.input_len for r in admit], pg)
        end = self.clock + dur
        self._occupy(pg, end)
        self._p_running = True
        self.metrics.prefill_iters += 1
        self._push(end, "prefill_done", admit)

    def _schedule_decode(self) -> None:
        if self._d_running or not self.active:
            return
        dg = self._dg()
        if not dg:
            return
        sum_kv = sum(r.seq_len for r in self.active)
        dur = self.sib.decode_time(len(dg), len(self.active), sum_kv, dg)
        end = self.clock + dur
        self._occupy(dg, end)
        self._d_running = True
        self.metrics.decode_iters += 1
        self._push(end, "decode_done", list(self.active))

    def _on_prefill_done(self, batch: List[Request]) -> None:
        self._p_running = False
        dg = self._dg()
        for r in batch:
            # REACTIVE migration prefill->decode group (the cost ESP avoids)
            moved_tokens = 0
            for src in self._pg():
                toks = len(self.pool.pools[src].tokens_of(r.rid))
                if toks == 0:
                    continue
                try:
                    self.pool.migrate_request(r.rid, src, dg)
                    moved_tokens += toks
                except OutOfSlots:
                    self.pool.free_request(r.rid)
                    r.n_evictions += 1
                    r.phase = Phase.PENDING
                    r.input_len = r.seq_len
                    self.pending.append(r)
                    moved_tokens = -1
                    break
            if moved_tokens < 0:
                continue
            self.metrics.reactive_migration_bytes += (
                moved_tokens * self.pool.pools[0].bytes_per_slot
            )
            t_mig = self.sib.migration_time(moved_tokens)
            r.prefill_end = self.clock + t_mig  # migration delays first token
            r.phase = Phase.DECODE
            r.generated += 1
            r.output_tokens.append(self._sample_token())
            if r.done:
                self._finish_request(r)
            else:
                self.active.append(r)

    def _on_decode_done(self, batch: List[Request]) -> None:
        self._d_running = False
        dg = self._dg()
        for r in batch:
            if r not in self.active:
                continue
            pos = r.seq_len - 1
            r.generated += 1
            r.output_tokens.append(self._sample_token())
            placed = False
            for inst in dg:
                try:
                    self.pool.pools[inst].alloc(r.rid, [pos])
                    placed = True
                    break
                except OutOfSlots:
                    continue
            if not placed:
                self.pool.free_request(r.rid)
                r.n_evictions += 1
                r.phase = Phase.PENDING
                r.input_len = r.seq_len
                r.prefill_end = None
                self.active.remove(r)
                self.pending.append(r)
                continue
            if r.done:
                self.active.remove(r)
                self._finish_request(r)
