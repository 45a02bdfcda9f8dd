"""Baseline: static tensor parallelism with continuous batching (vLLM-like).

All instances form ONE group (TP spans the fleet, as the paper configures
vLLM with TP=8 on 8 GPUs). Iteration-level scheduling: pending prefills run
as a batch on the whole group (blocking decode — the interference the paper
measures); otherwise one decode iteration over all active requests.
"""
from __future__ import annotations

from typing import List

from repro_torch.engine.request import Phase, Request
from repro_torch.engine.server import BaseServingEngine
from repro_torch.kvcache.pool import OutOfSlots


class StaticTPEngine(BaseServingEngine):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.active: List[Request] = []
        self.group = list(range(self.n))
        self._running = False

    def _group(self) -> List[int]:
        return [i for i in self.group if i not in self.failed]

    def _try_schedule(self) -> None:
        if self._running:
            return
        grp = self._group()
        if not grp or self.busy_until[grp[0]] > self.clock + 1e-12:
            return
        dop = len(grp)
        self.pending.sort(key=lambda r: r.arrival)

        # admit prefills (FCFS, memory-constrained; whole request on the
        # single group -> per-group locality, no cross-group flexibility)
        admit: List[Request] = []
        free = self.pool.total_free
        for r in list(self.pending):
            reserve = int(0.2 * r.max_new_tokens)
            if r.input_len + reserve <= free and len(admit) < 64:
                admit.append(r)
                free -= r.input_len
            else:
                break
        if admit:
            for r in admit:
                self.pending.remove(r)
                r.phase = Phase.PREFILL
                if r.prefill_start is None:
                    r.prefill_start = self.clock
                plan = self.pool.plan_placement(
                    r.rid, list(range(r.input_len)), grp
                )
                self.pool.place(plan)
            dur = self.sib.prefill_time(dop, [r.input_len for r in admit], grp)
            end = self.clock + dur
            self._occupy(grp, end)
            self._running = True
            self.metrics.prefill_iters += 1
            self._push(end, "prefill_done", admit)
            return

        if self.active:
            sum_kv = sum(r.seq_len for r in self.active)
            dur = self.sib.decode_time(dop, len(self.active), sum_kv, grp)
            end = self.clock + dur
            self._occupy(grp, end)
            self._running = True
            self.metrics.decode_iters += 1
            self._push(end, "decode_done", list(self.active))

    def _on_prefill_done(self, batch: List[Request]) -> None:
        self._running = False
        for r in batch:
            r.prefill_end = self.clock
            r.phase = Phase.DECODE
            r.generated += 1
            r.output_tokens.append(self._sample_token())
            if r.done:
                self._finish_request(r)
            else:
                self.active.append(r)

    def _on_decode_done(self, batch: List[Request]) -> None:
        self._running = False
        grp = self._group()
        for r in batch:
            if r not in self.active:
                continue
            pos = r.seq_len - 1
            r.generated += 1
            r.output_tokens.append(self._sample_token())
            placed = False
            for inst in grp:
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
