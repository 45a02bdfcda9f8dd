"""Ablation baselines for Fig. 12: LoongServe w/o ESP.

`FixedGroupsEngine` partitions instances into STATIC groups; each group is an
independent continuous-batching server (locality constraint: a request's KV
lives entirely inside one group). Covers:
  * static hybrid parallelism (TP x SP fixed): one group of all instances
    (equivalently use StaticTPEngine);
  * parallelism with replication ((TP=2) x 4): four singleton groups.
Requests are dispatched FCFS to the group with the most free KV slots that
fits them — fragmentation across groups is exactly what Fig. 4 depicts.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.engine.request import Phase, Request
from repro_torch.engine.server import BaseServingEngine
from repro_torch.kvcache.pool import OutOfSlots


class FixedGroupsEngine(BaseServingEngine):
    def __init__(self, *args, groups: Sequence[Sequence[int]], **kwargs):
        super().__init__(*args, **kwargs)
        self.groups: List[List[int]] = [list(g) for g in groups]
        self.active: Dict[int, List[Request]] = {g: [] for g in range(len(groups))}
        self._running: Dict[int, bool] = {g: False for g in range(len(groups))}

    def _grp(self, gi: int) -> List[int]:
        return [i for i in self.groups[gi] if i not in self.failed]

    def _free_of(self, gi: int) -> int:
        return sum(self.pool.pools[i].free_slots for i in self._grp(gi))

    def _try_schedule(self) -> None:
        self.pending.sort(key=lambda r: r.arrival)
        for gi in range(len(self.groups)):
            self._schedule_group(gi)

    def _schedule_group(self, gi: int) -> None:
        if self._running[gi]:
            return
        grp = self._grp(gi)
        if not grp:
            return
        dop = len(grp)
        admit: List[Request] = []
        free = self._free_of(gi)
        for r in list(self.pending):
            reserve = int(0.2 * r.max_new_tokens)
            if r.max_total_len > self.capacity * dop:
                continue  # cannot ever fit this group; maybe another can
            if r.input_len + reserve <= free:
                admit.append(r)
                free -= r.input_len
                if len(admit) >= 16:
                    break
            else:
                break  # FCFS head-of-line within the group
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
            self._running[gi] = True
            self.metrics.prefill_iters += 1
            self._push(end, "prefill_done", (gi, admit))
            return
        if self.active[gi]:
            sum_kv = sum(r.seq_len for r in self.active[gi])
            dur = self.sib.decode_time(dop, len(self.active[gi]), sum_kv, grp)
            end = self.clock + dur
            self._occupy(grp, end)
            self._running[gi] = True
            self.metrics.decode_iters += 1
            self._push(end, "decode_done", (gi, list(self.active[gi])))

    def _on_prefill_done(self, payload) -> None:
        gi, batch = payload
        self._running[gi] = False
        for r in batch:
            r.prefill_end = self.clock
            r.phase = Phase.DECODE
            r.generated += 1
            r.output_tokens.append(self._sample_token())
            if r.done:
                self._finish_request(r)
            else:
                self.active[gi].append(r)

    def _on_decode_done(self, payload) -> None:
        gi, batch = payload
        self._running[gi] = False
        grp = self._grp(gi)
        for r in batch:
            if r not in self.active[gi]:
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
                self.active[gi].remove(r)
                self.pending.append(r)
                continue
            if r.done:
                self.active[gi].remove(r)
                self._finish_request(r)
