"""Baseline: chunked prefill / SplitFuse (Sarathi, DeepSpeed-FastGen,
LightLLM w/ SplitFuse — the paper's strongest baseline, §7).

Each iteration fuses the decode batch with a chunk of pending prefill tokens
(budget `chunk_size`). Decode is protected from long prompts, but splitting
the prompt makes the prefill phase less efficient (the KV of earlier chunks
is re-read per chunk) and long-context "P:D" ratios still interfere — the
effects the paper measures in Fig. 10.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.engine.request import Phase, Request
from repro_torch.engine.server import BaseServingEngine
from repro_torch.kvcache.pool import OutOfSlots


class ChunkedPrefillEngine(BaseServingEngine):
    def __init__(self, *args, chunk_size: int = 2048, **kwargs):
        super().__init__(*args, **kwargs)
        self.chunk_size = chunk_size
        self.active: List[Request] = []  # decoding
        self.prefilling: Dict[int, int] = {}  # rid -> tokens prefilled so far
        self.in_prefill: List[Request] = []
        self._running = False

    def _group(self) -> List[int]:
        return [i for i in range(self.n) if i not in self.failed]

    def _try_schedule(self) -> None:
        if self._running:
            return
        grp = self._group()
        if not grp:
            return
        dop = len(grp)
        self.pending.sort(key=lambda r: r.arrival)

        # admit new requests into the prefilling set while memory allows
        free = self.pool.total_free
        committed = sum(
            r.input_len - self.prefilling[r.rid] for r in self.in_prefill
        )
        for r in list(self.pending):
            reserve = int(0.2 * r.max_new_tokens)
            if r.input_len + reserve + committed <= free:
                self.pending.remove(r)
                r.phase = Phase.PREFILL
                if r.prefill_start is None:
                    r.prefill_start = self.clock
                self.in_prefill.append(r)
                self.prefilling[r.rid] = 0
                committed += r.input_len
            else:
                break

        # build the fused iteration: decode tokens + prefill chunk budget
        chunk_alloc: List[Tuple[Request, int, int]] = []  # (req, start, n)
        budget = self.chunk_size
        for r in self.in_prefill:
            if budget <= 0:
                break
            done_tok = self.prefilling[r.rid]
            take = min(budget, r.input_len - done_tok)
            if take > 0:
                chunk_alloc.append((r, done_tok, take))
                budget -= take
        if not chunk_alloc and not self.active:
            return

        # cost: decode part + chunk part; chunk attention re-reads the KV
        # prefix of earlier chunks (quadratic surcharge via sum over chunks)
        sum_kv = sum(r.seq_len for r in self.active)
        t = self.sib.decode_time(dop, max(len(self.active), 1), sum_kv, grp)
        for r, start, take in chunk_alloc:
            # effective cost of a chunk at offset `start`: linear part for
            # `take` tokens + attention against `start+take` prefix
            fit = self.sib._fit_prefill(dop)
            t += fit.beta * take + fit.gamma * float(take) * float(start + take)
        end = self.clock + t
        self._occupy(grp, end)
        self._running = True
        self.metrics.prefill_iters += 1 if chunk_alloc else 0
        self.metrics.decode_iters += 1 if self.active else 0
        self._push(end, "decode_done", (list(self.active), chunk_alloc))

    def _on_decode_done(self, payload) -> None:
        self._running = False
        active, chunk_alloc = payload
        grp = self._group()
        # prefill chunk progress
        for r, start, take in chunk_alloc:
            try:
                plan = self.pool.plan_placement(
                    r.rid, list(range(start, start + take)), grp
                )
                self.pool.place(plan)
            except OutOfSlots:
                continue
            self.prefilling[r.rid] += take
            if self.prefilling[r.rid] >= r.input_len:
                self.in_prefill.remove(r)
                self.prefilling.pop(r.rid)
                r.prefill_end = self.clock
                r.phase = Phase.DECODE
                r.generated += 1
                r.output_tokens.append(self._sample_token())
                if r.done:
                    self._finish_request(r)
                else:
                    self.active.append(r)
        # decode progress
        for r in active:
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

    def _on_prefill_done(self, payload) -> None:  # pragma: no cover
        raise AssertionError("chunked engine fuses phases")
