"""Request lifecycle & metrics (pending -> prefill -> decode -> finished)."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional


class Phase(enum.Enum):
    PENDING = "pending"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    EVICTED = "evicted"  # KV dropped; needs prefill recompute


_req_counter = itertools.count()


@dataclass
class Request:
    input_len: int
    max_new_tokens: int
    arrival: float = 0.0
    rid: int = field(default_factory=lambda: next(_req_counter))
    prompt: Optional[list] = None  # token ids (real-exec mode)
    phase: Phase = Phase.PENDING

    # progress
    generated: int = 0
    output_tokens: List[int] = field(default_factory=list)
    # unified chunked prefill: tokens [0, prefill_pos) have been computed
    # and written to the pool; the next chunk starts here
    prefill_pos: int = 0

    # metrics (timestamps)
    prefill_start: Optional[float] = None
    prefill_end: Optional[float] = None
    finish_time: Optional[float] = None
    decode_exec_time: float = 0.0  # accumulated decode compute time
    n_evictions: int = 0

    @property
    def seq_len(self) -> int:
        return self.input_len + self.generated

    @property
    def max_total_len(self) -> int:
        """Worst-case KV demand (§5.1 eviction-avoidance estimate)."""
        return self.input_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    # ------------------------------------------------------------- metrics
    def input_latency(self) -> Optional[float]:
        if self.prefill_end is None:
            return None
        return self.prefill_end - self.arrival

    def norm_input_latency(self) -> Optional[float]:
        lat = self.input_latency()
        return None if lat is None else lat / max(self.input_len, 1)

    def output_latency(self) -> Optional[float]:
        if self.finish_time is None or self.prefill_end is None:
            return None
        return self.finish_time - self.prefill_end

    def norm_output_latency(self) -> Optional[float]:
        lat = self.output_latency()
        if lat is None or self.generated == 0:
            return None
        return lat / self.generated

    def e2e_latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def norm_e2e_latency(self) -> Optional[float]:
        lat = self.e2e_latency()
        if lat is None:
            return None
        return lat / max(self.seq_len, 1)
