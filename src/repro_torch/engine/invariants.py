"""Engine invariant sanitizer: global-state consistency checks for the
serving loop, run after every event under chaos (see `repro_torch.chaos`).

The port's copy of `repro/engine/invariants.py` (numpy only; the port keeps
its own copy because it imports nothing of the reference package).

The engine's failure semantics are distributed bookkeeping: pool slots,
group membership, launch stamps and per-request token budgets must stay
mutually consistent through ANY interleaving of failures, rejoins,
preemptions, quarantines and memory pressure.  Each check here is an
invariant that holds at event boundaries (after `_handle` returns — i.e.
after the event's completion processing AND the scheduling round it
triggered):

  I1  slot accounting — every rid holding slots on any pool is either a
      live (PREFILL/DECODE) request or chaos ballast (rid < 0); FINISHED /
      PENDING requests hold zero slots anywhere (no leaks after failure,
      preemption, quarantine or finish).
  I2  pool internal consistency — free pages + owned pages == total pages,
      used tokens == Σ per-request tokens == occupied slot_pos entries,
      free-page stack entries unique and disjoint from owned pages.
  I3  KV coverage — a DECODE-phase request stores exactly positions
      {0..seq_len-2} across the fleet, each exactly once (the final emitted
      token's KV is appended at the next decode completion); a PREFILL-phase
      request holds exactly its reserved placement {0..input_len-1}.  A
      request inside the salvage-recovery window (`eng._recovering`)
      instead validates against its DECLARED coverage target
      `RecoveryState.expected` — salvage re-reserves the dead rank's spans
      immediately, so coverage is {0..expected-1} throughout recovery and
      the check snaps back to exact phase-derived coverage the moment the
      recovery chain completes and the rid leaves `_recovering`.
  I4  group sanity — ready_decode groups contain only DECODE-phase
      requests, membership ∩ failed == ∅, and no rid sits in two groups.
  I5  placement liveness — every slot-holding instance of a live request is
      alive (failure handling freed dead shards synchronously).
  I6  transient-state consistency — `_pending_kv` is drained at event
      boundaries; decode launch stamps (`_decode_launch_seq`,
      `_running_decode_ends`) key only in-flight decode_done events and
      mirror each other; prefill epoch stamps key only in-flight
      prefill_done events.
  I7  clock/failure sanity — failed instances are parked at busy_until=inf,
      alive ones finite; pending queue has no duplicate rids.
  I8  token conservation — `max_total_len` (input + remaining budget) is
      constant across evictions/recomputes, emitted tokens == (input_len -
      original input_len) + generated (folded prefixes are counted once),
      and generated never exceeds the remaining budget.

Violations raise `InvariantViolation` with the event context; the checker
is pure read-only over engine state (safe to arm on any engine, sim or
real).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.engine.request import Phase

LIVE_PHASES = (Phase.PREFILL, Phase.DECODE)


class InvariantViolation(AssertionError):
    """An engine global-state invariant does not hold."""


class InvariantChecker:
    """Read-only sanitizer over one engine's global state.

    Arm with `arm()` (registers an event hook: checked after EVERY handled
    event) or call `check()` manually at chosen points.  Per-request token
    baselines (I8) are recorded the first time a rid is seen; arming before
    `run()` makes them exact from arrival.

    ``check_every_n`` samples the armed hook: only every n-th handled event
    runs the full check (long local chaos soaks); CI keeps the default of 1
    (after-every-event).  Manual `check()` calls are never sampled.
    """

    def __init__(self, engine, check_every_n: int = 1):
        assert check_every_n >= 1, check_every_n
        self.eng = engine
        self.check_every_n = check_every_n
        self._event_i = 0
        self.checks = 0
        # rid -> (original input_len, original max_total_len); recorded at
        # first sight (self-consistent even when armed mid-flight: emitted
        # tokens so far == len(output_tokens))
        self._baseline: Dict[int, Tuple[int, int]] = {}

    # ------------------------------------------------------------------ arm
    def arm(self) -> None:
        self.eng.event_hooks.append(self._on_event)

    def disarm(self) -> None:
        if self._on_event in self.eng.event_hooks:
            self.eng.event_hooks.remove(self._on_event)

    def _on_event(self, eng, kind, payload) -> None:
        self._event_i += 1
        if self._event_i % self.check_every_n == 0:
            self.check(context=f"after event {kind!r}")

    # ---------------------------------------------------------------- check
    def _fail(self, inv: str, msg: str, context: str) -> None:
        raise InvariantViolation(
            f"[{inv}] {msg} ({context}; check #{self.checks})"
        )

    def check(self, context: str = "manual") -> None:
        self.checks += 1
        eng = self.eng
        live = {
            rid for rid, r in eng._req_index.items() if r.phase in LIVE_PHASES
        }

        # I1 + I2: per-pool slot accounting ------------------------------
        holders: Dict[int, Dict[int, np.ndarray]] = {}  # rid -> inst -> pos
        for pool in eng.pool.pools:
            owned_pages = 0
            used = 0
            for rid in pool.requests():
                st = pool._reqs[rid]
                owned_pages += st.n_pages
                used += st.n_tok
                if rid >= 0 and rid not in live:
                    r = eng._req_index.get(rid)
                    self._fail(
                        "I1",
                        f"instance {pool.instance_id} holds {st.n_tok} slots "
                        f"of rid {rid} (phase "
                        f"{r.phase if r else 'UNKNOWN'}) — leaked slots",
                        context,
                    )
                if rid >= 0:
                    holders.setdefault(rid, {})[pool.instance_id] = (
                        st.pos[: st.n_tok].copy()
                    )
            if pool._n_free_pages + owned_pages != pool.n_pages:
                self._fail(
                    "I2",
                    f"instance {pool.instance_id}: free pages "
                    f"{pool._n_free_pages} + owned {owned_pages} != total "
                    f"{pool.n_pages}",
                    context,
                )
            if used != pool.used:
                self._fail(
                    "I2",
                    f"instance {pool.instance_id}: used counter {pool.used} "
                    f"!= Σ per-request tokens {used}",
                    context,
                )
            if int((pool.slot_pos >= 0).sum()) != used:
                self._fail(
                    "I2",
                    f"instance {pool.instance_id}: occupied slot_pos "
                    f"{int((pool.slot_pos >= 0).sum())} != used {used}",
                    context,
                )
            free = pool._free_pages[: pool._n_free_pages]
            if len(np.unique(free)) != pool._n_free_pages:
                self._fail(
                    "I2",
                    f"instance {pool.instance_id}: duplicate pages on the "
                    "free stack",
                    context,
                )

        # I3: KV coverage per live request --------------------------------
        recovering = getattr(eng, "_recovering", {})
        for rid, per_inst in holders.items():
            r = eng._req_index[rid]
            pos = np.concatenate(list(per_inst.values()))
            rec = recovering.get(rid)
            if rec is not None:
                # salvage window: validate the DECLARED coverage target —
                # the lost spans were re-reserved at salvage time, so the
                # fleet holds exactly {0..expected-1} until the recovery
                # chain completes (then the rid leaves _recovering and the
                # exact phase-derived rule below applies again)
                expect = rec.expected
            else:
                expect = (
                    r.seq_len - 1 if r.phase is Phase.DECODE else r.input_len
                )
            if len(pos) != expect or (
                len(pos) and not np.array_equal(np.sort(pos),
                                                np.arange(expect))
            ):
                self._fail(
                    "I3",
                    f"rid {rid} ({r.phase.value}, seq_len {r.seq_len}) "
                    f"stores {len(pos)} positions, expected exactly "
                    f"0..{expect - 1} once each",
                    context,
                )

        # I4: ready group sanity ------------------------------------------
        seen_in_group = set()
        for g in getattr(eng, "ready_decode", []):
            dead = set(g.instances) & eng.failed
            if dead:
                self._fail(
                    "I4", f"ready group {g.instances} ∩ failed = {dead}",
                    context,
                )
            for r in g.requests:
                if r.phase is not Phase.DECODE:
                    self._fail(
                        "I4",
                        f"rid {r.rid} in a ready group with phase "
                        f"{r.phase.value}",
                        context,
                    )
                if r.rid in seen_in_group:
                    self._fail(
                        "I4", f"rid {r.rid} in two ready groups", context
                    )
                seen_in_group.add(r.rid)

        # I5: placement liveness ------------------------------------------
        for rid, per_inst in holders.items():
            dead = set(per_inst) & eng.failed
            if dead:
                self._fail(
                    "I5",
                    f"rid {rid} holds KV on failed instance(s) {dead}",
                    context,
                )

        # I6: transient state ----------------------------------------------
        if getattr(eng, "_pending_kv", None):
            self._fail(
                "I6",
                f"_pending_kv not drained: rids {list(eng._pending_kv)}",
                context,
            )
        queued = {}
        for _, _, kind, payload in eng.events:
            queued.setdefault(kind, set()).add(id(payload))
        if hasattr(eng, "_decode_launch_seq"):
            stamps = set(eng._decode_launch_seq)
            ends = set(eng._running_decode_ends)
            if stamps != ends:
                self._fail(
                    "I6", "_decode_launch_seq and _running_decode_ends "
                    "key different launches", context,
                )
            # a unified (fused prefill+decode) launch stamps both maps and
            # completes through a single "unified_done" event
            unified = queued.get("unified_done", set())
            if not stamps <= queued.get("decode_done", set()) | unified:
                self._fail(
                    "I6", "decode launch stamp without an in-flight "
                    "decode_done/unified_done event", context,
                )
            if not set(eng._prefill_launch_epoch) <= (
                queued.get("prefill_done", set()) | unified
            ):
                self._fail(
                    "I6", "prefill epoch stamp without an in-flight "
                    "prefill_done/unified_done event", context,
                )

        # I7: failure/clock sanity -----------------------------------------
        for i in range(eng.n):
            if i in eng.failed and eng.busy_until[i] != float("inf"):
                self._fail(
                    "I7", f"failed instance {i} not parked at inf", context
                )
            if i not in eng.failed and eng.busy_until[i] == float("inf"):
                self._fail(
                    "I7", f"alive instance {i} parked at inf", context
                )
        rids_pending = [r.rid for r in eng.pending]
        if len(set(rids_pending)) != len(rids_pending):
            self._fail("I7", "duplicate rids in the pending queue", context)

        # I8: token conservation --------------------------------------------
        for rid, r in eng._req_index.items():
            base = self._baseline.get(rid)
            if base is None:
                base = self._baseline[rid] = (
                    r.input_len + r.generated - len(r.output_tokens),
                    r.max_total_len,
                )
            input0, budget0 = base
            if r.max_total_len != budget0:
                self._fail(
                    "I8",
                    f"rid {rid}: max_total_len drifted "
                    f"{budget0} -> {r.max_total_len}",
                    context,
                )
            emitted = (r.input_len - input0) + r.generated
            if len(r.output_tokens) != emitted:
                self._fail(
                    "I8",
                    f"rid {rid}: {len(r.output_tokens)} emitted tokens vs "
                    f"(input_len - input0) + generated = {emitted}",
                    context,
                )
            if r.generated > r.max_new_tokens:
                self._fail(
                    "I8",
                    f"rid {rid}: generated {r.generated} exceeds budget "
                    f"{r.max_new_tokens}",
                    context,
                )

    # -------------------------------------------------------------- helpers
    def leaked_slots(self) -> int:
        """Tokens held by non-live, non-ballast rids (0 when I1 holds)."""
        eng = self.eng
        live = {
            rid for rid, r in eng._req_index.items() if r.phase in LIVE_PHASES
        }
        return sum(
            pool._reqs[rid].n_tok
            for pool in eng.pool.pools
            for rid in pool.requests()
            if rid >= 0 and rid not in live
        )
