"""Seeded chaos harness: deterministic fault injection for the serving loop.

The port's copy of `repro/chaos.py` (numpy only; it drives the port's
engine through `repro_torch.kernels.ops.set_fault_hook`, and the port
imports nothing of the reference package).

`ChaosMonkey` drives the engine's failure machinery the way a hostile
cluster would — but reproducibly: every decision comes from one
`np.random.default_rng(seed)` stream, so the same (seed, workload, rates)
triple replays the exact same event trace, making failure semantics
regression-testable (tests/test_torch_chaos.py asserts trace + metrics
equality with the reference's harness).

Injectors (each armed by a nonzero rate in `ChaosConfig`):

  * fail / rejoin storms — `fail_instance` on a random alive instance
    (never below `min_alive`), `join_instance` on a random failed one.
    Every observed failure is audited post-hoc (salvage-aware): the dead
    pool must be drained and each request in the engine's salvage-recovery
    window must hold exactly its declared coverage on the survivors;
    `salvage_ratio()` reports salvaged/(salvaged+recomputed) over the soak;
  * stragglers — stretch a busy instance's remaining `busy_until` interval
    by a random multiplier (the scheduler routes around it), optionally
    degrading its persistent SIB speed;
  * memory pressure — allocate "ballast" pages on a random pool under a
    reserved NEGATIVE rid (chaos-owned: the invariant sanitizer recognises
    rid < 0), shrinking effective capacity; released randomly and fully at
    `disarm()`;
  * transient dispatch faults — a raising hook installed into
    `kernels/ops.set_fault_hook`: each guarded dispatch point may raise
    `TransientDispatchError` (never more than `fault_burst` in a row, so
    faults stay transient and bounded retry can always succeed);
  * NaN-poisoned logits — mark a random in-flight DECODE request's next
    emission poisoned (`engine._logit_poison`): the real-mode executor
    overwrites that request's logits row with NaN before the value guard
    sees it, sim mode short-circuits to the same quarantine path.

Arming appends an event hook (`engine.event_hooks`) that fires after every
handled event; injections push ordinary engine events or mutate documented
engine state, so the serving loop under chaos is the SAME loop as
production — no special-cased control flow.

`disarm()` heals the cluster for quiescence: clears the fault hook, stops
injecting, releases all ballast, rejoins every failed instance and clears
pending poison, so a post-chaos `run()` can drain to completion ("all
submitted requests eventually complete").
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.engine.request import Phase
from repro_torch.kernels import ops
from repro_torch.kvcache.pool import OutOfSlots

# chaos ballast rids are negative and engine request rids are
# itertools.count() >= 0 — the two namespaces never collide
_ballast_rid = itertools.count(start=-1, step=-1)


@dataclass
class ChaosConfig:
    """Per-event injection rates (probabilities drawn once per handled
    engine event) + bounds.  All rates default to 0 (injector disarmed)."""

    fail_rate: float = 0.0
    rejoin_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_mult: Tuple[float, float] = (1.5, 8.0)
    slowdown_rate: float = 0.0  # persistent SIB speed degradation
    pressure_rate: float = 0.0  # ballast alloc
    release_rate: float = 0.0  # ballast free
    ballast_frac: float = 0.25  # max fraction of one pool per ballast grab
    dispatch_fault_rate: float = 0.0  # per guarded dispatch point
    fault_burst: int = 2  # max consecutive faults (keeps them transient)
    nan_rate: float = 0.0
    min_alive: int = 1
    max_injections: Optional[int] = None  # stop injecting after N actions


class ChaosMonkey:
    """Deterministic, seeded fault injector for one engine."""

    def __init__(self, engine, config: ChaosConfig, seed: int = 0):
        self.eng = engine
        self.cfg = config
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.trace: List[Tuple[Any, ...]] = []  # (event#, action, *args)
        self.n_events = 0
        self.n_injections = 0
        self._armed = False
        self._fault_streak = 0
        self._ballast: Dict[int, Tuple[int, int]] = {}  # rid -> (inst, n)

    # ------------------------------------------------------------- lifecycle
    def arm(self) -> None:
        assert not self._armed
        self._armed = True
        self.eng.event_hooks.append(self._on_event)
        if self.cfg.dispatch_fault_rate > 0:
            ops.set_fault_hook(self._fault_hook)

    def disarm(self) -> None:
        """Stop injecting and heal the cluster so the loop can drain."""
        if self._on_event in self.eng.event_hooks:
            self.eng.event_hooks.remove(self._on_event)
        ops.set_fault_hook(None)
        self._armed = False
        for rid in list(self._ballast):
            # fleet-wide free: defense in depth should anything have moved
            # ballast off its recorded instance
            self.eng.pool.free_request(rid)
        self._ballast.clear()
        eng = self.eng
        if hasattr(eng, "_logit_poison"):
            eng._logit_poison.clear()
        for inst in sorted(eng.failed):
            eng.join_instance(inst, at=eng.clock)
            self.trace.append((self.n_events, "heal_join", inst))

    # ------------------------------------------------------------- injectors
    def _alive(self) -> List[int]:
        return [i for i in range(self.eng.n) if i not in self.eng.failed]

    def _log(self, action: str, *args) -> None:
        self.n_injections += 1
        self.trace.append((self.n_events, action) + args)

    def _on_event(self, eng, kind, payload) -> None:
        self.n_events += 1
        # salvage-aware failure audit: hooks fire AFTER the event is
        # handled, so a "fail" event is observed post-`_apply_failure` —
        # the dead pool must be empty (shards either salvaged off it or
        # freed for recompute) and every request inside the recovery
        # window must hold exactly its declared coverage on survivors.
        # Pure asserts: no rng draws, so the trace stays seed-aligned.
        if kind == "fail" and payload in eng.failed:
            inst = payload
            leftover = list(eng.pool.pools[inst].requests())
            assert not leftover, (
                f"chaos: failed instance {inst} still holds rids {leftover}"
            )
            for rid, rec in getattr(eng, "_recovering", {}).items():
                held = eng.pool.request_tokens(rid)
                assert held == rec.expected, (
                    f"chaos: recovering rid {rid} holds {held} tokens "
                    f"fleet-wide, declared coverage {rec.expected}"
                )
        cfg = self.cfg
        if (
            cfg.max_injections is not None
            and self.n_injections >= cfg.max_injections
        ):
            return
        rng = self.rng
        # one draw per injector per event keeps the stream alignment
        # independent of which branches fire
        draws = rng.random(6)

        alive = self._alive()
        if draws[0] < cfg.fail_rate and len(alive) > cfg.min_alive:
            inst = int(rng.choice(alive))
            eng.fail_instance(inst, at=eng.clock)
            self._log("fail", inst)

        if draws[1] < cfg.rejoin_rate and eng.failed:
            inst = int(rng.choice(sorted(eng.failed)))
            eng.join_instance(inst, at=eng.clock)
            self._log("rejoin", inst)

        if draws[2] < cfg.straggler_rate:
            busy = [
                i for i in self._alive()
                if eng.busy_until[i] > eng.clock
            ]
            if busy:
                inst = int(rng.choice(busy))
                lo, hi = cfg.straggler_mult
                mult = float(rng.uniform(lo, hi))
                eng.busy_until[inst] = eng.clock + (
                    eng.busy_until[inst] - eng.clock
                ) * mult
                self._log("straggle", inst, round(mult, 3))

        if draws[3] < cfg.slowdown_rate:
            alive = self._alive()
            if alive:
                inst = int(rng.choice(alive))
                speed = float(rng.uniform(0.25, 1.0))
                eng.sib.set_instance_speed(inst, speed)
                self._log("slowdown", inst, round(speed, 3))

        if draws[4] < cfg.pressure_rate:
            self._grab_ballast()
        elif draws[4] < cfg.pressure_rate + cfg.release_rate and self._ballast:
            rid = sorted(self._ballast)[-1]
            inst, n = self._ballast.pop(rid)
            eng.pool.free_request(rid)  # fleet-wide (see disarm)
            self._log("release", inst, n)

        if draws[5] < cfg.nan_rate:
            decoding = sorted(
                rid for rid, r in eng._req_index.items()
                if r.phase is Phase.DECODE
            )
            if decoding and hasattr(eng, "_logit_poison"):
                rid = int(rng.choice(decoding))
                eng._logit_poison.add(rid)
                # log the victim's run-relative index, not its absolute rid:
                # rids come from a process-global counter, so two identical
                # runs in one process disagree on them — the fingerprint
                # must depend only on seeded decisions
                self._log("poison", sorted(eng._req_index).index(rid))

    def _grab_ballast(self) -> None:
        eng = self.eng
        alive = self._alive()
        if not alive:
            return
        inst = int(self.rng.choice(alive))
        pool = eng.pool.pools[inst]
        cap = max(int(self.cfg.ballast_frac * pool.capacity), pool.page_size)
        n = int(self.rng.integers(pool.page_size, cap + 1))
        rid = next(_ballast_rid)
        try:
            pool.alloc(rid, list(range(n)))
        except OutOfSlots:
            self._log("pressure_oom", inst, n)
            return
        self._ballast[rid] = (inst, n)
        self._log("pressure", inst, n)

    # ------------------------------------------------------------ fault hook
    def _fault_hook(self, point: str) -> None:
        """Installed into ops.set_fault_hook: raise at the executors'
        per-batch dispatch guards ("prefill_dispatch"/"decode_dispatch" —
        side-effect-free raise points), never more than `fault_burst` in a
        row so the engine's bounded retry can always make progress."""
        if not point.endswith("_dispatch"):
            return
        if self._fault_streak >= self.cfg.fault_burst:
            self._fault_streak = 0
            return
        if self.rng.random() < self.cfg.dispatch_fault_rate:
            self._fault_streak += 1
            self.trace.append((self.n_events, "dispatch_fault", point))
            raise ops.TransientDispatchError(f"chaos: {point}")
        self._fault_streak = 0

    # --------------------------------------------------------------- queries
    def trace_fingerprint(self) -> Tuple[Tuple[Any, ...], ...]:
        """Hashable trace for equality assertions across runs."""
        return tuple(self.trace)

    def salvage_ratio(self) -> float:
        """Fraction of fault-affected computed tokens retained in place by
        salvage (vs recomputed) over the soak so far — the headline
        recovery-efficiency metric (1.0 = every failure fully salvaged,
        0.0 = every failure fell back to full recompute)."""
        return self.eng.metrics.snapshot()["salvage_ratio"]
