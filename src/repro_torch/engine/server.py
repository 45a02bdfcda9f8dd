"""Serving engines: event-driven iteration loop over elastic instances.

`BaseServingEngine` owns the clock, the event queue, the distributed KV pool,
the SIB and metrics; `LoongServeEngine` drives it with the four-step global
manager (ESP). Baselines (`repro_torch.baselines`, copies of the
reference's) subclass the same loop so the comparison is apples-to-apples: identical
cost model, pool accounting and request lifecycle — only the policy
differs.

Two compute modes:
  * sim  — tokens are synthetic; iteration durations come from the SIB
           analytical model (the paper's own scheduling signal). This scales
           to paper-sized workloads (Fig. 10-12) on CPU.
  * real — a model actually prefills/decodes on the engine's device (the
           card, or the CPU when the caller names it); KV tensors flow
           through the pools exactly as the plans dictate.

Fault tolerance: `fail_instance` drops an instance and its KV shards.
Affected requests are SALVAGED where possible — surviving instances' KV
stays registered, only the dead rank's stripe is re-prefilled by a recovery
chain, and the request resumes at its cursor (elastic scale-down as the
fault path; `RecoveryState`/`_try_salvage`) — with full prefill recompute
as the fallback; `join_instance` adds fresh capacity; `checkpoint`/`restore`
snapshot the full serving state including in-flight unified chains.
Elasticity is the recovery mechanism (DESIGN.md §7).
"""
from __future__ import annotations

import heapq
import itertools
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.request import Phase, Request
from repro_torch.kvcache.distributed import DistributedKVPool
from repro_torch.kvcache.pool import OutOfSlots
from repro_torch.manager.scheduler import (
    DecodeBatch,
    GlobalManager,
    ManagerConfig,
    PrefillBatch,
    UnifiedWork,
)
from repro_torch.manager.sib import SIB, HardwareSpec


@dataclass
class EngineMetrics:
    finished: List[Request] = field(default_factory=list)
    rejected: int = 0
    scaling_migration_bytes: int = 0  # ESP transitions: MUST stay 0
    reactive_migration_bytes: int = 0
    prefill_iters: int = 0
    decode_iters: int = 0
    # degradation-path counters (observability for planner/pool divergence
    # and the chaos soak's determinism fingerprint)
    dropped_migrations: int = 0  # planner-requested moves the pool refused
    dispatch_retries: int = 0  # transient dispatch faults absorbed by retry
    dispatch_declared_failures: int = 0  # retry budget exhausted -> failure
    nan_quarantined: int = 0  # poisoned-logit requests requeued
    preemptions: int = 0  # decode-OOM evictions (victim or self)
    recomputed_tokens: int = 0  # previously-computed tokens lost + re-prefilled
    salvaged_tokens: int = 0  # computed tokens retained in place by fault salvage
    backpressure_deferrals: int = 0  # scheduling rounds that deferred admits

    def summary(self) -> Dict[str, float]:
        fin = [r for r in self.finished if r.finish_time is not None]
        out: Dict[str, float] = {
            "n_finished": len(fin),
            "rejected": self.rejected,
            "scaling_migration_bytes": self.scaling_migration_bytes,
            "reactive_migration_bytes": self.reactive_migration_bytes,
            "prefill_iters": self.prefill_iters,
            "decode_iters": self.decode_iters,
            "dropped_migrations": self.dropped_migrations,
            "dispatch_retries": self.dispatch_retries,
            "dispatch_declared_failures": self.dispatch_declared_failures,
            "nan_quarantined": self.nan_quarantined,
            "preemptions": self.preemptions,
            "recomputed_tokens": self.recomputed_tokens,
            "salvaged_tokens": self.salvaged_tokens,
            "backpressure_deferrals": self.backpressure_deferrals,
        }
        if fin:
            for name, fn in [
                ("norm_e2e", lambda r: r.norm_e2e_latency()),
                ("norm_input", lambda r: r.norm_input_latency()),
                ("norm_output", lambda r: r.norm_output_latency()),
            ]:
                vals = [fn(r) for r in fin if fn(r) is not None]
                if vals:
                    out[f"{name}_mean"] = float(np.mean(vals))
                    out[f"{name}_p90"] = float(np.percentile(vals, 90))
            span = max(r.finish_time for r in fin) - min(r.arrival for r in fin)
            toks = sum(r.seq_len for r in fin)
            out["throughput_tok_s"] = toks / max(span, 1e-9)
        return out

    def snapshot(self) -> Dict[str, float]:
        """`summary()` plus derived recovery efficiency: `salvage_ratio` is
        the fraction of failure-touched computed KV that was retained in
        place instead of re-prefilled (1.0 = every failure was absorbed by
        pure scale-down resume, 0.0 = every failure fell back to full
        recompute; 0.0 also when no failure touched any computed KV)."""
        out = self.summary()
        denom = self.salvaged_tokens + self.recomputed_tokens
        out["salvage_ratio"] = self.salvaged_tokens / denom if denom else 0.0
        return out


@dataclass
class RecoveryState:
    """Per-request elastic fault-recovery bookkeeping (DESIGN.md §7).

    A SALVAGING request keeps its surviving KV shards registered in the
    pools; ``spans`` are the dead rank's *computed* stripe runs, consumed
    front-to-back by the recovery chain's hole chunks (a span start is the
    chunk start, so positions below it are fully covered — the unified
    PREFIX partial reads the salvaged pages).  ``expected`` is the
    allocated-coverage target ({0..expected-1}; the lost positions are
    re-reserved on survivors at salvage time, so invariant I3 validates
    this declared coverage during the relaxation window).  When the spans
    drain, ``resume_decode`` requests re-enter DECODE at their cursor
    (RESUMING -> running, no token emitted); mid-prefill requests simply
    continue frontier chunking."""

    spans: List[Tuple[int, int]]
    expected: int
    resume_decode: bool
    salvaged: int


_event_seq = itertools.count()

#: bumped whenever the checkpoint layout changes incompatibly; `restore()`
#: refuses stamps it does not understand instead of dying mid-unpickle later
CHECKPOINT_FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint could not be restored: missing file, truncated/corrupt
    pickle, or an incompatible format version.  The message always names the
    offending path (and both versions on a mismatch)."""


class BaseServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        n_instances: int,
        capacity_per_instance: int,
        *,
        hw: Optional[HardwareSpec] = None,
        store_values: bool = False,
        model=None,
        params=None,
        seed: int = 0,
        page_size: int = 1,
        admission_watermark: float = 0.0,
        dispatch_max_retries: int = 3,
        dispatch_backoff: float = 1e-3,
    ):
        self.cfg = cfg
        self.n = n_instances
        self.capacity = capacity_per_instance
        self.page_size = page_size
        self.pool = DistributedKVPool(cfg, n_instances, capacity_per_instance,
                                      store_values, page_size)
        self.sib = SIB(cfg, hw)
        self.clock = 0.0
        self.pending: List[Request] = []
        self.events: List[Tuple[float, int, str, Any]] = []
        self.busy_until: Dict[int, float] = {i: 0.0 for i in range(n_instances)}
        self.failed: Set[int] = set()
        self.metrics = EngineMetrics()
        self.model = model
        self.params = params
        self.real = model is not None
        self.rng = np.random.default_rng(seed)
        self._req_index: Dict[int, Request] = {}
        # admission backpressure: defer NEW prefills while fleet-wide free
        # slots sit below this fraction of alive capacity (0 = disabled) —
        # decode keeps draining and frees slots instead of the scheduler
        # admitting prompts that would immediately OOM-preempt
        self.admission_watermark = admission_watermark
        # bounded retry-with-backoff on TransientDispatchError before the
        # dispatching instance is declared failed
        self.dispatch_max_retries = dispatch_max_retries
        self.dispatch_backoff = dispatch_backoff
        # dedicated deterministic stream for dispatch-backoff jitter: drawing
        # from `self.rng` would shift the sim token stream (and the chaos
        # monkey owns its own rng), so same-seed replay stays bit-for-bit
        self._backoff_rng = np.random.default_rng([seed, 0xBAC0FF])
        # rid -> RecoveryState for requests whose failure was absorbed by
        # KV salvage + scale-down resume instead of full recompute
        self._recovering: Dict[int, RecoveryState] = {}
        # observers called as hook(engine, kind, payload) after EVERY handled
        # event (chaos injection, invariant sanitizer, tracing)
        self.event_hooks: List[Any] = []
        # rids whose NEXT logits row is overwritten with NaN (chaos
        # injection); the value guard moves them into _quarantine
        self._logit_poison: Set[int] = set()
        # rids whose last logits were non-finite: requeued for recompute at
        # the next completion processing instead of emitting garbage
        self._quarantine: Set[int] = set()

    # ----------------------------------------------------------- submission
    def submit(self, req: Request, at: Optional[float] = None) -> None:
        t = req.arrival if at is None else at
        req.arrival = t
        cap_total = self.capacity * (self.n - len(self.failed))
        if req.max_total_len > cap_total:
            self.metrics.rejected += 1
            return
        self._push(t, "arrival", req)
        self._req_index[req.rid] = req

    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self.events, (t, next(_event_seq), kind, payload))

    # ------------------------------------------------------------ main loop
    def _has_live_work(self) -> bool:
        """Unfinished work that scheduling could still advance (subclasses
        extend with their own queues)."""
        return bool(self.pending)

    def _next_horizon(self) -> Optional[float]:
        """Earliest future time an alive instance frees up, or None.  Under
        normal operation every busy interval is backed by a queued completion
        event; this differs only when busy_until was inflated externally
        (straggler injection, backoff charges)."""
        ts = [
            t for i, t in self.busy_until.items()
            if i not in self.failed and t > self.clock and t != float("inf")
        ]
        return min(ts, default=None)

    def run(self, max_time: float = float("inf"), max_events: int = 2_000_000):
        n_ev = 0
        while n_ev < max_events:
            if not self.events:
                # liveness: the queue drained but live work remains (e.g. a
                # straggler-inflated busy_until with no completion event
                # behind it, or a stalled instance-less decode group).  Tick
                # forward to the next idle horizon and re-enter scheduling
                # instead of abandoning unfinished requests.
                t = self._next_horizon()
                if t is None or t > max_time or not self._has_live_work():
                    break
                self._push(t, "tick", None)
            t, seq, kind, payload = heapq.heappop(self.events)
            if t > max_time:
                # keep the event for a later run()/restore
                heapq.heappush(self.events, (t, seq, kind, payload))
                break
            self.clock = max(self.clock, t)
            with obs.span("engine.step"):
                self._handle(kind, payload)
                for hook in list(self.event_hooks):
                    hook(self, kind, payload)
            n_ev += 1
        return self.metrics

    def _handle(self, kind: str, payload: Any) -> None:
        if kind == "arrival":
            self.pending.append(payload)
            payload.phase = Phase.PENDING
        elif kind == "prefill_done":
            self._on_prefill_done(payload)
        elif kind == "decode_done":
            self._on_decode_done(payload)
        elif kind == "unified_done":
            self._on_unified_done(payload)
        elif kind == "fail":
            self._apply_failure(payload)
        elif kind == "join":
            self._apply_join(payload)
        if (
            kind == "arrival"
            and self.events
            and self.events[0][0] <= self.clock
            and self.events[0][2] == "arrival"
        ):
            # same-instant arrival burst: defer planning until the last
            # arrival of the burst so the whole burst is admitted in ONE
            # scheduling pass (one prefill batch / one decode group) instead
            # of planning after each arrival with a partial view
            return
        with obs.span("engine.schedule", len(self.pending)):
            self._try_schedule()

    # hooks ------------------------------------------------------------
    def _try_schedule(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _on_prefill_done(self, batch) -> None:  # pragma: no cover
        raise NotImplementedError

    def _on_decode_done(self, batch) -> None:  # pragma: no cover
        raise NotImplementedError

    def _on_unified_done(self, work) -> None:  # pragma: no cover
        raise NotImplementedError

    # ------------------------------------------------------------- helpers
    def idle_instances(self) -> List[int]:
        return [
            i
            for i in range(self.n)
            if i not in self.failed and self.busy_until[i] <= self.clock + 1e-12
        ]

    def _occupy(self, instances: Sequence[int], until: float) -> None:
        for i in instances:
            self.busy_until[i] = until

    def _finish_request(self, req: Request) -> None:
        req.phase = Phase.FINISHED
        req.finish_time = self.clock
        self.pool.free_request(req.rid)
        self.metrics.finished.append(req)

    def _sample_token(self, logits=None) -> int:
        """One row's token: greedy over a host logits row, or a random draw
        without one (sim mode).  Real-mode executors sample on the device
        (`executor.greedy_ids`) unless this is replaced."""
        if logits is None:
            return int(self.rng.integers(0, self.cfg.vocab_size))
        return int(np.argmax(logits))

    # -------------------------------------------------- fault tolerance API
    def fail_instance(self, inst: int, at: Optional[float] = None) -> None:
        self._push(at if at is not None else self.clock, "fail", inst)

    def join_instance(self, inst: int, at: Optional[float] = None) -> None:
        self._push(at if at is not None else self.clock, "join", inst)

    def _requeue_for_recompute(self, req: Request,
                               lost: Optional[int] = None) -> None:
        """Evicted-KV recovery: the request re-enters prefill over everything
        generated so far.  The emitted tokens become part of the new prompt
        (in real mode literally, so the recompute reproduces the exact
        sequence) and move from the generation budget into the input — KV
        accounting stays exact (seq_len == recomputed prompt + new tokens,
        no double count of the folded prefix).

        ``lost`` is the recompute charge: previously-COMPUTED tokens whose
        KV is being discarded.  Defaults to the full computed span —
        ``seq_len`` for decode-phase requests, the chunk cursor for
        mid-prefill ones — minus any spans a fault salvage already charged
        (its surviving `RecoveryState` holes were never recomputed)."""
        if lost is None:
            rec = self._recovering.get(req.rid)
            if rec is not None:
                base = rec.expected if rec.resume_decode else req.prefill_pos
                lost = max(base - sum(e - s for s, e in rec.spans), 0)
            elif req.phase is Phase.DECODE:
                lost = req.seq_len
            else:
                lost = req.prefill_pos
        self.metrics.recomputed_tokens += lost
        self._recovering.pop(req.rid, None)
        req.n_evictions += 1
        req.phase = Phase.PENDING
        if req.prompt is not None and len(req.prompt) < req.seq_len:
            need = req.seq_len - len(req.prompt)
            req.prompt = list(req.prompt) + list(req.output_tokens[-need:])
        req.input_len = req.seq_len  # recompute over everything so far
        req.max_new_tokens -= req.generated  # folded tokens are input now
        req.generated = 0
        req.prefill_end = None
        req.prefill_pos = 0  # unified chunk cursor restarts with the prefill

    def _apply_failure(self, inst: int) -> None:
        self.failed.add(inst)
        self.busy_until[inst] = float("inf")
        # KV shards on the instance are lost.  Elastic fault recovery first
        # (`_try_salvage`, engine-specific): survivors keep their shards of
        # an affected request registered and only the dead rank's stripe is
        # re-prefilled by a recovery chain.  Requests salvage cannot cover
        # fall back to full recompute (generated prefix becomes part of the
        # new prompt).
        affected = list(self.pool.pools[inst].requests())
        salvaged: List[Request] = []
        for rid in affected:
            req = self._req_index.get(rid)
            if (
                req is not None
                and req.phase is not Phase.FINISHED
                and self._try_salvage(req, inst)
            ):
                salvaged.append(req)
                continue
            self.pool.free_request(rid)
            if req is None or req.phase in (Phase.FINISHED,):
                continue
            self._requeue_for_recompute(req)
            if req not in self.pending:
                self.pending.append(req)
        keep = {r.rid for r in salvaged}
        self._drop_request_state([rid for rid in affected if rid not in keep])
        if salvaged:
            self._launch_recovery(salvaged)

    def _try_salvage(self, req: Request, inst: int) -> bool:
        """Attempt KV salvage + scale-down resume for one request affected
        by the failure of `inst`.  Base engines (the baselines) have no
        recovery chain — always full recompute."""
        return False

    def _launch_recovery(self, reqs: List[Request]) -> None:
        """Launch the recovery chain for this failure event's salvaged
        requests (engine-specific; unreachable while `_try_salvage` says
        no)."""
        raise NotImplementedError

    def _apply_join(self, inst: int) -> None:
        if inst in self.failed:
            self.failed.discard(inst)
            self.busy_until[inst] = self.clock
        elif inst >= self.n:  # truly new instance: grow the registry
            for j in range(self.n, inst + 1):
                self.pool.pools.append(
                    type(self.pool.pools[0])(
                        self.cfg, self.capacity, j,
                        self.pool.pools[0].store_values, self.page_size,
                    )
                )
                self.busy_until[j] = self.clock
            self.n = inst + 1

    def _drop_request_state(self, rids: Sequence[int]) -> None:
        """Subclasses drop any per-request runtime state for re-queued rids."""

    # ------------------------------------------------------- checkpointing
    def checkpoint(self, path: str) -> None:
        state = {
            "format_version": CHECKPOINT_FORMAT_VERSION,
            "clock": self.clock,
            "pending": self.pending,
            "events": self.events,
            "busy_until": self.busy_until,
            "failed": self.failed,
            "metrics": self.metrics,
            "req_index": self._req_index,
            "pool_state": [p.state_dict() for p in self.pool.pools],
            "extra": self._checkpoint_extra(),
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def restore(self, path: str) -> None:
        try:
            with open(path, "rb") as f:
                state = pickle.load(f)
        except FileNotFoundError as e:
            raise CheckpointError(f"checkpoint not found: {path}") from e
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ImportError) as e:
            raise CheckpointError(
                f"checkpoint {path} is truncated or corrupt: {e}"
            ) from e
        if not isinstance(state, dict) or "format_version" not in state:
            raise CheckpointError(
                f"checkpoint {path} carries no format-version stamp "
                "(pre-versioned or foreign file) — refusing to restore"
            )
        got = state["format_version"]
        if got != CHECKPOINT_FORMAT_VERSION:
            raise CheckpointError(
                f"checkpoint {path} has format version {got}, this engine "
                f"supports {CHECKPOINT_FORMAT_VERSION}"
            )
        missing = {
            "clock", "pending", "events", "busy_until", "failed", "metrics",
            "req_index", "pool_state",
        } - set(state)
        if missing:
            raise CheckpointError(
                f"checkpoint {path} is missing keys {sorted(missing)}"
            )
        self.clock = state["clock"]
        self.pending = state["pending"]
        self.events = state["events"]
        self.busy_until = state["busy_until"]
        self.failed = state["failed"]
        self.metrics = state["metrics"]
        self._req_index = state["req_index"]
        for p, ps in zip(self.pool.pools, state["pool_state"]):
            p.load_state_dict(ps)
        # transient injection state never survives a restore
        self._logit_poison.clear()
        self._quarantine.clear()
        self._restore_extra(state.get("extra"))

    def _checkpoint_extra(self) -> Any:
        return None

    def _restore_extra(self, extra: Any) -> None:
        pass


# ======================================================================= ESP


class LoongServeEngine(BaseServingEngine):
    """The paper's system: ESP + four-step global manager.

    Real-mode compute is delegated to an executor (engine/executor.py):
    `LocalExecutor` runs the in-process packed/paged paths on ``device``
    (``"cuda"`` by default; real-mode construction raises when no CUDA
    device is present, and tests pass ``device="cpu"`` explicitly).  A
    sim-mode engine holds no tensors: it resolves no device (``device`` is
    None) and runs anywhere, as the reference's does.  `MeshExecutor`
    (``executor="mesh"`` or an explicit ``mesh=``, a ("data", "model")
    `DeviceMesh` from `launch.mesh`) runs the SPMD programs across the
    processes of a `torch.distributed` world — NCCL on ``cuda``, gloo on
    ``cpu`` — every rank running this engine in lockstep.  The engine
    itself holds NO kernel dispatch — only scheduling, lifecycle and
    accounting."""

    def __init__(self, *args, mcfg: Optional[ManagerConfig] = None,
                 executor: Optional[str] = None, mesh=None,
                 device="cuda", **kwargs):
        from repro_torch.device import resolve_device

        super().__init__(*args, **kwargs)
        self.device = resolve_device(device) if self.real else None
        self.manager = GlobalManager(self.cfg, self.sib, self.pool,
                                     mcfg or ManagerConfig())
        self.ready_decode: List[DecodeBatch] = []
        self._real_cache: Dict[int, Any] = {}  # rid -> recurrent state (real)
        self._pending_kv: Dict[int, Any] = {}  # rid -> new kv awaiting alloc
        self._running_decode_ends: Dict[int, float] = {}  # gid -> end time
        self._decode_launch_seq: Dict[int, Dict[int, int]] = {}  # gid -> rid -> seq
        self._prefill_launch_epoch: Dict[int, Dict[int, int]] = {}  # bid -> rid -> n_evictions
        # rids currently riding an in-flight unified chain (prefill chunks
        # or interleaved decode rows): the scheduler must not launch them in
        # a parallel decode group while the chain owns their iteration
        self._in_unified: Set[int] = set()
        # in-flight chains (id(work) -> the UnifiedWork): decode groups
        # overlapping one wait in `ready_decode` for the chain's next chunk
        # boundary and ride the fused iteration instead of launching a
        # competing standalone iteration on the same instances; the failure
        # path reaches in-flight rider groups through it for sub-mesh
        # re-formation, and checkpoints round-trip it
        self._active_unified: Dict[int, UnifiedWork] = {}
        self.executor = None
        if self.real:
            from repro_torch.engine.executor import LocalExecutor, MeshExecutor

            if mesh is not None or executor == "mesh":
                self.executor = MeshExecutor(self, mesh)
            else:
                assert executor in (None, "local"), executor
                self.executor = LocalExecutor(self)

    # ------------------------------------------------------------- schedule
    def _has_live_work(self) -> bool:
        return bool(self.pending) or bool(self.ready_decode)

    def _backpressured(self) -> bool:
        """Admission backpressure watermark: True while fleet-wide free KV
        slots sit below `admission_watermark` × alive capacity.  New prefills
        are deferred (the pending queue is hidden from the planner) so the
        decode fleet drains and frees slots, instead of admitting prompts
        that would immediately bounce off the pool and OOM-preempt running
        requests."""
        if self.admission_watermark <= 0.0:
            return False
        alive = [
            p for p in self.pool.pools if p.instance_id not in self.failed
        ]
        total = sum(p.capacity for p in alive)
        free = sum(p.free_slots for p in alive)
        return free < self.admission_watermark * total

    def _try_schedule(self) -> None:
        obs.mark("engine.admitted", self._schedule_rounds())

    def _schedule_rounds(self) -> int:
        """Plan and launch until nothing more fits; returns the requests
        moved into prefill."""
        admitted = 0
        for rnd in range(4):  # drain: admit more work onto leftover instances
            idle = [
                i
                for i in self.idle_instances()
                if not any(i in g.instances for g in self.ready_decode)
            ]
            if rnd == 0 and not idle and self.pending:
                obs.mark("engine.no_idle", len(self.pending))
            if not idle and not self.ready_decode:
                return admitted
            if not self.pending and not self.ready_decode:
                return admitted
            self.pending.sort(key=lambda r: r.arrival)
            pending_view = self.pending
            if pending_view and self._backpressured():
                self.metrics.backpressure_deferrals += 1
                pending_view = []
                if not self.ready_decode:
                    return admitted
            plan = self.manager.schedule(
                pending_view, self.ready_decode, idle, self.clock
            )
            if not plan.prefill and pending_view:
                # second-chance admission at the iteration boundary: groups
                # sitting in `ready_decode` are BETWEEN iterations right
                # now, so their instances are legal placement targets for a
                # pending prompt the strictly-idle pass could not admit
                # (iteration-level continuous batching).  The sequential
                # path stalls the stripped groups for the whole monolithic
                # prefill; the unified path fuses them into the chain as
                # riders instead.  Safe to discard the first plan: a plan
                # with no prefill batches reserved nothing in the pool.
                boundary = [
                    i for i in self.idle_instances() if i not in idle
                ]
                if boundary:
                    # delay-execution's premise ("wait for busy instances
                    # to free up") is already satisfied at the boundary —
                    # don't let it defer the retry a second time
                    saved = self.manager.mcfg.enable_delay_execution
                    self.manager.mcfg.enable_delay_execution = False
                    try:
                        retry = self.manager.schedule(
                            pending_view, self.ready_decode,
                            idle + boundary, self.clock,
                        )
                    finally:
                        self.manager.mcfg.enable_delay_execution = saved
                    if retry.prefill:
                        plan = retry
            if not plan.prefill and not plan.decode and not plan.migrations:
                return admitted
            self._execute_plan(plan)
            admitted += sum(len(b.requests) for b in plan.prefill)
        return admitted

    def _execute_plan(self, plan) -> None:
        # migrations (allocation-step KV moves — reactive, counted)
        mig_delay: Dict[int, float] = {}
        for m in plan.migrations:
            try:
                moved = self.pool.migrate_request(m.rid, m.src, m.dsts)
            except OutOfSlots:
                # planner/pool divergence: the move it asked for no longer
                # fits — drop it (the request keeps serving from `src`) but
                # COUNT it so the divergence is observable in summary()
                self.metrics.dropped_migrations += 1
                continue
            self.metrics.reactive_migration_bytes += moved
            t = self.sib.migration_time(m.n_tokens)
            mig_delay[m.src] = mig_delay.get(m.src, 0.0) + t

        # prefill batches
        for b in plan.prefill:
            for r in b.requests:
                if r in self.pending:
                    self.pending.remove(r)
                r.phase = Phase.PREFILL
                r.prefill_pos = 0
                if r.prefill_start is None:
                    r.prefill_start = self.clock
            if self._unified_eligible(b):
                # unified continuous batching: instead of annexing the decode
                # groups' instances for one long prefill (stalling their
                # token flow), FUSE the groups that would stall — instance
                # overlap or already stalled — into a chain of chunked
                # prefill+decode iterations
                fused = [
                    g for g in self.ready_decode
                    if set(g.instances) & set(b.instances) or not g.instances
                ]
                for g in fused:
                    self.ready_decode.remove(g)
                for g in self.ready_decode:
                    g.instances = [
                        i for i in g.instances if i not in b.instances
                    ]
                mig = max(
                    (mig_delay.get(i, 0.0) for i in b.instances), default=0.0
                )
                self._launch_unified(UnifiedWork(b, fused), extra_delay=mig)
                continue
            # drop annexed instances from stalled ready groups
            for g in self.ready_decode:
                g.instances = [i for i in g.instances if i not in b.instances]
            lens = [r.input_len for r in b.requests]
            dur = self.sib.prefill_time(b.dop, lens, b.instances)
            dur += max((mig_delay.get(i, 0.0) for i in b.instances), default=0.0)
            end = self.clock + dur
            self._occupy(b.instances, end)
            self.metrics.prefill_iters += 1
            # launch-time eviction-epoch stamp: prefill_done uses it to drop
            # requests requeued (and possibly re-prefilled) by an in-flight
            # fail_instance — their reserved placement slots are gone
            self._prefill_launch_epoch[id(b)] = {
                r.rid: r.n_evictions for r in b.requests
            }
            self._push(end, "prefill_done", b)

        # decode batches (one iteration each; greedy execution emerges from
        # faster groups re-entering the queue sooner)
        launched = []
        soonest_end = min(self._running_decode_ends.values(), default=None)
        # instances a prefill batch of THIS plan occupies: the manager built
        # plan.decode before the annexation above stripped the ready groups,
        # so mirror the strip on the fresh plan copies — an annexed group
        # must stall (or ride the unified chain), not relaunch alongside
        # the prefill on the instances it just lost
        taken = {i for pb in plan.prefill for i in pb.instances}
        for g in plan.decode:
            if taken:
                g.instances = [i for i in g.instances if i not in taken]
            if not g.instances:
                continue  # stalled (preempted) — retried next round
            if any(r.rid in self._in_unified for r in g.requests):
                continue  # riding an in-flight unified chain this iteration
            if any(
                set(g.instances) & set(w.alive_instances(self.failed))
                for w in self._active_unified.values()
            ):
                # a unified chain owns (some of) these instances: hold the
                # group in ready_decode so the chain absorbs it at its next
                # chunk boundary instead of racing a standalone iteration
                continue
            sum_kv = sum(r.seq_len for r in g.requests)
            dur = self.sib.decode_time(
                g.dop, len(g.requests), sum_kv, g.instances
            )
            # batch-consolidation hold: if another decode group finishes
            # within a fraction of our iteration, wait and merge with it at
            # that boundary (shared weight read; zero-copy under multi-master)
            if (
                soonest_end is not None
                and soonest_end - self.clock < 0.3 * dur
            ):
                continue
            end = self.clock + dur
            self._occupy(g.instances, end)
            for r in g.requests:
                r.decode_exec_time += dur
            self.metrics.decode_iters += 1
            self._running_decode_ends[id(g)] = end
            # launch-time sequence stamp: decode_done uses it to tell "still
            # this iteration's request" from "requeued by a failure and
            # already recomputed into a new group" (seq_len is monotone and
            # only moves when a prefill/decode completion is processed)
            self._decode_launch_seq[id(g)] = {r.rid: r.seq_len for r in g.requests}
            self._push(end, "decode_done", g)
            launched.append(g)
        for g in launched:
            for rg in list(self.ready_decode):
                if set(r.rid for r in rg.requests) & set(
                    r.rid for r in g.requests
                ):
                    self.ready_decode.remove(rg)

    # ------------------------------------------------- dispatch fault paths
    def _dispatch_with_retry(self, fn, instances: List[int],
                             point: str) -> bool:
        """Run one executor dispatch with bounded retry-with-backoff on
        `TransientDispatchError` (chaos-injected or a genuinely flaky
        backend).  The raise happens at the dispatch guard BEFORE any compute
        or KV write, so retrying is side-effect-free.  Each retry charges
        exponential backoff to the group's instances in sim-clock time.  On
        budget exhaustion the first alive instance of the group is declared
        failed (routing through the normal `_apply_failure` requeue path) and
        False is returned — the caller requeues whatever that did not
        cover."""
        from repro_torch.kernels import ops  # the port's fault seam

        for attempt in range(self.dispatch_max_retries + 1):
            try:
                ops.check_fault(point + "_dispatch")
                fn()
                return True
            except ops.TransientDispatchError:
                if attempt == self.dispatch_max_retries:
                    break
                self.metrics.dispatch_retries += 1
                pause = self.dispatch_backoff * (2 ** attempt)
                for i in instances:
                    if i not in self.failed:
                        # seeded jitter in [0.5, 1.5) per instance so
                        # simultaneous retries across a group don't
                        # resynchronize into a retry storm; the dedicated
                        # stream keeps same-seed chaos replay bit-for-bit
                        jitter = 0.5 + self._backoff_rng.random()
                        self.busy_until[i] = (
                            max(self.busy_until[i], self.clock) + pause * jitter
                        )
        self.metrics.dispatch_declared_failures += 1
        victim = next((i for i in instances if i not in self.failed), None)
        if victim is not None:
            self._apply_failure(victim)
        return False

    def _drain_quarantine(self, requests: List[Request]) -> List[Request]:
        """Remove NaN-quarantined requests from `requests`, requeueing ONLY
        those for recompute (the rest of the batch is untouched).  Returns
        the surviving requests."""
        poisoned = [r for r in requests if r.rid in self._quarantine]
        if not poisoned:
            return requests
        for r in poisoned:
            self._quarantine.discard(r.rid)
            self.metrics.nan_quarantined += 1
            self._pending_kv.pop(r.rid, None)
            self.pool.free_request(r.rid)
            self._requeue_for_recompute(r)
            if r not in self.pending:
                self.pending.append(r)
        self._drop_request_state([r.rid for r in poisoned])
        return [r for r in requests if r.rid not in {
            p.rid for p in poisoned
        }]

    # --------------------------------------------------------- prefill done
    def _on_prefill_done(self, batch: PrefillBatch) -> None:
        # graceful in-flight failure (mirror of _on_decode_done): requests
        # requeued by a fail_instance between this batch's launch and now
        # lost their reserved placement slots — drop them (the epoch stamp
        # also catches ones already relaunched and back in PREFILL phase).
        epoch = self._prefill_launch_epoch.pop(id(batch), None)
        alive = []
        for r in batch.requests:
            if r.phase is not Phase.PREFILL or (
                epoch is not None and epoch.get(r.rid) != r.n_evictions
            ):
                continue
            if self._placement_lost(batch, r):
                # part of the reserved placement sits on a failed instance
                # (normally _apply_failure already requeued the request; this
                # catches the post-restore case where the epoch stamp was
                # dropped): scattering would silently skip the dead shard and
                # leave partial KV — requeue for recompute instead, mirroring
                # decode_done's stamp check.
                self.pool.free_request(r.rid)
                self._requeue_for_recompute(r)
                if r not in self.pending:
                    self.pending.append(r)
                continue
            alive.append(r)
        if len(alive) < len(batch.requests):
            batch.requests = alive
            batch.instances = [i for i in batch.instances if i not in self.failed]
            batch.scale_down_to = [
                i for i in batch.scale_down_to if i not in self.failed
            ]
            if not alive:
                return
        # proactive scale-down: KV lands in the already-reserved slots of the
        # target group during the ring pass — ZERO migration bytes.
        if self.real:
            ok = self._dispatch_with_retry(
                lambda: self._real_prefill(batch), batch.instances, "prefill"
            )
            if not ok:
                # the prefill never ran: its reserved placement holds no
                # written KV — requeue every request still in PREFILL (ones
                # whose slots sat on the declared-failed instance were
                # already requeued by _apply_failure)
                for r in batch.requests:
                    if r.phase is Phase.PREFILL:
                        self.pool.free_request(r.rid)
                        self._requeue_for_recompute(r)
                        if r not in self.pending:
                            self.pending.append(r)
                return
            # NaN guard tripped inside the executor: quarantined requests
            # got no sampled token — requeue ONLY them, keep the batch
            batch.requests = self._drain_quarantine(batch.requests)
            if not batch.requests:
                return
        for r in batch.requests:
            r.prefill_end = self.clock
            r.phase = Phase.DECODE
            r.generated += 1  # prefill emits the first token
            if not self.real:
                r.output_tokens.append(self._sample_token())
        done = [r for r in batch.requests if r.done]
        live = [r for r in batch.requests if not r.done]
        for r in done:
            self._finish_request(r)
            if r.norm_output_latency():
                self.manager.note_finished_decode(r.norm_output_latency())
        if live:
            # always drop failed instances: an instance can die mid-flight
            # while holding none of this batch's KV, in which case the
            # alive-filter above never rebuilt the instance list — a dead
            # member here would get prefill slots reserved on it next round
            insts = [i for i in batch.scale_down_to if i not in self.failed]
            masters = (
                self.manager._assign_masters(live, insts) if insts else {}
            )
            self.ready_decode.append(DecodeBatch(live, insts, masters))

    # -------------------------------------------- unified continuous batching
    def _unified_eligible(self, b: PrefillBatch) -> bool:
        """A prefill batch runs as a unified chunked chain when the knob is
        set, the executor has the fused path, and every prompt is
        materialized (chunk packing slices real token ids)."""
        return (
            self.real
            and self.manager.mcfg.prefill_chunk_tokens is not None
            and self.executor is not None
            and getattr(self.executor, "supports_unified", False)
            and all(
                r.prompt is not None and len(r.prompt) == r.input_len
                for r in b.requests
            )
        )

    def _pending_spans(self, r: Request) -> List[Tuple[int, int]]:
        """Ascending token spans this request still needs computed: a
        recovering request's lost holes first (each must fully fill before
        any later chunk runs, so prefix coverage below a chunk start stays
        complete), then — unless it resumes straight into decode — the
        normal prefill frontier ``[prefill_pos, input_len)``."""
        rec = self._recovering.get(r.rid)
        spans: List[Tuple[int, int]] = list(rec.spans) if rec is not None else []
        if (
            (rec is None or not rec.resume_decode)
            and r.prefill_pos < r.input_len
        ):
            spans.append((r.prefill_pos, r.input_len))
        return spans

    def _next_chunks(self, work: UnifiedWork) -> Dict[int, Tuple[int, int]]:
        """Chunk schedule for ONE chain link: walk the batch in order giving
        each unfinished prompt its next contiguous slice until the
        ``prefill_chunk_tokens`` budget runs out (the first prompt always
        gets at least one token, so the chain advances).  A recovering
        request's next slice comes from its first lost hole instead of the
        frontier cursor (at most one hole span per request per link).  A
        recovery chain on an engine without the chunking knob runs each
        span whole."""
        budget = self.manager.mcfg.prefill_chunk_tokens
        budget = max(int(budget), 1) if budget is not None else (1 << 30)
        chunks: Dict[int, Tuple[int, int]] = {}
        for r in work.batch.requests:
            spans = self._pending_spans(r)
            if not spans:
                continue
            if budget <= 0 and chunks:
                break
            start, end = spans[0]
            ln = min(end - start, max(budget, 1))
            chunks[r.rid] = (start, ln)
            budget -= ln
        return chunks

    def _launch_unified(self, work: UnifiedWork,
                        extra_delay: float = 0.0) -> None:
        """Launch one link of a unified chain: recompute the chunk schedule
        from the cursors, charge one fused iteration (chunked-prefill time +
        one decode iteration for the riders) to the union of instances, and
        stamp BOTH launch-consistency maps — the prefill eviction epochs and
        the decode seq stamps guard the same completion event."""
        work.chunks = self._next_chunks(work)
        b = work.batch
        insts = work.alive_instances(self.failed)
        dop = max(len(insts), 1)
        dur = extra_delay
        clens = [ln for _, ln in work.chunks.values()]
        if clens:
            dur += self.sib.prefill_time(dop, clens, insts)
        dreqs = [r for g in work.groups for r in g.requests]
        if dreqs:
            ddur = self.sib.decode_time(
                dop, len(dreqs), sum(r.seq_len for r in dreqs), insts
            )
            for r in dreqs:
                r.decode_exec_time += ddur
            dur += ddur
            self.metrics.decode_iters += 1
        end = self.clock + dur
        self._occupy(insts, end)
        self.metrics.prefill_iters += 1
        self._prefill_launch_epoch[id(work)] = {
            r.rid: r.n_evictions for r in b.requests
        }
        self._decode_launch_seq[id(work)] = {r.rid: r.seq_len for r in dreqs}
        self._running_decode_ends[id(work)] = end
        for r in b.requests:
            self._in_unified.add(r.rid)
        for r in dreqs:
            self._in_unified.add(r.rid)
        self._active_unified[id(work)] = work
        self._push(end, "unified_done", work)

    def _on_unified_done(self, work: UnifiedWork) -> None:
        """Completion of one chain link: run the fused executor step, apply
        BOTH sides' completion processing (prefill cursor advance + decode
        token placement), then either launch the next link (prompts still
        mid-prefill) or dissolve the chain back into `ready_decode`."""
        self._running_decode_ends.pop(id(work), None)
        self._active_unified.pop(id(work), None)
        launch_seq = self._decode_launch_seq.pop(id(work), None)
        epoch = self._prefill_launch_epoch.pop(id(work), None)
        for g in work.groups:
            for r in g.requests:
                self._in_unified.discard(r.rid)
        b = work.batch
        alive = []
        for r in b.requests:
            self._in_unified.discard(r.rid)
            # the same in-flight-failure filters as _on_prefill_done
            if r.phase is not Phase.PREFILL or (
                epoch is not None and epoch.get(r.rid) != r.n_evictions
            ):
                continue
            if self._placement_lost(b, r):
                self.pool.free_request(r.rid)
                self._requeue_for_recompute(r)
                if r not in self.pending:
                    self.pending.append(r)
                continue
            alive.append(r)
        b.requests = alive
        b.instances = [i for i in b.instances if i not in self.failed]
        b.scale_down_to = [i for i in b.scale_down_to if i not in self.failed]
        # the same stale-completion filters as _on_decode_done
        groups = []
        for g in work.groups:
            galive = [
                r for r in g.requests
                if r.phase is Phase.DECODE
                and (launch_seq is None or launch_seq.get(r.rid) == r.seq_len)
            ]
            if galive:
                groups.append(DecodeBatch(
                    galive, [i for i in g.instances if i not in self.failed],
                    g.masters,
                ))
        work.groups = groups
        work.chunks = {
            r.rid: work.chunks[r.rid]
            for r in b.requests if r.rid in work.chunks
        }
        if not b.requests and not groups:
            return
        insts = work.alive_instances(self.failed)
        # sim-mode chains exist only as recovery chains (salvage works on
        # pool bookkeeping alone); there is no executor to dispatch
        ok = True
        if self.real:
            ok = self._dispatch_with_retry(
                lambda: self._real_unified(work), insts, "unified"
            )
        if not ok:
            # the fused step never ran: requeue the chunked prompts for
            # recompute and send surviving riders back to the ready queue
            for r in b.requests:
                if r.phase is Phase.PREFILL:
                    self.pool.free_request(r.rid)
                    self._requeue_for_recompute(r)
                    if r not in self.pending:
                        self.pending.append(r)
            for g in groups:
                live = [r for r in g.requests if r.phase is Phase.DECODE]
                if live:
                    self.ready_decode.append(DecodeBatch(
                        live, [i for i in g.instances if i not in self.failed],
                        g.masters,
                    ))
            return
        # ---- prefill side: advance cursors; completed prompts join decode
        chunked = [r for r in b.requests if r.rid in work.chunks]
        survivors = self._drain_quarantine(chunked)
        completed = []
        recovered = []
        for r in survivors:
            start, ln = work.chunks[r.rid]
            rec = self._recovering.get(r.rid)
            if rec is not None and rec.spans and rec.spans[0][0] == start:
                # hole chunk: consume the lost span, not the frontier
                # cursor — salvaged KV above the hole is already in place
                _, e0 = rec.spans[0]
                if start + ln >= e0:
                    rec.spans.pop(0)
                else:
                    rec.spans[0] = (start + ln, e0)
                if not rec.spans:
                    self._recovering.pop(r.rid, None)
                    if rec.resume_decode:
                        # coverage is whole again: RESUMING -> running.
                        # The request re-enters decode AT its cursor; hole
                        # chunks never sample, so no token is emitted here
                        r.phase = Phase.DECODE
                        recovered.append(r)
                continue
            r.prefill_pos = start + ln
            if r.prefill_pos >= r.input_len:
                self._recovering.pop(r.rid, None)
                r.prefill_end = self.clock
                r.phase = Phase.DECODE
                r.generated += 1  # the fused step emitted the first token
                if not self.real:
                    r.output_tokens.append(self._sample_token())
                completed.append(r)
        for r in [q for q in completed if q.done]:
            self._finish_request(r)
            if r.norm_output_latency():
                self.manager.note_finished_decode(r.norm_output_latency())
        new_dec = [r for r in completed if not r.done]
        # ---- decode side: the standard completion epilogue, per group
        out_groups = []
        for g in groups:
            live = self._decode_epilogue(g)
            if live is not None:
                out_groups.append(live)
        if new_dec:
            insts_nd = [i for i in b.scale_down_to if i not in self.failed]
            masters = (
                self.manager._assign_masters(new_dec, insts_nd)
                if insts_nd else {}
            )
            out_groups.append(DecodeBatch(new_dec, insts_nd, masters))
        if recovered:
            # resumed decode requests re-form as a group on the surviving
            # sub-mesh (DoP-1): they ride the chain's next link as riders
            # or dissolve into `ready_decode` with it
            insts_rec = [i for i in b.instances if i not in self.failed]
            masters = (
                self.manager._assign_masters(recovered, insts_rec)
                if insts_rec else {}
            )
            out_groups.append(DecodeBatch(recovered, insts_rec, masters))
        # ---- continue the chain while any prompt is mid-prefill
        remaining = [r for r in b.requests if r.phase is Phase.PREFILL]
        if remaining:
            b.requests = remaining
            work.groups = [g for g in out_groups if g.requests]
            # continuous batching at the chunk boundary: decode groups that
            # became ready since the last link and would stall on (or
            # overlap) this chain's instances ride the next iteration
            insts = set(work.alive_instances(self.failed))
            for g in list(self.ready_decode):
                if set(g.instances) & insts or not g.instances:
                    self.ready_decode.remove(g)
                    work.groups.append(g)
            self._launch_unified(work)
        else:
            self.ready_decode.extend(g for g in out_groups if g.requests)

    # ---------------------------------------------------------- decode done
    def _placement_order(self, r: Request, g: DecodeBatch) -> List[int]:
        """KV-append probe order for one decoded token: the request's master
        first, then the rest of the decode group, then any other live
        instance — each instance exactly once (a rid missing from
        `g.masters` must not probe `g.instances[0]` twice)."""
        master = g.masters.get(r.rid, g.instances[0] if g.instances else None)
        order = [master] if master is not None else []
        order += [i for i in g.instances if i != master]
        order += [
            i for i in range(self.n)
            if i not in g.instances and i != master
        ]
        return [i for i in order if i not in self.failed]

    def _try_place_token(self, r: Request, g: DecodeBatch, pos: int,
                         fills: Dict[int, list]) -> bool:
        """Append one decoded token's KV slot on the first instance in the
        request's placement order with room; real mode also queues the
        pending KV in `fills` (instance -> rows) for the epilogue to write
        through."""
        for inst in self._placement_order(r, g):
            try:
                self.pool.pools[inst].alloc(r.rid, [pos])
            except OutOfSlots:
                continue
            if self.real and r.rid in self._pending_kv:
                k_new, v_new = self._pending_kv.pop(r.rid)
                fills.setdefault(inst, []).append((r.rid, [pos], k_new, v_new))
            return True
        return False

    def _oom_victim(self, exclude: Set[int]) -> Optional[Request]:
        """Decode-OOM preemption policy: pick the DECODE-phase request that
        loses the least work — fewest generated tokens, youngest arrival and
        highest rid as tiebreaks — never one in `exclude`."""
        cands = [
            q for rid, q in self._req_index.items()
            if q.phase is Phase.DECODE and rid not in exclude
        ]
        if not cands:
            return None
        return min(cands, key=lambda q: (q.generated, -q.arrival, -q.rid))

    def _preempt_and_place(self, r: Request, g: DecodeBatch, pos: int,
                           fills: Dict[int, list]) -> bool:
        """Free pool space for `r`'s token append by evicting victims
        (lowest-progress first) and retrying placement.  Victims are never
        taken from the group currently being processed — their tokens for
        this iteration are already committed.  A victim mid-flight in
        another launched group is safe: its launch stamp no longer matches
        after recompute, so the stale completion is dropped."""
        exclude = {q.rid for q in g.requests}
        for _ in range(4):
            victim = self._oom_victim(exclude)
            if victim is None:
                return False
            exclude.add(victim.rid)
            self.metrics.preemptions += 1
            self._pending_kv.pop(victim.rid, None)
            self.pool.free_request(victim.rid)
            self._requeue_for_recompute(victim)
            if victim not in self.pending:
                self.pending.append(victim)
            self._drop_request_state([victim.rid])
            # purge the victim from waiting groups (mirrors _apply_failure)
            for gg in list(self.ready_decode):
                gg.requests = [
                    q for q in gg.requests if q.phase is Phase.DECODE
                ]
                if not gg.requests:
                    self.ready_decode.remove(gg)
            if self._try_place_token(r, g, pos, fills):
                return True
        return False

    def _on_decode_done(self, g: DecodeBatch) -> None:
        self._running_decode_ends.pop(id(g), None)
        # graceful in-flight failure: a `fail_instance` landing between this
        # group's launch and now freed some requests' KV and re-queued them
        # to PENDING — skip those (and dead instances) instead of tripping
        # the decode paths' KV-coverage assert.  The launch-time seq stamp
        # additionally rejects requests that were requeued AND already
        # recomputed into a fresh group before this stale completion fired
        # (their seq_len moved on) — without it they would be decoded twice.
        launch_seq = self._decode_launch_seq.pop(id(g), None)
        alive = [
            r for r in g.requests
            if r.phase is Phase.DECODE
            and (launch_seq is None or launch_seq.get(r.rid) == r.seq_len)
        ]
        if len(alive) < len(g.requests):
            if not alive:
                return
            g = DecodeBatch(
                alive, [i for i in g.instances if i not in self.failed],
                g.masters,
            )
        if self.real:
            ok = self._dispatch_with_retry(
                lambda: self._real_decode(g), g.instances, "decode"
            )
            if not ok:
                # the iteration never ran (raise precedes any KV write):
                # surviving members simply go back to the ready queue — a
                # group left with no alive instances is revived by the
                # scheduler's stalled-group path
                live = [r for r in g.requests if r.phase is Phase.DECODE]
                insts = [i for i in g.instances if i not in self.failed]
                if live:
                    self.ready_decode.append(DecodeBatch(live, insts, g.masters))
                return
        else:
            # sim mode: poison short-circuits to the same quarantine path
            # the real-mode value guard feeds
            for r in g.requests:
                if r.rid in self._logit_poison:
                    self._logit_poison.discard(r.rid)
                    self._quarantine.add(r.rid)
        live = self._decode_epilogue(g)
        if live is not None:
            self.ready_decode.append(live)

    def _decode_epilogue(self, g: DecodeBatch) -> Optional[DecodeBatch]:
        """Post-compute half of a decode completion: quarantine drain, token
        accounting, per-token KV placement (with OOM preemption), finishes.
        Returns the surviving group for the caller to requeue — the plain
        decode path appends it to `ready_decode`; the unified chain carries
        it into its next fused iteration instead."""
        with obs.span("engine.decode_epilogue", len(g.requests)):
            survivors = self._drain_quarantine(g.requests)
            if not survivors:
                return None
            if len(survivors) < len(g.requests):
                g = DecodeBatch(survivors, g.instances, g.masters)
            done, live = [], []
            fills: Dict[int, list] = {}  # instance -> new KV rows to write
            for r in g.requests:
                # the processed token's position (its KV is appended now)
                pos = r.seq_len - 1
                r.generated += 1
                if not self.real:
                    r.output_tokens.append(self._sample_token())
                if r.done:
                    # the final token's KV is never attended — don't burn a
                    # slot (and never requeue a finished request on
                    # fleet-wide OOM)
                    self._pending_kv.pop(r.rid, None)
                    done.append(r)
                    continue
                placed = self._try_place_token(r, g, pos, fills)
                if not placed:
                    # fleet-wide OOM: preempt the youngest/lowest-progress
                    # decode request(s) OUTSIDE this group and retry, so work
                    # already deep into generation is not the one thrown away
                    placed = self._preempt_and_place(r, g, pos, fills)
                if not placed:
                    # no preemptable victim either: self-evict & requeue
                    self.metrics.preemptions += 1
                    self._pending_kv.pop(r.rid, None)
                    self.pool.free_request(r.rid)
                    self._requeue_for_recompute(r)
                    self.pending.append(r)
                    continue
                (done if r.done else live).append(r)
            for inst, rows in fills.items():
                self.pool.pools[inst].fill_rows(rows)
            for r in done:
                self._finish_request(r)
                if r.norm_output_latency():
                    self.manager.note_finished_decode(r.norm_output_latency())
                self._real_cache.pop(r.rid, None)
            if not live:
                return None
            # always re-filter failed instances (an instance that died
            # mid-flight holding none of this group's KV is not caught by
            # the alive-filter above)
            return DecodeBatch(
                live, [i for i in g.instances if i not in self.failed],
                g.masters,
            )

    # ----------------------------------------------------------- real compute
    # Thin dispatch only: the bodies live in engine/executor.py behind the
    # LocalExecutor/MeshExecutor seam.  The `_real_*` names are kept as the
    # stable probe points benchmarks and tests drive directly.
    def _real_prefill(self, batch: PrefillBatch) -> None:
        return self.executor.prefill(batch)

    def _real_prefill_packed(self, batch: PrefillBatch) -> None:
        return self.executor.prefill_packed(batch)

    def _real_prefill_serial(self, batch: PrefillBatch) -> None:
        return self.executor.prefill_serial(batch)

    def _real_decode(self, g: DecodeBatch) -> None:
        return self.executor.decode(g)

    def _real_decode_paged(self, g: DecodeBatch) -> None:
        return self.executor.decode_paged(g)

    def _real_decode_serial(self, g: DecodeBatch) -> None:
        return self.executor.decode_serial(g)

    def _real_unified(self, work: UnifiedWork) -> None:
        return self.executor.unified(work)

    def _placement_lost(self, batch: PrefillBatch, r: Request) -> bool:
        """True when part of the request's reserved KV placement sits on a
        failed instance — its prefill KV could only be scattered partially."""
        return any(
            pos_list and inst in self.failed
            for inst, pos_list in batch.placement.get(r.rid, {}).items()
        )

    def _apply_join(self, inst: int) -> None:
        super()._apply_join(inst)
        # newly-grown pools need their mirror pinned to a data-shard device
        # under the mesh executor (no-op for LocalExecutor)
        if self.executor is not None and hasattr(self.executor, "_bind_pool_devices"):
            self.executor._bind_pool_devices()

    # ------------------------------------------------ elastic fault recovery
    def _try_salvage(self, req: Request, inst: int) -> bool:
        """Elastic fault recovery (the paper's zero-migration scale-down
        repurposed as the failure path): keep the surviving instances' KV
        shards of `req` registered, re-reserve the dead rank's positions on
        the survivors, and register a `RecoveryState` whose lost *computed*
        spans the recovery chain re-prefills as hole chunks.  Recovery cost
        is proportional to the lost stripe, not the request length.

        Returns False — meaning the caller falls back to full recompute —
        when nothing computed survives, when the request is already
        mid-recovery (a double failure), when real mode lacks the unified
        chunk machinery that drives hole re-prefill, or when the survivors
        cannot hold the lost stripe."""
        rid = req.rid
        if rid in self._recovering:
            return False  # second failure mid-recovery: full recompute
        if req.phase is Phase.DECODE:
            expected = req.seq_len - 1  # stored KV: positions 0..seq_len-2
            cursor = expected
            resume_decode = True
        elif req.phase is Phase.PREFILL and req.prefill_pos > 0:
            expected = req.input_len
            cursor = req.prefill_pos  # positions >= cursor: reserved, unfilled
            resume_decode = False
        else:
            return False  # nothing computed yet: requeueing loses nothing
        if self.real and not (
            self.executor is not None
            and getattr(self.executor, "supports_unified", False)
            and req.prompt is not None
            and len(req.prompt) == req.input_len
        ):
            return False  # span re-prefill runs through the unified path
        plan = self.pool.salvage_placement(rid, expected, self.failed)
        filled = sum(int((p < cursor).sum()) for p in plan.coverage.values())
        if filled == 0:
            return False
        lost = [p for s, e in plan.lost_spans for p in range(s, e)]
        alive = [
            i for i in range(min(self.n, len(self.pool.pools)))
            if i not in self.failed
        ]
        try:
            repl = (
                self.pool.plan_placement(rid, lost, alive) if lost else None
            )
        except OutOfSlots:
            return False  # survivors can't absorb the stripe
        # ---- commit: the request is SALVAGING from here on
        self.pool.pools[inst].free_request(rid)
        if repl is not None:
            # immediate re-reservation keeps the allocated coverage exactly
            # {0..expected-1} throughout recovery (what relaxed I3 checks)
            self.pool.place_salvage(repl)
        self._detach_from_inflight(rid)
        holes = [(s, min(e, cursor)) for s, e in plan.lost_spans if s < cursor]
        self.metrics.salvaged_tokens += filled
        self.metrics.recomputed_tokens += sum(e - s for s, e in holes)
        req.phase = Phase.PREFILL
        self._recovering[rid] = RecoveryState(
            spans=holes, expected=expected,
            resume_decode=resume_decode, salvaged=filled,
        )
        return True

    def _detach_from_inflight(self, rid: int) -> None:
        """Hand ownership of `rid`'s next iteration to the recovery chain:
        delete it from every in-flight launch stamp so stale completions of
        already-queued links/groups drop it (`.get(rid)` mismatches) instead
        of advancing its cursor or decoding it a second time."""
        for stamp in itertools.chain(
            self._decode_launch_seq.values(),
            self._prefill_launch_epoch.values(),
        ):
            stamp.pop(rid, None)
        self._in_unified.discard(rid)
        self._pending_kv.pop(rid, None)

    def _launch_recovery(self, reqs: List[Request]) -> None:
        """One recovery chain per failure event: the salvaged requests
        re-form on the surviving sub-mesh (the union of instances still
        holding their KV — the old group minus the dead rank, DoP-1) and
        resume at their span/chunk cursors through the ordinary unified
        chain machinery.  The batch placement is the live coverage map, so
        hole-chunk KV scatters into the re-reserved slots."""
        placement = {
            r.rid: {
                i: pos.tolist()
                for i, pos in self.pool.coverage_map(
                    r.rid, self.failed
                ).items()
            }
            for r in reqs
        }
        insts = sorted({i for cov in placement.values() for i in cov})
        if not insts:  # unreachable while _try_salvage demands coverage
            for r in reqs:
                self.pool.free_request(r.rid)
                self._requeue_for_recompute(r)
                if r not in self.pending:
                    self.pending.append(r)
            return
        b = PrefillBatch(reqs, insts, insts, placement)
        # failure can land mid-iteration: queue the chain behind whatever
        # the surviving instances are already busy with
        extra = max(
            (max(0.0, self.busy_until[i] - self.clock) for i in insts),
            default=0.0,
        )
        self._launch_unified(UnifiedWork(b, []), extra_delay=extra)

    def _promote_masters(self, g: DecodeBatch) -> None:
        """Master promotion: requests whose KV-append master died get a
        fresh master among the group's surviving instances."""
        orphans = [
            r for r in g.requests if g.masters.get(r.rid) in self.failed
        ]
        if orphans and g.instances:
            g.masters.update(
                self.manager._assign_masters(orphans, g.instances)
            )

    def _apply_failure(self, inst: int) -> None:
        super()._apply_failure(inst)
        # drop the failed instance's device KV mirror (a full pool-sized
        # copy) — it will be rebuilt from scratch if the instance rejoins
        if inst < len(self.pool.pools):
            self.pool.pools[inst].drop_mirror()
        # evict compiled programs / mesh-cache entries that bake in the
        # dead instance: surviving groups re-form at DoP-1 and compile
        # fresh reduced-DoP programs on the sub-mesh
        if self.executor is not None:
            self.executor.on_instance_failed(inst)
        # purge requeued (now-PENDING/-PREFILL) requests and the dead
        # instance from waiting decode groups so they are not scheduled
        # with freed KV; promote masters the failure orphaned
        for g in list(self.ready_decode):
            g.requests = [r for r in g.requests if r.phase is Phase.DECODE]
            g.instances = [i for i in g.instances if i not in self.failed]
            if not g.requests:
                self.ready_decode.remove(g)
                continue
            self._promote_masters(g)
        # in-flight chains: rider groups re-form on the surviving sub-mesh
        # at their next link (the chain itself filters alive instances at
        # every launch)
        for w in self._active_unified.values():
            for g in w.groups:
                g.instances = [i for i in g.instances if i not in self.failed]
                self._promote_masters(g)

    def _drop_request_state(self, rids) -> None:
        for rid in rids:
            self._real_cache.pop(rid, None)

    def _checkpoint_extra(self):
        # launch-time consistency state is keyed by id() of the in-flight
        # payload objects; persist it keyed by the OBJECTS themselves — the
        # single pickle.dump shares identity with the copies inside
        # `events`, so `_restore_extra` can rebuild the id()-keyed maps
        # against the restored heap and an in-flight unified chain RESUMES
        # at its chunk cursors instead of restarting
        stamped = [
            p for _, _, kind, p in self.events
            if kind in ("prefill_done", "decode_done", "unified_done")
        ]
        return {
            "ready_decode": self.ready_decode,
            "in_unified": set(self._in_unified),
            "recovering": dict(self._recovering),
            "launch_stamps": [
                (
                    p,
                    self._prefill_launch_epoch.get(id(p)),
                    self._decode_launch_seq.get(id(p)),
                    self._running_decode_ends.get(id(p)),
                    id(p) in self._active_unified,
                )
                for p in stamped
            ],
        }

    def _restore_extra(self, extra) -> None:
        self._running_decode_ends = {}
        self._decode_launch_seq = {}
        self._prefill_launch_epoch = {}
        self._in_unified = set()
        self._active_unified = {}
        self._recovering = {}
        if not extra:
            return
        self.ready_decode = extra["ready_decode"]
        self._in_unified = set(extra.get("in_unified", ()))
        self._recovering = dict(extra.get("recovering", {}))
        for p, epoch, seq, end, active in extra.get("launch_stamps", ()):
            if epoch is not None:
                self._prefill_launch_epoch[id(p)] = epoch
            if seq is not None:
                self._decode_launch_seq[id(p)] = seq
            if end is not None:
                self._running_decode_ends[id(p)] = end
            if active:
                self._active_unified[id(p)] = p
