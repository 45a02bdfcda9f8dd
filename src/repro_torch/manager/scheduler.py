"""LoongServe global manager: the scalable four-step scheduler (§5).

Per iteration:
  1. dispatching   — choose R_p from the pending queue (FCFS with Appendix-A
                     relaxations): GPU-memory constraint incl. future-KV
                     eviction avoidance, compute tipping point, gain/cost
                     preemption analysis (Eq. 1-2);
  2. allocation    — give R_p idle instances first, migrate-to-avoid-preempt,
                     then marginal instances while Gain > Cost (Eq. 3-4);
  3. batching      — DP over (sorted requests x sorted instances) with the
                     monotone-split speedup (Eq. 5-6);
  4. scaling plans — proactive scale-down targets for prefill batches (to the
                     min DoP whose pools fit the KV), decode scale-up on
                     memory pressure or the compute-bound batch threshold,
                     multi-master assignment (§5.4).

The manager is pure decision logic over an `InstanceState` registry + the
distributed pool + SIB — no JAX, so it ports to a multi-controller driver
unchanged (DESIGN.md §2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.request import Phase, Request
from repro_torch.kvcache.distributed import DistributedKVPool
from repro_torch.manager.batching import BatchSplit, dp_batching, make_prefill_cost
from repro_torch.manager.sib import SIB


@dataclass
class PrefillBatch:
    requests: List[Request]
    instances: List[int]  # ESP group (DoP = len)
    scale_down_to: List[int]  # proactive scale-down target R' ⊆ instances
    placement: Dict[int, Dict[int, List[int]]] = field(default_factory=dict)
    # rid -> {instance: [positions]} proactive retention plan

    @property
    def dop(self) -> int:
        return len(self.instances)


@dataclass
class DecodeBatch:
    requests: List[Request]
    instances: List[int]  # parallel group
    masters: Dict[int, int]  # rid -> master instance (multi-master, §4.2)

    @property
    def dop(self) -> int:
        return len(self.instances)


@dataclass
class UnifiedWork:
    """One link of a unified continuous-batching chain: a prefill batch
    advanced chunk-by-chunk (``prefill_chunk_tokens`` per iteration) with
    in-flight decode groups riding the SAME fused iteration, so decode
    tokens keep flowing while a long prompt prefills (the LoongServe
    unified iteration; executed by `Executor.unified`).

    ``chunks`` maps rid -> (start, length): the slice of the request's
    prompt packed THIS iteration (recomputed by the engine per link from
    each request's ``prefill_pos`` cursor).  A batch request absent from
    ``chunks`` waits this iteration (chunk budget exhausted)."""

    batch: PrefillBatch
    groups: List[DecodeBatch] = field(default_factory=list)
    chunks: Dict[int, Tuple[int, int]] = field(default_factory=dict)

    def alive_instances(self, failed) -> List[int]:
        insts = {i for i in self.batch.instances if i not in failed}
        for g in self.groups:
            insts.update(i for i in g.instances if i not in failed)
        return sorted(insts)


@dataclass
class Migration:
    rid: int
    src: int
    dsts: List[int]
    n_tokens: int


@dataclass
class IterationPlan:
    prefill: List[PrefillBatch] = field(default_factory=list)
    decode: List[DecodeBatch] = field(default_factory=list)
    migrations: List[Migration] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)


@dataclass
class ManagerConfig:
    max_num_ooe: int = 8  # Appendix A: bounded out-of-order execution
    enable_ooe: bool = True
    enable_delay_execution: bool = True
    enable_multi_master: bool = True
    max_prefill_batch: int = 64
    future_kv_reserve_frac: float = 0.2  # fraction of max_total_len reserved
    scale_up_batch_threshold: Optional[int] = None  # None -> SIB ridge point
    watermark_frac: float = 0.02  # keep-free watermark per instance
    # unified continuous batching: when set, real-mode prefill batches run
    # as a chain of fused iterations of at most this many prefill tokens
    # each, with in-flight decode groups interleaved into every iteration
    # (decode TBT stays bounded during long-prompt prefill).  None keeps
    # the one-shot packed prefill.
    prefill_chunk_tokens: Optional[int] = None


class GlobalManager:
    def __init__(
        self,
        cfg: ModelConfig,
        sib: SIB,
        pool: DistributedKVPool,
        mcfg: Optional[ManagerConfig] = None,
    ):
        self.cfg = cfg
        self.sib = sib
        self.pool = pool
        self.mcfg = mcfg or ManagerConfig()
        self._ooe_counter = 0
        self._finished_decode_lat: List[float] = []  # AvgLat_d estimator

    # ================================================================ public
    def schedule(
        self,
        pending: List[Request],
        decode_groups: List[DecodeBatch],
        idle_instances: List[int],
        now: float,
        group_busy_until: Optional[Dict[int, float]] = None,
    ) -> IterationPlan:
        plan = IterationPlan()
        group_busy_until = group_busy_until or {}

        # ---- step 1: dispatching --------------------------------------
        rp, preempt_groups = self._dispatch(
            pending, decode_groups, idle_instances, now, group_busy_until
        )

        # ---- step 2: elastic instance allocation ----------------------
        ep = self._allocate(rp, decode_groups, idle_instances, preempt_groups, plan)
        # capacity safety: trim R_p tail until the allocated group can hold
        # every admitted prompt (unified pool semantics apply only inside E_p)
        if rp:
            ep_free = sum(self.pool.pools[i].free_slots for i in ep)
            while rp and sum(r.input_len for r in rp) > ep_free:
                dropped = rp.pop()
                obs.mark("scheduler.trim", dropped.input_len)

        # ---- step 3: batching (DP) ------------------------------------
        batches = self._batch(rp, ep)

        # ---- step 4: elastic scaling plan generation -------------------
        pending_left = any(r not in rp for r in pending)
        self._scaling_plans(
            batches, decode_groups, idle_instances, ep, plan,
            under_load=pending_left,
        )
        return plan

    def note_finished_decode(self, norm_output_latency: float) -> None:
        self._finished_decode_lat.append(norm_output_latency)
        if len(self._finished_decode_lat) > 256:
            self._finished_decode_lat = self._finished_decode_lat[-256:]

    # ========================================================== step 1
    def _avg_lat_d(self) -> float:
        if not self._finished_decode_lat:
            return self.sib.decode_time(1, 1, 1024)
        return sum(self._finished_decode_lat) / len(self._finished_decode_lat)

    def _memory_admissible(self, req: Request, free_now: int,
                           active_future_kv: int) -> bool:
        """§5.1 GPU-memory constraint: room for the prompt now AND a reserve
        against future growth to avoid eviction/recompute."""
        need_now = req.input_len
        reserve = int(self.mcfg.future_kv_reserve_frac * req.max_new_tokens)
        future_reserve = int(
            self.mcfg.future_kv_reserve_frac * active_future_kv
        )
        return need_now + reserve + future_reserve <= free_now

    def _dispatch(
        self, pending, decode_groups, idle_instances, now, busy
    ) -> Tuple[List[Request], List[DecodeBatch]]:
        mcfg = self.mcfg
        rp: List[Request] = []
        preempt_groups: List[DecodeBatch] = []
        free_now = self.pool.total_free
        active_future = sum(
            (r.max_new_tokens - r.generated)
            for g in decode_groups
            for r in g.requests
        )
        idle_dop = max(len(idle_instances), 1)
        tipping = self.sib.prefill_tipping_point(idle_dop)

        skipped_head = False
        stop = None  # why admission stopped short of the queue's end
        for req in list(pending):
            if len(rp) >= mcfg.max_prefill_batch:
                stop = "batch_cap"
                break
            lens = [r.input_len for r in rp] + [req.input_len]
            # compute tipping point (§5.1): stop once the batch saturates
            if rp and self.sib.prefill_time(idle_dop, lens) > tipping:
                stop = "tipping"
                break
            if not self._memory_admissible(req, free_now, active_future):
                # Appendix A: bounded out-of-order execution
                if mcfg.enable_ooe and self._ooe_counter < mcfg.max_num_ooe:
                    skipped_head = True
                    continue
                stop = "memory"
                break
            # Appendix A: delay execution — if waiting for busy instances to
            # free up beats running now on what's idle, postpone.
            if (
                mcfg.enable_delay_execution
                and not rp
                and idle_instances
                and decode_groups
            ):
                t_now = self.sib.prefill_time(idle_dop, [req.input_len])
                all_dop = idle_dop + sum(len(g.instances) for g in decode_groups)
                t_all = self.sib.prefill_time(all_dop, [req.input_len])
                wait = self._avg_lat_d()
                if t_all + wait < t_now:
                    obs.mark("scheduler.delay")
                    stop = "delay"
                    break
            rp.append(req)
            free_now -= req.input_len
        if stop is None and skipped_head:
            stop = "memory"  # the requests left were skipped out of order
        if stop is not None:
            obs.mark(f"scheduler.stop.{stop}")
        self._ooe_counter = self._ooe_counter + 1 if skipped_head else 0

        # gain/cost preemption analysis (Eq. 1-2): consider extending R_p with
        # requests that only fit if a decode group's slots are taken.
        remaining = [r for r in pending if r not in rp]
        if remaining and decode_groups:
            avg_lat_d = self._avg_lat_d()
            for g in decode_groups:
                if not remaining:
                    break
                g_free = sum(
                    self.pool.pools[i].free_slots for i in g.instances
                )
                extra: List[Request] = []
                need = 0
                for r in remaining:
                    if need + r.input_len <= g_free:
                        extra.append(r)
                        need += r.input_len
                if not extra:
                    continue
                ep_lens = [r.input_len for r in rp + extra]
                dop = max(len(idle_instances) + len(g.instances), 1)
                t_joint = self.sib.prefill_time(dop, ep_lens)
                cost = sum(
                    t_joint / max(r.max_new_tokens - r.generated, 1)
                    for r in g.requests
                )  # Eq. 1
                min_exec = min(
                    (r.decode_exec_time for r in g.requests), default=0.0
                )
                gain = sum(
                    max(avg_lat_d - min_exec, 0.0) / max(r.input_len, 1)
                    for r in extra
                )  # Eq. 2
                if gain > cost:
                    rp.extend(extra)
                    remaining = [r for r in remaining if r not in extra]
                    preempt_groups.append(g)
                    obs.mark("scheduler.preempt_group", len(extra))
        return rp, preempt_groups

    # ========================================================== step 2
    def _allocate(
        self, rp, decode_groups, idle_instances, preempt_groups, plan
    ) -> List[int]:
        if not rp:
            return []
        ep: List[int] = list(idle_instances)
        for g in preempt_groups:
            ep.extend(i for i in g.instances if i not in ep)
        need = sum(r.input_len for r in rp)

        def ep_free() -> int:
            return sum(self.pool.pools[i].free_slots for i in ep)

        # preempt instances with the most unused slots; migrate their decode
        # KV away instead of evicting when possible (§5.2)
        # deduped: an instance can transiently sit in two groups (stalled
        # groups under failure churn) — duplicate entries here would emit
        # migrations with duplicate destinations
        decode_insts = list(dict.fromkeys(
            i
            for g in decode_groups
            if g not in preempt_groups
            for i in g.instances
        ))
        candidates = sorted(
            (i for i in decode_insts if i not in ep),
            key=lambda i: -self.pool.pools[i].free_slots,
        )
        while ep_free() < need and candidates:
            inst = candidates.pop(0)
            others = [j for j in decode_insts if j != inst and j not in ep]
            moved_ok = True
            # rid < 0 is foreign occupancy (not engine-owned, e.g. chaos
            # ballast): immovable — plan around it, never migrate it
            movable = [r for r in self.pool.pools[inst].requests() if r >= 0]
            for rid in movable:
                toks = len(self.pool.pools[inst].tokens_of(rid))
                dst_free = sum(self.pool.pools[j].free_slots for j in others)
                if toks > dst_free:
                    moved_ok = False
                    break
            if not moved_ok:
                continue
            for rid in movable:
                toks = len(self.pool.pools[inst].tokens_of(rid))
                plan.migrations.append(Migration(rid, inst, list(others), toks))
            ep.append(inst)
            obs.mark("scheduler.annex")

        # marginal-gain expansion (Eq. 3-4): add e_min while Gain > Cost
        lens = [r.input_len for r in rp]
        while True:
            rest = sorted(
                (i for i in decode_insts if i not in ep),
                key=lambda i: self.pool.pools[i].used,
            )
            if not rest:
                break
            e_min = rest[0]
            d0, d1 = len(ep), len(ep) + 1
            t0 = self.sib.prefill_time(max(d0, 1), lens)
            t1 = self.sib.prefill_time(d1, lens)
            gain = sum((t0 - t1) / max(r.input_len, 1) for r in rp)  # Eq. 3
            v_bytes_tokens = self.pool.pools[e_min].used
            t_mig = self.sib.migration_time(v_bytes_tokens)
            cost = sum(t_mig / max(r.input_len, 1) for r in rp)  # Eq. 4
            if gain <= cost:
                break
            others = [j for j in decode_insts if j != e_min and j not in ep]
            dst_free = sum(self.pool.pools[j].free_slots for j in others)
            if self.pool.pools[e_min].used > dst_free:
                break
            for rid in self.pool.pools[e_min].requests():
                if rid < 0:  # foreign occupancy — immovable
                    continue
                toks = len(self.pool.pools[e_min].tokens_of(rid))
                plan.migrations.append(Migration(rid, e_min, list(others), toks))
            ep.append(e_min)
            obs.mark("scheduler.annex_e_min")
        return ep

    # ========================================================== step 3
    def _batch(self, rp, ep) -> List[PrefillBatch]:
        if not rp or not ep:
            return []
        reqs = sorted(rp, key=lambda r: -r.input_len)
        insts = sorted(ep, key=lambda i: self.pool.pools[i].free_slots)
        lens = [r.input_len for r in reqs]
        caps = [self.pool.pools[i].free_slots for i in insts]
        speeds = [self.sib.instance_speed.get(i, 1.0) for i in insts]
        cost = make_prefill_cost(self.sib, lens, speeds)
        _, splits = dp_batching(lens, caps, cost)
        if not splits:
            # fall back: one batch on all instances (capacity permitting)
            obs.mark("scheduler.dp_fallback")
            return [PrefillBatch(reqs, insts, scale_down_to=[])]
        batches = []
        for s in splits:
            batches.append(
                PrefillBatch(
                    requests=reqs[s.req_lo : s.req_hi],
                    instances=insts[s.inst_lo : s.inst_hi],
                    scale_down_to=[],
                )
            )
        obs.mark("scheduler.dp_batches", len(batches))
        return batches

    # ========================================================== step 4
    def _merge_decode_groups(
        self, groups: List[DecodeBatch], under_load: bool
    ) -> List[DecodeBatch]:
        """Consolidate decode batches when it frees instance-time (shared
        weight read). Multi-master + token-granularity KV make the merge
        zero-copy: requests keep their KV placement, only masters/groups are
        reassigned. Under light load we keep groups separate (latency)."""
        if len(groups) <= 1:
            return list(groups)
        merged: List[DecodeBatch] = []
        for g in sorted(groups, key=lambda g: -len(g.requests)):
            placed = False
            for m in merged:
                union = sorted(set(m.instances) | set(g.instances))
                overlap = bool(set(m.instances) & set(g.instances))
                if not union:
                    continue
                t_m = self.sib.decode_time(
                    len(union), len(m.requests) + len(g.requests),
                    sum(r.seq_len for r in m.requests + g.requests),
                )
                t_a = self.sib.decode_time(
                    max(m.dop, 1), len(m.requests),
                    sum(r.seq_len for r in m.requests),
                )
                t_b = self.sib.decode_time(
                    max(g.dop, 1), len(g.requests),
                    sum(r.seq_len for r in g.requests),
                )
                save = t_a * max(m.dop, 1) + t_b * max(g.dop, 1) - t_m * len(union)
                if overlap or save > 0:
                    m.requests = m.requests + g.requests
                    m.instances = union
                    placed = True
                    obs.mark("scheduler.merge_decode", len(m.requests))
                    break
            if not placed:
                merged.append(DecodeBatch(list(g.requests), list(g.instances), dict(g.masters)))
        return merged

    def _scaling_plans(self, batches, decode_groups, idle_instances, ep, plan,
                       under_load: bool = False):
        # prefill: proactive scale-down to the min DoP whose pools fit the
        # batch's KV (incl. reserve) — §5.4 "scale down the DoP to the minimum
        # DoP that the key-value tensors of requests can fit"
        for b in batches:
            need = sum(r.input_len for r in b.requests)
            reserve = int(
                self.mcfg.future_kv_reserve_frac
                * sum(r.max_new_tokens for r in b.requests)
            )
            target: List[int] = []
            acc = 0
            # prefer instances with most free slots for the shrunken group
            for i in sorted(
                b.instances, key=lambda j: -self.pool.pools[j].free_slots
            ):
                target.append(i)
                acc += self.pool.pools[i].free_slots
                if acc >= need + reserve and len(target) >= self.sib.min_best_decode_dop():
                    break
            b.scale_down_to = sorted(target)
            # token-level retention placement for the proactive scale-down
            kept = []
            for r in b.requests:
                try:
                    pl = self.pool.plan_placement(
                        r.rid, list(range(r.input_len)), b.scale_down_to
                    )
                except Exception:  # capacity race: leave it pending
                    obs.mark("scheduler.defer_no_placement")
                    continue
                b.placement[r.rid] = pl.assignment
                self.pool.place(pl)  # reserve slots now (zero-copy at exec)
                kept.append(r)
            b.requests = kept
            if kept:
                plan.prefill.append(b)

        # decode: scale up on memory pressure or compute-bound batch (§5.4)
        thresh = (
            self.mcfg.scale_up_batch_threshold
            or self.sib.decode_compute_bound_batch(1)
        )
        free_idle = [i for i in idle_instances if i not in ep]
        decode_groups = self._merge_decode_groups(decode_groups, under_load)
        for g in decode_groups:
            new_insts = list(g.instances)
            g_free = sum(self.pool.pools[i].free_slots for i in new_insts)
            growth = len(g.requests)  # one token per request per iteration
            sum_kv = sum(r.seq_len for r in g.requests)
            mem_pressure = g_free < growth * 4
            compute_bound = len(g.requests) > thresh * max(len(new_insts), 1)
            while (mem_pressure or compute_bound) and free_idle:
                add = free_idle.pop(0)
                new_insts.append(add)
                g_free += self.pool.pools[add].free_slots
                mem_pressure = g_free < growth * 4
                compute_bound = len(g.requests) > thresh * len(new_insts)
                obs.mark("scheduler.scale_up", len(new_insts))
            # opportunistic scale-up under light load (§5: "as long as
            # scaling-up is beneficial ... use more idle GPUs"): multi-master
            # scale-up is migration-free, so the only cost is the per-DoP
            # communication term already inside the SIB decode model.
            while free_idle and new_insts:
                d = len(new_insts)
                t_now = self.sib.decode_time(d, len(g.requests), sum_kv)
                t_up = self.sib.decode_time(d + 1, len(g.requests), sum_kv)
                if t_up < t_now * 0.98:
                    new_insts.append(free_idle.pop(0))
                    obs.mark("scheduler.scale_up_opportunistic",
                             len(new_insts))
                else:
                    break
            if not new_insts and free_idle:  # stalled group revival
                new_insts.append(free_idle.pop(0))
            masters = (
                self._assign_masters(g.requests, new_insts) if new_insts else {}
            )
            plan.decode.append(
                DecodeBatch(list(g.requests), new_insts, masters)
            )

    def _assign_masters(self, requests, instances) -> Dict[int, int]:
        """Multi-master: spread new-KV writes as uniformly as memory allows
        (§5.4 'the number of newly key-value tensors generated by each master
        is set to as uniform as possible')."""
        if not self.mcfg.enable_multi_master or len(instances) == 1:
            inst = max(
                instances, key=lambda i: self.pool.pools[i].free_slots
            )
            return {r.rid: inst for r in requests}
        masters: Dict[int, int] = {}
        load = {i: 0 for i in instances}
        free = {i: self.pool.pools[i].free_slots for i in instances}
        for r in sorted(requests, key=lambda r: -r.seq_len):
            cand = [i for i in instances if free[i] > load[i]]
            if not cand:
                cand = list(instances)
            pick = min(cand, key=lambda i: load[i])
            masters[r.rid] = pick
            load[pick] += 1
        return masters
