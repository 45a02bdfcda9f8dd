"""Unified distributed KV cache pool (LoongServe §3/§4).

The per-instance pools together form one logical pool; tokens of one request
may live on any subset of instances at single-token granularity. This module
owns placement planning (used by proactive scale-down and multi-master
appends), migration accounting (used by the *baselines* and by the allocation
step's preemption path — ESP's own transitions are zero-copy), and
fragmentation metrics (paper Fig. 4's failure mode, which token granularity
eliminates).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.pool import KVPool, OutOfSlots


@dataclass
class PlacementPlan:
    """Token-level placement: instance -> sorted list of global positions."""

    request_id: int
    assignment: Dict[int, List[int]]

    @property
    def n_tokens(self) -> int:
        return sum(len(v) for v in self.assignment.values())

    def instances(self) -> List[int]:
        return [i for i, toks in self.assignment.items() if toks]


@dataclass
class SalvagePlan:
    """Fault-salvage inventory for one request after an instance died.

    ``coverage`` is the sparse per-request coverage map over SURVIVING
    instances (instance -> sorted positions still resident); ``lost_spans``
    are the maximal contiguous runs of ``[0, expected)`` no survivor holds —
    exactly the spans the recovery chain must re-prefill (the dead rank's
    stripe), everything else is salvaged in place."""

    request_id: int
    expected: int
    coverage: Dict[int, np.ndarray]
    lost_spans: List[Tuple[int, int]]

    @property
    def n_salvaged(self) -> int:
        return sum(len(p) for p in self.coverage.values())

    @property
    def n_lost(self) -> int:
        return sum(e - s for s, e in self.lost_spans)


class DistributedKVPool:
    def __init__(self, cfg: ModelConfig, n_instances: int,
                 capacity_per_instance: int, store_values: bool = True,
                 page_size: int = 1):
        self.cfg = cfg
        self.page_size = page_size
        self.pools: List[KVPool] = [
            KVPool(cfg, capacity_per_instance, i, store_values, page_size)
            for i in range(n_instances)
        ]
        self.migrated_bytes = 0  # reactive-migration traffic (baselines)

    # ------------------------------------------------------------- accounting
    @property
    def total_free(self) -> int:
        return sum(p.free_slots for p in self.pools)

    @property
    def total_used(self) -> int:
        return sum(p.used for p in self.pools)

    def free_map(self) -> Dict[int, int]:
        return {p.instance_id: p.free_slots for p in self.pools}

    def max_contiguous_request(self) -> int:
        """Largest request a *locality-constrained* system could admit
        (paper Fig. 4): bounded by the single largest per-instance free space.
        The unified pool instead admits up to `total_free`."""
        return max((p.free_slots for p in self.pools), default=0)

    def fragmentation_waste(self) -> int:
        """Tokens admissible by the unified pool but NOT by a locality-
        constrained one."""
        return self.total_free - self.max_contiguous_request()

    def request_instances(self, request_id: int) -> List[int]:
        return [p.instance_id for p in self.pools if p.tokens_of(request_id)]

    def request_tokens(self, request_id: int) -> int:
        return sum(len(p.tokens_of(request_id)) for p in self.pools)

    # -------------------------------------------------------------- placement
    def plan_placement(
        self,
        request_id: int,
        positions: Sequence[int],
        target_instances: Sequence[int],
        *,
        proportional: bool = True,
    ) -> PlacementPlan:
        """Split `positions` across `target_instances` at token granularity.

        proportional=True splits by free capacity (LoongServe: "any token-level
        KV cache allocation plan according to the memory availability of each
        instance without computational load imbalance", §4.1); otherwise an
        even round-robin split.
        """
        positions = list(positions)
        n = len(positions)
        # dedupe targets (order-preserving): duplicates would share one
        # assignment key but take two cursor passes below — the second pass
        # OVERWRITES the first instance's token range and silently drops it
        target_instances = list(dict.fromkeys(target_instances))
        free = {i: self.pools[i].free_slots for i in target_instances}
        if sum(free.values()) < n:
            raise OutOfSlots(
                f"request {request_id}: need {n} tokens, "
                f"free {sum(free.values())} on {list(target_instances)}"
            )
        assignment: Dict[int, List[int]] = {i: [] for i in target_instances}
        if proportional:
            total_free = sum(free.values())
            quota = {
                i: int(np.floor(n * free[i] / total_free)) for i in target_instances
            }
            # distribute the remainder to the freest instances
            rem = n - sum(quota.values())
            for i in sorted(target_instances, key=lambda j: -free[j]):
                if rem == 0:
                    break
                if quota[i] < free[i]:
                    quota[i] += 1
                    rem -= 1
            # cap by actual free space, spill remainder
            spill = 0
            for i in target_instances:
                if quota[i] > free[i]:
                    spill += quota[i] - free[i]
                    quota[i] = free[i]
            for i in target_instances:
                take = min(spill, free[i] - quota[i])
                quota[i] += take
                spill -= take
            cursor = 0
            for i in target_instances:
                assignment[i] = positions[cursor : cursor + quota[i]]
                cursor += quota[i]
        else:
            for j, pos in enumerate(positions):
                assignment[target_instances[j % len(target_instances)]].append(pos)
        return PlacementPlan(request_id, assignment)

    def place(
        self,
        plan: PlacementPlan,
        k: Optional[np.ndarray] = None,  # [n_attn, n_tokens, KVH, D] by position order
        v: Optional[np.ndarray] = None,
        position_index: Optional[Dict[int, int]] = None,
    ) -> None:
        """Write tokens per `plan`. With values, `position_index` maps global
        position -> column of k/v (default: enumerate sorted positions)."""
        if k is not None and position_index is None:
            all_pos = sorted(
                pos for toks in plan.assignment.values() for pos in toks
            )
            position_index = {p: i for i, p in enumerate(all_pos)}
        for inst, toks in plan.assignment.items():
            if not toks:
                continue
            if k is None:
                self.pools[inst].alloc(plan.request_id, toks)
            else:
                cols = [position_index[p] for p in toks]
                self.pools[inst].write(
                    plan.request_id, toks, k[:, cols], v[:, cols]
                )

    # ---------------------------------------------------------------- salvage
    def coverage_map(
        self, request_id: int, failed: Sequence[int] = ()
    ) -> Dict[int, np.ndarray]:
        """Sparse per-request coverage over surviving instances: instance ->
        sorted global positions resident there (empty legs omitted)."""
        out: Dict[int, np.ndarray] = {}
        for p in self.pools:
            if p.instance_id in failed:
                continue
            pos = p.positions_of(request_id)
            if len(pos):
                out[p.instance_id] = pos
        return out

    def salvage_placement(
        self, request_id: int, expected: int, failed: Sequence[int]
    ) -> SalvagePlan:
        """Plan elastic fault recovery for one request: what the survivors
        still hold of positions ``[0, expected)`` and which contiguous spans
        died with the failed instance(s).  Pure inventory — re-reserving the
        lost spans is `place_salvage`, recomputing them is the engine's
        recovery chain."""
        cov = self.coverage_map(request_id, failed)
        mask = np.ones(max(expected, 0), bool)
        for pos in cov.values():
            held = pos[pos < expected]
            mask[held] = False
        missing = np.nonzero(mask)[0]
        spans: List[Tuple[int, int]] = []
        if len(missing):
            brk = np.nonzero(np.diff(missing) > 1)[0]
            starts = np.concatenate([missing[:1], missing[brk + 1]])
            ends = np.concatenate([missing[brk], missing[-1:]]) + 1
            spans = [(int(s), int(e)) for s, e in zip(starts, ends)]
        return SalvagePlan(request_id, expected, cov, spans)

    def place_salvage(self, plan: PlacementPlan) -> None:
        """Re-reserve a dead rank's positions on the survivors.  Unlike
        `place`, the targets may already hold HIGHER positions of the same
        request, so each leg goes through `insert_positions` (which restores
        the pool's position-ascending local order)."""
        for inst, toks in plan.assignment.items():
            if toks:
                self.pools[inst].insert_positions(plan.request_id, toks)

    # -------------------------------------------------------------- migration
    def migrate_request(
        self, request_id: int, src: int, dst_candidates: Sequence[int]
    ) -> int:
        """Move a request's tokens off instance `src` (reactive migration /
        preemption-avoidance path, §5.2). Returns bytes moved and accounts
        them in `migrated_bytes`."""
        pool = self.pools[src]
        toks = pool.tokens_of(request_id)
        if not toks:
            return 0
        positions = sorted(toks)
        _, k, v = pool.gather(request_id)
        plan = self.plan_placement(
            request_id, positions, [d for d in dst_candidates if d != src]
        )
        # transactional: land every destination BEFORE freeing the source
        # copy, rolling fresh destinations back on a mid-place failure — a
        # refused migration must never lose tokens (the engine drops it and
        # keeps serving from src)
        fresh = [
            i for i in plan.instances() if not self.pools[i].tokens_of(request_id)
        ]
        try:
            if k is not None and pool.store_values:
                pos_idx = {p: i for i, p in enumerate(positions)}
                self.place(plan, k, v, pos_idx)
            else:
                self.place(plan)
        except Exception:
            for i in fresh:
                self.pools[i].free_request(request_id)
            raise
        pool.free_request(request_id)
        moved = len(positions) * pool.bytes_per_slot
        self.migrated_bytes += moved
        return moved

    def free_request(self, request_id: int) -> int:
        return sum(p.free_request(request_id) for p in self.pools)

    # ---------------------------------------------------------------- gather
    def gather_request(
        self, request_id: int
    ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        """Dense (positions, k, v) across all instances, position-sorted."""
        parts = [p.gather(request_id) for p in self.pools]
        positions = np.concatenate([pp[0] for pp in parts])
        order = np.argsort(positions)
        positions = positions[order]
        if not self.pools[0].store_values:
            return positions, None, None
        k = np.concatenate([pp[1] for pp in parts], axis=1)[:, order]
        v = np.concatenate([pp[2] for pp in parts], axis=1)[:, order]
        return positions, k, v
