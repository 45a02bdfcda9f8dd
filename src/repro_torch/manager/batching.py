"""DP batching (§5.3): split sorted requests across sorted elastic instances.

f[i][k] = min over j<i, l<k with D(j,i) <= V(l,k) of f[j][l] + T(R(j,i), E(l,k))

Requests are sorted by length descending ("requests with similar sequence
lengths ... batched together"); instances ascending by free KV slots. Uses the
split-point monotonicity of Eq. 6 (quadrangle-inequality structure) to shrink
the (j, l) search windows: near-O((n+m)²) in practice. NOTE: the paper's QI
argument assumes the capacity constraint D(j,i) <= V(l,k) is slack; when it
binds, monotone windows can prune the optimum — `dp_batching` is then a
bounded-suboptimality heuristic (tests pin exactness in the slack regime and
a tight bound under binding capacity).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

INF = float("inf")


@dataclass
class BatchSplit:
    """Requests [req_lo, req_hi) mapped to instances [inst_lo, inst_hi)."""

    req_lo: int
    req_hi: int
    inst_lo: int
    inst_hi: int

    @property
    def dop(self) -> int:
        return self.inst_hi - self.inst_lo


def dp_batching(
    lens: Sequence[int],  # request lengths, sorted DESC
    capacities: Sequence[int],  # per-instance free KV slots, sorted ASC
    cost: Callable[[int, int, int, int], float],  # cost(j, i, l, k) of batch
    *,
    monotone: bool = True,
    max_dop: Optional[int] = None,
) -> Tuple[float, List[BatchSplit]]:
    """Returns (min total input latency, batch splits). `cost(j,i,l,k)` is the
    summed input latency of requests j..i-1 on instances l..k-1 (paper: sum of
    T over the batch's requests, weighted handled by caller)."""
    n, m = len(lens), len(capacities)
    if n == 0:
        return 0.0, []
    d = [0] * (n + 1)
    for i, ln in enumerate(lens):
        d[i + 1] = d[i] + ln
    vcap = [0] * (m + 1)
    for k, c in enumerate(capacities):
        vcap[k + 1] = vcap[k] + c

    f = [[INF] * (m + 1) for _ in range(n + 1)]
    sj = [[0] * (m + 1) for _ in range(n + 1)]  # split_req
    sl = [[0] * (m + 1) for _ in range(n + 1)]  # split_ins
    for k in range(m + 1):
        f[0][k] = 0.0

    back = 2  # window back-off: recovers most QI violations cheaply
    for i in range(1, n + 1):
        for k in range(1, m + 1):
            j_lo = (
                max(sj[i][k - 1] - back, 0)
                if (monotone and k > 1 and f[i][k - 1] < INF) else 0
            )
            l_lo = (
                max(sl[i - 1][k] - back, 0)
                if (monotone and i > 1 and f[i - 1][k] < INF) else 0
            )
            def search(jl, ll):
                best, bj, bl = INF, 0, 0
                for j in range(jl, i):
                    for l in range(ll, k):
                        if f[j][l] == INF:
                            continue
                        need = d[i] - d[j]
                        have = vcap[k] - vcap[l]
                        if need > have:
                            continue
                        if max_dop is not None and (k - l) > max_dop:
                            continue
                        c = f[j][l] + cost(j, i, l, k)
                        if c < best:
                            best, bj, bl = c, j, l
                return best, bj, bl

            best, bj, bl = search(j_lo, l_lo)
            if best == INF and (j_lo > 0 or l_lo > 0):
                # capacity can make the pruned window infeasible even when a
                # wider split exists — fall back to the exhaustive window
                best, bj, bl = search(0, 0)
            f[i][k] = best
            sj[i][k], sl[i][k] = bj, bl

    best_k, best_val = -1, INF
    for k in range(1, m + 1):
        if f[n][k] < best_val:
            best_val, best_k = f[n][k], k
    if best_k < 0:
        return INF, []

    # backtrack
    splits: List[BatchSplit] = []
    i, k = n, best_k
    while i > 0:
        j, l = sj[i][k], sl[i][k]
        splits.append(BatchSplit(j, i, l, k))
        i, k = j, l
    splits.reverse()
    return best_val, splits


def dp_batching_naive(lens, capacities, cost, *, max_dop=None):
    return dp_batching(lens, capacities, cost, monotone=False, max_dop=max_dop)


def make_prefill_cost(sib, lens: Sequence[int], speeds: Optional[Sequence[float]] = None):
    """Paper objective: per-batch sum over its requests of normalized input
    latency contribution — here Σ_r T(batch)/input_len_r (matches Eq. 3's
    normalization). Instances are interchangeable up to speed; a batch on
    instances l..k-1 runs at the slowest member's speed."""

    def cost(j: int, i: int, l: int, k: int) -> float:
        batch_lens = lens[j:i]
        t = sib.prefill_time(k - l, batch_lens)
        if speeds is not None:
            t = t / min(speeds[l:k])
        return sum(t / max(ln, 1) for ln in batch_lens)

    return cost
