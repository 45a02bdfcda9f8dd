"""The device trace of a ``--trace 1`` run: `torch.profiler` with CUDA
activity only (CUPTI), over the whole measured window.

Device operations come back on the profiler's clock.  A marker (one
fill of a small tensor, the first device operation after the profiler
starts, followed by a synchronize) ties that clock to the host's: its end
on the device is taken to be the host clock just after the synchronize,
which is late by the synchronize's return, some microseconds.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch


class Trace:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()
        torch.cuda.synchronize(self.device)
        torch.empty(4096, device=self.device).fill_(1.0)
        torch.cuda.synchronize(self.device)
        self.t_marker = time.perf_counter()

    def stop(self) -> List[Tuple[str, float, float]]:
        """Device operations (name, start, end) on the host clock."""
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns()
            evs.append((e.name(), s, s + e.duration_ns()))
        if not evs:
            return []
        evs.sort(key=lambda x: x[1])
        off = self.t_marker - evs[0][2] * 1e-9  # the marker is the first
        return [(n, a * 1e-9 + off, b * 1e-9 + off) for n, a, b in evs[1:]]


def clip(kernels, t0: float, t1: float):
    """The operations' parts inside [t0, t1]."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in kernels if b > t0 and a < t1]


def busy(kernels) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, merged, in time order."""
    out: List[List[float]] = []
    for _, a, b in sorted(kernels, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(n)
    for i, c in enumerate(n):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i > 0:
            cut = i
            break
    return n[:cut][:160]


def breakdown(kernels, spans, t0: float, t1: float) -> Dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing (the innermost span over each idle gap's
    middle; "engine" where no span was open)."""
    by: Dict[str, float] = {}
    for n, a, b in kernels:
        k = short(n)
        by[k] = by.get(k, 0.0) + (b - a)
    ops = sorted(by.items(), key=lambda x: -x[1])[:10]
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for name, a, b in spans:
        by_name.setdefault(name, []).append((a, b))
    lists = {k: (sorted(v), [a for a, _ in sorted(v)]) for k, v in by_name.items()}
    idle: Dict[str, float] = {}
    edges = [t0] + [x for iv in busy(kernels) for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, name, width = (a + b) / 2, "engine", float("inf")
        for k, (ivs, starts) in lists.items():  # innermost open span
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and ivs[j][1] >= mid and ivs[j][1] - ivs[j][0] < width:
                name, width = k, ivs[j][1] - ivs[j][0]
        idle[name] = idle.get(name, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
