"""Driving the system under test: the port's LoongServe engine, built by
its serving entry, run open loop against the host clock.

The engine's own clock is its data-sheet model (`manager/sib.py`): it
only orders the engine's events here.  Every number is taken on the host
clock from outside the program:

  * a request is stamped when it falls due and is submitted then, at the
    engine's current modelled time, never earlier;
  * the engine is stepped one event at a time, so arrivals go in between
    events; with nothing to do the loop sleeps until the next due time;
  * each output token is stamped when the executor call that computed it
    returns (``executor.prefill`` / ``executor.decode``, wrapped on the
    instance as `chip_smoke.py::_serve` does; both end in a device->host
    copy of the ids sampled on the device and of the new KV).

With ``spans=True`` (the traced run) the pool mirror's sync
(``KVPool.device_kv``), the host pool's write of new KV (``KVPool.fill``)
and the decode epilogue that copies the sampled ids and new KV to the host
(``executor._emit_decoded``, device synchronized first so that it holds
host work only) are wrapped too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

now = time.perf_counter


@dataclasses.dataclass
class Record:
    """What a run saw; the per-layer readers take their numbers from it."""

    cfg: dict
    mix: dict
    t0: float = 0.0
    t_end: float = 0.0
    t_close: float = 0.0
    reqs: List[Dict] = dataclasses.field(default_factory=list)
    calls: List[Dict] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    counters: Dict = dataclasses.field(default_factory=dict)
    kernels: Optional[List[tuple]] = None  # (name, start, end), host clock
    lateness: List[float] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0


def model_config(cfg: dict):
    """The port's `ModelConfig` from the keys of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def build(cfg: dict, params: Dict, device):
    """The engine as the serve CLI builds it: LoongServe, real mode, the
    default `ManagerConfig`, the local executor."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model

    mc = model_config(cfg)
    model = build_model(mc, device=device)
    return build_engine("loongserve", mc, cfg["n_instances"],
                        cfg["capacity_per_instance"], device=device,
                        store_values=True, model=model, params=params,
                        page_size=cfg.get("page_size", 1), executor="local")


def build_mirrors(eng) -> None:
    """Every pool's device mirror, one full upload each (set-up)."""
    for pool in eng.pool.pools:
        pool.device_kv()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, eng, rec: Record, device, spans: bool):
        self.eng, self.rec, self.device = eng, rec, device
        self.by_rid: Dict[int, Dict] = {}
        self._wrap_executor()
        if spans:
            self._wrap_spans()

    # ------------------------------------------------------------ wraps
    def _stamp(self, reqs, t: float, prefill: bool) -> None:
        for r in reqs:
            d = self.by_rid.get(r.rid)
            if d is None:
                continue
            n = len(r.output_tokens)
            new = n - d["n_out"]
            if new > 0:
                d["tokens"] += [t] * new
                d["n_out"] = n
                if d["first"] is None:
                    d["first"] = t
            if prefill and d["prefilled"] is None and new > 0:
                d["prefilled"] = t

    def _wrap_executor(self) -> None:
        ex, rec = self.eng.executor, self.rec
        prefill, decode = ex.prefill, ex.decode

        def timed_prefill(batch):
            reqs = list(batch.requests)
            call = {"kind": "prefill", "dop": len(batch.instances),
                    "lens": [len(r.prompt) for r in reqs], "start": now()}
            for r in reqs:
                d = self.by_rid.get(r.rid)
                if d is not None and d["started"] is None:
                    d["started"] = call["start"]
            try:
                return prefill(batch)
            finally:
                call["end"] = now()
                rec.calls.append(call)
                self._stamp(reqs, call["end"], True)

        def timed_decode(g):
            reqs = list(g.requests)
            call = {"kind": "decode", "dop": len(g.instances), "rows": len(reqs),
                    "ctx": [r.seq_len - 1 for r in reqs], "start": now()}
            try:
                return decode(g)
            finally:
                call["end"] = now()
                rec.calls.append(call)
                self._stamp(reqs, call["end"], False)

        ex.prefill, ex.decode = timed_prefill, timed_decode

    def _span(self, name: str, fn, sync: bool = False):
        spans, dev = self.rec.spans, self.device

        def run(*a, **k):
            if sync:
                _sync(dev)
            t = now()
            try:
                return fn(*a, **k)
            finally:
                spans.append((name, t, now()))
        return run

    def _wrap_spans(self) -> None:
        ex = self.eng.executor
        ex._emit_decoded = self._span("emit_to_host", ex._emit_decoded, True)
        for pool in self.eng.pool.pools:
            pool.device_kv = self._span("mirror_sync", pool.device_kv)
            pool.fill = self._span("kv_fill_host", pool.fill)

    # ------------------------------------------------------------- runs
    def submit(self, prompt: list, out_len: int, due: float) -> None:
        from repro_torch.engine.request import Request

        r = Request(input_len=len(prompt), max_new_tokens=out_len, prompt=prompt)
        self.by_rid[r.rid] = d = {
            "rid": r.rid, "due": due, "prompt": prompt, "prompt_len": len(prompt),
            "out_len": out_len, "first": None, "tokens": [], "n_out": 0,
            "prefilled": None, "started": None, "req": r}
        self.rec.reqs.append(d)
        self.eng.submit(r, at=self.eng.clock)

    def warm_up(self, shapes, vocab: int) -> None:
        """Serve the mix's warm-up requests to completion (set-up): every
        kernel is built and loaded, and the allocator has grown."""
        rng = np.random.default_rng(0)
        for n, out in shapes:
            self.submit(rng.integers(0, vocab, int(n)).tolist(), int(out), now())
        self.eng.run()
        _sync(self.device)
        self.rec.reqs.clear()
        self.rec.calls.clear()
        self.rec.spans.clear()
        self.by_rid.clear()

    def preload(self, items, prompts, settled: int = 4) -> None:
        """An offline batch's set-up: submit every request, then step the
        engine until its last `settled` executor calls were all decode
        calls, so that the window opens on a loaded engine decoding, and
        not on the prefills of the first admissions (a fixed lump of
        prompt tokens that would otherwise make most of the window's
        served tokens)."""
        for it, p in zip(items, prompts):
            self.submit(p, it.out_len, now())
        self.rec.counters["submitted"] = len(items)
        calls = self.rec.calls
        while not (len(calls) >= settled
                   and all(c["kind"] == "decode" for c in calls[-settled:])):
            if not self.eng.events and not self.eng._has_live_work():
                break
            self.eng.run(max_events=1)
        _sync(self.device)
        self.rec.calls.clear()
        self.rec.spans.clear()

    def window(self, items, prompts, seconds: float) -> None:
        """Open loop for `seconds`: submit each item when due, step the
        engine one event at a time, sleep when there is nothing to do."""
        eng, rec = self.eng, self.rec
        rec.t0 = now()
        rec.t_end = rec.t0 + seconds
        i, n = 0, len(items)
        while True:
            t = now()
            if t >= rec.t_end:
                break
            while i < n and rec.t0 + items[i].due <= t:
                due = rec.t0 + items[i].due
                self.submit(prompts[i], items[i].out_len, due)
                rec.lateness.append(now() - due)
                i += 1
            if eng.events or eng._has_live_work():
                before = len(eng.events), eng.clock
                eng.run(max_events=1)
                if eng.events or (len(eng.events), eng.clock) != before:
                    continue
            nxt = rec.t0 + items[i].due if i < n else rec.t_end
            a = now()
            time.sleep(max(0.0, min(nxt, rec.t_end) - a))
            rec.spans.append(("waiting_for_arrivals", a, now()))
        rec.t_close = now()
        rec.counters["submitted"] = rec.counters.get("submitted", 0) + i
