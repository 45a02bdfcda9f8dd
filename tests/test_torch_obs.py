"""The serving path's recorder (`repro_torch.obs`): the ring and its
totals, the clock, and the records a real-mode engine run makes — named
and nested as the engine, scheduler, executor and KV pool make them, as
many per decode call at 4 rows as at 32, with the bytes each copy moved
(ids and KV: the logits stay on the device)."""
import time
import types
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import init_params  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kvcache.distributed import DistributedKVPool  # noqa: E402
from repro_torch.manager.scheduler import (  # noqa: E402
    DecodeBatch, GlobalManager, ManagerConfig,
)
from repro_torch.manager.sib import SIB  # noqa: E402

CFG = reduced(get_config("lwm-7b"), n_layers=2)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def fake_clock(monkeypatch):
    clk = FakeClock()
    monkeypatch.setattr(obs, "clock", clk)
    return clk


@pytest.fixture
def fresh(monkeypatch):
    """A recorder of its own for the test, as the module's."""
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "_REC", rec)
    return rec


def test_ring_bound_and_dropped(fake_clock):
    rec = obs.Recorder(capacity=4)
    for i in range(6):
        fake_clock.t = float(i)
        rec.mark("m", i)
    assert rec.dropped == 2
    assert [r.value for r in rec.records()] == [2, 3, 4, 5]
    # records 0 and 1 (ending at 0 s and 1 s) are gone
    assert not rec.intact(1.0) and rec.intact(1.5)
    # the totals keep every record, dropped ones too
    assert rec.snapshot()["m"] == {"count": 6, "seconds": 0.0,
                                   "exclusive_s": 0.0, "value": 15}


def test_window_nesting_and_exclusive_time(fake_clock):
    rec = obs.Recorder()
    fake_clock.t = 1.0
    with rec.span("outer", 7) as outer:
        fake_clock.t = 2.0
        with rec.span("inner"):
            fake_clock.t = 4.0
            rec.mark("point", 3)
            fake_clock.t = 5.0
        fake_clock.t = 6.0
        with rec.span("inner") as sp:
            fake_clock.t = 6.5
            sp.value = 2
        fake_clock.t = 8.0
        outer.value = 9
    names = [(r.name, r.start, r.end, r.value) for r in rec.records()]
    assert names == [("point", 4.0, 4.0, 3), ("inner", 2.0, 5.0, None),
                     ("inner", 6.0, 6.5, 2), ("outer", 1.0, 8.0, 9)]
    snap = rec.snapshot()
    assert snap["outer"] == {"count": 1, "seconds": 7.0, "exclusive_s": 3.5,
                             "value": 9}
    assert snap["inner"] == {"count": 2, "seconds": 3.5, "exclusive_s": 3.5,
                             "value": 2}
    # the window takes the records that overlap it
    assert [r.name for r in rec.records(4.5, 5.5)] == ["inner", "outer"]
    assert [r.name for r in rec.records(6.6, 7.0)] == ["outer"]
    assert rec.records(8.5, 9.0) == []


def test_a_span_records_when_its_body_raises(fresh):
    with pytest.raises(ValueError):
        with obs.span("executor.launch"):
            raise ValueError
    assert [r.name for r in obs.records()] == ["executor.launch"]


def test_the_clock_is_perf_counter(fresh):
    assert obs.clock is time.perf_counter
    a = time.perf_counter()
    with obs.span("s"):
        pass
    obs.mark("m")
    b = time.perf_counter()
    for r in obs.records():
        assert a <= r.start <= r.end <= b


# ------------------------------------------------------------ the engine
def _engine(n_instances=4):
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.models import build_model

    return LoongServeEngine(CFG, n_instances, 2048, store_values=True,
                            model=build_model(CFG, device="cpu"),
                            params=params, device="cpu")


def _serve(eng, n_reqs, prompt_len=8, new_tokens=4, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [Request(input_len=prompt_len, max_new_tokens=new_tokens,
                    prompt=rng.integers(0, CFG.vocab_size, prompt_len).tolist())
            for _ in range(n_reqs)]
    for r in reqs:
        eng.submit(r, at=0.0)
    eng.run()
    assert all(len(r.output_tokens) == new_tokens for r in reqs)
    return reqs


def _parents(records):
    """{index of a record: name of the innermost span holding it}."""
    order = sorted(range(len(records)),
                   key=lambda i: (records[i].start, -records[i].end))
    stack, out = [], {}
    for i in order:
        r = records[i]
        while stack and records[stack[-1]].end < r.start:
            stack.pop()
        out[i] = records[stack[-1]].name if stack else None
        if r.end > r.start:
            stack.append(i)
    return out


NESTING = {
    "engine.step": {None},
    "engine.schedule": {"engine.step"},
    "engine.admitted": {"engine.schedule"},
    "engine.no_idle": {"engine.schedule"},
    "engine.decode_epilogue": {"engine.step"},
    "kv_pool.fill": {"engine.decode_epilogue"},
    "executor.decode": {"engine.step"},
    "executor.prefill": {"engine.step"},
    "executor.plan": {"executor.decode", "executor.prefill"},
    "kv_pool.mirror_sync": {"executor.plan", "kv_pool.fill_packed"},
    "executor.launch": {"executor.decode", "executor.prefill"},
    "executor.wait": {"executor.decode", "executor.prefill"},
    "executor.d2h": {"executor.decode", "executor.prefill"},
    "executor.sample": {"executor.decode", "executor.prefill"},
    "kv_pool.fill_packed": {"executor.prefill"},
}


def test_an_engine_run_makes_the_named_spans_nested(fresh):
    """One instance, so the burst is admitted in parts while decode holds
    the instance (`engine.no_idle`)."""
    eng = _engine(n_instances=1)
    _serve(eng, 6)
    recs = obs.records()
    names = {r.name for r in recs}
    assert set(NESTING) <= names, set(NESTING) - names
    for i, parent in _parents(recs).items():
        name = recs[i].name
        if name.startswith("scheduler."):
            assert parent == "engine.schedule", (name, parent)
        else:
            assert parent in NESTING[name], (name, parent)
    # every request admitted once; rows and tokens agree call by call
    assert sum(r.value for r in recs if r.name == "engine.admitted") == 6
    assert sum(r.value for r in recs if r.name == "executor.prefill") == 6 * 8
    calls = [r for r in recs if r.name == "executor.decode"]
    tokens = [r.value for r in recs if r.name == "executor.sample"]
    assert sum(c.value for c in calls) == 6 * 3  # 4 tokens: 1 from prefill
    assert sum(tokens) == 6 * 4


def _decode_step_names(n_rows):
    """The names of the records of a steady decode step on one instance:
    the engine step holding a decode call of all `n_rows` rows, in the form
    most such steps take (the first and last steps also admit, merge or
    finish)."""
    rec = obs.Recorder()
    orig = obs._REC
    obs._REC = rec
    try:
        _serve(_engine(n_instances=1), n_rows, new_tokens=6)
    finally:
        obs._REC = orig
    recs = rec.records()
    calls = [r for r in recs
             if r.name == "executor.decode" and r.value == n_rows]
    assert len(calls) >= 3
    forms = Counter()
    for c in calls:
        step = next(r for r in recs if r.name == "engine.step"
                    and r.start <= c.start <= r.end)
        forms[tuple(sorted(r.name for r in recs
                           if step.start <= r.start <= step.end))] += 1
    return forms.most_common(1)[0][0]


def test_records_per_decode_call_do_not_grow_with_rows():
    few, many = _decode_step_names(4), _decode_step_names(32)
    assert few == many
    assert 10 <= len(few) <= 25, few


def test_d2h_value_is_the_bytes_of_the_ids_and_kv(fresh):
    """The logits are sampled on the device: a decode row brings its int32
    id (-1 for a row that is not all finite) and its new f32 KV."""
    eng = _engine()
    _serve(eng, 5, new_tokens=3)
    recs = obs.records()
    calls = [r for r in recs if r.name == "executor.decode"]
    per_row = (4  # int32 id
               + 2 * CFG.n_layers * CFG.n_kv_heads * CFG.head_dim * 4)  # f32 KV
    for c in calls:
        inside = [r for r in recs if c.start <= r.start and r.end <= c.end]
        d2h = [r.value for r in inside if r.name == "executor.d2h"]
        sample = [r.value for r in inside if r.name == "executor.sample"]
        assert d2h == [c.value * per_row] and sample == [c.value]


# ------------------------------------------------------------- scheduler
def _manager(n, capacity, **mcfg):
    """The manager over sim pools at full lwm-7b size (no tensors), whose
    cost model prices prompts as the scheduler sees them in serving."""
    cfg = get_config("lwm-7b")
    pool = DistributedKVPool(cfg, n, capacity, store_values=False)
    return GlobalManager(cfg, SIB(cfg), pool, ManagerConfig(**mcfg)), pool


def _names(recs):
    return [r.name for r in recs]


def test_scheduler_marks_a_delay(fresh):
    """One idle instance of four, a long prompt: waiting for the decode
    group's three instances beats prefilling on one now."""
    mgr, _ = _manager(4, 1 << 20)
    mgr.note_finished_decode(1e-6)
    running = Request(input_len=16, max_new_tokens=8)
    group = DecodeBatch([running], [1, 2, 3], {running.rid: 1})
    long_ = Request(input_len=60000, max_new_tokens=8)
    plan = mgr.schedule([long_], [group], [0], 0.0)
    assert not plan.prefill
    names = _names(obs.records())
    assert "scheduler.delay" in names and "scheduler.stop.delay" in names
    assert obs.snapshot()["scheduler.delay"]["count"] == 1


def test_scheduler_marks_a_trim(fresh):
    """Two prompts fit the fleet but not the one idle instance, whose
    neighbour's KV cannot move: the second prompt is trimmed."""
    mgr, pool = _manager(2, 100, enable_delay_execution=False)
    pool.pools[1].alloc(99, list(range(10)))
    running = Request(input_len=10, max_new_tokens=2)
    group = DecodeBatch([running], [1], {running.rid: 1})
    a, b = (Request(input_len=60, max_new_tokens=2) for _ in range(2))
    plan = mgr.schedule([a, b], [group], [0], 0.0)
    assert [r.rid for pb in plan.prefill for r in pb.requests] == [a.rid]
    assert [(r.name, r.value) for r in obs.records()] == [
        ("scheduler.trim", 60), ("scheduler.dp_batches", 1)]


@pytest.mark.parametrize("owner, name", [
    ("repro_torch.manager.scheduler:IterationPlan", "log"),
    ("repro_torch.engine.server:EngineMetrics", "q_broadcast_bytes"),
    ("repro_torch.engine.server:LoongServeEngine", "_prefill_programs"),
    ("repro_torch.engine.executor:LocalExecutor", "_prefill_programs"),
])
def test_the_unread_artifacts_are_gone(owner, name):
    """The free-text plan log and two values nothing read: the marks and
    spans carry what they held."""
    import dataclasses
    import importlib

    mod, cls = owner.split(":")
    c = getattr(importlib.import_module(mod), cls)
    fields = ({f.name for f in dataclasses.fields(c)}
              if dataclasses.is_dataclass(c) else set())
    assert name not in fields and not hasattr(c, name)


# --------------------------------------------------------------- kernels
def test_kernel_build_and_load_are_recorded(fresh, monkeypatch):
    from repro_torch.kernels import _build

    class Lib:
        def __getattr__(self, name):
            f = types.SimpleNamespace()
            setattr(self, name, f)
            return f

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_start", lambda name: ("started", name))
    monkeypatch.setattr(_build, "_finish", lambda name, started: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    lib = _build.load_library("paged_decode")
    assert _build.load_library("paged_decode") is lib  # cached: no record
    recs = obs.records()
    assert _names(recs) == ["kernels.build.paged_decode",
                            "kernels.load.paged_decode"]
    assert [r.value for r in recs] == [1, 1]


# ------------------------------------------------------------- serve CLI
def test_serve_cli_prints_the_totals(fresh, capsys):
    import json

    from repro_torch.launch import serve

    assert serve.main(["--real", "--device", "cpu", "--dataset", "sharegpt",
                       "--n", "2", "--instances", "2", "--json"]) == 0
    out = capsys.readouterr().out
    data = json.loads(out[out.index("{"):])
    assert data["n_finished"] == 2
    totals = data["obs"]
    assert totals == obs.snapshot()
    steps = totals["executor.decode"]["count"]
    assert steps > 0 and totals["executor.launch"]["count"] >= steps
    for t in totals.values():
        assert 0.0 <= t["exclusive_s"] <= t["seconds"] + 1e-9
