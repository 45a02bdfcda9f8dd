"""The readers of the program's own records (`repro_torch.obs`) against a
timeline built by hand: spans and marks made on a fake clock, device
operations placed beside them, every expected share counted by hand.
Each reads nothing where the program has no recorder, where its ring
dropped a record inside the window, or (the device's) without a trace."""
import sys
import types

import pytest

from esp_bench import run as bench_run

NAMES = ["engine.host_share", "engine.admit_blocked_share",
         "executor.sample_share", "executor.d2h_bytes_per_token",
         "device.idle_launch_share", "device.idle_unattributed_share"]
# window [0, 10] s; device busy 3.5-4.5 (in the launch), 5-6 (wait, copy),
# 9.5-9.6 (after the step)
KERNELS = [("split_kernel", 3.5, 4.5), ("gemm", 5.0, 5.5),
           ("Memcpy DtoH", 5.5, 6.0), ("fill", 9.5, 9.6)]
EXPECTED = {
    # exclusive: schedule 1-2 and 8.5-8.9, epilogue 7-8.5 less its fill 0.5
    "engine.host_share": 24.0,
    # two rounds with requests waiting; the first admitted none
    "engine.admit_blocked_share": 50.0,
    "executor.sample_share": 8.0,  # 6-6.8
    "executor.d2h_bytes_per_token": 1000.0,  # 4000 bytes, 4 tokens
    # idle while the launch is innermost: 3-3.5 and 4.5-5
    "device.idle_launch_share": 10.0,
    # idle with no span open: 0-1, 9-9.5, 9.6-10
    "device.idle_unattributed_share": 19.0,
}


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def recorder(monkeypatch):
    obs = pytest.importorskip("repro_torch.obs")
    clk = Clock()
    monkeypatch.setattr(obs, "clock", clk)

    def make(capacity=obs.CAPACITY, before=0):
        rec = obs.Recorder(capacity)
        monkeypatch.setattr(obs, "_REC", rec)
        for i in range(before):  # records that end before the window
            clk.t = -5.0 + i * 1e-3
            obs.mark("engine.no_idle", 1)
        _timeline(obs, clk)
        return rec
    return make


def _at(clk, t):
    clk.t = t


def _timeline(obs, clk):
    _at(clk, 1.0)
    with obs.span("engine.step"):
        with obs.span("engine.schedule", 5):
            _at(clk, 1.5)
            obs.mark("scheduler.stop.memory")
            _at(clk, 1.9)
            obs.mark("engine.admitted", 0)
            _at(clk, 2.0)
        with obs.span("executor.decode", 4):
            with obs.span("executor.plan"):
                _at(clk, 2.2)
                with obs.span("kv_pool.mirror_sync", 100):
                    _at(clk, 2.8)
                _at(clk, 3.0)
            with obs.span("executor.launch"):
                _at(clk, 5.0)
            with obs.span("executor.wait"):
                _at(clk, 5.5)
            with obs.span("executor.d2h", 4000):
                _at(clk, 6.0)
            with obs.span("executor.sample", 4):
                _at(clk, 6.8)
            _at(clk, 7.0)
        with obs.span("engine.decode_epilogue", 4):
            _at(clk, 7.5)
            with obs.span("kv_pool.fill", 4):
                _at(clk, 8.0)
            _at(clk, 8.5)
        with obs.span("engine.schedule", 5):
            _at(clk, 8.8)
            obs.mark("engine.admitted", 2)
            _at(clk, 8.9)
        _at(clk, 9.0)


def _rec(kernels=KERNELS):
    return types.SimpleNamespace(t0=0.0, t_close=10.0, window_s=10.0,
                                 kernels=kernels)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_timeline_counted_by_hand(recorder, name):
    recorder()
    assert bench_run.reader(name)(_rec()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_past_records_dropped_before_the_window(recorder, name):
    ring = recorder(capacity=20, before=8)
    assert ring.dropped > 0
    assert bench_run.reader(name)(_rec()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_after_a_drop_inside_the_window(recorder, name):
    ring = recorder(capacity=6)
    assert ring.dropped > 0
    assert bench_run.reader(name)(_rec()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_without_the_recorder(recorder, monkeypatch, name):
    import repro_torch

    recorder()
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert bench_run.reader(name)(_rec()) is None


@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith("device.")])
def test_device_readers_read_nothing_without_a_trace(recorder, name):
    recorder()
    assert bench_run.reader(name)(_rec(kernels=None)) is None
