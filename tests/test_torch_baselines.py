"""The port's baselines (the paper's comparison systems: static TP,
chunked prefill, PD disaggregation, replicated groups) and its serve CLI.

  * The reference's tests/test_engine.py baseline cases on the port, which
    runs them on its own H100 cost model.
  * With the reference's `HardwareSpec` passed to both packages, every
    system's sim-mode `summary()` equals the reference's on the same
    workload.
  * ``python -m repro_torch.launch.serve`` as tests/test_cli.py runs the
    reference's (sim mode with the default device, as it runs anywhere),
    plus real mode on the CPU (``--device cpu``); ``--real`` with the
    default device raises where there is no CUDA device.
"""
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY  # noqa: E402
from repro.data import poisson_workload as j_poisson_workload  # noqa: E402
from repro.launch.serve import build_engine as j_build_engine  # noqa: E402
from repro.manager.sib import HardwareSpec as JHardwareSpec  # noqa: E402
from repro_torch.baselines import (  # noqa: E402
    ChunkedPrefillEngine,
    FixedGroupsEngine,
    PDDisaggEngine,
    StaticTPEngine,
)
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.data import poisson_workload  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.launch.serve import SYSTEMS, build_engine  # noqa: E402
from repro_torch.manager.sib import HardwareSpec  # noqa: E402

CFG = T_REGISTRY["lwm-7b"]
ROOT = pathlib.Path(__file__).parent.parent


@pytest.mark.parametrize("ctor", [
    lambda: StaticTPEngine(CFG, 8, 250_000),
    lambda: ChunkedPrefillEngine(CFG, 8, 250_000),
    lambda: PDDisaggEngine(CFG, 8, 250_000),
    lambda: FixedGroupsEngine(CFG, 8, 250_000, groups=[[i] for i in range(8)]),
])
def test_baselines_complete(ctor):
    eng = ctor()
    reqs = poisson_workload("sharegpt", 20, rate=2.0, seed=9)
    for r in copy.deepcopy(reqs):
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) + m.rejected >= 19  # replicated groups may reject


def test_pd_disagg_rejects_what_unified_pool_serves():
    """PD disaggregation runs out of memory on a long request (half the
    memory per phase); LoongServe's unified pool serves it."""
    long_req = Request(input_len=1_300_000, max_new_tokens=16)
    pd = PDDisaggEngine(CFG, 8, 200_000)
    pd.submit(copy.deepcopy(long_req))
    mpd = pd.run()
    ls = LoongServeEngine(CFG, 8, 200_000)
    ls.submit(copy.deepcopy(long_req))
    mls = ls.run()
    assert mpd.rejected == 1 or len(mpd.finished) == 0
    assert len(mls.finished) == 1


def test_loongserve_beats_baselines_on_long_context():
    reqs = poisson_workload("lveval", 40, rate=0.15, seed=7)
    results = {}
    for name, ctor in [
        ("loongserve", lambda: LoongServeEngine(CFG, 8, 250_000)),
        ("vllm", lambda: StaticTPEngine(CFG, 8, 250_000)),
        ("pd", lambda: PDDisaggEngine(CFG, 8, 250_000)),
    ]:
        eng = ctor()
        for r in copy.deepcopy(reqs):
            eng.submit(r)
        results[name] = eng.run().summary()
    assert results["loongserve"]["norm_e2e_mean"] < results["vllm"]["norm_e2e_mean"]
    assert results["loongserve"]["norm_e2e_mean"] < results["pd"]["norm_e2e_mean"]


@pytest.mark.parametrize("system", SYSTEMS)
def test_sim_summary_matches_reference(system):
    """Same workload, same cost model: the port's engine gives the
    reference's metrics exactly."""
    hw = JHardwareSpec()
    summaries = []
    for port in (True, False):
        if port:
            eng = build_engine(system, CFG, 8, 250_000,
                               hw=HardwareSpec(**dataclasses.asdict(hw)))
            reqs = poisson_workload("mixed", 30, rate=0.5, seed=3)
        else:
            eng = j_build_engine(system, REGISTRY["lwm-7b"], 8, 250_000, hw=hw)
            reqs = j_poisson_workload("mixed", 30, rate=0.5, seed=3)
        for r in reqs:
            eng.submit(r)
        summaries.append(eng.run().summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["n_finished"] > 0


def _serve(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
    )


def _summary(out):
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout[out.stdout.index("{"):])


def test_serve_cli_sim():
    data = _summary(_serve("--dataset", "sharegpt", "--rate", "2", "--n", "12",
                           "--json"))
    assert data["n_finished"] == 12
    assert data["scaling_migration_bytes"] == 0


def test_serve_cli_baseline():
    data = _summary(_serve("--system", "pd-disagg", "--dataset", "sharegpt",
                           "--rate", "2", "--n", "8", "--json"))
    assert data["n_finished"] + data["rejected"] == 8


def test_serve_cli_real_on_cpu():
    data = _summary(_serve("--real", "--device", "cpu", "--dataset", "sharegpt",
                           "--n", "4", "--json"))
    assert data["n_finished"] == 4
    assert data["scaling_migration_bytes"] == 0


def test_serve_real_without_cuda_raises(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--real", "--n", "1"])
