"""The port's chaos harness and invariant sanitizer against the JAX
package's.

Sim mode: given the same seed, workload, rates and cost model (``hw=``),
the port's `ChaosMonkey.trace_fingerprint()` and `metrics.summary()` equal
the reference's — the copied control plane replays the same event trace
bit for bit, salvage included.  Real mode: a small soak with all six
injectors (dispatch faults through the port's `ops.set_fault_hook`, NaN
poison through the executor's value guard) on the packed/paged path and on
the unified chunked path; zero violations and leaks, and every token equal
to the JAX `serial_decode_oracle`.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.chaos import ChaosConfig as JChaosConfig  # noqa: E402
from repro.chaos import ChaosMonkey as JChaosMonkey  # noqa: E402
from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.data import poisson_workload as j_poisson_workload  # noqa: E402
from repro.engine.invariants import InvariantChecker as JChecker  # noqa: E402
from repro.engine.server import LoongServeEngine as JEngine  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.manager.sib import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.chaos import ChaosConfig, ChaosMonkey  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import poisson_workload  # noqa: E402
from repro_torch.engine.invariants import (  # noqa: E402
    InvariantChecker,
    InvariantViolation,
)
from repro_torch.engine.request import Phase, Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.manager.scheduler import ManagerConfig  # noqa: E402
from repro_torch.manager.sib import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the reference tests' real-mode soak rates (tests/test_chaos.py), as the
# card smoke holds them
from chip_smoke import CHAOS_RATES  # noqa: E402

SOAK_RATES = dict(
    fail_rate=0.02, rejoin_rate=0.06, straggler_rate=0.05, slowdown_rate=0.02,
    pressure_rate=0.05, release_rate=0.04, dispatch_fault_rate=0.25,
    nan_rate=0.03, min_alive=2,
)
KILL_RATES = dict(fail_rate=0.08, rejoin_rate=0.20, min_alive=2,
                  max_injections=40)


def _sim_soak(port, rates, seed, *, n_req, max_events):
    """One sim-mode soak in either package on the reference's cost model."""
    hw = JHardwareSpec()
    if port:
        eng = LoongServeEngine(T_REGISTRY["lwm-7b"], 6, 24_000,
                               admission_watermark=0.1, device="cpu",
                               hw=HardwareSpec(**dataclasses.asdict(hw)))
        reqs = poisson_workload("mixed", n_req, rate=2.0, seed=11,
                                max_len=16_000)
        monkey = ChaosMonkey(eng, ChaosConfig(**rates), seed=seed)
        chk = InvariantChecker(eng)
    else:
        eng = JEngine(REGISTRY["lwm-7b"], 6, 24_000, admission_watermark=0.1,
                      hw=hw)
        reqs = j_poisson_workload("mixed", n_req, rate=2.0, seed=11,
                                  max_len=16_000)
        monkey = JChaosMonkey(eng, JChaosConfig(**rates), seed=seed)
        chk = JChecker(eng)
    for r in reqs:
        eng.submit(r)
    monkey.arm()  # chaos first, checker second (post-injection state)
    chk.arm()
    eng.run(max_events=max_events)
    monkey.disarm()
    eng.run()
    assert all(r.phase.name == "FINISHED" for r in reqs)
    assert chk.leaked_slots() == 0
    assert eng.pool.total_used == 0
    return eng, monkey, chk


@pytest.mark.parametrize("rates,seed,n_req,max_events", [
    (SOAK_RATES, 7, 25, 800),
    (KILL_RATES, 131, 30, 1500),
])
def test_sim_chaos_matches_reference(rates, seed, n_req, max_events):
    """Same seed, workload and cost model: identical injection trace and
    metrics (the kill-heavy mix drives decode- and prefill-phase salvage)."""
    pe, pm, pc = _sim_soak(True, rates, seed, n_req=n_req,
                           max_events=max_events)
    je, jm, jc = _sim_soak(False, rates, seed, n_req=n_req,
                           max_events=max_events)
    assert pm.trace_fingerprint() == jm.trace_fingerprint()
    assert pe.metrics.summary() == je.metrics.summary()
    assert pm.salvage_ratio() == jm.salvage_ratio()
    assert pc.checks == jc.checks > 0
    assert len(pm.trace) > 10
    if rates is KILL_RATES:
        assert pe.metrics.salvaged_tokens > 0


def test_invariant_checker_flags_manual_leak():
    """Negative control: the port's sanitizer fires on slots held by a rid
    the engine does not know."""
    eng = LoongServeEngine(T_REGISTRY["lwm-7b"], 2, 1000, device="cpu")
    eng.submit(Request(input_len=40, max_new_tokens=4, arrival=0.0))
    eng.run()
    chk = InvariantChecker(eng)
    chk.check()
    eng.pool.pools[0].alloc(12345, [0, 1, 2])
    with pytest.raises(InvariantViolation, match=r"\[I1\]"):
        chk.check()


@pytest.fixture(scope="module")
def models():
    jcfg = reduced(REGISTRY["lwm-7b"])
    tcfg = t_reduced(T_REGISTRY["lwm-7b"])
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return tcfg, jmodel, jparams, build_model(tcfg, device="cpu"), params


@pytest.mark.parametrize("chunk", [None, 16])
def test_real_chaos_soak_oracle_parity(models, chunk):
    """Real-mode soak with all six injectors on the reference's
    configuration: with ``chunk`` set, prefill runs as unified chains.  Zero violations and leaks, and every
    token equal to the JAX oracle."""
    cfg, jmodel, jparams, model, params = models
    eng = LoongServeEngine(cfg, 3, 600, store_values=True, model=model,
                           params=params, admission_watermark=0.15,
                           device="cpu",
                           mcfg=ManagerConfig(prefill_chunk_tokens=chunk))
    rng = np.random.default_rng(7)
    reqs, orig = [], {}
    for i in range(10):
        ilen = int(rng.integers(16, 49))
        mnt = int(rng.integers(4, 9))
        prompt = rng.integers(0, cfg.vocab_size, ilen).tolist()
        r = Request(input_len=ilen, max_new_tokens=mnt, arrival=i * 0.01,
                    prompt=list(prompt))
        reqs.append(r)
        eng.submit(r)
        orig[r.rid] = (list(prompt), mnt)
    monkey = ChaosMonkey(eng, ChaosConfig(**CHAOS_RATES), seed=7)
    chk = InvariantChecker(eng)
    monkey.arm()
    chk.arm()
    ops.reset_dispatch_counts()
    eng.run(max_events=300)
    monkey.disarm()
    eng.run()
    assert ops._fault_hook is None  # disarm cleared the port's fault seam
    assert all(r.phase is Phase.FINISHED for r in reqs)
    assert chk.leaked_slots() == 0
    assert eng.pool.total_used == 0
    actions = {t[1] for t in monkey.trace}
    for a in ("fail", "rejoin", "straggle", "slowdown", "pressure",
              "dispatch_fault", "poison"):
        assert a in actions, f"injector {a!r} never fired"
    assert eng.metrics.dispatch_retries > 0
    assert eng.metrics.nan_quarantined > 0
    if chunk is not None:
        assert ops.dispatch_counts["unified_step"] > 0
        assert ops.dispatch_counts.get("prefill_packed", 0) == 0
    for r in reqs:
        prompt0, mnt0 = orig[r.rid]
        want = jref.serial_decode_oracle(jmodel, jparams, prompt0, mnt0 - 1)
        assert list(r.output_tokens) == list(want), r.rid


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_quarantine_takes_only_the_two_bad_rows(models, monkeypatch, phase):
    """In one batch of clean rows (the packed prefill, or the paged
    decode), a poisoned request and one whose logits row the unembedding
    makes NaN: the device's flags quarantine and requeue exactly those two,
    the clean rows keep their tokens, and after the recompute every
    request's tokens equal the JAX oracle."""
    cfg, jmodel, jparams, model, params = models
    # one instance, and a modelled memory slow enough that the tiny model's
    # prefill tipping point admits the whole burst as one packed batch
    eng = LoongServeEngine(cfg, 1, 900, store_values=True, model=model,
                           params=params, device="cpu",
                           hw=HardwareSpec(hbm_bw=3.35e6))
    rng = np.random.default_rng(5)
    reqs, orig = [], {}
    for _ in range(6):
        ilen = int(rng.integers(16, 33))
        prompt = rng.integers(0, cfg.vocab_size, ilen).tolist()
        r = Request(input_len=ilen, max_new_tokens=5, prompt=list(prompt))
        reqs.append(r)
        orig[r.rid] = list(prompt)
        eng.submit(r, at=0.0)
    nan_row = []  # the row the next unembedding turns NaN

    def unembed(p, x, _orig=model.unembed):
        out = _orig(p, x)
        if nan_row:
            out = out.clone()
            out.view(-1, out.shape[-1])[nan_row.pop()] = float("nan")
        return out
    monkeypatch.setattr(model, "unembed", unembed)
    ex = eng.executor
    entry = getattr(ex, phase)
    seen = {}

    def once(batch):
        rows = batch.requests
        if seen or len(rows) < 4:
            return entry(batch)
        poisoned, bad = rows[1], rows[2]
        seen.update(poisoned=poisoned.rid, bad=bad.rid)
        before = {r.rid: len(r.output_tokens) for r in rows}
        eng._logit_poison.add(poisoned.rid)
        nan_row.append(2)
        entry(batch)
        assert eng._quarantine == {poisoned.rid, bad.rid}
        for r in rows:
            grew = len(r.output_tokens) - before[r.rid]
            assert grew == (0 if r.rid in eng._quarantine else 1), r.rid
    monkeypatch.setattr(ex, phase, once)
    requeued = []
    requeue = eng._requeue_for_recompute

    def spy(req, *a, **k):
        requeued.append(req.rid)
        return requeue(req, *a, **k)
    monkeypatch.setattr(eng, "_requeue_for_recompute", spy)
    ops.reset_dispatch_counts()
    eng.run()
    assert seen and not nan_row and not eng._logit_poison
    assert sorted(requeued) == sorted(seen.values())
    assert eng.metrics.nan_quarantined == 2
    assert ops.dispatch_counts.get("prefill_serial_model", 0) == 0
    assert all(r.phase is Phase.FINISHED for r in reqs)
    for r in reqs:
        want = jref.serial_decode_oracle(jmodel, jparams, orig[r.rid], 4)
        assert list(r.output_tokens) == list(want), r.rid
