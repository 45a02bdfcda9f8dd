"""Elastic fault recovery on the port's engine: KV salvage + scale-down
resume through the unified step, against the JAX package.

A single-instance failure mid-chain at DoP 2 and 4 (the reference's
`_TOPOLOGIES`, tests/test_salvage.py) salvages the survivors' KV: each
salvaged request recomputes at most its lost stripe, the sanitizer stays
green, and every token equals the JAX `serial_decode_oracle`.  Decode-phase
salvage in sim mode gives the JAX engine's accounting and metrics exactly
(same cost model).  A checkpoint taken while a unified chain is in flight
restores into a fresh engine that resumes the chain at its cursor.
"""
import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.engine.request import Phase as JPhase  # noqa: E402
from repro.engine.request import Request as JRequest  # noqa: E402
from repro.engine.server import LoongServeEngine as JEngine  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.manager.sib import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.invariants import InvariantChecker  # noqa: E402
from repro_torch.engine.request import Phase, Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.manager.scheduler import ManagerConfig  # noqa: E402
from repro_torch.manager.sib import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import SALVAGE_TOPOLOGIES  # noqa: E402

JCFG = reduced(REGISTRY["lwm-7b"])
TCFG = t_reduced(T_REGISTRY["lwm-7b"])


@pytest.fixture(scope="module")
def models():
    jmodel = j_build_model(JCFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(TCFG, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, build_model(TCFG, device="cpu"), params


def _engine(models, n, cap, chunk):
    _, _, model, params = models
    return LoongServeEngine(TCFG, n, cap, store_values=True, model=model,
                            params=params, device="cpu",
                            mcfg=ManagerConfig(prefill_chunk_tokens=chunk))


def _assert_oracle(models, reqs, done):
    """``reqs`` hold the original prompts (folding mutates the engine's)."""
    jmodel, jparams, _, _ = models
    for orig, r in zip(reqs, done):
        want = jref.serial_decode_oracle(jmodel, jparams, orig.prompt,
                                         orig.max_new_tokens - 1)
        assert want == r.output_tokens, (r.rid, want, r.output_tokens)


def _salvage_workload(rng, n_short=3, long_len=240):
    reqs = []
    for _ in range(n_short):
        ln = int(rng.integers(20, 30))
        reqs.append(Request(
            input_len=ln, max_new_tokens=8, arrival=0.0,
            prompt=rng.integers(0, TCFG.vocab_size, ln).tolist(),
        ))
    reqs.append(Request(
        input_len=long_len, max_new_tokens=4, arrival=0.03,
        prompt=rng.integers(0, TCFG.vocab_size, long_len).tolist(),
    ))
    return reqs


# (group DoP, engine instances, per-instance capacity, long prompt): the
# reference's topologies, as the card smoke holds them — the long prompt
# exceeds (dop-1) instances' capacity, so the placement stripes it over `dop`
# instances
@pytest.mark.parametrize("dop,n,cap,long_len", SALVAGE_TOPOLOGIES)
def test_mid_chain_failure_salvage_parity(models, dop, n, cap, long_len):
    """Mid-chain failure at DoP 2 / 4: the chain salvages instead of
    recomputing, the recovery holes run as unified chunks, and the tokens
    are the no-failure oracle's."""
    rng = np.random.default_rng(29)
    reqs = _salvage_workload(rng, long_len=long_len)
    eng = _engine(models, n, cap, 48)
    chk = InvariantChecker(eng)
    chk.arm()
    rs = copy.deepcopy(reqs)
    for r in rs:
        eng.submit(r)
    long_r = rs[-1]
    guard = 0
    while not (
        long_r.phase is Phase.PREFILL
        and long_r.prefill_pos >= int(0.8 * long_len)
        and len(eng.pool.request_instances(long_r.rid)) >= dop
        and any(e[2] == "unified_done" for e in eng.events)
    ):
        assert eng.events and guard < 2000, "never reached a striped mid-chain"
        eng.run(max_events=1)
        guard += 1
    victim = eng.pool.request_instances(long_r.rid)[0]
    held = {
        rid: len(eng.pool.pools[victim].tokens_of(rid))
        for rid in eng.pool.pools[victim].requests()
    }
    # the survivors' KV of the chain so far lives only in the device mirror
    # (fill_packed write-through): salvage must still see it
    assert any(p.stale_host_slot_count() for p in eng.pool.pools
               if p.instance_id != victim)
    eng.fail_instance(victim)
    eng.run(max_events=1)  # the fail event is next
    rec = dict(eng._recovering)
    assert long_r.rid in rec, "mid-chain failure did not salvage the chain"
    for rid, st in rec.items():
        lost = sum(e - s for s, e in st.spans)
        assert lost <= held.get(rid, 0), (rid, st.spans, held)
        assert st.salvaged > 0
    ops.reset_dispatch_counts()
    m = eng.run()
    assert len(m.finished) == len(rs)
    assert eng.metrics.salvaged_tokens > 0
    assert eng.metrics.recomputed_tokens < sum(r.seq_len for r in rs)
    assert ops.dispatch_counts["unified_step"] > 0  # holes ran as chunks
    assert not eng._recovering
    assert chk.leaked_slots() == 0
    assert eng.pool.total_used == 0
    _assert_oracle(models, reqs, rs)


def test_decode_phase_salvage_sim_accounting():
    """Failure during decode (sim mode): the prefix minus the dead stripe is
    salvaged and the request resumes decode; the accounting and the whole
    metrics summary equal the JAX engine's on the same cost model."""
    hw = JHardwareSpec()
    runs = {}
    for tag, Eng, Req, Ph, kw in (
        ("port", LoongServeEngine, Request, Phase,
         dict(hw=HardwareSpec(**dataclasses.asdict(hw)), device="cpu")),
        ("jax", JEngine, JRequest, JPhase, dict(hw=hw)),
    ):
        cfg = TCFG if tag == "port" else JCFG
        eng = Eng(cfg, 3, 100, **kw)
        reqs = [Req(input_len=150, max_new_tokens=10, arrival=0.0)
                for _ in range(2)]
        for r in reqs:
            eng.submit(r)
        guard = 0
        while not any(r.phase is Ph.DECODE and r.generated >= 2 for r in reqs):
            assert eng.events and guard < 800, "no request reached decode"
            eng.run(max_events=1)
            guard += 1
        vr = next(r for r in reqs if r.phase is Ph.DECODE and r.generated >= 2)
        insts = eng.pool.request_instances(vr.rid)
        assert len(insts) >= 2, insts
        victim = next(i for i in insts if i not in eng.failed)
        survivors_hold = sum(
            len(p) for p in eng.pool.coverage_map(vr.rid, {victim}).values()
        )
        victim_holds = len(eng.pool.pools[victim].tokens_of(vr.rid))
        eng.fail_instance(victim)
        eng.run(max_events=1)
        rec = eng._recovering.get(vr.rid)
        assert rec is not None and rec.resume_decode
        assert rec.expected == rec.salvaged + sum(e - s for s, e in rec.spans)
        assert eng.metrics.salvaged_tokens >= survivors_hold
        assert eng.metrics.recomputed_tokens <= victim_holds
        m = eng.run()
        assert len(m.finished) == len(reqs)
        assert all(r.generated == r.max_new_tokens for r in reqs)
        assert eng.pool.total_used == 0
        snap = eng.metrics.snapshot()
        assert snap["salvage_ratio"] > 0
        runs[tag] = (eng.metrics.summary(), snap["salvage_ratio"],
                     [len(r.output_tokens) for r in reqs])
    assert runs["port"] == runs["jax"]


def test_checkpoint_restore_mid_unified_chain_resumes(models, tmp_path):
    """Checkpoint while a unified chain is in flight: cursors, the chain
    registry and the chunk KV (which so far lives only in the device
    mirror) round-trip; the restored engine rebuilds its mirrors on its own
    device and resumes the chain at its cursor with oracle tokens."""
    rng = np.random.default_rng(31)
    reqs = _salvage_workload(rng, n_short=2, long_len=200)
    eng = _engine(models, 2, 600, 32)
    rs = copy.deepcopy(reqs)
    for r in rs:
        eng.submit(r)
    long_r = rs[-1]
    guard = 0
    while not (
        long_r.phase is Phase.PREFILL
        and 0 < long_r.prefill_pos < long_r.input_len
        and any(e[2] == "unified_done" for e in eng.events)
    ):
        assert eng.events and guard < 1000, "never caught the chain mid-link"
        eng.run(max_events=1)
        guard += 1
    cursor = long_r.prefill_pos
    stale = sum(p.stale_host_slot_count() for p in eng.pool.pools)
    assert stale > 0  # chunk KV written device-side only, so far
    path = str(tmp_path / "mid_chain.ckpt")
    eng.checkpoint(path)
    assert sum(p.stale_host_slot_count() for p in eng.pool.pools) == 0

    eng2 = _engine(models, 2, 600, 32)
    eng2.restore(path)
    assert eng2._active_unified, "in-flight chain registry did not round-trip"
    r2 = eng2._req_index[long_r.rid]
    assert r2.prefill_pos == cursor
    assert any(e[2] == "unified_done" for e in eng2.events)
    for p, p0 in zip(eng2.pool.pools, eng.pool.pools):
        assert p.device == p0.device and p._mirror is None
        # the host copy restored the chunk KV the mirror held
        for rid in p0.requests():
            np.testing.assert_array_equal(p.gather(rid)[1], p0.gather(rid)[1])
    ops.reset_dispatch_counts()
    m = eng2.run()
    assert len(m.finished) == len(rs)
    total_input = sum(r.input_len for r in rs)
    assert ops.dispatch_counts["unified_prefill_tokens"] <= total_input - cursor
    _assert_oracle(models, reqs, [eng2._req_index[x.rid] for x in rs])
