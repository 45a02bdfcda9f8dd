"""Elastic scaling + fault tolerance demo on the PyTorch port (the
counterpart of `examples/elastic_scaling_demo.py`).

1. Proactive scale-down: a long prefill's KV lands directly in the shrunken
   target group's pools (zero migration bytes).
2. Multi-master scale-up: decode group grows with no KV movement.
3. Failure: an instance dies mid-decode; affected requests recompute and
   still finish (elasticity as the recovery mechanism).
4. Checkpoint/restore of the full serving state.

Part one is the reference demo's run, in sim mode at lwm-7b's paper scale
(SIB clock on the H100 cost model; no tensors).  Part two runs the same
four events in real mode on ``--device`` (the card by default; ``--device
cpu`` runs the kernels' plain versions) with a reduced lwm-7b: a long
prompt striped over several instances, a failure while requests decode, a
checkpoint restored into a fresh engine, and every request's tokens held
against the serial dense oracle.

  PYTHONPATH=src python examples/torch_elastic_scaling_demo.py [--device cpu]
"""
import argparse
import copy
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import init_params
from repro_torch.device import resolve_device
from repro_torch.engine.request import Phase, Request
from repro_torch.engine.server import LoongServeEngine
from repro_torch.kernels.ref import serial_decode_oracle
from repro_torch.models import build_model

from torch_quickstart import kernel_launches


def sim_demo():
    cfg = get_config("lwm-7b")
    eng = LoongServeEngine(cfg, 8, 300_000)

    # 1+2: long request -> prefill at high DoP, decode scaled down
    long_req = Request(input_len=200_000, max_new_tokens=64, arrival=0.0)
    short = [Request(input_len=2_000, max_new_tokens=64, arrival=0.01 * i)
             for i in range(6)]
    for r in [long_req] + short:
        eng.submit(r)

    # 3: kill an instance mid-flight, bring it back later
    eng.fail_instance(2, at=5.0)
    eng.join_instance(2, at=30.0)

    # 4: checkpoint after some progress, restore into a fresh engine
    eng.run(max_time=10.0)
    with tempfile.NamedTemporaryFile(suffix=".ckpt", delete=False) as f:
        path = f.name
    eng.checkpoint(path)
    eng2 = LoongServeEngine(cfg, 8, 300_000)
    eng2.restore(path)
    m = eng2.run()

    print("== elastic scaling + fault tolerance demo ==")
    for k, v in m.summary().items():
        print(f"  {k:28s} {v}")
    evicted = sum(r.n_evictions for r in m.finished)
    print(f"  recomputed-after-failure requests: {evicted}")
    assert m.scaling_migration_bytes == 0, "ESP transitions must be zero-copy"
    assert len(m.finished) == 7, [r.phase for r in m.finished]
    print("OK — all requests finished despite the instance failure")


def real_demo(dev):
    cfg = reduced(get_config("lwm-7b"))
    model = build_model(cfg, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def engine():
        return LoongServeEngine(cfg, 4, 160, store_values=True, model=model,
                                params=params, device=dev)

    rng = np.random.default_rng(5)
    # the long prompt needs three instances' pools; six short ones follow
    reqs = [Request(input_len=400, max_new_tokens=8, arrival=0.0,
                    prompt=rng.integers(0, cfg.vocab_size, 400).tolist())]
    reqs += [Request(input_len=24, max_new_tokens=8, arrival=1e-3 * (i + 1),
                     prompt=rng.integers(0, cfg.vocab_size, 24).tolist())
             for i in range(6)]
    eng = engine()
    rs = copy.deepcopy(reqs)  # the engine folds recomputed tokens into these
    for r in rs:
        eng.submit(r)
    long_r = rs[0]
    dop = 0
    while not (long_r.phase is Phase.DECODE and long_r.output_tokens):
        assert eng.events, "the long request never reached decode"
        eng.run(max_events=1)
        dop = max(dop, len(eng.pool.request_instances(long_r.rid)))
    # 3: an instance holding the long request's KV dies mid-decode, and
    # comes back a little later
    victim = eng.pool.request_instances(long_r.rid)[0]
    eng.fail_instance(victim)
    eng.join_instance(victim, at=eng.clock + 0.05)
    for _ in range(10):
        eng.run(max_events=1)
    # 4: checkpoint mid-flight, restore into a fresh engine, run to the end
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "serve.ckpt")
        eng.checkpoint(path)
        eng2 = engine()
        eng2.restore(path)
    m = eng2.run()

    print(f"== the same events in real mode ({dev}, reduced lwm-7b) ==")
    print(f"  long prompt striped over {dop} instances; instance {victim} "
          "failed mid-decode and rejoined")
    for k in ("n_finished", "scaling_migration_bytes", "recomputed_tokens",
              "salvaged_tokens"):
        print(f"  {k:28s} {m.summary()[k]}")
    assert dop >= 3, dop
    assert m.scaling_migration_bytes == 0, "ESP transitions must be zero-copy"
    assert len(m.finished) == len(reqs), [r.phase for r in m.finished]
    with torch.no_grad():
        for orig, r in zip(reqs, rs):
            r = eng2._req_index[r.rid]  # the restored engine's copy
            want = serial_decode_oracle(model, params, orig.prompt,
                                        orig.max_new_tokens - 1)
            assert want == list(r.output_tokens), (r.rid, want,
                                                   r.output_tokens)
    print(f"token parity: {len(reqs)} requests == serial dense oracle")
    print("kernel launches:", json.dumps(kernel_launches(), sort_keys=True))
    print("OK — real-mode tokens survive the failure and the restore")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda by default (raises without a card); cpu "
                         "must be named")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sim_demo()
    real_demo(dev)


if __name__ == "__main__":
    main()
