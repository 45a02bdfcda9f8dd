"""End-to-end serving entry point: the PyTorch counterpart of
`repro/launch/serve.py`.

Runs the LoongServe engine (or one of the baselines) over a synthetic
workload, in sim mode (SIB clock on the H100 cost model; paper scale) or
real mode (the reduced model generating tokens through the distributed
pools, on the card by default).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch lwm-7b \\
      --dataset mixed --rate 0.5 --n 64 --system loongserve
  PYTHONPATH=src python -m repro_torch.launch.serve --real --n 8 --dataset sharegpt

``--device`` names the device real mode runs on (``cuda`` by default;
nothing falls back to the CPU: without CUDA ``--real`` raises, and
``--device cpu`` must be asked for).  Sim mode holds no tensors and runs
anywhere, as the reference's does.

After the engine's summary the run prints the totals of its records
(`repro_torch.obs.snapshot()`: per span or mark, count, seconds,
exclusive seconds and the sum of values; the key ``"obs"`` under
``--json``).
"""
from __future__ import annotations

import argparse
import json
import sys

# the serving systems `build_engine` knows: LoongServe and the paper's baselines
SYSTEMS = ("loongserve", "vllm-tp", "chunked", "pd-disagg", "replicated")


def build_engine(system: str, cfg, n_instances: int, capacity: int, *,
                 device="cuda", **kw):
    """The serving system `system` (one of `SYSTEMS`) on `cfg`.  `device` is
    the LoongServe engine's compute device in real mode; the baselines are
    sim-mode engines that hold none."""
    from repro_torch.baselines import (
        ChunkedPrefillEngine,
        FixedGroupsEngine,
        PDDisaggEngine,
        StaticTPEngine,
    )
    from repro_torch.engine.server import LoongServeEngine

    if system == "loongserve":
        return LoongServeEngine(cfg, n_instances, capacity, device=device, **kw)
    if system == "vllm-tp":
        return StaticTPEngine(cfg, n_instances, capacity, **kw)
    if system == "chunked":
        return ChunkedPrefillEngine(cfg, n_instances, capacity, **kw)
    if system == "pd-disagg":
        return PDDisaggEngine(cfg, n_instances, capacity, **kw)
    if system == "replicated":
        groups = [[i] for i in range(n_instances)]
        return FixedGroupsEngine(cfg, n_instances, capacity, groups=groups, **kw)
    raise ValueError(system)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lwm-7b")
    ap.add_argument("--system", default="loongserve", choices=SYSTEMS)
    ap.add_argument("--dataset", default="mixed",
                    choices=["sharegpt", "leval", "lveval", "mixed"])
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=250_000)
    ap.add_argument("--real", action="store_true",
                    help="reduced model, real token generation on --device")
    ap.add_argument("--device", default="cuda",
                    help="the device --real runs on (cuda by default; cpu "
                         "must be named)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import poisson_workload, with_prompts

    cfg = get_config(args.arch)
    kw = {}
    if args.real:
        import torch

        from repro_torch.convert import init_params
        from repro_torch.device import resolve_device
        from repro_torch.models import build_model

        dev = resolve_device(args.device)
        cfg = reduced(cfg)
        model = build_model(cfg, device=dev)
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
        kw = dict(store_values=True, model=model, params=params)
        capacity = 4096
        reqs = poisson_workload(args.dataset, args.n, args.rate,
                                seed=args.seed, max_len=256)
        for r in reqs:
            r.max_new_tokens = min(r.max_new_tokens, 16)
        with_prompts(reqs, cfg.vocab_size, args.seed)
    else:
        capacity = args.capacity
        reqs = poisson_workload(args.dataset, args.n, args.rate, seed=args.seed)

    eng = build_engine(args.system, cfg, args.instances, capacity,
                       device=args.device, **kw)
    for r in reqs:
        eng.submit(r)
    metrics = eng.run()
    summary = metrics.summary()
    records = obs.snapshot()
    if args.json:
        print(json.dumps(dict(summary, obs=records), indent=1))
    else:
        print(f"=== {args.system} on {args.dataset} (rate {args.rate}) ===")
        for k, v in summary.items():
            print(f"  {k:28s} {v}")
        if args.real and metrics.finished:
            r0 = metrics.finished[0]
            print(f"  sample output tokens: {r0.output_tokens[:8]}")
        print("  records (count, seconds, exclusive s, sum of values):")
        for k, t in records.items():
            print(f"  {k:34s} {t['count']:7d} {t['seconds']:10.6f} "
                  f"{t['exclusive_s']:10.6f} {t['value']:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
