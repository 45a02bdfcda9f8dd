"""Quickstart on the PyTorch port: serve a reduced LWM model end to end
with LoongServe (the counterpart of `examples/quickstart.py`).

Real compute on ``--device`` (the card by default; ``--device cpu`` runs
the kernels' plain versions): requests flow pending -> ESP prefill
(proactive scale-down places KV tokens across instance pools with ZERO
migration) -> multi-master decode -> finished, generating real tokens,
each request's tokens held against the serial dense oracle.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import init_params
from repro_torch.data import poisson_workload, with_prompts
from repro_torch.device import resolve_device
from repro_torch.engine.server import LoongServeEngine
from repro_torch.kernels.ref import serial_decode_oracle
from repro_torch.models import build_model


def kernel_launches() -> dict:
    """Launches of every hand-written kernel so far in this process (each
    wrapper counts its CUDA launches; the plain versions count none)."""
    from repro_torch.kernels import (flash_decode, paged_flash_decode,
                                     paged_flash_prefill, striped_attention)

    out = {}
    for mod in (paged_flash_prefill, paged_flash_decode, striped_attention,
                flash_decode):
        out.update(mod.launch_counts)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda by default (raises without a card); cpu "
                         "must be named")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("lwm-7b"))
    model = build_model(cfg, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    eng = LoongServeEngine(
        cfg, n_instances=4, capacity_per_instance=2048,
        store_values=True, model=model, params=params, device=dev,
    )
    reqs = poisson_workload("sharegpt", 8, rate=2.0, seed=1, max_len=120)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, 12)
    with_prompts(reqs, cfg.vocab_size, seed=2)
    for r in reqs:
        eng.submit(r)

    metrics = eng.run()
    print(f"== LoongServe quickstart (PyTorch port, {dev}) ==")
    for k, v in metrics.summary().items():
        print(f"  {k:28s} {v}")
    print("\nScaling-migration bytes (ESP zero-overhead invariant):",
          metrics.scaling_migration_bytes)
    for r in metrics.finished[:3]:
        print(f"  r{r.rid}: in={r.input_len} -> out {r.output_tokens}")
    assert metrics.scaling_migration_bytes == 0
    assert len(metrics.finished) == len(reqs)
    with torch.no_grad():
        for r in metrics.finished:
            want = serial_decode_oracle(model, params, r.prompt,
                                        len(r.output_tokens) - 1)
            assert want == list(r.output_tokens), (r.rid, want,
                                                   r.output_tokens)
    print(f"token parity: {len(metrics.finished)} requests == serial dense "
          "oracle")
    print("kernel launches:", json.dumps(kernel_launches(), sort_keys=True))
    print("OK")


if __name__ == "__main__":
    main()
