"""Fig.10-style comparison on the PyTorch port: LoongServe vs vLLM-TP vs
chunked prefill vs PD-disaggregation on the four paper workloads (SIB-clock
simulation on the H100 cost model; the counterpart of
`examples/compare_systems.py`).

The simulation holds no tensors; ``--device`` (``cuda`` by default, which
raises without a card; ``cpu`` when asked) is the device the LoongServe
engine would compute on, resolved as every entry point of the port does.

  PYTHONPATH=src python examples/torch_compare_systems.py [--n 80] [--device cpu]
"""
import argparse
import copy
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

from repro_torch.configs import get_config
from repro_torch.data import poisson_workload
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="cuda by default (raises without a card); cpu "
                         "must be named")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("lwm-7b")
    CAP = 250_000
    systems = ["loongserve", "vllm-tp", "chunked", "pd-disagg"]
    for ds, rate in [("sharegpt", 4.0), ("leval", 0.5), ("lveval", 0.15),
                     ("mixed", 0.5)]:
        reqs = poisson_workload(ds, args.n, rate, seed=7)
        print(f"=== {ds} (rate {rate}) ===")
        base_e2e = None
        for name in systems:
            eng = build_engine(name, cfg, 8, CAP, device=dev)
            for r in copy.deepcopy(reqs):
                eng.submit(r)
            m = eng.run().summary()
            e2e = m.get("norm_e2e_mean", float("nan"))
            if name == "loongserve":
                base_e2e = e2e
            speedup = (e2e / base_e2e) if base_e2e else float("nan")
            print(
                f"  {name:12s} e2e={e2e:.5f} in={m.get('norm_input_mean', 0):.5f} "
                f"out={m.get('norm_output_mean', 0):.5f} fin={m.get('n_finished')} "
                f"mig={m.get('reactive_migration_bytes', 0)/1e9:.1f}GB "
                f"(loongserve is {speedup:.2f}x better)"
            )


if __name__ == "__main__":
    main()
