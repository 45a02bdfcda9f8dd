"""Run one cell of the benchmark once.

    python3 esp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; its configuration
is ``esp_bench/configs/<config>.json``, its traffic mix
``esp_bench/traffic/<traffic>.json`` and each metric is read by
``esp_bench/metrics/<metric>.py``, all found by name.  The last line of
standard output is the result as one JSON object; the numbers compared
for ``correct`` are the last lines of standard error.

``--rehearse-cpu`` runs the same path on the CPU at a tiny size (two
layers of width 2048, a 512-token vocabulary, short prompts, float32):
for tests and for a look at the control flow, never a measurement.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "esp_bench"
# every build and kernel cache of the program stays inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start() -> float:
    """Seconds from this process's start to T_IMPORT (0 where /proc is not
    readable)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T_IMPORT), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T0_OFFSET = _since_process_start()


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def metrics_of(bench: dict, cell: str, trace: bool):
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or else the file of the name with its last
    dotted parts dropped: one formula serves the names that split it by
    the kind of cell (``device.idle_share.open`` and ``.backlog`` are
    both read by ``device.idle_share.py``)."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for the metric {name}")


def reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"esp_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rehearsal(cfg: dict, mix: dict):
    """A tiny configuration and mix for a run on the CPU (width 2048, so
    that the logits spread about as widely as at the cells' widths): the
    dense keys shrunk here, then the family's own (expert widths, state
    sizes) by its reference module's ``rehearse(cfg) -> cfg`` where it
    defines one.

    Its limit is set from its own readings, as a cell's is from the card:
    sound runs of the float32 program read a gap of 0.0 on 12 seeds, the
    float8 control 0.21-0.45 on 4 (the float8 gap grows with width and
    vocabulary, so it stays under the cells' limits at this size)."""
    from esp_bench import lookup

    cfg = dict(cfg, n_layers=2, d_model=2048, n_heads=8,
               n_kv_heads=min(cfg["n_kv_heads"], 8), d_head=32, d_ff=512,
               vocab_size=512, dtype="float32", capacity_per_instance=2048,
               logit_gap_limit=0.05)
    rehearse = getattr(lookup.reference(cfg), "rehearse", None)
    if rehearse is not None:
        cfg = rehearse(cfg)
    laws = [dict(law, prompt=dict(law["prompt"], median=24, lo=4, hi=96),
                 output=dict(lo=8, hi=20)) for law in mix["mix"]]
    mix = dict(mix, mix=laws, n=min(mix["n"], 600),
               rate=mix.get("rate", 1.0) * 20, warmup=[[16, 2], [40, 2]])
    return cfg, mix


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true")
    ap.add_argument("--rate", type=float, default=None,
                    help="override the mix's rate (the rate sweep only)")
    ap.add_argument("--control", action="store_true",
                    help="put the control (the reference in float8) in the "
                         "program's place: its gap on the same sample decides "
                         "correct (setting the limit only)")
    args = ap.parse_args(argv)
    return run(args)


def run(args, fault=None, guard=True) -> int:
    """One run.  Tests only: `fault` breaks the engine after it is built,
    and ``guard=False`` skips the check for JAX's modules (a test process
    holds them for the other test files)."""
    import torch

    from esp_bench import check, drive, traffic, weights
    from esp_bench.stats import served_split
    from esp_bench.trace import Trace, breakdown, busy, clip

    bench, cell, cfg, mix = load_cell(args.workload)
    if args.rate is not None:
        mix = dict(mix, rate=args.rate)
    if args.rehearse_cpu:
        cfg, mix = rehearsal(cfg, mix)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"esp_bench: needs {cell['chips']} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    trace = bool(args.trace) and device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    stages = {}

    def stage(name, t):
        sync()
        stages[name] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    params = weights.draw(cfg, args.seed, device)
    t = stage("weights", t)
    eng = drive.build(cfg, params, device)
    t = stage("engine", t)
    drive.build_mirrors(eng)
    t = stage("mirrors", t)
    rec = drive.Record(cfg=cfg, mix=mix)
    drv = drive.Driver(eng, rec, device, spans=bool(args.trace))
    drv.warm_up(mix["warmup"], cfg["vocab_size"])
    t = stage("warm_up", t)
    if fault is not None:
        fault(eng)
    items = [it for it in traffic.items(mix) if it.due < args.seconds]
    prompts = traffic.prompts([it.prompt_len for it in items], cfg["vocab_size"],
                              args.seed)
    rejected0 = eng.metrics.rejected
    if mix.get("preload"):
        drv.preload(items, prompts)
        items, prompts = [], []
        t = stage("preload", t)
    gc.collect()
    up0 = sum(p.mirror_uploaded_slots for p in eng.pool.pools)
    sync()
    rec.setup_s = T0_OFFSET + time.perf_counter() - T_IMPORT
    tr = Trace(device) if trace else None
    if tr:
        tr.start()
    drv.window(items, prompts, args.seconds)
    if tr:
        rec.kernels = clip(tr.stop(), rec.t0, rec.t_close)
    sync()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    left = sum(1 for d in rec.reqs if d["n_out"] < d["out_len"])
    rec.counters.update(
        rejected=eng.metrics.rejected - rejected0,
        preemptions=eng.metrics.preemptions,
        unfinished=left, finished=len(rec.reqs) - left,
        mirror_uploaded_slots=sum(p.mirror_uploaded_slots for p in eng.pool.pools) - up0,
        host_syncs=sum(p.host_syncs for p in eng.pool.pools),
        prefill_calls=sum(c["kind"] == "prefill" for c in rec.calls),
        decode_calls=sum(c["kind"] == "decode" for c in rec.calls),
        lateness_max_s=max(rec.lateness, default=0.0),
        lateness_mean_s=sum(rec.lateness) / max(len(rec.lateness), 1))
    rec.counters["served_prompt_tokens"], rec.counters["served_output_tokens"] = (
        served_split(rec.reqs, rec.t0, rec.t_close))
    for d in rec.reqs:
        d["served"] = list(d.pop("req").output_tokens[:d["out_len"]])
    rec.counters["waiting_at_close"] = sum(1 for d in rec.reqs if d["started"] is None)
    print("esp_bench set-up stages (s) " + json.dumps(stages), flush=True)
    print("esp_bench counters " + json.dumps(rec.counters), flush=True)

    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": False, "attempted": len(rec.reqs),
              "failed": rec.counters["rejected"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if trace:
        calls = [(f"executor.{c['kind']}", c["start"], c["end"]) for c in rec.calls]
        result["device"]["busy_s"] = sum(b - a for a, b in busy(rec.kernels))
        result["device"]["window_s"] = rec.window_s
        result["breakdown"] = breakdown(rec.kernels, rec.spans + calls,
                                        rec.t0, rec.t_close)

    # the comparison, once the program's state is freed
    del drv, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = check.sample(rec, args.seed)
    lowp = "fp8" if args.control else None
    gap = max(check.gaps(cfg, params, sample, device, lowp=lowp), default=float("inf"))
    limits = {"logit_gap": {"value": gap, "limit": cfg["logit_gap_limit"],
                            "of": lowp or "program",
                            "sampled_requests": len(sample),
                            "sampled_tokens": sum(d["out_len"] for d in sample)}}
    ok = gap <= cfg["logit_gap_limit"]
    if mix["kind"] == "backlog":
        limits["backlog_left"] = {"value": left, "limit": "at least 1"}
        ok = ok and left >= 1
    bad = forbidden_modules() if guard else []
    if bad:
        print(f"esp_bench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    result["correct"] = bool(ok)
    result["check"] = limits
    for k, v in limits.items():
        print(f"esp_bench check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
