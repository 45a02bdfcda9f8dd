#!/usr/bin/env python3
"""Time each pass of the split-K decode kernels (K2, K5) on a CUDA card.

    python3 tools/decode_probe.py

At the shapes `chip_smoke.py` times — K2 at B 16 with contexts 256-4096
over an f32 pool (H = KVH = 32, D 128, bf16 q; page size 1 with the pages
scattered or in order, and page size 16); K5 at mixtral width (B 1, 4095
window keys, GQA 32/8, D 128), also run in row blocks of one q head, and
with 1 q head per KV head (the same bytes, a quarter of the FMAs); K5 at
zamba2 width (B 1, 8192 keys, 32 heads, D 80); bf16, L2 cold — it prints,
for each planner setting, the plan, the device time per call (CUDA events
around a CUDA graph of 20 calls, as chip_smoke.py times them) and the mean
duration of each kernel from torch.profiler: pass 1 (`split_kernel`) and
the merge (`merge_kernel`).  A setting is the port's own planner
(`kernels/decode_split.py::plan`) or a fixed number of 64-key tiles per
split.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# planner settings per case: ("port", None) is kernels/decode_split.py::plan
# as it ships; ("tiles", k) fixes k 64-key tiles per split
K2_SETTINGS = [("port", None), ("tiles", 4), ("tiles", 16), ("tiles", 64)]
K5_SETTINGS = [("port", None), ("tiles", 1), ("tiles", 2), ("tiles", 4)]


def _plan_with(own, ds, kind, arg):
    """A planner for one setting, from the port's own planner ``own``."""

    def plan(b, kvh, n_keys_bound, *, q_per_kv=1, n_sm=ds.H100_SMS):
        if kind == "port":
            return own(b, kvh, n_keys_bound, q_per_kv=q_per_kv, n_sm=n_sm)
        tiles = max(1, -(-n_keys_bound // ds.TILE))
        per = min(arg, tiles)
        return -(-tiles // per), per * ds.TILE
    return plan


def _kernel_ms(call, n=20):
    """Mean duration per call of pass 1 and of the merge (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
    out = {"split": 0.0, "merge": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        for key in out:
            if f"{key}_kernel" in e.key:
                out[key] += us / 1e3 / n
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import COLD_BYTES, _device_ms
    from repro_torch.kernels import decode_split as ds
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_flash_decode as pfd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []  # (tag, bound args for the plan, call(i), settings)
    # ---- K2: B 16, contexts 256-4096, f32 pool (chip_smoke.py's timed shape)
    B, H, KVH, D = 16, 32, 32, 128
    ctx = rng.integers(256, 4097, B).astype(np.int32)
    qd = randn(B, 1, H, D)
    ln = torch.as_tensor(ctx, device=dev)
    for page, scattered in ((1, True), (1, False), (16, True)):
        npg = -(-ctx // page)
        n_pages = int(npg.sum()) + 8
        kp = randn(n_pages, page, KVH, D, dtype=torch.float32)
        vp = randn(n_pages, page, KVH, D, dtype=torch.float32)
        order = rng.permutation(n_pages) if scattered else np.arange(n_pages)
        table = np.zeros((B, int(npg.max())), np.int32)
        c0 = 0
        for b in range(B):
            table[b, :npg[b]] = order[c0:c0 + npg[b]]
            c0 += npg[b]
        bt = torch.as_tensor(table, device=dev)
        tag = f"K2 page={page} {'scattered' if scattered else 'in order'}"
        cases.append((tag, (B, KVH, bt.shape[1] * page, 1),
                      lambda i, a=(qd, kp, vp, bt, ln): pfd.paged_flash_decode_partial(*a),
                      K2_SETTINGS))
    # ---- K5 at the serial path's widths, L2 cold (rotating k / v copies);
    # mixtral's GQA group also in row blocks of one q head, and mixtral's KV
    # width with one q head per KV head (the same bytes, a quarter the FMAs)
    for tag, s, h, kvh, d, window in (("K5 mixtral ctx=5000", 5000, 32, 8, 128, 4096),
                                      ("K5 mixtral rows/CTA=1", 5000, 32, 8, 128, 4096),
                                      ("K5 mixtral-kv q_per_kv=1", 5000, 8, 8, 128, 4096),
                                      ("K5 zamba2 ctx=8192", 8192, 32, 32, 80, None)):
        q = randn(1, 1, h, d)
        k, v = randn(1, s, kvh, d), randn(1, s, kvh, d)
        n_cp = max(2, -(-COLD_BYTES // (k.nbytes + v.nbytes)))
        kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n_cp - 1)]
        l5 = torch.tensor([s], dtype=torch.int32, device=dev)
        bound = s if window is None else min(s, window - 1)
        cases.append((tag, (1, kvh, bound, h // kvh),
                       lambda i, q=q, kvs=kvs, l5=l5, w=window, n=n_cp:
                       fd.flash_decode_partial(q, *kvs[i % n], l5, window=w),
                       K5_SETTINGS))

    own_plan, own_rows = ds.plan, ds.rows_per_cta
    try:
        for tag, (b, kvh, bound, qpk), call, settings in cases:
            # "rows/CTA=n": a GQA group of 4 runs in row blocks of n
            rows = int(tag.split("rows/CTA=")[1]) if "rows/CTA=" in tag else None
            ds.rows_per_cta = (lambda g, n=rows: min(n, own_rows(g))) if rows else own_rows
            for kind, arg in settings:
                ds.plan = _plan_with(own_plan, ds, kind, arg)
                n_splits, chunk = ds.plan(b, kvh, bound, q_per_kv=qpk,
                                          n_sm=ds.sm_count(dev))
                ms, how = _device_ms(call)
                parts = _kernel_ms(call)
                ctas = b * kvh * -(-qpk // ds.rows_per_cta(qpk)) * n_splits
                print(f"[probe {card}] {tag} {kind} {arg}: "
                      f"plan {n_splits} x {chunk} keys ({ctas} CTAs): {ms:.4f} ms/call "
                      f"({how}); pass 1 {parts['split']:.4f} ms, merge "
                      f"{parts['merge']:.4f} ms (profiler)")
    finally:
        ds.plan, ds.rows_per_cta = own_plan, own_rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
