#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LoongServe on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit; none is caught):
  1. print the card's name and power limit; build the hand-written kernels
     from src/repro_torch/csrc (one nvcc per source, in parallel) and print
     the ``-Xptxas -v`` summary;
  2. hold each kernel against its plain PyTorch version on the same inputs,
     TF32 off, at full-width lwm-7b shapes (H = KVH = 32, D = 128): K1 over a
     ragged packed batch of ~8k tokens, K3 through full rings of 2 and 4
     shards, K2 with B = 16 and contexts up to 4k at page_size 1 and 16;
     plus small variants (glm4-width GQA, window, softcap, empty rows);
  3. time each kernel, its plain version and (K1) the library call
     `scaled_dot_product_attention` with the block-diagonal causal mask —
     a yardstick only, never called by the port — against the least time
     the card could take (bytes over 3.35 TB/s, operations over 989
     TFLOP/s bf16);
  4. serve full-width, full-depth lwm-7b in bf16 (random weights drawn on
     the card from a seed) with 4 elastic instances: 8 requests of 512-2048
     prompt tokens, 16 new tokens each; every kernel must be launched and no
     serial prefill run;
  5. token parity at full width and reduced depth (2 layers, f32): the
     engine's greedy tokens equal the port's plain serial oracle exactly.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of this repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (data sheet)
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
TOL_OUT = 1e-4  # normalized outputs: f32 accumulation, other order, <=4k keys
TOL_M = 1e-4  # running max: the same scores summed in another order
RTOL_L = 1e-4  # softmax denominators (up to thousands): relative

# ------------------------------------------------------------------ helpers


def _time_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _offsets(lens, n_slots):
    off = np.full(n_slots + 1, sum(lens), np.int32)
    off[0] = 0
    off[1:len(lens) + 1] = np.cumsum(lens)
    return off


def _segments(off, t):
    """Segment lengths the kernel computes: the requests, then the bucket
    padding (its own segment)."""
    segs = [int(b - a) for a, b in zip(off[:-1], off[1:]) if b > a]
    if t > off[-1]:
        segs.append(int(t - off[-1]))
    return segs


def _ring_pairs(off, t, n, r, c):
    """Attending (q, k) token pairs of one ring step (q shard r, KV chunk c):
    same segment and gk <= gq over global striped positions."""
    total = 0
    start = 0
    for ln in _segments(off, t):
        gq = np.arange(start + (r - start) % n, start + ln, n)  # q residue r
        first_c = start + (c - start) % n  # first k position with residue c
        total += int(np.maximum((gq - first_c) // n + 1, 0).sum())
        start += ln
    return total


def _fin(o, l):
    import torch

    return o / torch.where(l == 0, torch.ones_like(l), l)[..., None]


def _check(name, got, want, log):
    """Hold a kernel's (o[, m, l]) against its plain version; returns the max
    abs error of the normalized output."""
    import torch

    if isinstance(got, torch.Tensor):
        err = (got - want).abs().max().item()
        ok = err <= TOL_OUT
        log.append(f"  {name}: max_abs_err {err:.3e} (tol {TOL_OUT:g})")
    else:
        o, m, l = got[0], got[1], got[2]
        wo, wm, wl = want[0], want[1], want[2]
        fin = torch.isfinite(wm)
        same_empty = bool((torch.isfinite(m) == fin).all())
        err = (_fin(o, l) - _fin(wo, wl)).abs().max().item()
        em = (m[fin] - wm[fin]).abs().max().item() if fin.any() else 0.0
        el = ((l - wl).abs() / wl.abs().clamp_min(1e-30)).max().item()
        ok = same_empty and err <= TOL_OUT and em <= TOL_M and el <= RTOL_L
        log.append(f"  {name}: max_abs_err(o/l) {err:.3e} (tol {TOL_OUT:g}), "
                   f"m {em:.3e} (tol {TOL_M:g}), l rel {el:.3e} "
                   f"(tol {RTOL_L:g}), empty rows match {same_empty}")
    if not ok:
        print("\n".join(log))
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------- phases


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernel libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")


def phase_kernels(rec, card):
    """Checks (phase 2) and timings (phase 3) at full-width shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import striped
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import paged_flash_prefill as pfp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    H, KVH, D = 32, 32, 128
    log = ["[check] kernels vs plain versions (TF32 off)"]

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- K1: ragged packed batch, ~8k tokens on an 8192 bucket, bf16
    lens = [2048, 1536, 1024, 1024, 768, 512, 512, 300, 200, 100, 90]
    T = 8192
    off = _offsets(lens, 16)  # trailing repeats: empty segments
    q, k, v = randn(T, H, D), randn(T, KVH, D), randn(T, KVH, D)
    got = pfp.packed_flash_prefill(q, k, v, off)
    want = pfp.packed_flash_prefill_plain(q, k, v, off)
    err_k1 = _check(f"K1 T={T} B={len(lens)} bf16", got, want, log)
    del got, want
    segs = _segments(off, T)
    flops = 4 * H * D * sum(s * (s + 1) // 2 for s in segs)
    bytes_ = T * (H + 2 * KVH) * D * 2 + T * H * D * 4
    ms = _time_ms(lambda: pfp.packed_flash_prefill(q, k, v, off))
    plain_ms = _time_ms(lambda: pfp.packed_flash_prefill_plain(q, k, v, off), 3, 1)
    seg_id = torch.as_tensor(np.repeat(np.arange(len(segs)), segs), device=dev)
    ti = torch.arange(T, device=dev)
    mask = (seg_id[:, None] == seg_id[None, :]) & (ti[:, None] >= ti[None, :])
    q4, k4, v4 = (x.transpose(0, 1)[None].contiguous() for x in (q, k, v))
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), 5, 1)
    del mask, q4, k4, v4
    rec["K1"] = dict(
        name="packed_flash_prefill", route="cuda",
        source="src/repro_torch/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/paged_flash_prefill.py:160",
        max_abs_err=err_k1, ms=ms, plain_ms=plain_ms,
        bound_ms=max(flops / PEAK_BF16, bytes_ / HBM_BPS) * 1e3,
        bound_by="operations" if flops / PEAK_BF16 > bytes_ / HBM_BPS else "bytes",
        library_ms=lib_ms,
    )
    print(f"[time {card}] K1 T={T}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"sdpa+mask {lib_ms:.3f} ms, bound {rec['K1']['bound_ms']:.4f} ms "
          f"({rec['K1']['bound_by']}; {flops / 1e9:.1f} GFLOP, "
          f"{bytes_ / 1e6:.1f} MB)")

    # ---- K3: full rings of n shards over the same batch
    for n in (2, 4):
        qs = [q[r::n].contiguous() for r in range(n)]
        ks = [k[r::n].contiguous() for r in range(n)]
        vs = [v[r::n].contiguous() for r in range(n)]
        offs = [striped.shard_offsets(off, n, r) for r in range(n)]
        sched = striped.ring_chunk_schedule(n)

        def ring(fn):
            carries = [None] * n
            for step in range(n):
                for r in range(n):
                    c = sched[step][r]
                    carries[r] = fn(qs[r], ks[c], vs[c], offs[r], offs[c],
                                    carries[r], q_shard=r, k_shard=c, n_shards=n)
            return carries

        kc, pc = [None] * n, [None] * n
        errs = []
        for step in range(n):  # every step against the plain step, same carry
            for r in range(n):
                c = sched[step][r]
                args = (qs[r], ks[c], vs[c], offs[r], offs[c])
                kw = dict(q_shard=r, k_shard=c, n_shards=n)
                kc[r] = pfp.packed_flash_prefill_ring_chunk(*args, pc[r], **kw)
                want_c = pfp.packed_flash_prefill_ring_chunk_plain(*args, pc[r], **kw)
                errs.append(_check(f"K3 n={n} step={step} shard={r}", kc[r],
                                   want_c, log))
                pc[r] = want_c
        ring_out = striped.unstripe(torch.cat([_fin(o, l) for o, _, l in kc]),
                                    n, axis=0)
        k1 = pfp.packed_flash_prefill_plain(q, k, v, off)
        errs.append(_check(f"K3 ring n={n} finalized vs plain K1", ring_out,
                           k1, log))
        del kc, pc, ring_out, k1
        launches = n * n
        flops = sum(4 * H * D * _ring_pairs(off, T, n, r, c)
                    for r in range(n) for c in range(n))
        tl = T // n
        per = tl * (H + 2 * KVH) * D * 2 + 2 * tl * H * (D + 2) * 4
        bytes_ = launches * per - n * tl * H * (D + 2) * 4  # no carry in at step 0
        ms = _time_ms(lambda: ring(pfp.packed_flash_prefill_ring_chunk), 5) / launches
        plain_ms = _time_ms(lambda: ring(pfp.packed_flash_prefill_ring_chunk_plain),
                            1, 1) / launches
        bound = max(flops / PEAK_BF16, bytes_ / HBM_BPS) * 1e3 / launches
        print(f"[time {card}] K3 ring n={n} (T={T}, {launches} launches): kernel "
              f"{ms:.3f} ms/launch, plain {plain_ms:.3f} ms/launch, bound "
              f"{bound:.4f} ms/launch ({flops / 1e9:.1f} GFLOP per ring)")
        if n == 4:
            rec["K3"] = dict(
                name="packed_flash_prefill_ring_chunk", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/paged_flash_prefill.py:320",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations" if flops / PEAK_BF16 > bytes_ / HBM_BPS else "bytes",
                library_ms=None,
            )
        del qs, ks, vs
    del q, k, v

    # ---- K2: B = 16, contexts up to 4k, f32 pool (the engine's mirror type)
    B = 16
    ctx = rng.integers(256, 4097, B).astype(np.int32)
    for page in (1, 16):
        npg = -(-ctx // page)
        n_pages = int(npg.sum()) + 8
        kp = randn(n_pages, page, KVH, D, dtype=torch.float32)
        vp = randn(n_pages, page, KVH, D, dtype=torch.float32)
        perm = rng.permutation(n_pages)
        table = np.zeros((B, int(npg.max())), np.int32)
        c0 = 0
        for b in range(B):
            table[b, :npg[b]] = perm[c0:c0 + npg[b]]
            c0 += npg[b]
        qd = randn(B, 1, H, D)
        bt = torch.as_tensor(table, device=dev)
        ln = torch.as_tensor(ctx, device=dev)
        got = pfd.paged_flash_decode_partial(qd, kp, vp, bt, ln)
        want = pfd.paged_flash_decode_partial_plain(qd, kp, vp, bt, ln)
        err = _check(f"K2 B={B} page={page} ctx<={int(ctx.max())}", got, want, log)
        nbytes = (2 * int(ctx.sum()) * KVH * D * 4 + B * H * D * 2
                  + B * H * (D + 2) * 4 + int(npg.sum()) * 4 + B * 4)
        flops = 4 * H * D * int(ctx.sum())
        ms = _time_ms(lambda: pfd.paged_flash_decode_partial(qd, kp, vp, bt, ln), 20)
        plain_ms = _time_ms(lambda: pfd.paged_flash_decode_partial_plain(
            qd, kp, vp, bt, ln), 5)
        bound = max(nbytes / HBM_BPS, flops / PEAK_BF16) * 1e3
        print(f"[time {card}] K2 B={B} page={page} sum_ctx={int(ctx.sum())}: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
              f"(bytes; {nbytes / 1e6:.1f} MB)")
        if page == 1:  # the engine's default page size
            rec["K2"] = dict(
                name="paged_flash_decode_partial", route="cuda",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_flash_decode.py:114",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BPS >= flops / PEAK_BF16 else "operations",
                library_ms=None,
            )
        del kp, vp, got, want

    # ---- small variants: glm4-width GQA, window, softcap, empty rows
    lens = [1, 0, 37, 200, 0, 129, 64]
    T = 448  # 3/4-point bucket
    off = _offsets(lens, 8)
    for kvh, window, softcap, dt in [(2, None, None, torch.float32),
                                     (2, 96, None, torch.bfloat16),
                                     (32, None, 30.0, torch.float32),
                                     (2, 64, 30.0, torch.bfloat16)]:
        tag = f"KVH={kvh} window={window} softcap={softcap} {str(dt)[6:]}"
        q, k, v = randn(T, H, D, dtype=dt), randn(T, kvh, D, dtype=dt), randn(T, kvh, D, dtype=dt)
        kw = dict(window=window, softcap=softcap)
        _check(f"K1 {tag}", pfp.packed_flash_prefill(q, k, v, off, **kw),
               pfp.packed_flash_prefill_plain(q, k, v, off, **kw), log)
        for n in (2, 4):
            offs = [striped.shard_offsets(off, n, r) for r in range(n)]
            r, c = n - 1, 0
            args = (q[r::n], k[c::n], v[c::n], offs[r], offs[c], None)
            skw = dict(q_shard=r, k_shard=c, n_shards=n, **kw)
            _check(f"K3 n={n} {tag}",
                   pfp.packed_flash_prefill_ring_chunk(*args, **skw),
                   pfp.packed_flash_prefill_ring_chunk_plain(*args, **skw), log)
        b = 6
        sctx = np.array([0, 1, 300, 77, 0, 1000], np.int32)  # empty rows too
        for page in (1, 16):
            npg = -(-sctx // page)
            n_pages = int(npg.sum()) + 4
            kp = randn(n_pages, page, kvh, D, dtype=dt)
            vp = randn(n_pages, page, kvh, D, dtype=dt)
            table = np.zeros((b, int(npg.max())), np.int32)
            pos = np.full((n_pages, page), -1, np.int32)
            perm, c0 = rng.permutation(n_pages), 0
            for i in range(b):
                pages = perm[c0:c0 + npg[i]]
                c0 += npg[i]
                table[i, :npg[i]] = pages
                for j, pg in enumerate(pages):
                    pos[pg] = np.arange(j * page, (j + 1) * page)
            a = [randn(b, 1, H, D, dtype=dt), kp, vp,
                 torch.as_tensor(table, device=dev), torch.as_tensor(sctx, device=dev),
                 torch.as_tensor(pos, device=dev)]
            dkw = dict(query_pos=a[4], **kw)
            got = pfd.paged_flash_decode_partial(*a, **dkw)
            want = pfd.paged_flash_decode_partial_plain(*a, **dkw)
            _check(f"K2 page={page} {tag}", got, want, log)
            assert torch.isinf(got.m[0]).all() and (got.l[0] == 0).all()
    print("\n".join(log))
    torch.cuda.empty_cache()


def _serve(cfg, n_inst, capacity, lens, new_tokens, seed, check_oracle):
    """One real-mode engine run; returns (metrics, kernel launches, dispatch
    counts, wall seconds, {stage: seconds} spans)."""
    import torch

    from repro_torch.convert import init_params
    from repro_torch.engine.request import Request
    from repro_torch.engine.server import LoongServeEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import paged_flash_prefill as pfp
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    eng = LoongServeEngine(cfg, n_inst, capacity, store_values=True,
                           model=model, params=params)
    rng = np.random.default_rng(seed)
    reqs = [Request(input_len=n, max_new_tokens=new_tokens, arrival=0.0,
                    prompt=rng.integers(0, cfg.vocab_size, n).tolist())
            for n in lens]
    for r in reqs:
        eng.submit(r)
    # build the pool mirrors (one full host->device upload each) before the
    # clock starts, and time it on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pool in eng.pool.pools:
        pool.device_kv()
    torch.cuda.synchronize()
    spans = {"mirror_build": time.perf_counter() - t0}

    def timed(key, fn):
        """Host-clock span of one executor stage, synchronized at both ends
        (the stages end in a device->host copy anyway)."""
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                torch.cuda.synchronize()
                spans[key] = spans.get(key, 0.0) + time.perf_counter() - t
        return run

    ex = eng.executor
    ex.prefill = timed("prefill", ex.prefill)
    ex.decode = timed("decode", ex.decode)
    ex._emit_decoded = timed("decode: emit + KV to host", ex._emit_decoded)
    for pool in eng.pool.pools:
        pool.device_kv = timed("mirror sync", pool.device_kv)
    up0 = sum(p.mirror_uploaded_slots for p in eng.pool.pools)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_counts()  # counts of the main path only, from here
    pfp.launch_counts.clear()
    pfd.launch_counts.clear()
    t0 = time.perf_counter()
    m = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans["uploaded_slots"] = sum(p.mirror_uploaded_slots for p in eng.pool.pools) - up0
    spans["host_syncs"] = sum(p.host_syncs for p in eng.pool.pools)
    counts = dict(pfp.launch_counts) | dict(pfd.launch_counts)
    dispatch = dict(ops.dispatch_counts)
    assert len(m.finished) == len(reqs), (len(m.finished), len(reqs))
    assert m.scaling_migration_bytes == 0, m.scaling_migration_bytes
    for name in ("packed_flash_prefill", "packed_flash_prefill_ring_chunk",
                 "paged_flash_decode_partial"):
        assert counts.get(name, 0) > 0, (name, counts)
    assert dispatch.get("prefill_serial_model", 0) == 0, dispatch
    for r in reqs:
        assert len(r.output_tokens) == new_tokens, r.output_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.output_tokens)
    if check_oracle:
        from repro_torch.kernels import ref

        for r in reqs:
            want = ref.serial_decode_oracle(model, params, r.prompt, new_tokens - 1)
            assert r.output_tokens == want, (r.rid, r.output_tokens, want)
    return m, counts, dispatch, wall, spans


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    phase_build()
    rec: dict = {}
    phase_kernels(rec, smi.splitlines()[0])

    from repro_torch.configs import get_config

    # ---- phase 4: full-width, full-depth lwm-7b in bf16, 4 instances
    cfg = get_config("lwm-7b")
    lens = [int(x) for x in np.random.default_rng(0).integers(512, 2049, 8)]
    m, counts, dispatch, wall, spans = _serve(cfg, 4, 4096, lens, 16, 0, False)
    summ = m.summary()
    toks = sum(len(r.output_tokens) for r in m.finished)
    print(f"[serve] lwm-7b full width/depth bf16, 4 instances x 4096 slots, "
          f"{len(lens)} requests (prompts {lens}), 16 new tokens each: "
          f"wall {wall:.3f} s, {toks} tokens out, prefill_iters "
          f"{summ['prefill_iters']}, decode_iters {summ['decode_iters']}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[serve] kernel launches {counts}; dispatches {dispatch}")
    print("[serve] spans (s; emit nests in decode, mirror sync in prefill and decode): "
          + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in spans.items()))
    layers = cfg.n_layers
    print(f"[serve] per step: K2 {counts['paged_flash_decode_partial'] / max(summ['decode_iters'], 1) / layers:.2f} "
          f"launches per layer per decode iteration; K1 "
          f"{counts['packed_flash_prefill'] / layers:.0f} DoP=1 batch-layers; K3 "
          f"{counts['packed_flash_prefill_ring_chunk'] / layers:.0f} ring launches per layer")
    rec["K1"]["launches"] = counts["packed_flash_prefill"]
    rec["K3"]["launches"] = counts["packed_flash_prefill_ring_chunk"]
    rec["K2"]["launches"] = counts["paged_flash_decode_partial"]
    gc.collect()  # the engine and its executor reference each other
    torch.cuda.empty_cache()

    # ---- phase 5: parity at full width, reduced depth, f32
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    lens2 = [int(x) for x in np.random.default_rng(1).integers(128, 1025, 6)]
    _, counts2, _, wall2, _ = _serve(cfg2, 4, 2048, lens2, 8, 1, True)
    print(f"[parity] lwm-7b width, 2 layers, f32: {len(lens2)} requests "
          f"(prompts {lens2}) token-identical to the serial oracle; launches "
          f"{counts2}; wall {wall2:.3f} s")

    order = ("K1", "K3", "K2")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rec[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
