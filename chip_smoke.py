#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LoongServe on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit; none is caught):
  1. print the card's name and power limit; build the hand-written kernels
     from src/repro_torch/csrc (one nvcc per source, in parallel) and print
     the ``-Xptxas -v`` summary;
  2. hold each kernel against its plain PyTorch version on the same inputs,
     TF32 off (bf16 K1 / K3 / K4 run on the tensor cores and are held to
     1e-4 + 2^-8 max|v| with a mean error within 1e-3; f32 operands and K2 /
     K5 to 1e-4): K1-K3 at full-width lwm-7b shapes (H = KVH = 32, D = 128): K1
     over a ragged packed batch of ~8k tokens, K3 through full rings of 2 and
     4 shards, K2 with B = 16 and contexts up to 4k at page_size 1 and 16;
     K4 at mixtral width (H 32 / KVH 8, D 128, bf16, S 6144, window 4096)
     and zamba2 width (H = KVH = 32, D 80, S 4096); K5 at both widths with
     B = 1 and 8k contexts, and at B = 16 with k_pos_offset > 0, a window
     and empty rows; plus small variants (GQA, non-causal, window, softcap,
     striped and unsorted positions, B > 1, f32, empty rows);
  3. time each kernel, its plain version and the library call that computes
     the same function — `scaled_dot_product_attention` with the same mask
     (K1, K4), `aten._scaled_dot_product_flash_attention` over the valid
     keys (K5) — a yardstick only, never called by the port — against the
     least time the card could take (bytes over 3.35 TB/s, operations over
     989 TFLOP/s bf16); for K1, K3 and K4 also the achieved TFLOP/s, the
     share of the bound and the f32 route's time at the same shapes.  K2 and
     K5 (and K5's flash call) are timed as device time per call: CUDA events
     around the replay of a CUDA graph of 20 calls (the profiler's kernel
     durations if capture is refused), with K5's calls rotated over copies
     of k / v that exceed 64 MB, so L2 is cold as it is in serving; their
     eager wrapper's time per call is printed beside.  The text lines also
     give the time each kernel's previous design took on the H100
     (``PREV_MS``, not measured in this run);
  4. serve full-width, full-depth lwm-7b in bf16 (random weights drawn on
     the card from a seed) with 4 elastic instances: 8 requests of 512-2048
     prompt tokens, 16 new tokens each; K1, K2 and K3 must be launched and
     no serial prefill run;
  5. token parity at full width and reduced depth (2 layers, f32): the
     engine's greedy tokens equal the port's plain serial oracle exactly;
  6. serve full-width mixtral-8x7b (moe) in bf16, cut to 16 of its 32 layers
     (full depth is ~93 GB of bf16 weights; 16 layers are ~47 GB), through
     the engine's serial path: 7 requests (6 prompts of 512-2048 tokens and
     one of 5000, which the 4096-token window masks), 12 new tokens each;
     K4 and K5 must be launched and K1-K3 not;
  7. serve full-width, full-depth zamba2-2.7b (hybrid: 54 Mamba2 layers,
     the shared attention block applied 9 times, head dim 80) in bf16 the
     same way, 6 requests of 512-2048 tokens;
  8. token parity of both serial families at full width and reduced depth
     in f32 (mixtral 2 layers with a 4200-token prompt so the window bites;
     zamba2 one superblock): the engine's tokens equal the port's plain
     serial oracle exactly;
  9. unified serving: full-width, full-depth lwm-7b in bf16 with
     ``ManagerConfig(prefill_chunk_tokens=512)``, 4 instances x 4096 slots,
     four prompts of 512-1024 tokens (24 new tokens each) and a 4096-token
     prompt arriving at t = 0.05 s (8 new tokens): every prefill runs as a
     chain of unified steps (K2 as the per-token prefix plane, K3 as the
     chunk plane; K1 never launches), at least 3 links carry decode rows
     while the long prompt is mid-prefill, and every large prefix-plane
     launch plans one split (no split-K workspace); spans for the host
     tables, the model step, the emit and the decode outside the chain;
  10. unified parity at full width, 2 layers, f32: chunk-resume for chunk
     budgets 4096 / 37 / 1, a mid-chain instance failure at DoP 2 and 4
     that salvages the survivors' KV (tests/test_salvage.py's topologies
     x10), and a checkpoint taken mid-chain restored into a fresh engine
     that resumes at its cursor; tokens equal the serial oracle;
  11. the real-mode chaos soak of tests/test_chaos.py at full width, 2
     layers, f32 (all six injectors), on the packed / paged path and on
     the unified path: every injector fires, zero invariant violations and
     leaks, tokens equal the serial oracle.

Phases 2-3 also hold K2 and K3 at the unified step's shapes (K2: B = 512
per-token rows over tables 4096 wide, a third of them empty; K3: n_shards
= 1, four chunks, 32 one-row segments and padding, carried from K2's
output) and add their times and both K2 bounds (distinct bytes, bytes as
launched) to the K2 / K3 rows as ``unified_*`` fields.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of this repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_F32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
TOL_OUT = 1e-4  # normalized outputs: f32 accumulation, other order, <=8k keys
BF16_ROUND = 2.0 ** -7  # a bf16 output may round to the neighbouring value
TOL_M = 1e-4  # running max: the same scores summed in another order
RTOL_L = 1e-4  # softmax denominators (up to thousands): relative
# bf16 operands of K1 / K3 / K4 run on the tensor cores (csrc/attn_tc.cuh):
# Q K^T of bf16 operands accumulates exactly in f32, but each softmax weight
# is rounded to bf16 (at most 2^-9 of it) before P V, so the normalized
# output may move by 2^-9 max|v|; the factor 2 covers the rescale by alpha
TC_P_ROUND = 2.0 ** -8  # times max|v|, on top of TOL_OUT
TOL_MEAN = 1e-3  # mean abs error of the normalized output, tensor-core route
# the kernels' times in their previous design (K1 / K3 / K4: fp32-FMA bodies
# on bf16 operands; K2 / K5: one CTA per request and KV head; this script on
# an NVIDIA H100 80GB HBM3 at 700 W), printed beside the new ones in the text
# lines only: the JSON table holds what this run measured
PREV_MS = {"K1": 6.711, "K3": 0.861, "K4": 15.889, "K4 zamba2": 6.971,
           "K2": 2.541, "K5": 0.8049, "K5 zamba2": 1.536}
COLD_BYTES = 64 * 2**20  # K / V copies a timed K5 call rotates over: > L2 (50 MB)

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


def _device_ms(call, calls=20, reps=5):
    """Device time per call of ``call(i)``: CUDA events around replays of a
    CUDA graph of ``calls`` calls (i = 0 .. calls - 1), so the host's Python
    is not in the time; where capture is refused, the profiler's kernel
    durations over the same calls.  Returns (ms, how it was measured)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capturing stream
        for i in range(3):
            call(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for i in range(calls):
                call(i)
    except RuntimeError as e:  # capture refused: the profiler's kernel times
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                call(i)
            torch.cuda.synchronize()
        us = sum(getattr(e_, "device_time_total", getattr(e_, "cuda_time_total", 0.0))
                 for e_ in prof.key_averages())
        return us / 1e3 / calls, (f"profiler kernel durations over {calls} calls "
                                  f"(graph capture refused: {str(e)[:60]})")
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / (reps * calls), f"device time, graph of {calls} calls"


def _rates(flops, ms, bound_ms):
    """Achieved rate and share of the bound of one timed kernel."""
    return (f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f}% of its bound")


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


def _check(name, got, want, log, v=None):
    """Hold a kernel's (o[, m, l]) against its plain version; returns the max
    abs error of the normalized output.  ``v`` (the values) marks the bf16
    tensor-core route: the output tolerance is TOL_OUT + 2^-8 max|v| and the
    mean error must stay within TOL_MEAN.  A bf16 output (K4) is the result
    rounded once more, so it may land one bf16 step from the plain one: its
    tolerance adds 2^-7 |plain|."""
    import torch

    tol_v = TOL_OUT if v is None else TOL_OUT + TC_P_ROUND * v.float().abs().max().item()
    tol = f"{tol_v:.3g}" + ("" if v is None else " (1e-4 + 2^-8 max|v|)")
    if isinstance(got, torch.Tensor):
        diff = (got.float() - want.float()).abs()
        if got.dtype == torch.bfloat16:
            ok = bool((diff <= tol_v + BF16_ROUND * want.float().abs()).all())
            tol += " + 2^-7 |plain|"
        else:
            ok = diff.max().item() <= tol_v
    else:
        o, m, l = got[0], got[1], got[2]
        wo, wm, wl = want[0], want[1], want[2]
        fin = torch.isfinite(wm)
        same_empty = bool((torch.isfinite(m) == fin).all())
        diff = (_fin(o, l) - _fin(wo, wl)).abs()
        em = (m[fin] - wm[fin]).abs().max().item() if fin.any() else 0.0
        el = ((l - wl).abs() / wl.abs().clamp_min(1e-30)).max().item()
        ok = (same_empty and diff.max().item() <= tol_v and em <= TOL_M
              and el <= RTOL_L)
        tol += (f"; m {em:.3e} (tol {TOL_M:g}), l rel {el:.3e} (tol {RTOL_L:g}), "
                f"empty rows match {same_empty}")
    err, mean = diff.max().item(), diff.mean().item()
    if v is not None:
        ok = ok and mean <= TOL_MEAN
        tol += f"; mean {mean:.3e} (tol {TOL_MEAN:g})"
    log.append(f"  {name}: max_abs_err {err:.3e} (tol {tol})")
    if not ok:
        print("\n".join(log))
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------- phases


def _short_kernel_name(mangled):
    """A ptxas entry name, demangled (``c++filt``) without the namespaces
    and parameter lists; the mangled name where c++filt is missing."""
    try:
        name = subprocess.run(["c++filt", "-p"], input=mangled, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    for junk in ("repro::decode::", "repro::tc::", "repro::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    return name


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernel libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():  # one line per kernel: registers, spills
        entry, spill = None, ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line:
                spill = line.split(":")[-1].strip()
            elif "Used" in line and entry:
                used = line.split(":")[-1].strip()
                print(f"[ptxas {name}] {_short_kernel_name(entry)}: {used}; {spill}")
                entry = None


def phase_kernels(rec, card):
    """Checks (phase 2) and timings (phase 3) at full-width shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import striped
    from repro_torch.kernels import decode_split
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
    err_k1 = _check(f"K1 T={T} B={len(lens)} bf16", got, want, log, v=v)
    del got, want
    qf, kf, vf = q.float(), k.float(), v.float()  # the f32 (FMA) route
    _check(f"K1 T={T} B={len(lens)} f32", pfp.packed_flash_prefill(qf, kf, vf, off),
           pfp.packed_flash_prefill_plain(qf, kf, vf, off), log)
    f32_ms = _time_ms(lambda: pfp.packed_flash_prefill(qf, kf, vf, off), 3)
    del qf, kf, vf
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
    print(f"[time {card}] K1 T={T}: kernel {ms:.3f} ms (previous design, earlier run: {PREV_MS['K1']} ms), "
          f"{_rates(flops, ms, rec['K1']['bound_ms'])}, plain {plain_ms:.3f} ms, "
          f"sdpa+mask {lib_ms:.3f} ms, f32 route {f32_ms:.3f} ms, bound "
          f"{rec['K1']['bound_ms']:.4f} ms ({rec['K1']['bound_by']}; "
          f"{flops / 1e9:.1f} GFLOP, {bytes_ / 1e6:.1f} MB)")

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
                                   want_c, log, v=v))
                pc[r] = want_c
        ring_out = striped.unstripe(torch.cat([_fin(o, l) for o, _, l in kc]),
                                    n, axis=0)
        k1 = pfp.packed_flash_prefill_plain(q, k, v, off)
        errs.append(_check(f"K3 ring n={n} finalized vs plain K1", ring_out,
                           k1, log, v=v))
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
        f32 = ""
        if n == 4:  # the f32 (FMA) route at the same shapes
            qs, ks, vs = ([x.float() for x in xs] for xs in (qs, ks, vs))
            ring_f32 = striped.unstripe(torch.cat(
                [_fin(o, l) for o, _, l in ring(pfp.packed_flash_prefill_ring_chunk)]),
                n, axis=0)
            _check(f"K3 ring n={n} f32 finalized vs plain K1", ring_f32,
                   pfp.packed_flash_prefill_plain(q.float(), k.float(), v.float(), off),
                   log)
            del ring_f32
            f32 = (f", f32 route "
                   f"{_time_ms(lambda: ring(pfp.packed_flash_prefill_ring_chunk), 2) / launches:.3f}"
                   " ms/launch")
        print(f"[time {card}] K3 ring n={n} (T={T}, {launches} launches): kernel "
              f"{ms:.3f} ms/launch" + (f" (previous design, earlier run: {PREV_MS['K3']} ms)" if n == 4 else "")
              + f", {_rates(flops / launches, ms, bound)}, plain {plain_ms:.3f} "
              f"ms/launch{f32}, bound {bound:.4f} ms/launch ({flops / 1e9:.1f} "
              "GFLOP per ring)")
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
        # the pool (2 x 1.1 GB at page 1) is far larger than L2: cold anyway
        ms, how = _device_ms(lambda i: pfd.paged_flash_decode_partial(qd, kp, vp, bt, ln))
        eager_ms = _time_ms(lambda: pfd.paged_flash_decode_partial(qd, kp, vp, bt, ln), 20)
        plain_ms = _time_ms(lambda: pfd.paged_flash_decode_partial_plain(
            qd, kp, vp, bt, ln), 5)
        bound = max(nbytes / HBM_BPS, flops / PEAK_BF16) * 1e3
        n_splits, chunk = decode_split.plan(B, KVH, bt.shape[1] * page,
                                            q_per_kv=H // KVH,
                                            n_sm=decode_split.sm_count(dev))
        print(f"[time {card}] K2 B={B} page={page} sum_ctx={int(ctx.sum())}: kernel "
              f"{ms:.4f} ms ({how}; previous design, earlier run: {PREV_MS['K2']} ms), "
              f"eager wrapper {eager_ms:.4f} ms/call, {100 * bound / ms:.1f}% of its "
              f"bound, plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes; "
              f"{nbytes / 1e6:.1f} MB), plan {n_splits} split(s) of {chunk} keys, "
              f"{B * KVH * n_splits} CTAs")
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
        tcv = v if dt == torch.bfloat16 else None  # the tensor-core route
        _check(f"K1 {tag}", pfp.packed_flash_prefill(q, k, v, off, **kw),
               pfp.packed_flash_prefill_plain(q, k, v, off, **kw), log, v=tcv)
        for n in (2, 4):
            offs = [striped.shard_offsets(off, n, r) for r in range(n)]
            r, c = n - 1, 0
            args = (q[r::n], k[c::n], v[c::n], offs[r], offs[c], None)
            skw = dict(q_shard=r, k_shard=c, n_shards=n, **kw)
            _check(f"K3 n={n} {tag}",
                   pfp.packed_flash_prefill_ring_chunk(*args, **skw),
                   pfp.packed_flash_prefill_ring_chunk_plain(*args, **skw), log,
                   v=tcv)
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


# the unified step's operands at lwm-7b width: (prefix, rows) of each
# prefill chunk, then UNI_DECODES one-row decode segments, padded to UNI_T
UNI_CHUNKS = [(3584, 64), (2048, 112), (1024, 128), (0, 160)]
UNI_DECODES = 32
UNI_T = 512
UNI_TABLE = 4096  # table width: the engine buckets max pages to a power of 2


def _plain_rows(fn, q, kp, vp, bt, ln, rows=32):
    """K2's plain version over blocks of ``rows`` rows (the same math per
    row; one gather of 512 rows x 4096 keys would need ~60 GB)."""
    import torch

    from repro_torch.models.attention import Partial

    parts = [fn(q[i:i + rows], kp, vp, bt[i:i + rows], ln[i:i + rows])
             for i in range(0, q.shape[0], rows)]
    return Partial(*(torch.cat(x) for x in zip(*parts)))


def phase_unified_kernels(rec, card):
    """K2 and K3 at the unified step's shapes (phases 2 and 3): K2 as the
    prefix plane (one row per packed token, each carrying its request's
    whole table row), K3 as the chunk plane (n_shards = 1) folding the chunk
    into K2's partial as its carry.  Added to the K2 / K3 rows as
    ``unified_*`` fields."""
    import torch

    from repro_torch.kernels import decode_split
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import paged_flash_prefill as pfp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    H, KVH, D = 32, 32, 128
    log = ["[check] K2 / K3 at the unified step's shapes vs plain versions (TF32 off)"]
    prefixes = [p for p, _ in UNI_CHUNKS] + [
        int(x) for x in rng.integers(512, 3585, UNI_DECODES)]
    seg_lens = [n for _, n in UNI_CHUNKS] + [1] * UNI_DECODES
    n_tok = sum(seg_lens)
    pad = UNI_T - n_tok
    assert pad > 0
    # the pool: every request's keys on scattered slots (page size 1)
    n_slots = sum(prefixes) + 8
    kp = torch.randn((n_slots, 1, KVH, D), generator=gen, device=dev)
    vp = torch.randn((n_slots, 1, KVH, D), generator=gen, device=dev)
    perm = rng.permutation(n_slots).astype(np.int32)
    table = np.zeros((UNI_T, UNI_TABLE), np.int32)
    lengths = np.zeros(UNI_T, np.int32)
    c = c0 = 0
    for p, n in zip(prefixes, seg_lens):
        table[c:c + n, :p] = perm[c0:c0 + p]
        lengths[c:c + n] = p
        c0 += p
        c += n
    bt = torch.as_tensor(table, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    q = torch.randn((UNI_T, H, D), generator=gen, device=dev).to(torch.bfloat16)
    qd = q[:, None]
    empty = float((lengths == 0).mean())
    n_splits, chunk = decode_split.plan(UNI_T, KVH, UNI_TABLE, q_per_kv=H // KVH,
                                        n_sm=decode_split.sm_count(dev))
    assert n_splits == 1, (n_splits, chunk)  # no workspace at this size
    part = pfd.paged_flash_decode_partial(qd, kp, vp, bt, ln)
    want = _plain_rows(pfd.paged_flash_decode_partial_plain, qd, kp, vp, bt, ln)
    err2 = _check(f"K2 unified prefix plane B={UNI_T} ({empty:.0%} rows empty)",
                  part, want, log)
    del want
    key_rows = int(lengths.sum())
    distinct = sum(prefixes)
    kv_b = KVH * D * 4 * 2  # f32 K + V per key
    other = (UNI_T * H * D * 2 + UNI_T * H * (D + 2) * 4 + UNI_T * 4)
    launched_bytes = key_rows * kv_b + other + key_rows * 4
    distinct_bytes = distinct * kv_b + other + distinct * 4
    flops = 4 * H * D * key_rows  # f32 FMAs over the f32 pool
    ms, how = _device_ms(lambda i: pfd.paged_flash_decode_partial(qd, kp, vp, bt, ln))
    plain_ms = _time_ms(lambda: _plain_rows(pfd.paged_flash_decode_partial_plain,
                                            qd, kp, vp, bt, ln), 1, 0)
    bound = max(distinct_bytes / HBM_BPS, flops / PEAK_F32) * 1e3
    bound_launched = max(launched_bytes / HBM_BPS, flops / PEAK_F32) * 1e3
    rec["K2"].update(unified_shape=(
        f"B {UNI_T} per-token rows, table {UNI_TABLE} wide, prefixes "
        f"{[p for p, _ in UNI_CHUNKS]} + {UNI_DECODES} decode rows, {empty:.0%} "
        "empty, f32 pool, bf16 q, page 1"),
        unified_ms=ms, unified_plain_ms=plain_ms, unified_max_abs_err=err2,
        unified_bound_ms=bound, unified_launched_bound_ms=bound_launched)
    print(f"[time {card}] K2 unified prefix plane (B={UNI_T}, {key_rows} key-rows "
          f"as launched, {distinct} distinct keys): kernel {ms:.4f} ms ({how}), "
          f"{launched_bytes / ms / 1e9:.2f} TB/s as launched, plain {plain_ms:.1f} ms, "
          f"bound {bound:.4f} ms (distinct bytes {distinct_bytes / 1e9:.2f} GB), "
          f"as-launched bound {bound_launched:.4f} ms ({launched_bytes / 1e9:.2f} GB); "
          f"plan {n_splits} split of {chunk} keys, {UNI_T * KVH} CTAs, no workspace")
    # ---- K3: the chunk plane folded into K2's partial (rows of chunk 3 and
    # the padding carry nothing: m = -inf, l = 0)
    off = np.full(len(seg_lens) + 1 + 7, n_tok, np.int32)  # trailing empty segs
    off[0] = 0
    off[1:len(seg_lens) + 1] = np.cumsum(seg_lens)
    offd = torch.as_tensor(off, device=dev)
    k = torch.randn((UNI_T, KVH, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((UNI_T, KVH, D), generator=gen, device=dev).to(torch.bfloat16)
    carry = (part.o[:, 0].contiguous(), part.m[:, 0].contiguous(),
             part.l[:, 0].contiguous())
    assert torch.isinf(carry[1]).any() and torch.isfinite(carry[1]).any()
    kw = dict(q_shard=0, k_shard=0, n_shards=1)
    got = pfp.packed_flash_prefill_ring_chunk(q, k, v, offd, offd, carry, **kw)
    want = pfp.packed_flash_prefill_ring_chunk_plain(q, k, v, offd, offd, carry, **kw)
    err3 = _check(f"K3 unified chunk plane T={UNI_T} (carry from K2)", got, want,
                  log, v=v)
    del got, want
    segs = _segments(off, UNI_T)
    flops3 = 4 * H * D * sum(s_ * (s_ + 1) // 2 for s_ in segs)
    bytes3 = UNI_T * (H + 2 * KVH) * D * 2 + 2 * UNI_T * H * (D + 2) * 4
    ms3, how3 = _device_ms(lambda i: pfp.packed_flash_prefill_ring_chunk(
        q, k, v, offd, offd, carry, **kw))
    plain3 = _time_ms(lambda: pfp.packed_flash_prefill_ring_chunk_plain(
        q, k, v, offd, offd, carry, **kw), 3, 1)
    bound3 = max(flops3 / PEAK_BF16, bytes3 / HBM_BPS) * 1e3
    rec["K3"].update(unified_shape=(
        f"T {UNI_T}, n_shards 1, chunks {[n for _, n in UNI_CHUNKS]} + "
        f"{UNI_DECODES} one-row segments + {pad} padding, carry from K2, bf16"),
        unified_ms=ms3, unified_plain_ms=plain3, unified_max_abs_err=err3,
        unified_bound_ms=bound3)
    print(f"[time {card}] K3 unified chunk plane (T={UNI_T}, {len(segs)} segments): "
          f"kernel {ms3:.4f} ms ({how3}), {_rates(flops3, ms3, bound3)}, plain "
          f"{plain3:.3f} ms, bound {bound3:.5f} ms ({bytes3 / 1e6:.1f} MB, "
          f"{flops3 / 1e9:.2f} GFLOP)")
    print("\n".join(log))
    del kp, vp, part, carry
    torch.cuda.empty_cache()


def _attended_pairs(qp, kp, causal, window):
    """(q, k) pairs the position mask admits: the work K4's bound counts."""
    total = 0
    kp = np.asarray(kp, np.int64)
    for i in range(0, len(qp), 1024):
        d = np.asarray(qp[i:i + 1024], np.int64)[:, None] - kp[None, :]
        ok = np.ones(d.shape, bool)
        if causal:
            ok &= d >= 0
        if window is not None:
            ok &= d < window
        total += int(ok.sum())
    return total


def _valid_keys(lens, s, offset, window):
    """Keys K5 reads: per row, [max(0, len - window + 1 - offset),
    min(S, len - offset))."""
    n = 0
    for ln in lens:
        hi = max(0, min(s, int(ln) - offset))
        lo = max(0, int(ln) - window + 1 - offset) if window else 0
        n += max(0, hi - min(lo, hi))
    return n


def _k5_flash(q, kvs, ln, s, off, window, log, tag):
    """K5's function as one PyTorch call, timed as the kernel is: flash
    attention of each GQA group's q rows over the row's valid keys returns
    (output, logsumexp), which is the partial (o = output, m = logsumexp,
    l = 1).  Held once against the plain partial, both finalized.  Returns
    (ms, how it was timed, the call's name)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    b, _, h, d = q.shape
    kvh = kvs[0][0].shape[2]
    n = int(ln[0])  # B = 1: the row's valid keys [lo, hi) in shard coordinates
    hi = max(0, min(s, n - off))
    lo = min(hi, max(0, n - window + 1 - off)) if window else 0
    q4 = q.view(b, kvh, h // kvh, d)
    views = [(k[:, lo:hi].transpose(1, 2), v[:, lo:hi].transpose(1, 2)) for k, v in kvs]
    name = "aten._scaled_dot_product_flash_attention"

    def call(kk, vv):
        return torch.ops.aten._scaled_dot_product_flash_attention(
            q4, kk, vv, 0.0, False, False)[:2]

    try:
        out, lse = call(*views[0])
    except RuntimeError:  # refused on this card's torch: the efficient kernel
        name = ("aten._scaled_dot_product_efficient_attention (the flash call "
                "was refused)")

        def call(kk, vv):
            o_, lse_ = torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, kk, vv, None, True)[:2]
            return o_, lse_[..., :h // kvh]

        out, lse = call(*views[0])
    want = fd.flash_decode_partial_plain(q, kvs[0][0], kvs[0][1], ln,
                                         k_pos_offset=off, window=window)
    _check(f"K5 {tag}: {name.split()[0]} vs plain (finalized)",
           out.reshape(b, 1, h, d), _fin(want.o, want.l), log, v=views[0][1])
    lse_err = (lse.reshape(b, 1, h) - want.m - torch.log(want.l)).abs().max().item()
    log.append(f"  K5 {tag}: its logsumexp vs plain m + log l: max abs err "
               f"{lse_err:.3e} (tol 1e-3)")
    assert lse_err <= 1e-3, lse_err
    ms, how = _device_ms(lambda i: call(*views[i % len(views)]))
    return ms, how, name


def phase_attention_kernels(rec, card):
    """K4 and K5: checks (phase 2) and timings (phase 3) at the widths of
    the serial path's models."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_split
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import striped_attention as sa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    log = ["[check] K4 / K5 vs plain versions (TF32 off)"]
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ipos(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)

    # ---- K4: (tag, B, Sq, Sk, H, KVH, D, dtype, causal, window, softcap,
    # positions); the first two are the main path's widths
    ar = np.arange
    k4_cases = [
        ("mixtral S=6144 window=4096", 1, 6144, 6144, 32, 8, 128, bf16, True,
         4096, None, (ar(6144), ar(6144))),
        ("zamba2 S=4096", 1, 4096, 4096, 32, 32, 80, bf16, True, None, None,
         (ar(4096), ar(4096))),
        ("non-causal Sq=300 Sk=500 B=2 f32", 2, 300, 500, 32, 8, 128, f32,
         False, None, None, (ar(300), ar(500))),
        ("softcap D=80 B=2", 2, 257, 257, 32, 32, 80, bf16, True, None, 30.0,
         (ar(257), ar(257))),
        ("striped q shard 3 / kv shard 1 of 4, window", 1, 512, 512, 32, 8,
         128, bf16, True, 200, None, (ar(512) * 4 + 3, ar(512) * 4 + 1)),
        ("unsorted positions B=3 f32 window softcap", 3, 200, 333, 32, 8, 128,
         f32, True, 64, 50.0, (rng.permutation(400)[:200],
                               rng.permutation(400)[:333])),
    ]
    k4_err = 0.0
    timed = {}
    for tag, b, sq, sk, h, kvh, d, dt, causal, window, softcap, (qp, kp) in k4_cases:
        q, k, v = randn(b, sq, h, d, dtype=dt), randn(b, sk, kvh, d, dtype=dt), \
            randn(b, sk, kvh, d, dtype=dt)
        qpd, kpd = ipos(qp), ipos(kp)
        kw = dict(causal=causal, window=window, softcap=softcap)
        err = _check(f"K4 {tag}", sa.striped_flash_attention(q, k, v, qpd, kpd, **kw),
                     sa.striped_flash_attention_plain(q, k, v, qpd, kpd, **kw), log,
                     v=v if dt == bf16 else None)
        k4_err = max(k4_err, err)
        if not tag.startswith(("mixtral", "zamba2")):
            continue
        qf, kf, vf = q.float(), k.float(), v.float()  # the f32 (FMA) route
        _check(f"K4 {tag} f32", sa.striped_flash_attention(qf, kf, vf, qpd, kpd, **kw),
               sa.striped_flash_attention_plain(qf, kf, vf, qpd, kpd, **kw), log)
        f32_ms = _time_ms(lambda: sa.striped_flash_attention(qf, kf, vf, qpd, kpd, **kw), 3)
        del qf, kf, vf
        pairs = _attended_pairs(qp, kp, causal, window) * b
        flops = 4 * h * d * pairs
        bytes_ = (2 * b * sq * h * d + 2 * b * sk * kvh * d) * q.element_size()
        ms = _time_ms(lambda: sa.striped_flash_attention(q, k, v, qpd, kpd, **kw))
        plain_ms = _time_ms(lambda: sa.striped_flash_attention_plain(
            q, k, v, qpd, kpd, **kw), 2, 1)
        # yardstick: SDPA on the GQA-expanded [B, H, S, D] layout, the same
        # mask (is_causal without a window, else a boolean mask)
        q4 = q.transpose(1, 2).contiguous()
        k4, v4 = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
                  for x in (k, v))
        if window is None:
            sdpa_kw = dict(is_causal=True)
        else:
            dd = qpd[:, None] - kpd[None, :]
            sdpa_kw = dict(attn_mask=(dd >= 0) & (dd < window))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, **sdpa_kw), 5, 1)
        bound = max(flops / PEAK_BF16, bytes_ / HBM_BPS) * 1e3
        by = "operations" if flops / PEAK_BF16 > bytes_ / HBM_BPS else "bytes"
        prev = PREV_MS["K4" if tag.startswith("mixtral") else "K4 zamba2"]
        timed[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          library_ms=lib_ms)
        print(f"[time {card}] K4 {tag}: kernel {ms:.3f} ms (previous design, earlier run: {prev} ms), "
              f"{_rates(flops, ms, bound)}, plain {plain_ms:.3f} ms, sdpa "
              f"{lib_ms:.3f} ms, f32 route {f32_ms:.3f} ms, bound {bound:.4f} ms "
              f"({by}; {flops / 1e9:.1f} GFLOP over {pairs} pairs, "
              f"{bytes_ / 1e6:.1f} MB)")
        del q4, k4, v4
    rec["K4"] = dict(
        name="striped_flash_attention", route="cuda",
        source="src/repro_torch/csrc/striped_attention.cu",
        replaces="src/repro/kernels/striped_attention.py:102",
        max_abs_err=k4_err, **timed["mixtral S=6144 window=4096"])

    # ---- K5: (tag, B, S, lengths, offset, H, KVH, D, q dtype, kv dtype,
    # window, softcap); the first three are the serial decode's shapes
    legacy = rng.integers(1024, 1024 + 4096 + 600, 16)
    legacy[[0, 5]] = [0, 700]  # empty rows: no length, or all before the shard
    k5_cases = [
        ("mixtral B=1 ctx=5000 window=4096", 1, 5000, [5000], 0, 32, 8, 128,
         bf16, bf16, 4096, None),
        ("mixtral B=1 ctx=8192 window=4096", 1, 8192, [8192], 0, 32, 8, 128,
         bf16, bf16, 4096, None),
        ("zamba2 B=1 ctx=8192", 1, 8192, [8192], 0, 32, 32, 80, bf16, bf16,
         None, None),
        ("legacy B=16 S=4096 offset=1024 window=1000", 16, 4096, legacy, 1024,
         32, 8, 128, bf16, f32, 1000, None),
        ("zamba2 B=4 f32 softcap", 4, 700, [0, 1, 350, 700], 0, 32, 32, 80,
         f32, f32, None, 30.0),
    ]
    k5_err = 0.0
    for tag, b, s, lens, off, h, kvh, d, qdt, kvdt, window, softcap in k5_cases:
        q = randn(b, 1, h, d, dtype=qdt)
        k, v = randn(b, s, kvh, d, dtype=kvdt), randn(b, s, kvh, d, dtype=kvdt)
        ln = ipos(lens)
        kw = dict(k_pos_offset=off, window=window, softcap=softcap)
        got = fd.flash_decode_partial(q, k, v, ln, **kw)
        err = _check(f"K5 {tag}", got, fd.flash_decode_partial_plain(q, k, v, ln, **kw),
                     log)
        k5_err = max(k5_err, err)
        for i, x in enumerate(lens):
            if _valid_keys([x], s, off, window) == 0:
                assert torch.isinf(got.m[i]).all() and (got.l[i] == 0).all(), tag
        if tag.startswith("mixtral B=1 ctx=8192"):
            continue
        n_valid = _valid_keys(lens, s, off, window)
        nbytes = (2 * n_valid * kvh * d * k.element_size() + b * h * d * q.element_size()
                  + b * h * (d + 2) * 4 + b * 4)
        flops = 4 * h * d * n_valid
        # cold L2, as in serving (each decode step uploads the cache anew):
        # the timed calls rotate over copies of k / v that exceed 64 MB
        n_cp = max(2, -(-COLD_BYTES // (k.nbytes + v.nbytes)))
        kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n_cp - 1)]
        ms, how = _device_ms(lambda i: fd.flash_decode_partial(q, *kvs[i % n_cp], ln, **kw))
        turn = itertools.count()
        eager_ms = _time_ms(lambda: fd.flash_decode_partial(
            q, *kvs[next(turn) % n_cp], ln, **kw), 20)
        plain_ms = _time_ms(lambda: fd.flash_decode_partial_plain(q, k, v, ln, **kw), 5)
        bound = max(nbytes / HBM_BPS, flops / PEAK_BF16) * 1e3
        by = "bytes" if nbytes / HBM_BPS >= flops / PEAK_BF16 else "operations"
        lib_ms, lib = None, ""
        if b == 1:  # the serial path's shape: one flash call over the valid keys
            lib_ms, lib_how, lib_name = _k5_flash(q, kvs, ln, s, off, window, log,
                                                  tag)
            lib = f", {lib_name} {lib_ms:.4f} ms ({lib_how})"
        n_splits, chunk = decode_split.plan(
            b, kvh, s if window is None else min(s, window - 1), q_per_kv=h // kvh,
            n_sm=decode_split.sm_count(dev))
        ctas = b * kvh * -(-(h // kvh) // decode_split.rows_per_cta(h // kvh)) * n_splits
        prev = {"mixtral B=1 ctx=5000 window=4096": "K5",
                "zamba2 B=1 ctx=8192": "K5 zamba2"}.get(tag)
        prev = f"; previous design, earlier run: {PREV_MS[prev]} ms" if prev else ""
        print(f"[time {card}] K5 {tag}: kernel {ms:.4f} ms ({how}, cold L2: "
              f"{n_cp} k/v copies, {n_cp * (k.nbytes + v.nbytes) / 1e6:.0f} MB{prev}), "
              f"eager wrapper {eager_ms:.4f} ms/call, {100 * bound / ms:.1f}% of its "
              f"bound, plain {plain_ms:.4f} ms{lib}, bound {bound:.5f} ms ({by}; "
              f"{n_valid} valid keys, {nbytes / 1e6:.2f} MB; plan {n_splits} split(s) "
              f"of {chunk} keys, {ctas} CTAs)")
        if tag.startswith("mixtral B=1 ctx=5000"):
            rec["K5"] = dict(
                name="flash_decode_partial", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:98",
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
        del kvs
    rec["K5"]["max_abs_err"] = k5_err
    print("\n".join(log))
    torch.cuda.empty_cache()


def _expect_launches(counts, launched, not_launched):
    """Kernels that must have been launched in a run, and kernels that must
    not have been."""
    for name in launched:
        assert counts.get(name, 0) > 0, (name, counts)
    for name in not_launched:
        assert counts.get(name, 0) == 0, (name, counts)


def _kernel_counts():
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import paged_flash_prefill as pfp
    from repro_torch.kernels import striped_attention as sa

    counts = {}
    for mod in (pfp, pfd, sa, fd):
        counts.update(mod.launch_counts)
    return counts


def _reset_counts():
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import paged_flash_prefill as pfp
    from repro_torch.kernels import striped_attention as sa

    ops.reset_dispatch_counts()
    for mod in (pfp, pfd, sa, fd):
        mod.launch_counts.clear()


def _serve(cfg, n_inst, capacity, lens, new_tokens, seed, check_oracle,
           serial=False):
    """One real-mode engine run; returns (metrics, kernel launches, dispatch
    counts, wall seconds, {stage: seconds} spans).  ``serial`` families (moe,
    hybrid) take the per-request path: K4 and K5 must launch and K1-K3 not;
    otherwise the packed / paged path: K1-K3 must launch and no serial
    prefill run."""
    import torch

    from repro_torch.convert import init_params
    from repro_torch.engine.request import Request
    from repro_torch.engine.server import LoongServeEngine
    from repro_torch.kernels import ops
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
    spans = {}
    if not serial:
        # build the pool mirrors (one full host->device upload each) before
        # the clock starts, and time it on its own
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pool in eng.pool.pools:
            pool.device_kv()
        torch.cuda.synchronize()
        spans["mirror_build"] = time.perf_counter() - t0

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
    if serial:
        # decode_serial's per-step host round trip of the request's KV
        eng.pool.gather_request = timed("decode: host gather of the KV",
                                        eng.pool.gather_request)
        ex._to_dev = timed("host->device uploads (KV, tokens)", ex._to_dev)
    else:
        ex._emit_decoded = timed("decode: emit + KV to host", ex._emit_decoded)
        for pool in eng.pool.pools:
            pool.device_kv = timed("mirror sync", pool.device_kv)
    up0 = sum(p.mirror_uploaded_slots for p in eng.pool.pools)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # counts of the main path only, from here
    t0 = time.perf_counter()
    m = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans["uploaded_slots"] = sum(p.mirror_uploaded_slots for p in eng.pool.pools) - up0
    spans["host_syncs"] = sum(p.host_syncs for p in eng.pool.pools)
    counts = _kernel_counts()
    dispatch = dict(ops.dispatch_counts)
    assert len(m.finished) == len(reqs), (len(m.finished), len(reqs))
    assert m.scaling_migration_bytes == 0, m.scaling_migration_bytes
    packed = ("packed_flash_prefill", "packed_flash_prefill_ring_chunk",
              "paged_flash_decode_partial")
    if serial:
        _expect_launches(counts, ("striped_flash_attention", "flash_decode_partial"),
                         packed)
        assert dispatch.get("prefill_serial_model", 0) >= len(reqs), dispatch
        assert not eng._real_cache, "recurrent state of finished requests kept"
    else:
        _expect_launches(counts, packed, ())
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


def _report(tag, cfg, m, counts, dispatch, wall, spans, lens, new_tokens):
    import torch

    summ = m.summary()
    toks = sum(len(r.output_tokens) for r in m.finished)
    print(f"[serve] {tag}: {len(lens)} requests (prompts {lens}), {new_tokens} new "
          f"tokens each: wall {wall:.3f} s, {toks} tokens out, prefill_iters "
          f"{summ['prefill_iters']}, decode_iters {summ['decode_iters']}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[serve] {tag}: kernel launches {counts}; dispatches {dispatch}")
    print(f"[serve] {tag}: spans (s): "
          + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in spans.items()))
    return summ


def _serve_serial(name, cfg, lens, new_tokens, capacity, seed):
    """Phases 6-7: one serial-path serving run at full width; returns the
    kernel launches."""
    import torch

    m, counts, dispatch, wall, spans = _serve(cfg, 4, capacity, lens,
                                              new_tokens, seed, False, serial=True)
    _report(name, cfg, m, counts, dispatch, wall, spans, lens, new_tokens)
    dec = spans.get("decode", 0.0)
    host = (spans.get("decode: host gather of the KV", 0.0)
            + spans.get("host->device uploads (KV, tokens)", 0.0))
    n_attn = cfg.n_attention_applications
    print(f"[serve] {name}: wall split: serial prefill {spans.get('prefill', 0.0):.3f} s, "
          f"decode compute {dec - host:.3f} s, host gather + upload of the KV "
          f"{host:.3f} s (inside decode); K4 {counts['striped_flash_attention'] / n_attn:.0f} "
          f"prefills x {n_attn} attention layers, K5 "
          f"{counts['flash_decode_partial'] / n_attn:.0f} request-steps x {n_attn} "
          "attention layers")
    gc.collect()  # the engine and its executor reference each other
    torch.cuda.empty_cache()
    return counts


UNIFIED = ("paged_flash_decode_partial", "packed_flash_prefill_ring_chunk")


def phase_unified_serve(card, cfg):
    """Phase 9: unified serving (``prefill_chunk_tokens=512``) at full width
    and depth: four prompts of 512-1024 tokens, then one of 4096 while they
    decode.  Every prefill runs as a chain of unified steps (K2 prefix plane
    + K3 chunk plane; K1 never), decode rows ride the long prompt's chain.
    Returns the kernel launches."""
    import torch

    from repro_torch.convert import init_params
    from repro_torch.engine.request import Phase
    from repro_torch.kernels import decode_split, ops
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(9), "cuda")
    eng = _engine(cfg, 4, 4096, model, params, 512)
    assert eng.executor.supports_unified
    rng = np.random.default_rng(9)
    lens = [int(x) for x in rng.integers(512, 1025, 4)] + [4096]
    reqs = _requests(cfg, rng, lens, [24] * 4 + [8], [0.0] * 4 + [0.05])
    long_r = reqs[-1]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pool in eng.pool.pools:  # the f32 mirrors, before the clock
        pool.device_kv()
    torch.cuda.synchronize()
    mirror_build = time.perf_counter() - t0
    spans = {}
    state = {"chain": False, "key_rows": 0, "distinct_rows": 0, "io_bytes": 0}
    dev_ms = {"K2": [], "K3": []}
    plans = []

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                spans[key] = spans.get(key, 0.0) + time.perf_counter() - t
        return run

    def evented(key, fn):
        """CUDA events around each launch inside the chain (device time,
        launch gaps included); outside the chain the call passes through.
        K2's query rows and partials are counted from their shapes."""
        def run(q, *args, **kw):
            if not state["chain"]:
                return fn(q, *args, **kw)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(q, *args, **kw)
            b.record()
            dev_ms[key].append((a, b))
            if key == "K2":
                state["io_bytes"] += q.numel() * q.element_size() + sum(
                    t.numel() * t.element_size() for t in out)
            return out
        return run

    ex = eng.executor
    shards_fn = ex._unified_shards

    def host_tables(segs, tb):
        # every packed row reads its segment's whole prefix (covered ==
        # limit, asserted by the step): as launched vs read once per segment
        state["key_rows"] += sum(g.ln * g.limit for g in segs)
        state["distinct_rows"] += sum(g.limit for g in segs)
        return tables(segs, tb)

    tables = timed("unified: host tables (incl. mirror sync)", shards_fn)
    ex._unified_shards = host_tables
    model.prefill_packed = timed("unified: model step", model.prefill_packed)
    ex._unified_emit = timed("unified: emit", ex._unified_emit)
    ex.decode = timed("decode outside the chain", ex.decode)
    # the scheduler's reactive migrations move a request's KV on the host
    # (download of its device-only slots, then upload at the destination)
    eng.pool.migrate_request = timed("reactive migration (host KV move)",
                                     eng.pool.migrate_request)
    for pool in eng.pool.pools:
        pool.device_kv = timed("mirror sync", pool.device_kv)
    orig_ops = (ops.paged_decode_partial, ops.prefill_ring_chunk)
    ops.paged_decode_partial = evented("K2", ops.paged_decode_partial)
    ops.prefill_ring_chunk = evented("K3", ops.prefill_ring_chunk)
    plan_fn = decode_split.plan

    def plan(b, *a, **kw):
        out = plan_fn(b, *a, **kw)
        if state["chain"]:
            plans.append((b, out[0]))
        return out

    decode_split.plan = plan
    mix = []
    unified_fn = ex.unified

    def unified(work):
        before = (ops.dispatch_counts["unified_prefill_tokens"],
                  ops.dispatch_counts["unified_decode_tokens"])
        state["chain"] = True
        try:
            return timed("unified: whole step", unified_fn)(work)
        finally:
            state["chain"] = False
            mix.append((
                ops.dispatch_counts["unified_prefill_tokens"] - before[0],
                ops.dispatch_counts["unified_decode_tokens"] - before[1],
                long_r.phase is Phase.PREFILL and long_r.prefill_pos > 0,
            ))

    ex.unified = unified
    torch.cuda.reset_peak_memory_stats()
    mirror0 = [(p.mirror_full_syncs, p.mirror_uploaded_slots, p.host_syncs)
               for p in eng.pool.pools]
    _reset_counts()
    try:
        t0 = time.perf_counter()
        m = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decode_split.plan = plan_fn
        ops.paged_decode_partial, ops.prefill_ring_chunk = orig_ops
    counts = _kernel_counts()
    dispatch = dict(ops.dispatch_counts)
    assert len(m.finished) == len(reqs), (len(m.finished), len(reqs))
    assert m.scaling_migration_bytes == 0, m.scaling_migration_bytes
    assert dispatch.get("unified_step", 0) > 0, dispatch
    assert dispatch["unified_prefill_tokens"] == sum(lens), (dispatch, lens)
    _expect_launches(counts, UNIFIED, ("packed_flash_prefill",))
    long_iters = [(p, d) for p, d, mid in mix if mid]
    riding = [d for _, d in long_iters if d > 0]
    assert len(riding) >= 3, f"decode did not flow during the long prefill: {mix}"
    big = [n for b, n in plans if b >= 512]
    assert big and all(n == 1 for n in big), plans  # no workspace
    for r in reqs:
        assert len(r.output_tokens) == r.max_new_tokens, r.output_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.output_tokens)
    k2_ms = sum(a.elapsed_time(b) for a, b in dev_ms["K2"])
    k3_ms = sum(a.elapsed_time(b) for a, b in dev_ms["K3"])
    n_layers = cfg.n_layers
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[unified {card}] lwm-7b full width/depth bf16, 4 instances x 4096 slots, "
          f"prefill_chunk_tokens 512: prompts {lens} (the last at t = 0.05 s), "
          f"24 / 8 new tokens: wall {wall:.3f} s, {dispatch['unified_step']} unified "
          f"steps ({dispatch['unified_prefill_tokens']} prefill + "
          f"{dispatch['unified_decode_tokens']} decode tokens), decode_iters "
          f"{m.summary()['decode_iters']}, reactive migration "
          f"{m.reactive_migration_bytes / 1e9:.2f} GB, max_memory_allocated {peak:.2f} GiB; "
          f"mirror build before the clock {mirror_build:.3f} s")
    print(f"[unified {card}] chain links while the 4096-token prompt was mid-prefill "
          f"(prefill tokens, decode tokens): {long_iters}; {len(riding)} carried decode rows")
    rest = wall - sum(spans.get(k, 0.0) for k in (
        "unified: whole step", "decode outside the chain",
        "reactive migration (host KV move)"))
    print(f"[unified {card}] spans (s; host tables, model step and emit nest in the "
          "whole step, mirror sync in host tables and decode; K2 / K3 run inside "
          "the model step): "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
          + f", engine host (the rest of the wall) {rest:.3f}")
    kv_b = n_layers * cfg.n_kv_heads * cfg.d_head * 8  # f32 K + V, all layers
    distinct_s = (state["distinct_rows"] * kv_b + state["io_bytes"]) / HBM_BPS
    launched_s = (state["key_rows"] * kv_b + state["io_bytes"]) / HBM_BPS
    print(f"[unified {card}] prefix plane: {state['key_rows']} key-rows per layer "
          f"over the chain, {state['key_rows'] * n_layers} over all layers "
          f"({state['key_rows'] * kv_b / 1e12:.2f} TB of f32 K+V as launched; "
          f"{state['distinct_rows']} per layer, {state['distinct_rows'] * kv_b / 1e9:.1f} "
          f"GB, with each segment's prefix read once); K2 {len(dev_ms['K2'])} launches in the chain, "
          f"{k2_ms / 1e3:.3f} s between CUDA events around them (bound over "
          f"HBM: {distinct_s:.4f} s for the distinct prefix bytes plus "
          f"{state['io_bytes'] / 1e9:.2f} GB of query rows and partials, "
          f"{launched_s:.3f} s as launched); K3 "
          f"{len(dev_ms['K3'])} launches, {k3_ms / 1e3:.3f} s; split plans "
          f"(rows, splits): {sorted(set(plans))}")
    mirror = [(p.mirror_full_syncs - a, p.mirror_uploaded_slots - b, p.host_syncs - c)
              for p, (a, b, c) in zip(eng.pool.pools, mirror0)]
    print(f"[unified {card}] pool mirrors during the run, per instance (full "
          f"uploads, uploaded slots, host downloads): {mirror}")
    print(f"[unified {card}] kernel launches {counts}; dispatches {dispatch}")
    return counts


def _engine(cfg, n, cap, model, params, chunk, **kw):
    from repro_torch.engine.server import LoongServeEngine
    from repro_torch.manager.scheduler import ManagerConfig

    return LoongServeEngine(cfg, n, cap, store_values=True, model=model,
                            params=params, device="cuda",
                            mcfg=ManagerConfig(prefill_chunk_tokens=chunk), **kw)


def _requests(cfg, rng, lens, new_tokens, arrivals):
    from repro_torch.engine.request import Request

    return [Request(input_len=n, max_new_tokens=k, arrival=t,
                    prompt=rng.integers(0, cfg.vocab_size, n).tolist())
            for n, k, t in zip(lens, new_tokens, arrivals)]


def _oracle_parity(model, params, reqs, done, tag):
    """``reqs`` hold the original prompts; ``done`` the engine's requests."""
    from repro_torch.kernels import ref

    for orig, r in zip(reqs, done):
        want = ref.serial_decode_oracle(model, params, orig.prompt,
                                        orig.max_new_tokens - 1)
        assert r.output_tokens == want, (tag, r.rid, r.output_tokens, want)


def _step_until(eng, cond, limit, what):
    guard = 0
    while not cond():
        assert eng.events and guard < limit, what
        eng.run(max_events=1)
        guard += 1


# the salvage topologies of tests/test_salvage.py (``_TOPOLOGIES``): (group
# DoP, instances, per-instance capacity, long prompt); tests/test_torch_salvage.py
# runs them as they are, phase 10 with capacity and prompt lengths x SCALE
SALVAGE_TOPOLOGIES = [(2, 3, 220, 300), (4, 6, 170, 560)]
SCALE = 10


def phase_unified_parity(card, cfg):
    """Phase 10: the unified path's token parity with the port's plain serial
    oracle at f32: (a) chunk-resume for budgets 4096 / 37 / 1; (b) a
    single-instance failure mid-chain at DoP 2 and 4, salvaged; (c) a
    checkpoint mid-chain restored into a fresh engine that resumes the chain
    at its cursor.  Sizes are the reference tests' (tests/test_unified.py,
    tests/test_salvage.py) times ``SCALE``.  Returns the kernel launches of
    all three."""
    import copy
    import tempfile

    import torch

    from repro_torch.convert import init_params
    from repro_torch.engine.invariants import InvariantChecker
    from repro_torch.engine.request import Phase
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(10), "cuda")
    rng = np.random.default_rng(10)
    total = {}

    def add_counts():
        for k, v in _kernel_counts().items():
            total[k] = total.get(k, 0) + v

    # ---- (a) chunk-resume parity
    base = [13 * SCALE, 21 * SCALE, 5 * SCALE]
    for chunk in (4096, 37, 1):
        reqs = _requests(cfg, rng, base, [4] * 3, [0.0] * 3)
        eng = _engine(cfg, 2, 2000, model, params, chunk)
        rs = copy.deepcopy(reqs)
        for r in rs:
            eng.submit(r)
        _reset_counts()
        t0 = time.perf_counter()
        m = eng.run()
        wall = time.perf_counter() - t0
        d = dict(ops.dispatch_counts)
        assert len(m.finished) == len(rs)
        assert d["unified_prefill_tokens"] == sum(base), d
        if chunk == 1:
            assert d["unified_step"] >= sum(base), d
        _expect_launches(_kernel_counts(), UNIFIED, ("packed_flash_prefill",))
        add_counts()
        _oracle_parity(model, params, reqs, rs, f"chunk {chunk}")
        print(f"[parity {card}] unified chunk-resume, budget {chunk}: prompts {base} "
              f"token-identical to the serial oracle; {d['unified_step']} unified "
              f"steps; wall {wall:.3f} s")

    # ---- (b) mid-chain failure at DoP 2 and 4: salvage, not recompute
    for dop, n, cap, long_len in SALVAGE_TOPOLOGIES:
        cap, long_len = cap * SCALE, long_len * SCALE
        lens = [int(x) for x in rng.integers(20 * SCALE, 30 * SCALE, 3)] + [long_len]
        reqs = _requests(cfg, rng, lens, [8, 8, 8, 4], [0.0] * 3 + [0.03])
        eng = _engine(cfg, n, cap, model, params, 48 * SCALE)
        chk = InvariantChecker(eng)
        chk.arm()
        rs = copy.deepcopy(reqs)
        for r in rs:
            eng.submit(r)
        long_r = rs[-1]
        _reset_counts()
        t0 = time.perf_counter()
        _step_until(eng, lambda: (
            long_r.phase is Phase.PREFILL
            and long_r.prefill_pos >= int(0.8 * long_len)
            and len(eng.pool.request_instances(long_r.rid)) >= dop
            and any(e[2] == "unified_done" for e in eng.events)),
            4000, f"DoP {dop}: never reached a striped mid-chain")
        victim = eng.pool.request_instances(long_r.rid)[0]
        held = {rid: len(eng.pool.pools[victim].tokens_of(rid))
                for rid in eng.pool.pools[victim].requests()}
        stale = sum(p.stale_host_slot_count() for p in eng.pool.pools
                    if p.instance_id != victim)
        eng.fail_instance(victim)
        eng.run(max_events=1)
        rec = dict(eng._recovering)
        assert long_r.rid in rec, f"DoP {dop}: the failure did not salvage the chain"
        for rid, st in rec.items():
            assert sum(e - s for s, e in st.spans) <= held.get(rid, 0), (rid, st, held)
            assert st.salvaged > 0
        m = eng.run()
        wall = time.perf_counter() - t0
        assert len(m.finished) == len(rs)
        assert m.salvaged_tokens > 0
        assert m.recomputed_tokens < sum(r.seq_len for r in rs)
        assert not eng._recovering
        assert chk.leaked_slots() == 0 and eng.pool.total_used == 0
        _expect_launches(_kernel_counts(), UNIFIED, ("packed_flash_prefill",))
        add_counts()
        _oracle_parity(model, params, reqs, rs, f"salvage DoP {dop}")
        print(f"[parity {card}] salvage at DoP {dop} ({n} instances x {cap} slots, "
              f"prompts {lens}): instance {victim} failed mid-chain holding "
              f"{sum(held.values())} tokens ({stale} survivor slots device-only); "
              f"salvaged {m.salvaged_tokens}, recomputed {m.recomputed_tokens} of "
              f"{sum(r.seq_len for r in rs)} tokens; {chk.checks} invariant checks; "
              f"token-identical to the serial oracle; wall {wall:.3f} s")

    # ---- (c) checkpoint mid-chain, restore into a fresh engine, resume
    lens = [int(x) for x in rng.integers(20 * SCALE, 30 * SCALE, 2)] + [200 * SCALE]
    reqs = _requests(cfg, rng, lens, [8, 8, 4], [0.0, 0.0, 0.03])
    eng = _engine(cfg, 2, 600 * SCALE, model, params, 32 * SCALE)
    rs = copy.deepcopy(reqs)
    for r in rs:
        eng.submit(r)
    long_r = rs[-1]
    _step_until(eng, lambda: (
        long_r.phase is Phase.PREFILL
        and 0 < long_r.prefill_pos < long_r.input_len
        and any(e[2] == "unified_done" for e in eng.events)),
        2000, "never caught the chain mid-link")
    cursor = long_r.prefill_pos
    stale = sum(p.stale_host_slot_count() for p in eng.pool.pools)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "mid_chain.ckpt")
        eng.checkpoint(path)
        size = Path(path).stat().st_size
        eng2 = _engine(cfg, 2, 600 * SCALE, model, params, 32 * SCALE)
        eng2.restore(path)
    del eng
    assert eng2._active_unified and eng2._req_index[long_r.rid].prefill_pos == cursor
    holding = [p for p in eng2.pool.pools if p.requests()]
    assert holding and all(p._mirror is None for p in eng2.pool.pools)
    _reset_counts()
    m = eng2.run()
    d = dict(ops.dispatch_counts)
    assert len(m.finished) == len(rs)
    assert d["unified_prefill_tokens"] <= sum(lens) - cursor, (d, cursor)
    # the restored pools rebuilt their mirrors on the engine's device
    assert all(p.device == eng2.device for p in eng2.pool.pools)
    assert all(p._mirror is not None and p._mirror[0].device.type == eng2.device.type
               for p in holding)
    _expect_launches(_kernel_counts(), UNIFIED, ("packed_flash_prefill",))
    add_counts()
    _oracle_parity(model, params, reqs, [eng2._req_index[x.rid] for x in rs],
                   "checkpoint resume")
    print(f"[parity {card}] checkpoint mid-chain (prompts {lens}, cursor {cursor}, "
          f"{stale} slots device-only before the snapshot, {size / 1e6:.1f} MB): the "
          f"restored engine resumed with {d['unified_prefill_tokens']} prefill tokens "
          f"left of {sum(lens)}; token-identical to the serial oracle")
    return total


# tests/test_chaos.py's real-mode soak (test_real_chaos_soak_oracle_parity):
# 3 instances x 600 slots, all six injectors, seed 7; tests/test_torch_chaos.py
# runs it on the CPU
CHAOS_RATES = dict(
    fail_rate=0.05, rejoin_rate=0.3, straggler_rate=0.2, slowdown_rate=0.1,
    pressure_rate=0.25, release_rate=0.15, ballast_frac=0.3,
    dispatch_fault_rate=0.2, nan_rate=0.12, min_alive=2,
)


def phase_chaos(card, cfg):
    """Phase 11: the real-mode chaos soak at f32 with all six injectors, on
    the packed / paged path and on the unified path (chunk 16): every
    injector fires, retries and quarantines happen, the invariant sanitizer
    stays green after every event, nothing leaks, and every token equals
    the serial oracle.  Returns the kernel launches."""
    import torch

    from repro_torch.chaos import ChaosConfig, ChaosMonkey
    from repro_torch.convert import init_params
    from repro_torch.engine.invariants import InvariantChecker
    from repro_torch.engine.request import Phase
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(11), "cuda")
    total = {}
    for chunk in (None, 16):
        eng = _engine(cfg, 3, 600, model, params, chunk, admission_watermark=0.15)
        rng = np.random.default_rng(7)  # the reference test's workload
        reqs = []
        for i in range(10):
            ilen = int(rng.integers(16, 49))
            mnt = int(rng.integers(4, 9))
            reqs += _requests(cfg, rng, [ilen], [mnt], [i * 0.01])
        orig = [(list(r.prompt), r.max_new_tokens) for r in reqs]
        for r in reqs:
            eng.submit(r)
        monkey = ChaosMonkey(eng, ChaosConfig(**CHAOS_RATES), seed=7)
        chk = InvariantChecker(eng)
        monkey.arm()
        chk.arm()
        _reset_counts()
        t0 = time.perf_counter()
        eng.run(max_events=300)
        monkey.disarm()
        m = eng.run()
        wall = time.perf_counter() - t0
        assert ops._fault_hook is None
        assert all(r.phase is Phase.FINISHED for r in reqs)
        assert chk.leaked_slots() == 0 and eng.pool.total_used == 0
        actions = {t[1] for t in monkey.trace}
        for a in ("fail", "rejoin", "straggle", "slowdown", "pressure",
                  "dispatch_fault", "poison"):
            assert a in actions, f"chunk {chunk}: injector {a!r} never fired"
        assert m.dispatch_retries > 0 and m.nan_quarantined > 0
        counts = _kernel_counts()
        if chunk is None:
            _expect_launches(counts, ("packed_flash_prefill",
                                      "paged_flash_decode_partial"), ())
        else:
            _expect_launches(counts, UNIFIED, ("packed_flash_prefill",))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        for (prompt, mnt), r in zip(orig, reqs):
            want = ref.serial_decode_oracle(model, params, prompt, mnt - 1)
            assert list(r.output_tokens) == want, (chunk, r.rid)
        summ = m.summary()
        print(f"[chaos {card}] real-mode soak, prefill_chunk_tokens {chunk}: "
              f"{len(monkey.trace)} injections {sorted(actions)}, "
              f"{chk.checks} invariant checks, 0 violations, 0 leaked slots; "
              f"retries {summ['dispatch_retries']}, quarantined "
              f"{summ['nan_quarantined']}, salvaged {summ['salvaged_tokens']}, "
              f"recomputed {summ['recomputed_tokens']}; {len(reqs)} requests "
              f"token-identical to the serial oracle; launches {counts}; wall {wall:.3f} s")
    return total


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
    phase_unified_kernels(rec, smi.splitlines()[0])
    phase_attention_kernels(rec, smi.splitlines()[0])

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

    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 6: full-width mixtral-8x7b (moe), 16 of 32 layers, bf16
    mix = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=16)
    print("[serve] mixtral-8x7b cut to 16 of its 32 layers: full depth is "
          f"{get_config('mixtral-8x7b').param_count() * 2 / 1e9:.1f} GB of bf16 "
          f"weights, 16 layers {mix.param_count() * 2 / 1e9:.1f} GB, on an 80 GB card")
    lens6 = [int(x) for x in np.random.default_rng(6).integers(512, 2049, 6)] + [5000]
    c_mix = _serve_serial("mixtral-8x7b 16/32 layers bf16", mix, lens6, 12, 8192, 6)

    # ---- phase 7: full-width, full-depth zamba2-2.7b (hybrid), bf16
    zam = get_config("zamba2-2.7b")
    lens7 = [int(x) for x in np.random.default_rng(7).integers(512, 2049, 6)]
    c_zam = _serve_serial("zamba2-2.7b full depth bf16", zam, lens7, 12, 4096, 7)
    for key, name in (("K4", "striped_flash_attention"), ("K5", "flash_decode_partial")):
        rec[key]["launches"] = c_mix[name] + c_zam[name]
        print(f"[serve] {key} launches on the serial main path: mixtral "
              f"{c_mix[name]} + zamba2 {c_zam[name]}")

    # ---- phase 8: serial-path token parity, full width, reduced depth, f32
    for cfg8, lens8 in (
            (dataclasses.replace(mix, n_layers=2, dtype="float32"),
             [int(x) for x in np.random.default_rng(8).integers(128, 1025, 3)] + [4200]),
            (dataclasses.replace(zam, n_layers=6, dtype="float32"),
             [int(x) for x in np.random.default_rng(9).integers(128, 1025, 4)])):
        _, counts8, _, wall8, _ = _serve(cfg8, 4, 8192, lens8, 6, 8, True, serial=True)
        print(f"[parity] {cfg8.name} width, {cfg8.n_layers} layers, f32: "
              f"{len(lens8)} requests (prompts {lens8}) token-identical to the "
              f"serial oracle; launches {counts8}; wall {wall8:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()

    # ---- phase 9: unified serving at full width and depth, bf16
    card = smi.splitlines()[0]
    c_uni = phase_unified_serve(card, cfg)
    for key, name in (("K1", "packed_flash_prefill"),
                      ("K3", "packed_flash_prefill_ring_chunk"),
                      ("K2", "paged_flash_decode_partial")):
        rec[key]["launches_by_path"] = {"packed/paged (phase 4)": rec[key]["launches"],
                                        "unified (phase 9)": c_uni.get(name, 0)}
        rec[key]["launches"] += c_uni.get(name, 0)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phases 10-11: unified parity, salvage, checkpoint and chaos, f32
    t10 = time.perf_counter()
    phase_unified_parity(card, cfg2)
    print(f"[parity] phase 10 took {time.perf_counter() - t10:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    phase_chaos(card, cfg2)
    print(f"[chaos] phase 11 took {time.perf_counter() - t11:.1f} s")

    order = ("K1", "K3", "K2", "K4", "K5")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rec[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
